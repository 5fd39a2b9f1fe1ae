"""K6 reading the old ground itself (``ops/march.py march_budget``), on the CPU.

K6 takes the moved ground and reads each in-map, unignored point's word
``ground[cell]`` itself: K2's gather of the old ground is folded into it.
On CPU tensors the wrapper takes its plain route, K2's plain gather and
``core/outliers.py march_budget``, which is what ``tests/test_torch_cuda.py``
holds the kernel to on the card (bitwise). Here: the route bitwise the
gather and the plain budget on the edge scenes of ``tests/march_scenes.py``
with the seams of the read (overflow ids ``n^2`` on in-map points, -0.0
and NaN ground words at candidate cells, a word past each grid that a
guard-free read would see), on one vehicle and a batch of three, each row
bitwise its single call; the step's callers passing the moved ground.
Neither JAX nor ``groundgrid_tpu`` is imported here.
"""

import pytest
import torch

import march_scenes
from groundgrid_torch import ops
from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import outliers
from groundgrid_torch.ops import march
from groundgrid_torch.ops.lookup import lookup_plain

torch.set_num_threads(1)

CASES = {"seed-0": (0,), "seed-1": (1,), "batch-of-3": (2, 3, 4)}


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(got, want):
    return all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))


@pytest.mark.parametrize("case", list(CASES))
def test_route_is_the_gather_then_the_plain_budget(case):
    """The wrapper's CPU route bitwise ``lookup_plain`` of the moved ground
    followed by ``core/outliers.py march_budget`` (budgets, keys and
    directions), launching nothing."""
    cfg = GroundGridConfig(**march_scenes.EDGE)
    s, b, x, y, z, ground, _ = march_scenes.fold_inputs(cfg, CASES[case])
    before = ops.counter_values()
    got = march.march_budget(cfg, s, b, x, y, z, ground)
    assert ops.counter_values() == before
    (old_h,) = lookup_plain(b.cell, [ground], cfg.cell_count ** 2)
    assert _same(got, outliers.march_budget(cfg, s, b, x, y, z, old_h))
    assert int((got[0] > 0).sum()) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_seams_decide_candidates(case):
    """The seams matter on these inputs: overflow points read 0 and march
    (a read of the word past the grid would turn them away), NaN words
    turn their points away, -0.0 words leave theirs candidates."""
    cfg = GroundGridConfig(**march_scenes.EDGE)
    s, b, x, y, z, ground, ov = march_scenes.fold_inputs(cfg, CASES[case])
    n2 = cfg.cell_count ** 2
    budget = march.march_budget(cfg, s, b, x, y, z, ground)[0]
    assert bool((budget[ov] > 0).any())
    (old_h,) = lookup_plain(b.cell, [ground], n2)
    past = torch.where(ov, torch.full_like(old_h, march_scenes.PAST_GRID), old_h)
    unguarded = outliers.march_budget(cfg, s, b, x, y, z, past)[0]
    assert not torch.equal(_bits(unguarded), _bits(budget))
    live = b.inmap & ~b.ignored & ~ov
    nan, neg = live & old_h.isnan(), live & (old_h == 0) & old_h.signbit()
    assert bool(nan.any()) and not bool((budget[nan] > 0).any())
    assert bool(neg.any()) and bool((budget[neg] > 0).any())
    # the NaN words as 0: those points would march
    zeroed = torch.where(nan, torch.zeros_like(old_h), old_h)
    assert bool((outliers.march_budget(cfg, s, b, x, y, z, zeroed)[0][nan] > 0).any())


def test_batch_rows_are_single_calls():
    """A batch of three: (3, P) points and (3, N, N) ground, each row bitwise
    its vehicle's single call on its own grid."""
    cfg = GroundGridConfig(**march_scenes.EDGE)
    seeds = CASES["batch-of-3"]
    s, b, x, y, z, ground, _ = march_scenes.fold_inputs(cfg, seeds)
    got = march.march_budget(cfg, s, b, x, y, z, ground)
    for v, seed in enumerate(seeds):
        one = march.march_budget(cfg, *march_scenes.fold_inputs(cfg, (seed,))[:-1])
        assert _same((got[0][v], got[1][v], got[2][:, v]), one)


@pytest.mark.parametrize("caller", ["step", "spatial"])
def test_callers_hand_k6_the_moved_ground(monkeypatch, caller):
    """The step and the spatial step's shard bodies give K6 the whole moved
    ground (no K2 gather before it): one ``march_budget`` call a step or
    shard, its last argument an (N, N) grid."""
    from groundgrid_torch.data.synthetic import synthetic_sequence
    from groundgrid_torch.parallel import spatial
    from groundgrid_torch.pipeline import Step, init_state, pad_scan

    seen, lookups = [], []
    real_budget, real_lookup = march.march_budget, ops.lookup.lookup

    def budget(cfg, s, b, x, y, z, ground):
        seen.append(tuple(ground.shape))
        return real_budget(cfg, s, b, x, y, z, ground)

    def lookup(cell, tables, n2):
        lookups.append(len(tables))
        return real_lookup(cell, tables, n2)

    monkeypatch.setattr(march, "march_budget", budget)
    monkeypatch.setattr(ops.lookup, "lookup", lookup)
    cfg = GroundGridConfig(dimension=24.0, resolution=0.5, max_points=4096, ray_steps=28,
                           max_outlier_candidates=256)
    n = cfg.cell_count
    pts, lbl, T = next(synthetic_sequence(1, seed=4, n_beams=10, n_azimuth=300))
    state = init_state(cfg, T, "cpu")
    scan = pad_scan(cfg, pts, lbl, T, "cpu")
    if caller == "step":
        step = Step(cfg)
        step(state, scan)
        assert seen == [(n, n)] and lookups == [2]
    else:
        mesh = ["cpu"] * 2
        step = spatial.SpatialStep(cfg, mesh)
        g, c = spatial.split_rows(state.ground, mesh), spatial.split_rows(state.groundpatch, mesh)
        step(g, c, (state.center, state.center_lo), spatial.shard_scan(scan, mesh))
        assert seen == [(n, n)] * 2 and lookups == [2, 2]
