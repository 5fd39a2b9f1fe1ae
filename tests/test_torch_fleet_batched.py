"""The batched body of the unsorted fleet, on the CPU.

The JAX fleet steps an unsorted config's vehicles under ``jax.vmap``; the
port steps a device's block of B vehicles as one body over a leading
vehicle axis (``pipeline.Step.body``, captured by ``CapturedStep``), each
kernel taking the batch in one launch. Its contract: every vehicle's
outputs and state bitwise the single unsorted step's. Held here:

* K1, K2 and K4's plain versions on a batch, bitwise their single calls,
  with an empty batch, a vehicle whose ids are all the overflow bin, an
  empty grid and B = 1 (K3 in ``tests/test_torch_spiral_batched.py``);
* the batched body: 4 vehicles at ``tests/test_torch_fleet.py``'s tiny
  geometry over 3 scans (one at the half-cell snap tie, one shifting by
  several cells a scan, one overflowing ``max_points``, one with an empty
  scan) against 4 single eager steps: labels, outliers, x/y/z, ground,
  groundpatch and the center pair, bitwise;
* the captured batched step (on the CPU a replay runs the body) bitwise
  the eager batched body;
* ``FleetStep``, whose block's scan scalars are one pass over its
  vehicles, batched and sorted on two blocks of two: bitwise the batched
  body fed per-vehicle scalars, and the vehicles' own single steps;
* the fleet driver with 4 vehicles a block against streaming drivers.
"""

import numpy as np
import pytest
import torch

from groundgrid_torch import FleetDriver, GroundGridConfig, ScanRecord, StreamingDriver
from groundgrid_torch.core.detect import make_tables
from groundgrid_torch.data.synthetic import detect_layers, synthetic_sequence
from groundgrid_torch.ops import detect, lookup, raster
from groundgrid_torch.parallel.sharding import (
    make_fleet_step,
    shard_fleet_pytree,
    stack_fleet_pytree,
)
from groundgrid_torch.pipeline import (
    CapturedStep,
    CenterTracker,
    init_state,
    make_step_fn,
    pad_scan,
    prepare_scan,
)

torch.set_num_threads(1)

# tests/test_torch_fleet.py's TINY, unsorted (the config default)
TINY = dict(dimension=24.0, resolution=0.5, max_points=4096, ray_steps=28,
            max_outlier_candidates=256)
N2 = 24 * 24
OPS = ["sum"] * 5 + ["min", "max"]


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _sorted_ids(rng, kind, p):
    if kind == "random":
        return np.sort(rng.integers(0, N2 + 1, p))
    if kind == "overflow":  # every id the overflow bin
        return np.full(p, N2)
    if kind == "long_runs":
        return np.sort(rng.choice(8, p) * 37 % N2)
    raise KeyError(kind)


BATCHES = {"mixed": ["random", "overflow", "long_runs", "random"], "one": ["random"]}


@pytest.mark.parametrize("p", [0, 700])
@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_raster_batched_plain_is_single_calls(batch, p):
    rng = np.random.default_rng(len(batch) + p)
    kinds = BATCHES[batch]
    cell = torch.from_numpy(np.stack([_sorted_ids(rng, k, p) for k in kinds]).astype(np.int32))
    cols = [torch.from_numpy(rng.normal(size=cell.shape).astype(np.float32)) for _ in OPS]
    got = raster.raster_reduce(cell, cols, OPS, N2)
    assert all(g.shape == (len(kinds), N2) for g in got)
    for b in range(len(kinds)):
        want = raster.raster_reduce_plain(cell[b], [c[b] for c in cols], OPS, N2)
        for j, (g, w) in enumerate(zip(got, want)):
            assert _same(g[b], w), (b, j)
    if "overflow" in kinds:
        assert all(not g[kinds.index("overflow")].any() for g in got)


@pytest.mark.parametrize("n_tables", [1, 2])
@pytest.mark.parametrize("p", [0, 900])
@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_lookup_batched_plain_is_single_calls(batch, p, n_tables):
    rng = np.random.default_rng(p + n_tables)
    kinds = BATCHES[batch]
    cell = np.stack([rng.integers(-3, N2 + 4, p) if k == "random" else _sorted_ids(rng, k, p)
                     for k in kinds]).astype(np.int32)
    tables = [torch.from_numpy(rng.normal(size=(len(kinds), 24, 24)).astype(np.float32))
              for _ in range(n_tables)]
    got = lookup.lookup(torch.from_numpy(cell), tables, N2)
    for b in range(len(kinds)):
        want = lookup.lookup(torch.from_numpy(cell[b]), [t[b] for t in tables], N2)
        for g, w in zip(got, want):
            assert _same(g[b], w)
    with pytest.raises(ValueError):  # one table for the whole batch is not a batch's
        lookup.lookup(torch.from_numpy(cell), [tables[0][0]], N2)


@pytest.mark.parametrize("b", [1, 3])
def test_detect_batched_plain_is_single_calls(b):
    cfg = GroundGridConfig(dimension=16.65, resolution=0.37)
    n = cfg.cell_count
    tabs = make_tables(cfg, "cpu")
    layers = [np.stack(arrs) for arrs in zip(*(detect_layers(n, seed) for seed in range(b)))]
    layers[1][-1] *= np.float32(0.01)  # low variance: the main update fires
    if b > 1:
        layers[0][0] = 0.0  # an empty grid
    layers = [torch.from_numpy(a) for a in layers]
    got = detect.detect_fused(cfg, tabs, *layers)
    for v in range(b):
        want = detect.detect_fused(cfg, tabs, *(t[v] for t in layers))
        for g, w in zip(got, want):
            assert _same(g[v], w)
    assert not torch.equal(got[1][-1], layers[4][-1])
    with pytest.raises(ValueError):
        detect.detect_fused(cfg, tabs, layers[0][:, :-1], *layers[1:])


def _record(k, pts, lbl, T):
    return ScanRecord(index=k, timestamp=0.1 * k, points=pts, labels=lbl, t_map_velo=T)


def _vehicle_streams(n_scans=3):
    """Four vehicles: the half-cell snap tie, a multi-cell shift a scan,
    more points than ``max_points``, an empty scan."""
    rng = np.random.default_rng(4)
    streams = []
    # 0: half a cell a scan along x from x = 100, a plane of points
    pts = np.concatenate([rng.uniform(-8, 8, (512, 2)), rng.uniform(-1.6, -1.4, (512, 1)),
                          np.zeros((512, 1))], axis=1).astype(np.float32)
    recs = []
    for k in range(n_scans):
        T = np.eye(4)
        T[0, 3], T[2, 3] = 100.0 + k * TINY["resolution"] / 2.0, 1.7
        recs.append(_record(k, pts, np.full(512, 40, np.int32), T))
    streams.append(recs)
    # 1: a synthetic drive, 3.3 m (6+ cells) a scan
    streams.append([_record(k, np.concatenate([p, np.zeros((len(p), 1), np.float32)], 1), l, T)
                    for k, (p, l, T) in enumerate(
                        synthetic_sequence(n_scans, seed=21, n_beams=8, n_azimuth=128,
                                           step_m=3.3))])
    # 2: 40 x 128 rays, above max_points = 4096
    streams.append([_record(k, np.concatenate([p, np.zeros((len(p), 1), np.float32)], 1), l, T)
                    for k, (p, l, T) in enumerate(
                        synthetic_sequence(n_scans, seed=22, n_beams=40, n_azimuth=128))])
    # 3: a synthetic drive whose second scan is empty
    recs = [_record(k, np.concatenate([p, np.zeros((len(p), 1), np.float32)], 1), l, T)
            for k, (p, l, T) in enumerate(
                synthetic_sequence(n_scans, seed=23, n_beams=8, n_azimuth=128))]
    recs[1] = _record(1, np.zeros((0, 4), np.float32), np.zeros(0, np.int32),
                      recs[1].t_map_velo)
    streams.append(recs)
    assert streams[2][0].points.shape[0] > TINY["max_points"]
    return streams


def _scans(cfg, streams, k, trackers):
    """Tick ``k``'s scans, one a vehicle, with the f64 trackers' centers
    (cell-sorted against them for a sorted config)."""
    scans = []
    for v, recs in enumerate(streams):
        rec = recs[k]
        pos = np.asarray(rec.t_map_velo, np.float64)[:2, 3]
        center = trackers[v].update(pos)
        if cfg.sorted_scans:
            scans.append(prepare_scan(cfg, rec.points[:, :3], rec.labels, rec.t_map_velo,
                                      center, "cpu")[0])
            continue
        chi, clo = trackers[v].center_ds()
        scans.append(pad_scan(cfg, rec.points, rec.labels, rec.t_map_velo, "cpu")
                     ._replace(center=chi, center_lo=clo))
    return scans


def _run_batched(step, cfg, streams):
    """The vehicles as one batch through ``step``: per scan the stacked
    outputs and copies of the state."""
    trackers = [CenterTracker(cfg, np.asarray(r[0].t_map_velo, np.float64)[:2, 3])
                for r in streams]
    state = stack_fleet_pytree([init_state(cfg, r[0].t_map_velo, "cpu") for r in streams])
    results = []
    for k in range(len(streams[0])):
        scans = _scans(cfg, streams, k, trackers)
        host = [step.scalars(state.center[v].numpy(), state.center_lo[v].numpy(), scan)
                for v, scan in enumerate(scans)]
        scalars = torch.from_numpy(np.stack([h[0] for h in host]))
        state, out = step.run(state, stack_fleet_pytree(scans), scalars,
                              np.stack([h[1] for h in host]), np.stack([h[2] for h in host]))
        results.append((out, [t.clone() for t in (state.ground, state.groundpatch,
                                                   state.center, state.center_lo)]))
    return results


@pytest.fixture(scope="module")
def batched_run():
    cfg = GroundGridConfig(**TINY)
    assert not cfg.sorted_scans
    streams = _vehicle_streams()
    return cfg, streams, _run_batched(make_step_fn(cfg), cfg, streams)


def test_batched_body_is_single_steps(batched_run):
    """Every vehicle of the eager batched body bitwise its own single step
    over its stream: outputs, both layers and the center pair."""
    cfg, streams, results = batched_run
    for v, recs in enumerate(streams):
        step = make_step_fn(cfg)
        tracker = CenterTracker(cfg, np.asarray(recs[0].t_map_velo, np.float64)[:2, 3])
        state = init_state(cfg, recs[0].t_map_velo, "cpu")
        for k, rec in enumerate(recs):
            (scan,) = _scans(cfg, [[rec]], 0, [tracker])
            state, out = step(state, scan)
            got, layers = results[k]
            for name, a, b in zip(out._fields, got, out):
                assert _same(a[v], b), (v, k, name)
            for a, b in zip(layers, (state.ground, state.groundpatch, state.center,
                                     state.center_lo)):
                assert _same(a[v], b), (v, k)
    labels = [results[k][0].labels for k in range(3)]
    assert not labels[1][3].any()  # the empty scan: every padded point dropped
    assert (labels[0][2] != 0).sum() > 0 and (labels[2][1] == 99).sum() > 0


def test_captured_batched_step_is_eager_body(batched_run):
    """The captured step on a batch (one graph a tick on the card; on the
    CPU a replay runs the body) bitwise the eager batched body."""
    cfg, streams, eager = batched_run
    step = CapturedStep(cfg)
    got = _run_batched(step, cfg, streams)
    assert step._points[0].shape == (4, cfg.max_points)
    assert step._graph is not None and step._graph.graph is None  # no graph on the CPU
    for (out_a, layers_a), (out_b, layers_b) in zip(got, eager):
        assert all(_same(a, b) for a, b in zip(out_a, out_b))
        assert all(_same(a, b) for a, b in zip(layers_a, layers_b))
    assert len(step.marchable) == 4


def _run_fleet(cfg, streams, mesh):
    """The vehicles through one ``FleetStep`` on ``mesh``: per tick the
    outputs and copies of the state, concatenated over the blocks."""
    fleet = make_fleet_step(cfg, mesh)
    trackers = [CenterTracker(cfg, np.asarray(r[0].t_map_velo, np.float64)[:2, 3])
                for r in streams]
    states = shard_fleet_pytree(
        stack_fleet_pytree([init_state(cfg, r[0].t_map_velo, "cpu") for r in streams]),
        fleet.mesh)
    results = []
    for k in range(len(streams[0])):
        scans = shard_fleet_pytree(stack_fleet_pytree(_scans(cfg, streams, k, trackers)),
                                   fleet.mesh)
        states, outs, _ = fleet(states, scans)
        results.append(([torch.cat(field) for field in zip(*outs)],
                        [torch.cat([getattr(b, name) for b in states]).clone()
                         for name in ("ground", "groundpatch", "center", "center_lo")]))
    return fleet, results


def test_fleet_step_is_per_vehicle_scalars(batched_run):
    """A batched ``FleetStep`` tick on two blocks of two (each block's scan
    scalars one pass over its vehicles) bitwise the batched body fed the
    stacked per-vehicle ``scan_scalars`` calls: outputs, layers, centers."""
    cfg, streams, want = batched_run
    fleet, got = _run_fleet(cfg, streams, ["cpu"] * 2)
    assert fleet.batched
    for k, ((out_a, layers_a), (out_b, layers_b)) in enumerate(zip(got, want)):
        assert all(_same(a, b) for a, b in zip(out_a, out_b)), k
        assert all(_same(a, b) for a, b in zip(layers_a, layers_b)), k


def test_sorted_fleet_step_is_single_steps():
    """A sorted ``FleetStep`` (each block vehicle by vehicle, its scalars one
    pass) on two blocks of two: every vehicle bitwise its own single step
    over its stream."""
    cfg = GroundGridConfig(**TINY, sorted_scans=True)
    streams = _vehicle_streams()
    fleet, got = _run_fleet(cfg, streams, ["cpu"] * 2)
    assert not fleet.batched
    for v, recs in enumerate(streams):
        step = make_step_fn(cfg)
        tracker = CenterTracker(cfg, np.asarray(recs[0].t_map_velo, np.float64)[:2, 3])
        state = init_state(cfg, recs[0].t_map_velo, "cpu")
        for k, rec in enumerate(recs):
            (scan,) = _scans(cfg, [[rec]], 0, [tracker])
            state, out = step(state, scan)
            outs, layers = got[k]
            for name, a, b in zip(out._fields, outs, out):
                assert _same(a[v], b), (v, k, name)
            for a, b in zip(layers, (state.ground, state.groundpatch, state.center,
                                     state.center_lo)):
                assert _same(a[v], b), (v, k)
    assert (got[0][0][0] == 49).any()


def test_fleet_blocks_of_four_match_streaming():
    """The fleet driver with the four vehicles twice over, 4 a block on
    ``["cpu"] * 2``: each block one batched step, every vehicle bitwise its
    streaming driver, the block's layers its drivers' states."""
    cfg = GroundGridConfig(**TINY)
    streams = _vehicle_streams()
    streams = streams + streams[::-1]
    fleet = FleetDriver(cfg, batch=8, mesh=["cpu"] * 2)
    ticks = list(fleet.run(streams))
    assert fleet.step.batched and len(ticks) == 3
    for v, recs in enumerate(streams):
        driver = StreamingDriver(cfg, device="cpu")
        for k, rec in enumerate(recs):
            res = driver.process(rec)
            n = ticks[k].n_points[v]
            assert n == min(res.n_points, cfg.max_points)
            np.testing.assert_array_equal(ticks[k].labels[v][:n], res.labels[:n])
            np.testing.assert_array_equal(ticks[k].outlier[v][:n] > 0, res.outlier[:n])
            assert not res.labels[n:].any()  # beyond max_points: dropped
        block = fleet.states[v // 4]
        assert _same(block.ground[v % 4], driver.state.ground)
        assert _same(block.groundpatch[v % 4], driver.state.groundpatch)
        assert _same(block.center[v % 4], driver.state.center)
