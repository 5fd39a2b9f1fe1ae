"""The occlusion march as K6 and K7 split it: K6 (``march_budget``) also
writes each marchable ray's directions, and K7 (``march``) walks along them
and reads the occlusion keys from the moved ground and groundpatch.

On the CPU each wrapper takes its plain version (``core/outliers.py``):
held here bitwise to the composition they replace (the key table of
``occlusion_key_table``, then the table march that recomputed each ray),
on grids whose rays end on rows and columns 1, 2, 3 and n - 2, where the
table's low-side clamp acts (``tests/march_scenes.py``), and, through
``detect_outliers``, to the JAX package's eager ``detect_outliers`` at
2^17 and 2^17 + 1 points. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import march_scenes  # tests/ is on sys.path under pytest rootdir
from groundgrid_tpu.config import GroundGridConfig as JConfig
from groundgrid_tpu.core import outliers as joutliers
from groundgrid_tpu.core import rasterize as jraster

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import exactf32, outliers, scalars
from groundgrid_torch.core.rasterize import ds_cells, take_points
from groundgrid_torch.ops import binning, lookup, march, select

torch.set_num_threads(1)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _table_march(config, s, key_table, pidx, x, y, z, budget):
    """The march as it stood before K7 read the layers itself: each
    candidate's ray recomputed from its point, the keys read from the whole
    (N*N,) key table through K2's plain version, unchunked."""
    n = config.cell_count
    steps = torch.arange(3, config.ray_steps, dtype=torch.float32)[:, None]
    ox, oy, oz = (scalars.grid(v) for v in (s.ox, s.oy, s.oz))
    sh0, sl0, sh1, sl1 = (scalars.grid(v) for v in (s.sh0, s.sl0, s.sh1, s.sl1))
    dx, dy, dz, clen = outliers._ray(take_points(x, pidx), take_points(y, pidx),
                                     take_points(z, pidx), s)
    vx, vy, vz = (exactf32.div_rn(d, clen)[..., None, :] for d in (dx, dy, dz))
    within = steps * steps < take_points(budget, pidx)[..., None, :]
    i0, i1 = ds_cells(config, sh0, sl0, sh1, sl1, ox + steps * vx, oy + steps * vy)
    inside = (i0 > 0) & (i1 > 0) & (i0 < n - 1) & (i1 < n - 1)
    flat = torch.clamp(i0, 0, n - 1) * n + torch.clamp(i1, 0, n - 1)
    thr = outliers._mono_u32((steps * vz + oz) + float(np.float32(config.outlier_tolerance)))
    (vals,) = lookup.lookup_plain(flat.reshape(*budget.shape[:-1], -1), [key_table], n * n)
    hit = within & inside & (outliers._u32_bits(vals).reshape(flat.shape) >= thr)
    out = torch.zeros(budget.shape, dtype=torch.int32)
    return out.scatter_reduce_(-1, pidx, hit.any(dim=-2).to(torch.int32), reduce="amax")


def _scenes(cfg, seeds):
    """The edge scenes of ``seeds`` as torch inputs: scan scalars, binning,
    points and layers, one vehicle (a single seed) or stacked (B, ...)."""
    got = [march_scenes.edge_scene(cfg, seed) for seed in seeds]
    stack = (lambda a: torch.from_numpy(a[0])) if len(seeds) == 1 else (
        lambda a: torch.from_numpy(np.stack(a)))
    sc = march_scenes.Scene(*(stack(field) for field in zip(*got)))
    s = scalars.view(sc.packed)
    b = binning.bin_points(cfg, s, sc.x, sc.y, sc.rings, sc.valid)
    return s, b, sc


def _march_inputs(cfg, s, b, sc):
    (old_h,) = lookup.lookup(b.cell, [sc.ground], cfg.cell_count ** 2)
    budget, key, dirs, flags = march.march_budget(cfg, s, b, sc.x, sc.y, sc.z, sc.ground)
    assert flags.dtype == torch.bool and flags.shape == budget.shape and not bool(flags.any())
    k = min(cfg.max_outlier_candidates, sc.x.shape[-1])
    return old_h, budget, key, dirs, torch.topk(key, k, dim=-1, sorted=False).indices


def _march(cfg, s, sc, pidx, budget, dirs):
    """The plain march of ``pidx`` into fresh zeroed flags (K6's)."""
    return march.march(cfg, s, sc.ground, sc.conf, pidx, budget, dirs, (budget > 0).sum(-1),
                       torch.zeros(budget.shape, dtype=torch.bool))


CASES = {"edge-0": ((0,), {}), "edge-1": ((1,), {}), "batch-of-3": ((2, 3, 4), {}),
         # the cap below the marchable count: every candidate marches
         "all-marchable": ((5,), {"max_outlier_candidates": 1000})}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_march_is_the_table_composition(case):
    """The plain march of (ground, groundpatch) along K6's directions is
    bitwise the table march it replaces (``occlusion_key_table``, then the
    lattice of recomputed rays), on rays ending at the clamped border."""
    seeds, kw = CASES[case]
    cfg = GroundGridConfig(**{**march_scenes.EDGE, **kw})
    s, b, sc = _scenes(cfg, seeds)
    _, budget, _, dirs, pidx = _march_inputs(cfg, s, b, sc)
    got = _march(cfg, s, sc, pidx, budget, dirs)
    table = outliers.occlusion_key_table(cfg, sc.ground, sc.conf)
    want = _table_march(cfg, s, table, pidx, sc.x, sc.y, sc.z, budget)
    assert got.dtype == torch.bool and torch.equal(got, want > 0)
    assert int(want.sum()) > 0
    if case == "all-marchable":
        assert bool((take_points(budget, pidx) > 0).all())
        assert int((budget > 0).sum()) > cfg.max_outlier_candidates


def _key_table_without(kind):
    """``occlusion_key_table`` with one of its decisions changed: no
    low-side clamp, the block test ``>=``, or the cell test ``>=``."""

    def table(config, ground, groundpatch):
        box = outliers.box3_sum(groundpatch)
        if kind != "clamp":
            box = torch.cat([box[..., 3:4, :].expand(3, -1), box[..., 3:, :]], dim=-2)
            box = torch.cat([box[..., :, 3:4].expand(-1, 3), box[..., :, 3:]], dim=-1)
        min_conf = float(np.float32(config.min_outlier_detection_ground_confidence))
        cell = float(np.float32(0.01))
        ok = ((box >= min_conf) if kind == "block" else (box > min_conf)) & (
            (groundpatch >= cell) if kind == "cell" else (groundpatch > cell))
        key = torch.where(ok, outliers._mono_u32(ground), torch.zeros((), dtype=torch.int64))
        key = torch.where(key > 0x7FFFFFFF, key - (1 << 32), key)
        return key.to(torch.int32).view(torch.float32).flatten(-2)

    return table


@pytest.mark.parametrize("kind", ["clamp", "block", "cell"])
def test_edge_scene_turns_on_every_key_decision(monkeypatch, kind):
    """The edge scene's outliers change when the key table drops its
    low-side clamp, or takes a block sum equal to ``min_conf`` or a cell
    confidence equal to 0.01 as confident: the scenes that hold K7 to its
    plain version (here and on the card) see each decision of the fold,
    and their rays sample rows and columns 1, 2, 3 and n - 2."""
    cfg = GroundGridConfig(**march_scenes.EDGE)
    n = cfg.cell_count
    s, b, sc = _scenes(cfg, (0,))
    _, budget, _, dirs, pidx = _march_inputs(cfg, s, b, sc)
    want = _march(cfg, s, sc, pidx, budget, dirs)
    monkeypatch.setattr(outliers, "occlusion_key_table", _key_table_without(kind))
    changed = _march(cfg, s, sc, pidx, budget, dirs)
    assert int((changed != want).sum()) > 0
    # the live samples inside the grid reach each clamped row and column
    steps = torch.arange(3, cfg.ray_steps, dtype=torch.float32)[:, None]
    vx, vy = (take_points(d, pidx)[None, :] for d in dirs[:2])
    i0, i1 = ds_cells(cfg, s.sh0, s.sl0, s.sh1, s.sl1, s.ox + steps * vx, s.oy + steps * vy)
    live = (steps * steps < take_points(budget, pidx)[None, :]) & (i0 > 0) & (i1 > 0) & (
        i0 < n - 1) & (i1 < n - 1)
    for row in (1, 2, 3, n - 2):
        assert bool((live & (i0 == row)).any()) and bool((live & (i1 == row)).any()), row
    box = outliers.box3_sum(sc.conf)
    assert bool((box == np.float32(cfg.min_outlier_detection_ground_confidence)).any())
    assert bool((sc.conf == np.float32(0.01)).any())


@pytest.mark.parametrize("case", list(CASES))
def test_budget_directions_are_div_rn_of_the_ray(case):
    """K6's plain directions: bitwise ``div_rn(d, length)`` of ``_ray``
    where the budget is positive, +0.0 elsewhere; the budget and the key
    as before (the squared length of a downward candidate, else 0)."""
    seeds, kw = CASES[case]
    cfg = GroundGridConfig(**{**march_scenes.EDGE, **kw})
    s, b, sc = _scenes(cfg, seeds)
    old_h, budget, key, dirs, _ = _march_inputs(cfg, s, b, sc)
    dx, dy, dz, length = outliers._ray(sc.x, sc.y, sc.z, s)
    v = [exactf32.div_rn(d, length) for d in (dx, dy, dz)]
    cand = b.inmap & ~b.ignored & (sc.z < old_h - float(np.float32(0.2)))
    want_budget = torch.where(cand & (v[2] < float(np.float32(-0.01))), length * length,
                              torch.zeros_like(length))
    assert torch.equal(_bits(budget), _bits(want_budget))
    assert torch.equal(key, outliers.selection_key(want_budget))
    pos = budget > 0
    assert dirs.shape == (3, *budget.shape) and int(pos.sum()) > 0
    for got, want in zip(dirs, v):
        assert torch.equal(_bits(got[pos]), _bits(want[pos]))
        assert torch.equal(_bits(got[~pos]), torch.zeros(int((~pos).sum()), dtype=torch.int32))


@pytest.mark.parametrize("p_total", [1 << 17, (1 << 17) + 1])
def test_detect_outliers_on_edges_bitwise_jax(p_total):
    """``detect_outliers`` (K6's and K7's plain versions around K11's)
    bitwise the JAX package's eager ``detect_outliers`` on
    the edge scene spread over ``p_total`` slots (both selection keys), the
    cap below the marchable count."""
    kw = dict(march_scenes.EDGE, max_points=p_total, max_outlier_candidates=1500)
    cfg, jcfg = GroundGridConfig(**kw), JConfig(**kw)
    sc = march_scenes.edge_scene(GroundGridConfig(**march_scenes.EDGE), 6)
    slots = np.random.default_rng(p_total).permutation(p_total)[:sc.x.shape[0]]

    def spread(a):
        out = np.zeros(p_total, a.dtype)
        out[slots] = a
        return out

    x, y, z, rings, valid = (spread(a) for a in (sc.x, sc.y, sc.z, sc.rings, sc.valid))
    t = [torch.from_numpy(a) for a in (x, y, z)]
    s = scalars.view(torch.from_numpy(sc.packed))
    b = binning.bin_points(cfg, s, t[0], t[1], torch.from_numpy(rings), torch.from_numpy(valid))
    g, c = torch.from_numpy(sc.ground), torch.from_numpy(sc.conf)
    got, marchable = outliers.detect_outliers(cfg, s, g, c, b, *t, march.march_budget,
                                              select.select_candidates, march.march)
    zero = jnp.zeros(2, jnp.float32)
    with jax.disable_jit():
        jb = jraster.bin_points(jcfg, zero, *(jnp.asarray(a) for a in (x, y, z, rings, valid)),
                                jnp.asarray(sc.origin), center_lo=zero)
        want = np.asarray(joutliers.detect_outliers(
            jcfg, zero, jnp.asarray(sc.ground), jnp.asarray(sc.conf), jb, jnp.asarray(x),
            jnp.asarray(y), jnp.asarray(z), jnp.asarray(sc.origin), center_lo=zero))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(marchable) > cfg.max_outlier_candidates and 0 < int(want.sum())
