"""The binning and the occlusion march of the port, as K5, K6 and K7 split
them (``ops/binning.py``, ``ops/march.py``), against the JAX package on the
CPU.

On the CPU each wrapper takes its plain version: ``core/rasterize.py
bin_points`` for K5, ``core/outliers.py march_budget`` and ``march`` for K6
and K7, the last two joined by K11's plain selection (``ops/select.py``) in
``detect_outliers``. They
are held bitwise to the JAX package's eager ``bin_points`` and
``detect_outliers`` (eager: fused, XLA:CPU contracts the lattice's products
and adds into FMAs), on inputs made with numpy from a seed: coordinates on
a cell edge and one ulp either side of it, -0.0 coordinates, more marchable
points than ``max_outlier_candidates`` with the cut inside a group of equal
budgets on both sides of the 2^17-point key boundary, and a batch of three
vehicles, each row bitwise its single call. The kernels themselves run only
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groundgrid_tpu.config import GroundGridConfig as JConfig
from groundgrid_tpu.core import outliers as joutliers
from groundgrid_tpu.core import rasterize as jraster

from groundgrid_torch import pipeline as tpipe
from groundgrid_torch.config import GroundGridConfig as TConfig
from groundgrid_torch.core import outliers as toutliers
from groundgrid_torch.core import scalars as tscalars
from groundgrid_torch.core import transforms as ttf
from groundgrid_torch.core.rasterize import Binning
from groundgrid_torch.ops import _build, binning, march, select

torch.set_num_threads(1)

SMALL = dict(dimension=24.0, resolution=0.5, max_points=4096, ray_steps=28,
             max_outlier_candidates=300, max_ring=40)
ORIGIN = np.float32([0.4, -0.3, 1.7])


def _centers(seed):
    """The grid center as an f32 (hi, lo) pair: zero, and one whose tail
    is not (an f64 center the f32 hi does not hold)."""
    if seed == 0:
        return np.zeros(2, np.float32), np.zeros(2, np.float32)
    c64 = np.float64([1234.5678912345, -876.54321098765])
    hi = c64.astype(np.float32)
    return hi, (c64 - hi.astype(np.float64)).astype(np.float32)


def _edges(cfg, hi, lo, k, axis):
    """f32 coordinates at cell edge ``k`` of ``axis`` (the f32 nearest
    ``center + half - k * res``), and one ulp below and above. An edge at
    0.0 keeps 0.0 for its neighbours: one ulp off it is subnormal, which
    XLA:CPU flushes to zero (the JAX package bins it as 0.0) and the port
    keeps (:func:`test_subnormal_coordinates_bin_exactly`)."""
    edge = (np.float64(hi[axis]) + np.float64(lo[axis]) + cfg.half_length
            - k * np.float64(cfg.resolution)).astype(np.float32)
    below = np.nextafter(edge, np.float32(-np.inf))
    above = np.nextafter(edge, np.float32(np.inf))
    zero = edge == 0
    return edge, np.where(zero, edge, below), np.where(zero, edge, above)


def _points(rng, cfg, hi, lo, p):
    """(x, y, z, rings, valid) of ``p`` points: uniform over the grid and
    beyond it, on cell edges and one ulp off (each axis), at -0.0, rings
    above and below ``max_ring``, some padding."""
    n = cfg.cell_count
    span = np.float32(cfg.half_length) * np.float32(1.15)
    x = (hi[0] + rng.uniform(-span, span, p)).astype(np.float32)
    y = (hi[1] + rng.uniform(-span, span, p)).astype(np.float32)
    k = rng.integers(-1, n + 2, p)
    for axis, coords in ((0, x), (1, y)):
        edges = np.stack(_edges(cfg, hi, lo, k, axis))
        pick = rng.random(p) < 0.4
        coords[pick] = edges[rng.integers(0, 3, p), np.arange(p)][pick]
    x[:5], y[3:8] = -0.0, -0.0
    z = rng.uniform(-3.0, 1.5, p).astype(np.float32)
    rings = rng.integers(0, 64, p).astype(np.int32)
    valid = rng.random(p) < 0.97
    return x, y, z, rings, valid


def _jax_binning(jcfg, hi, lo, x, y, z, rings, valid):
    with jax.disable_jit():
        return jraster.bin_points(jcfg, jnp.asarray(hi), jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(z), jnp.asarray(rings), jnp.asarray(valid),
                                  jnp.asarray(ORIGIN), center_lo=jnp.asarray(lo))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("center", [0, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_bin_points_bitwise_jax(center, seed):
    """K5's plain path: every output bitwise the JAX package's eager
    ``bin_points`` (``faithful_cells``), on edges, +-1 ulp and -0.0."""
    tcfg, jcfg = TConfig(**SMALL), JConfig(**SMALL)
    hi, lo = _centers(center)
    x, y, z, rings, valid = _points(np.random.default_rng(seed), tcfg, hi, lo, tcfg.max_points)
    s = tscalars.host(tcfg, hi, lo, ttf.translation(*ORIGIN, np.float32))
    got = binning.bin_points(tcfg, s, *(torch.from_numpy(a) for a in (x, y, rings, valid)))
    want = _jax_binning(jcfg, hi, lo, x, y, z, rings, valid)
    for field in Binning._fields:
        np.testing.assert_array_equal(_bits(getattr(got, field).numpy()),
                                      _bits(getattr(want, field)), err_msg=field)
    # the edges split: both sides of an edge, in the map and off it, ignored points
    assert 0 < int(got.inmap.sum()) < tcfg.max_points
    assert int(got.ignored.sum()) > 0
    assert len(np.unique(got.gi0.numpy())) >= tcfg.cell_count


def test_bin_points_edges_fall_on_both_sides():
    """A coordinate one ulp either side of a cell edge lands in the two
    cells the f64 floor gives: the ds arithmetic resolves the edge."""
    cfg = TConfig(**SMALL)
    hi, lo = _centers(1)
    k = np.arange(2, cfg.cell_count - 2)
    edge, below, above = _edges(cfg, hi, lo, k, 0)
    x = np.concatenate([below, above])
    y = np.full_like(x, hi[1])
    s = tscalars.host(cfg, hi, lo, ttf.translation(*ORIGIN, np.float32))
    got = binning.bin_points(cfg, s, torch.from_numpy(x), torch.from_numpy(y),
                             torch.zeros(x.shape, dtype=torch.int32),
                             torch.ones(x.shape, dtype=torch.bool))
    want = np.floor((np.float64(hi[0]) + np.float64(lo[0]) + cfg.half_length
                     - x.astype(np.float64)) / cfg.resolution).astype(np.int32)
    np.testing.assert_array_equal(got.gi0.numpy(), want)
    assert (want[:len(k)] != want[len(k):]).all()


def test_subnormal_coordinates_bin_exactly():
    """One ulp either side of the 0.0 edge (subnormal coordinates), the
    port's binning (plain here, K5 on the card) takes the exact floor of
    ``(center + half - x) / res``, where f64 rounds ``half - x`` to
    ``half``; -0.0 and +0.0 bin alike."""
    cfg = TConfig(**SMALL)
    tiny = np.float32(1.401298464324817e-45)
    x = np.float32([tiny, -tiny, 0.0, -0.0])
    s = tscalars.host(cfg, *_centers(0), ttf.translation(*ORIGIN, np.float32))
    got = binning.bin_points(cfg, s, torch.from_numpy(x), torch.from_numpy(x),
                             torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool))
    m = cfg.cell_count // 2  # the cell whose low edge is x = 0.0 (center 0)
    assert got.gi0.tolist() == [m - 1, m, m, m] and got.gi1.tolist() == [m - 1, m, m, m]


N_LONG, N_TIED, N_SHORT, N_EDGE = 200, 200, 150, 120
K_CUT = 300  # the cap: the long rays, then the cut inside the tied group


def _march_scene(p_total, seed=0):
    """(x, y, z, valid): 200 long rays, 200 identical rays (equal budgets:
    the cap cuts among them), 150 short ones, 120 points on cell edges
    and +-1 ulp off (and two at -0.0), below a random terrain at -1.0;
    2500 points above it; the rest padding, shuffled over [0, p_total)."""
    rng = np.random.default_rng(seed)
    cfg = TConfig(**SMALL)
    hi, lo = _centers(0)

    def ring(k, r0, r1, z):
        ang, r = rng.uniform(0, 2 * np.pi, k), rng.uniform(r0, r1, k)
        return np.stack([r * np.cos(ang), r * np.sin(ang), np.full(k, z)], 1)

    kk = rng.integers(3, cfg.cell_count - 3, N_EDGE)
    edges = np.stack(_edges(cfg, hi, lo, kk, 0))[rng.integers(0, 3, N_EDGE), np.arange(N_EDGE)]
    edge_pts = np.stack([edges, rng.uniform(-6.0, 6.0, N_EDGE), np.full(N_EDGE, -2.6)], 1)
    edge_pts[:2, 1] = -0.0
    pts = np.concatenate([
        ring(N_LONG, 8.0, 11.0, -2.4),
        np.tile([[7.0, 2.0, -2.5]], (N_TIED, 1)),
        ring(N_SHORT, 4.0, 5.0, -1.6),
        edge_pts,
        ring(2500, 3.5, 11.5, 0.5),
    ]).astype(np.float32)
    slots = rng.permutation(p_total)[:pts.shape[0]]
    xyz = np.zeros((3, p_total), np.float32)
    xyz[:, slots] = pts.T
    valid = np.zeros(p_total, bool)
    valid[slots] = True
    return xyz, valid


def _terrain(n, seed):
    rng = np.random.default_rng(100 + seed)
    ground = rng.normal(-1.0, 0.05, (n, n)).astype(np.float32)
    conf = np.where(rng.random((n, n)) < 0.85, rng.uniform(0.2, 1.0, (n, n)),
                    0.0).astype(np.float32)
    return ground, conf


def _torch_outliers(cfg, x, y, z, valid, ground, conf, center=0):
    hi, lo = _centers(center)
    s = tscalars.host(cfg, hi, lo, ttf.translation(*ORIGIN, np.float32))
    t = [torch.from_numpy(a) for a in (x, y, z)]
    b = binning.bin_points(cfg, s, t[0], t[1], torch.zeros(x.shape, dtype=torch.int32),
                           torch.from_numpy(valid))
    g, c = torch.from_numpy(ground), torch.from_numpy(conf)
    return toutliers.detect_outliers(cfg, s, g, c, b, *t, march.march_budget,
                                     select.select_candidates, march.march)


@pytest.mark.parametrize("p_total", [1 << 17, (1 << 17) + 1])
def test_detect_outliers_bitwise_jax_at_the_cap(p_total):
    """The split march (K6's and K7's plain versions around K11's)
    bitwise the JAX package's eager ``detect_outliers`` on both selection
    keys (2^17 points: the truncated key, equal budgets to the higher
    index; one more: the exact budget, to the lower), the cap inside the
    tied group, cell-edge and -0.0 points marching; random terrain."""
    kw = dict(SMALL, max_points=p_total, max_outlier_candidates=K_CUT)
    tcfg, jcfg = TConfig(**kw), JConfig(**kw)
    n = tcfg.cell_count
    (x, y, z), valid = _march_scene(p_total)
    ground, conf = _terrain(n, 0)
    got, marchable = _torch_outliers(tcfg, x, y, z, valid, ground, conf)
    hi, lo = _centers(0)
    rings = np.zeros(p_total, np.int32)
    jb = _jax_binning(jcfg, hi, lo, x, y, z, rings, valid)
    with jax.disable_jit():
        want = np.asarray(joutliers.detect_outliers(
            jcfg, jnp.asarray(hi), jnp.asarray(ground), jnp.asarray(conf), jb, jnp.asarray(x),
            jnp.asarray(y), jnp.asarray(z), jnp.asarray(ORIGIN), center_lo=jnp.asarray(lo)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(marchable) > K_CUT and 0 < int(want.sum()) <= K_CUT


@pytest.mark.parametrize("p_total", [1 << 17, (1 << 17) + 1])
def test_march_stage_flags_and_count_match_jax(p_total):
    """The march stage as the step runs it on the seam scene, the cap inside
    the tied group: K6's plain version returns the outlier flags as bool
    zeros beside the budgets, K7's plain version sets them in place and
    returns that tensor, as bool; the flags are the JAX package's eager
    outliers bitwise and the marchable count (int64) the count of
    positive budgets, more than the cap."""
    kw = dict(SMALL, max_points=p_total, max_outlier_candidates=K_CUT)
    tcfg, jcfg = TConfig(**kw), JConfig(**kw)
    (x, y, z), valid = _march_scene(p_total)
    ground, conf = _terrain(tcfg.cell_count, 0)
    hi, lo = _centers(0)
    s = tscalars.host(tcfg, hi, lo, ttf.translation(*ORIGIN, np.float32))
    t = [torch.from_numpy(a) for a in (x, y, z)]
    b = binning.bin_points(tcfg, s, t[0], t[1], torch.zeros(p_total, dtype=torch.int32),
                           torch.from_numpy(valid))
    g, c = torch.from_numpy(ground), torch.from_numpy(conf)
    budget, key, dirs, flags = march.march_budget(tcfg, s, b, *t, g)
    assert flags.dtype == torch.bool and flags.shape == (p_total,) and not bool(flags.any())
    pidx, n_marchable = select.select_candidates(budget, key, K_CUT)
    assert n_marchable.dtype == torch.int64
    assert int(n_marchable) == int((budget > 0).sum()) > K_CUT
    got = march.march(tcfg, s, g, c, pidx, budget, dirs, n_marchable, flags)
    assert got is flags and got.dtype == torch.bool
    jb = _jax_binning(jcfg, hi, lo, x, y, z, np.zeros(p_total, np.int32), valid)
    with jax.disable_jit():
        want = np.asarray(joutliers.detect_outliers(
            jcfg, jnp.asarray(hi), jnp.asarray(ground), jnp.asarray(conf), jb, jnp.asarray(x),
            jnp.asarray(y), jnp.asarray(z), jnp.asarray(ORIGIN), center_lo=jnp.asarray(lo)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p_total", [1 << 17, (1 << 17) + 1])
def test_budget_keys_at_the_boundary(p_total):
    """K6's plain keys: unique, the positive budgets above every zero one,
    and the tied group ordered the JAX package's way on each side of 2^17
    points (the truncated key: higher index first; the exact one: lower)."""
    cfg = TConfig(**dict(SMALL, max_points=p_total))
    (x, y, z), valid = _march_scene(p_total)
    ground, _ = _terrain(cfg.cell_count, 0)
    s = tscalars.host(cfg, *_centers(0), ttf.translation(*ORIGIN, np.float32))
    t = [torch.from_numpy(a) for a in (x, y, z)]
    b = binning.bin_points(cfg, s, t[0], t[1], torch.zeros(p_total, dtype=torch.int32),
                           torch.from_numpy(valid))
    budget, key, _, flags = march.march_budget(cfg, s, b, *t, torch.from_numpy(ground))
    assert torch.equal(key, toutliers.selection_key(budget))
    assert flags.dtype == torch.bool and flags.shape == budget.shape and not bool(flags.any())
    assert torch.unique(key).numel() == p_total
    order = torch.argsort(key, descending=True)
    positive = int((budget > 0).sum())
    assert bool((budget[order[:positive]] > 0).all())
    tied = torch.nonzero(budget == budget[order[positive // 2]]).flatten()
    ranked = [int(i) for i in order if int(i) in set(tied.tolist())]
    expect = sorted(ranked, reverse=p_total <= 1 << toutliers.IDX_BITS)
    assert len(tied) > 1 and ranked == expect


def _near_center(v):
    """Vehicle ``v``'s grid center, an f32 (hi, lo) pair near the origin
    (the scene's), with a tail the f32 hi does not hold."""
    c64 = np.float64([0.25 * v + 1e-9 * v, -0.5 * v - 3e-9 * v])
    hi = c64.astype(np.float32)
    return hi, (c64 - hi.astype(np.float64)).astype(np.float32)


def test_batch_of_three_is_three_single_calls():
    """A batch of three odd vehicles ((3, P) points, (3, SIZE) scan
    scalars, (3, N, N) layers): each row of K5, K6 and K7's plain versions
    and of ``detect_outliers`` bitwise its vehicle's single call, and each
    single call bitwise the JAX package."""
    cfg, jcfg = TConfig(**SMALL), JConfig(**SMALL)
    n, p = cfg.cell_count, cfg.max_points
    rng = np.random.default_rng(3)
    scenes = []
    for v in range(3):
        (x, y, z), valid = _march_scene(p, seed=v)
        x = (x + np.float32(0.37 * v)).astype(np.float32)
        scenes.append((x, y, z, rng.integers(0, 64, p).astype(np.int32), valid))
    cols = [np.stack(c) for c in zip(*scenes)]
    packed = np.stack([tscalars.pack(cfg, *_near_center(v), (0, 0),
                                     ttf.translation(*(ORIGIN + np.float32(0.1 * v)),
                                                     np.float32), np.eye(4), np.eye(4))
                       for v in range(3)])
    terrain = [_terrain(n, v) for v in range(3)]
    ground = torch.from_numpy(np.stack([g for g, _ in terrain]))
    conf = torch.from_numpy(np.stack([c for _, c in terrain]))
    x, y, z, rings, valid = (torch.from_numpy(c) for c in cols)
    sb = tscalars.view(torch.from_numpy(packed))
    bb = binning.bin_points(cfg, sb, x, y, rings, valid)
    got, marchable = toutliers.detect_outliers(cfg, sb, ground, conf, bb, x, y, z,
                                               march.march_budget, select.select_candidates,
                                               march.march)
    budget, key, dirs, flags = march.march_budget(cfg, sb, bb, x, y, z, ground)
    assert flags.dtype == torch.bool and not bool(flags.any())
    for v in range(3):
        s = tscalars.view(torch.from_numpy(packed[v]))
        b1 = binning.bin_points(cfg, s, x[v], y[v], rings[v], valid[v])
        for field, a, w in zip(Binning._fields, bb, b1):
            assert torch.equal(_t_bits(a[v]), _t_bits(w)), (v, field)
        budget1, key1, dirs1, _ = march.march_budget(cfg, s, b1, x[v], y[v], z[v], ground[v])
        assert torch.equal(_t_bits(budget[v]), _t_bits(budget1)) and torch.equal(key[v], key1)
        assert torch.equal(_t_bits(dirs[:, v]), _t_bits(dirs1))
        out1, m1 = toutliers.detect_outliers(cfg, s, ground[v], conf[v], b1, x[v], y[v], z[v],
                                             march.march_budget, select.select_candidates,
                                             march.march)
        assert torch.equal(got[v], out1)
        assert int(marchable[v]) == int(m1) > cfg.max_outlier_candidates
        hi, lo = _near_center(v)
        origin = ORIGIN + np.float32(0.1 * v)
        with jax.disable_jit():
            want = jraster.bin_points(jcfg, jnp.asarray(hi), jnp.asarray(cols[0][v]),
                                      jnp.asarray(cols[1][v]), jnp.asarray(cols[2][v]),
                                      jnp.asarray(cols[3][v]), jnp.asarray(cols[4][v]),
                                      jnp.asarray(origin), center_lo=jnp.asarray(lo))
            want_out = joutliers.detect_outliers(
                jcfg, jnp.asarray(hi), jnp.asarray(terrain[v][0]), jnp.asarray(terrain[v][1]),
                want, *(jnp.asarray(c[v]) for c in cols[:3]), jnp.asarray(origin),
                center_lo=jnp.asarray(lo))
        np.testing.assert_array_equal(b1.cell.numpy(), np.asarray(want.cell))
        np.testing.assert_array_equal(out1.numpy(), np.asarray(want_out))
    assert int(got.sum()) > 0


def _t_bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def test_device_rows_of_packed_scalars():
    """The kernels' view of the scan scalars: the first row's address and
    the row stride, for one row and for a batch; anything but packed rows
    of the points' batch raises."""
    cfg = TConfig(**SMALL)
    packed = tscalars.pack(cfg, *_centers(1), (2, -1), ttf.translation(*ORIGIN, np.float32),
                           np.eye(4), np.eye(4))
    one = torch.from_numpy(packed)
    batch = torch.from_numpy(np.stack([packed] * 3))
    pts = torch.zeros(16)
    assert tscalars.device_rows(tscalars.view(one), pts) == (one.data_ptr(), 0)
    assert tscalars.device_rows(tscalars.view(batch), torch.zeros(3, 16)) == (
        batch.data_ptr(), tscalars.SIZE)
    with pytest.raises(ValueError):  # one row against a batch of points
        tscalars.device_rows(tscalars.view(one), torch.zeros(3, 16))
    with pytest.raises(ValueError):  # host floats, not packed views
        tscalars.device_rows(tscalars.ScanScalars(*([0.0] * 19)), pts)
    loose = tscalars.view(one)._replace(oz=torch.tensor(1.7))
    with pytest.raises(ValueError):
        tscalars.device_rows(loose, pts)


def test_build_hash_covers_the_headers(tmp_path, monkeypatch):
    """The kernels' library is named by a hash of the sources and of the
    headers they include: an edited header builds a new library."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._digest(_build._sources())
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._digest(_build._sources()) != first
    assert {p.name for p in _build._sources()} == {"a.cu"}


def test_step_stages_are_profiler_ranges():
    """Under ``torch.profiler`` every stage of the eager step is one range
    a step, holding its ops, and so is each part of the raster stage (the
    sort, the check, K9, K1, K10: a sorted config with the check runs all
    five), beside the driver's own spans (its dispatch, prep, fetch and
    fetch wait); outside one, the body dispatches no range."""
    from groundgrid_torch.data.synthetic import synthetic_sequence
    from groundgrid_torch.runtime.driver import ScanRecord, StreamingDriver
    from groundgrid_torch.runtime.kernel_timing import stage_us

    cfg = TConfig(dimension=24.0, resolution=0.5, max_points=4096, ray_steps=28,
                  max_outlier_candidates=256, sorted_scans=True)
    recs = [ScanRecord(k, 0.1 * k, p, l, T) for k, (p, l, T) in
            enumerate(synthetic_sequence(3, seed=5, n_beams=12, n_azimuth=256))]
    driver = StreamingDriver(cfg, "cpu")
    driver.step = tpipe.make_step_fn(cfg)
    driver.process(recs[0])
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        for rec in recs[1:]:
            driver.process(rec)
    ranges = [e for e in prof.events() if e.is_user_annotation]
    ran = [s for s in tpipe.STAGES if s != "aux"] + list(tpipe.RASTER_PARTS)
    runtime = ["runtime.dispatch", "runtime.prep", "runtime.fetch", "runtime.fetch.wait"]
    assert sorted(e.name for e in ranges) == sorted((ran + runtime) * 2)
    for e in ranges:
        if e.name not in ("transform",):  # sorted scans: nothing to transform
            assert e.cpu_children, e.name
    assert set(stage_us(prof, tpipe.STAGES)) == set(tpipe.STAGES)  # no device: zeros
    assert set(stage_us(prof, tpipe.RASTER_PARTS)) == set(tpipe.RASTER_PARTS)
    assert not torch.autograd._profiler_enabled()
