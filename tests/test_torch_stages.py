"""The port's pipeline stages against the JAX package's, on the same inputs.

A warm state comes from the JAX sorted-scan driver over the first two
``small_scans``; both packages then run one stage on the third scan from the
same arrays. Outlier flags and labels are bitwise; rasterized layers hold
the JAX kernel test's bounds; detection holds ground to 1e-4 and confidence
to 1e-5 (XLA rewrites the stage's divisions by constants into reciprocal
products, an ulp off the reference's division, which the port keeps).
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groundgrid_tpu.config import GroundGridConfig as JConfig
from groundgrid_tpu.core import classify as jclassify
from groundgrid_tpu.core import detect as jdetect
from groundgrid_tpu.core import grid as jgrid
from groundgrid_tpu.core import outliers as joutliers
from groundgrid_tpu.core import rasterize as jraster
from groundgrid_tpu.data.semantickitti import ScanRecord
from groundgrid_tpu.ops.pallas_raster import raster_sums
from groundgrid_tpu.runtime.driver import StreamingDriver as JDriver

from groundgrid_torch.config import GroundGridConfig as TConfig
from groundgrid_torch.core import classify as tclassify
from groundgrid_torch.core import detect as tdetect
from groundgrid_torch.core import outliers as toutliers
from groundgrid_torch.core import rasterize as traster
from groundgrid_torch.ops import lookup, raster

# the test workers share the CPU: torch's intra-op thread pools would
# oversubscribe it and stall on the many small ops of the plain versions
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def warm(small_config, small_scans):
    """Inputs of one warm step (scan 2), as NumPy arrays for both packages."""
    kw = {f: getattr(small_config, f) for f in small_config.__dataclass_fields__}
    kw["sorted_scans"] = True
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    driver = JDriver(jcfg)
    for i, (pts, labels, T) in enumerate(small_scans[:2]):
        driver.process(ScanRecord(index=i, timestamp=float(i), points=pts, labels=labels,
                                  t_map_velo=T))
    pts, labels, T = small_scans[2]
    scan = driver.make_scan(ScanRecord(index=2, timestamp=2.0, points=pts, labels=labels,
                                       t_map_velo=T))
    moved = jgrid.move(jcfg, driver.state, None, scan.t_base_map, new_center=scan.center,
                       new_center_lo=scan.center_lo)
    d = {k: np.asarray(v) for k, v in scan._asdict().items()}
    d.update(ground=np.asarray(moved.ground), groundpatch=np.asarray(moved.groundpatch))
    d["origin"] = d["t_map_velo"][:3, 3]
    return jcfg, tcfg, d


def _binnings(jcfg, tcfg, d, z_shift=None):
    z = d["pz"] if z_shift is None else d["pz"] + z_shift
    jb = jraster.bin_points(jcfg, jnp.asarray(d["center"]), jnp.asarray(d["px"]),
                            jnp.asarray(d["py"]), jnp.asarray(z), jnp.asarray(d["rings"]),
                            jnp.asarray(d["valid"] > 0), jnp.asarray(d["origin"]),
                            center_lo=jnp.asarray(d["center_lo"]))
    tb = traster.bin_points(tcfg, d["center"], d["center_lo"], _t(d["px"]), _t(d["py"]),
                            _t(d["rings"]), _t(d["valid"] > 0), d["origin"])
    return jb, tb, z


def _outliers(jcfg, tcfg, d, ground, groundpatch, z_shift=None):
    jb, tb, z = _binnings(jcfg, tcfg, d, z_shift)
    # op by op (no XLA fusion): the JAX package's arithmetic as written --
    # fused, XLA:CPU contracts the lattice's products and adds into FMAs
    with jax.disable_jit():
        want = joutliers.detect_outliers(
            jcfg, jnp.asarray(d["center"]), jnp.asarray(ground), jnp.asarray(groundpatch), jb,
            jnp.asarray(d["px"]), jnp.asarray(d["py"]), jnp.asarray(z),
            jnp.asarray(d["origin"]), center_lo=jnp.asarray(d["center_lo"]))
    n2 = tcfg.cell_count ** 2
    (old_h,) = lookup.lookup(tb.cell, [_t(ground)], n2)
    got, _ = toutliers.detect_outliers(tcfg, d["center"], d["center_lo"], _t(ground),
                                    _t(groundpatch), tb, _t(d["px"]), _t(d["py"]), _t(z),
                                    d["origin"], old_h, lookup.lookup)
    return got.numpy(), np.asarray(want)


def _raised(d, dz, rows):
    """Terrain raised by ``dz`` on a band of rows, confidence 0.6 on the
    first half of the rows: rays through the band turn into candidates,
    and those crossing confident cells fire."""
    n = d["ground"].shape[0]
    ii = np.arange(n)[:, None] + np.zeros((1, n), int)
    band = (ii >= rows[0]) & (ii < rows[1])
    ground = np.where(band, d["ground"] + np.float32(dz), d["ground"]).astype(np.float32)
    conf = np.where(ii < n // 2, np.float32(0.6), d["groundpatch"]).astype(np.float32)
    return ground, conf


def _marching(jcfg, tcfg, d, ground):
    """Approximate count of candidates with a descending ray (f64 math)."""
    jb, _, z = _binnings(jcfg, tcfg, d)
    n2 = jcfg.cell_count ** 2
    old_h = np.append(ground.reshape(-1), 0.0)[np.asarray(jb.cell)]
    cand = np.asarray(jb.inmap & ~jb.ignored) & (z < old_h - np.float32(0.2))
    rel = np.stack([d["px"], d["py"], z]).astype(np.float64) - d["origin"][:, None]
    vz = rel[2] / np.sqrt((rel ** 2).sum(0))
    return int((cand & (vz < -0.01)).sum())


def test_outliers_warm_scan_bitwise(warm):
    jcfg, tcfg, d = warm
    ground, conf = _raised(d, 0.3, (10, 20))
    assert _marching(jcfg, tcfg, d, ground) <= jcfg.max_outlier_candidates
    got, want = _outliers(jcfg, tcfg, d, ground, conf)
    assert 0 < want.sum() < _marching(jcfg, tcfg, d, ground)
    np.testing.assert_array_equal(got, want)
    # the plain warm state fires nothing, and neither does the port
    got, want = _outliers(jcfg, tcfg, d, d["ground"], d["groundpatch"])
    np.testing.assert_array_equal(got, want)


def test_outliers_storm_overflow_bitwise(warm):
    """Terrain raised 0.25 m everywhere: far more marching candidates than
    ``max_outlier_candidates``, so the shortest budgets are shed, and the
    port must shed the same ones and fire on the same."""
    jcfg, tcfg, d = warm
    ground, conf = _raised(d, 0.25, (0, jcfg.cell_count))
    assert _marching(jcfg, tcfg, d, ground) > 2 * jcfg.max_outlier_candidates
    got, want = _outliers(jcfg, tcfg, d, ground, conf)
    assert 0 < want.sum() < jcfg.max_outlier_candidates
    np.testing.assert_array_equal(got, want)


def test_rasterize_sorted_vs_jax(warm):
    jcfg, tcfg, d = warm
    jb, tb, z = _binnings(jcfg, tcfg, d)
    accept = np.array(jb.inmap & ~jb.ignored)
    accept[::13] = False  # some outliers
    t_base_map, origin, center = d["t_base_map"], d["origin"], d["center"]
    with mock.patch("groundgrid_tpu.ops.pallas_raster.raster_sums",
                    lambda *a: raster_sums(*a, interpret=True)):
        want = jraster.rasterize_sorted(jcfg, jb, jnp.asarray(z), jnp.asarray(origin),
                                        jnp.asarray(accept), center=jnp.asarray(center),
                                        t_base_map=jnp.asarray(t_base_map))
    got = traster.rasterize_sorted(tcfg, tb, _t(z), origin, _t(accept), center, t_base_map,
                                   raster.raster_reduce)
    for name in want._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if name in ("min_ground_height", "max_ground_height", "points", "points_raw"):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)
    # the exact-zero m2 gate: zero where the JAX package's m2 is zero
    np.testing.assert_array_equal(got.m2.numpy() == 0, np.asarray(want.m2) == 0)


def test_detect_vs_jax(warm):
    jcfg, tcfg, d = warm
    jb, _, z = _binnings(jcfg, tcfg, d)
    layers = jraster.rasterize(jcfg, jb, jnp.asarray(z), jnp.asarray(d["origin"]),
                               jb.inmap & ~jb.ignored, with_max=False,
                               center=jnp.asarray(d["center"]),
                               t_base_map=jnp.asarray(d["t_base_map"]))
    args = [np.asarray(a) for a in (layers.points, layers.variance, layers.min_ground_height,
                                    d["ground"], d["groundpatch"])]
    g_j, c_j = jax.jit(lambda *a: jdetect.detect_ground_patches(
        jcfg, jdetect.make_tables(jcfg), *a))(*args)
    g_t, c_t = tdetect.detect_ground_patches(tcfg, tdetect.make_tables(tcfg, "cpu"),
                                             *(_t(a) for a in args))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=0, atol=1e-5)
    assert (np.asarray(c_j) != args[4]).any()  # the sweep changed something


def test_classify_bitwise(warm):
    jcfg, tcfg, d = warm
    jb, tb, z = _binnings(jcfg, tcfg, d)
    n = jcfg.cell_count
    rng = np.random.default_rng(4)
    ground = d["ground"]
    variance = np.where(rng.random((n, n)) < 0.3, 0.0,
                        rng.uniform(0, 2e-3, (n, n))).astype(np.float32)
    outlier = rng.random(z.shape[0]) < 0.01
    want = jclassify.classify(jcfg, jb, jnp.asarray(z), jnp.asarray(ground),
                              jnp.asarray(variance), jnp.asarray(outlier), with_counts=False)
    gh, var = lookup.lookup(tb.cell, [_t(ground), _t(variance)], n * n)
    got = tclassify.classify(tcfg, tb, _t(z), _t(outlier), gh, var)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.labels))
    assert set(np.unique(got.numpy())) == {0, 49, 99}
