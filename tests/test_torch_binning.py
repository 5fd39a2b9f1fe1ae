"""Host prep, binning and grid state of the port, bitwise against the JAX package.

The sorted-scan invariant is that the host's predicted cell ids equal the
device's binning bit for bit; these tests hold the port's host prep and its
device binning (run here on CPU tensors) to the JAX package's, along with
the f64 center tracker, the grid move and the state converters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groundgrid_tpu import pipeline as jpipe
from groundgrid_tpu.config import GroundGridConfig as JConfig
from groundgrid_tpu.core import grid as jgrid
from groundgrid_tpu.core import rasterize as jraster
from groundgrid_tpu.core import transforms as jtf

from groundgrid_torch import pipeline as tpipe
from groundgrid_torch.config import GroundGridConfig as TConfig
from groundgrid_torch.core import grid as tgrid
from groundgrid_torch.core import rasterize as traster

# the test workers share the CPU: torch's intra-op thread pools would
# oversubscribe it and stall on the many small ops of the plain versions
torch.set_num_threads(1)


def _configs(small_config):
    kw = {f: getattr(small_config, f) for f in small_config.__dataclass_fields__}
    kw["sorted_scans"] = True
    return JConfig(**kw), TConfig(**kw)


def _map_points(cfg, pts, T):
    mv, _, _ = jtf.scan_poses(T)
    xyz = jtf.transform_points(np.asarray(T, np.float64), pts[:, :3].astype(np.float64))
    xyz = xyz.astype(np.float32)
    valid = np.ones(len(xyz), np.int32)
    return xyz, valid, mv


@pytest.mark.parametrize("scan", [0, 2])
def test_predict_cells_bitwise(small_config, small_scans, scan):
    jcfg, tcfg = _configs(small_config)
    pts, _, T = small_scans[scan]
    xyz, valid, _ = _map_points(jcfg, pts, T)
    valid[::7] = 0
    center64 = T[:2, 3] + np.array([0.123456789, -0.25])  # a half-cell tail
    got = tpipe.predict_cells(tcfg, center64, xyz[:, 0], xyz[:, 1], valid)
    want = jpipe.predict_cells(jcfg, center64, xyz[:, 0], xyz[:, 1], valid)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype == np.int32
    # an f32 hi with an explicit tail takes the same route
    hi, lo = tpipe._center_ds(center64)
    np.testing.assert_array_equal(
        tpipe.predict_cells(tcfg, hi, xyz[:, 0], xyz[:, 1], valid, center_lo=lo), want)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_bin_points_bitwise(small_config, small_scans, jit):
    jcfg, tcfg = _configs(small_config)
    pts, labels, T = small_scans[1]
    xyz, valid, mv = _map_points(jcfg, pts, T)
    rings = labels.astype(np.int32)
    rings[::11] = 2000  # beyond max_ring: ignored
    hi, lo = tpipe._center_ds(T[:2, 3].astype(np.float64) + 0.1)
    origin = mv[:3, 3]

    # center and origin are traced arguments, as in the JAX step (closed-over
    # constants would let XLA fold the ds center sum at compile time)
    def fn(c, cl, o, x, y, z, r, v):
        return jraster.bin_points(jcfg, c, x, y, z, r, v, o, center_lo=cl)

    args = [jnp.asarray(a) for a in (hi, lo, origin, xyz[:, 0], xyz[:, 1], xyz[:, 2], rings)]
    want = (jax.jit(fn) if jit else fn)(*args, jnp.asarray(valid > 0))
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (xyz[:, 0], xyz[:, 1])]
    got = traster.bin_points(tcfg, hi, lo, t[0], t[1], torch.from_numpy(rings),
                             torch.from_numpy(valid > 0), origin)
    for name in want._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if jit and name == "sqdist":
            # XLA:CPU contracts dx*dx + dy*dy into an FMA despite the JAX
            # package's barrier; the port rounds both squares, as the oracle
            # does (eager JAX, above, is bitwise). One ulp apart at most.
            np.testing.assert_array_less(np.abs(a - b), np.spacing(b) * 1.01)
            continue
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_center_tracker_bitwise_with_half_cell_tie(small_config):
    jcfg, tcfg = _configs(small_config)
    start = np.array([1000.0, -2000.0])
    res = small_config.resolution
    # steps of exactly half a cell (ties snap away from zero), plus odd steps
    steps = [0.5 * res, -0.5 * res, 1.5 * res, 0.37, -2.5 * res, 3.3, -0.5 * res]
    jt, tt = jpipe.CenterTracker(jcfg, start), tpipe.CenterTracker(tcfg, start)
    pos = start.copy()
    for s in steps:
        pos = pos + np.array([s, -s])
        np.testing.assert_array_equal(tt.update(pos), jt.update(pos))
        np.testing.assert_array_equal(tt.center, jt.center)
        for a, b in zip(tt.center_ds(), jt.center_ds()):
            np.testing.assert_array_equal(a, b)
    # the tie rule itself: half away from zero, not half to even
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.49], np.float64)
    np.testing.assert_array_equal(tgrid._snap_cells(x), jgrid._snap_cells(x, xp=np))
    np.testing.assert_array_equal(tgrid._snap_cells(torch.from_numpy(x)).numpy(),
                                  jgrid._snap_cells(x, xp=np))


@pytest.mark.parametrize("seed", range(4))
def test_move_bitwise(small_config, seed):
    jcfg, tcfg = _configs(small_config)
    n = small_config.cell_count
    rng = np.random.default_rng(seed)
    ground = rng.normal(-1.7, 0.3, (n, n)).astype(np.float32)
    conf = rng.random((n, n)).astype(np.float32)
    c0 = np.array([1234.56, -987.25]) + rng.normal(0, 50, 2)
    k = rng.integers(-5, 6, 2) if seed else np.array([0, 0])
    c1 = c0 + k * small_config.resolution
    hi0, lo0 = tpipe._center_ds(c0)
    hi1, lo1 = tpipe._center_ds(c1)
    yaw, pitch = rng.uniform(-3, 3), rng.uniform(-0.1, 0.1)
    T = np.eye(4)
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    T[:3, :3] = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]]) @ np.array(
        [[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    T[:3, 3] = [c1[0], c1[1], 12.3]
    _, _, bm = jtf.scan_poses(T)
    jstate = jgrid.GridState(jnp.asarray(ground), jnp.asarray(conf), jnp.asarray(hi0),
                             jnp.asarray(lo0))
    want = jax.jit(lambda s, b, c, l: jgrid.move(jcfg, s, None, b, new_center=c, new_center_lo=l))(
        jstate, bm, hi1, lo1)
    got = tgrid.move(tcfg, tgrid.state_from_numpy(ground, conf, hi0, lo0, "cpu"), bm, hi1, lo1)
    for a, b in zip(tgrid.state_to_numpy(got), (want.ground, want.groundpatch, want.center,
                                                want.center_lo)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_state_numpy_round_trip(small_config):
    jcfg, tcfg = _configs(small_config)
    T = np.eye(4)
    T[:3, 3] = [512.123456789, -77.7, 3.2]
    jstate = jpipe.init_state(jcfg, T)
    tstate = tpipe.init_state(tcfg, T, "cpu")
    arrays = [np.asarray(a) for a in jstate]
    for a, b in zip(tgrid.state_to_numpy(tstate), arrays):
        np.testing.assert_array_equal(a, b)
    back = tgrid.state_from_numpy(*arrays, device="cpu")
    for a, b in zip(tgrid.state_to_numpy(back), arrays):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.float32


def test_prepare_scan_matches_jax(small_config, small_scans):
    jcfg, tcfg = _configs(small_config)
    pts, labels, T = small_scans[0]
    center = T[:2, 3].astype(np.float64) + 0.2
    jscan, jorder = jpipe.prepare_scan(jcfg, pts, labels, T, center)
    tscan, torder = tpipe.prepare_scan(tcfg, pts, labels, T, center, "cpu")
    np.testing.assert_array_equal(torder, jorder)
    for name in ("px", "py", "pz", "rings", "valid"):
        np.testing.assert_array_equal(getattr(tscan, name).numpy(),
                                      np.asarray(getattr(jscan, name)), err_msg=name)
    for name in ("t_map_velo", "t_map_base", "t_base_map", "center", "center_lo"):
        np.testing.assert_array_equal(getattr(tscan, name), np.asarray(getattr(jscan, name)),
                                      err_msg=name)
