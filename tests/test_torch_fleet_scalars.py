"""The fleet's scan scalars in one pass over a block's vehicles, on the CPU.

``pipeline.scan_scalars`` (with ``scalars.pack``, ``scalars.binning_constants``
and ``grid.shift_cells`` or ``grid.index_shift_ds``) takes a stacked block of
B vehicles' centers and scans as it takes one vehicle's. Its contract: every
returned array, the (B, SIZE) rows and the (B, 2) new center pairs, bitwise
the stack of the B single calls. Held here over centers near 0 and at
+-5,000 m, shifts of 0, +-1 and past +-n (the clamp), exact half-cell
position deltas, zero, non-zero and absent center tails, B = 1, 3 and 64,
the center-carrying branch (f32 and wire scans) and the center-less one.
"""

import numpy as np
import pytest
import torch

from groundgrid_torch import GroundGridConfig
from groundgrid_torch.core import exactf32
from groundgrid_torch.core import grid as gridlib
from groundgrid_torch.core import scalars as scalarlib
from groundgrid_torch.core import transforms as tf
from groundgrid_torch.parallel.sharding import _vehicle
from groundgrid_torch.pipeline import Scan, WireScan, scan_scalars

CONFIGS = {
    "unsorted": GroundGridConfig(dimension=24.0, resolution=0.5, max_points=64),
    "sorted": GroundGridConfig(dimension=40.0, resolution=0.33, max_points=64,
                               sorted_scans=True),
    "wire": GroundGridConfig(dimension=40.0, resolution=0.33, max_points=64,
                             sorted_scans=True, wire_format=True),
}
BASES = {"origin": 0.0, "east": 5000.0, "west": -5000.0}
TAILS = ("zero", "nonzero", "none")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))


def _yaw(a):
    t = np.eye(4)
    t[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    return t


def _shifts(cfg, b, rng):
    """Whole-cell shifts: 0, +-1 and past +-n first, then random ones."""
    n = cfg.cell_count
    fixed = [(0, 0), (1, -1), (-1, 1), (n + 3, -(n + 7)), (-n, n), (2 * n, 0)]
    k = rng.integers(-n - 4, n + 5, (b, 2))
    k[:min(b, len(fixed))] = fixed[:b]
    return k


def _block(cfg, base, tail, b, seed, centered):
    """Old center pairs and a scan block of ``b`` vehicles about ``base``."""
    rng = np.random.default_rng(seed)
    res = np.float64(np.float32(cfg.resolution))
    old = base + np.round(rng.uniform(-40, 40, (b, 2)) * 64) / 64  # f32-exact
    k = _shifts(cfg, b, rng)
    if centered:
        new = old + k * np.float64(cfg.resolution)
        position = new + rng.uniform(-0.2, 0.2, (b, 2)) * res
    else:  # the sensor a whole number and a half of cells off: the snap's tie
        new = None
        position = old + (k + np.where(rng.random((b, 2)) < 0.5, 0.5, -0.5)) * res
    poses = [tf.scan_poses(tf.translation(*position[v], 1.7) @ _yaw(rng.uniform(-3, 3)))
             for v in range(b)]
    mv, mb, bm = (np.stack(p) for p in zip(*poses))
    hi, lo = exactf32.f64_to_ds(old)
    if tail == "zero":
        lo = np.zeros_like(hi)
    fields = dict(t_map_velo=mv, t_map_base=mb, t_base_map=bm, center=None, center_lo=None)
    if centered:
        chi, clo = exactf32.f64_to_ds(new)
        fields.update(center=chi, center_lo=None if tail == "none" else clo)
    points = torch.zeros((b, 8), dtype=torch.int16 if cfg.wire_format else torch.float32)
    if cfg.wire_format:
        scan = WireScan(qx=points, qy=points, qz=points, rings=points,
                        count=rng.integers(0, 64, b), **fields)
    else:
        ids = points.view(torch.int32)
        scan = Scan(px=points, py=points, pz=points, rings=ids, valid=ids, **fields)
    return hi, lo, scan


def _check(cfg, hi, lo, scan):
    got = scan_scalars(cfg, hi, lo, scan)
    b = len(hi)
    want = [scan_scalars(cfg, hi[v], lo[v], _vehicle(scan, v)) for v in range(b)]
    assert got[0].shape == (b, scalarlib.SIZE)
    for j, name in enumerate(("packed", "center", "center_lo")):
        stacked = np.stack([w[j] for w in want])
        assert _equal(got[j], stacked), name
    return got


@pytest.mark.parametrize("b", [1, 3, 64])
@pytest.mark.parametrize("tail", TAILS)
@pytest.mark.parametrize("base", sorted(BASES))
@pytest.mark.parametrize("mode", sorted(CONFIGS))
def test_block_scalars_are_single_calls(mode, base, tail, b):
    """The center-carrying branch: a block's rows and centers bitwise the
    stack of its vehicles' single calls; the shifts clamped to [-n, n]."""
    cfg = CONFIGS[mode]
    hi, lo, scan = _block(cfg, BASES[base], tail, b, seed=b + len(base), centered=True)
    packed, center, center_lo = _check(cfg, hi, lo, scan)
    ints = packed.view(np.int32)
    n = cfg.cell_count
    assert np.abs(ints[:, scalarlib.K0:scalarlib.K1 + 1]).max() <= n
    if b >= 4:
        assert (ints[3, scalarlib.K0], ints[3, scalarlib.K1]) == (n, -n)
    if tail == "none":
        assert not center_lo.any()
    want_count = scan.count if cfg.wire_format else 0
    assert np.array_equal(ints[:, scalarlib.COUNT], np.broadcast_to(want_count, b))


@pytest.mark.parametrize("b", [1, 3, 64])
@pytest.mark.parametrize("tail", ("zero", "nonzero"))
@pytest.mark.parametrize("base", sorted(BASES))
def test_block_scalars_without_centers_are_single_calls(base, tail, b):
    """The center-less branch (``index_shift_ds``, unsorted scans) at the
    half-cell snap tie: bitwise the stack of the single calls."""
    cfg = CONFIGS["unsorted"]
    hi, lo, scan = _block(cfg, BASES[base], tail, b, seed=7 * b, centered=False)
    _, center, center_lo = _check(cfg, hi, lo, scan)
    assert not np.array_equal(center, hi)  # the centers moved


def test_batched_shift_is_clamped_int32():
    """``shift_cells`` of one pair gives Python ints as they snap, of a
    batch int32 clamped to [-n, n]; a -0.0 delta gives 0 either way."""
    cfg = CONFIGS["unsorted"]
    n = cfg.cell_count
    res = np.float32(cfg.resolution)
    old = np.float32([[0.0, -0.0], [100.0, 100.0], [-2.0, 3.0]])
    new = old + np.float32([[0, 0], [(n + 9) * res, -(n + 9) * res], [res, -res]])
    got = gridlib.shift_cells(cfg, old, new)
    assert got.dtype == np.int32 and got.tolist() == [[0, 0], [n, -n], [1, -1]]
    assert [gridlib.shift_cells(cfg, o, w) for o, w in zip(old, new)] == [
        (0, 0), (n + 9, -(n + 9)), (1, -1)]
    neg = gridlib.shift_cells(cfg, np.float32([[0.0, 0.0]]), np.float32([[-0.0, -0.0]]))
    assert _equal(neg, np.zeros((1, 2), np.int32))
    assert gridlib.shift_cells(cfg, np.float32([0.0, 0.0]), np.float32([-0.0, -0.0])) == (0, 0)


def test_pack_keeps_f32_and_takes_tuples():
    """``pack`` of one vehicle with Python-int shifts (the clamp as Python
    ints take it) is a row of the batch; no column widens to f64."""
    cfg = CONFIGS["sorted"]
    n = cfg.cell_count
    hi, lo, scan = _block(cfg, 5000.0, "nonzero", 3, seed=5, centered=True)
    k = [(3, -500), (10 ** 12, -(10 ** 12)), (0, 0)]
    rows = scalarlib.pack(cfg, hi, lo, np.asarray(k), scan.t_map_velo, scan.t_map_base,
                          scan.t_base_map)
    assert rows.dtype == np.float32 and rows.shape == (3, scalarlib.SIZE)
    for v in range(3):
        one = scalarlib.pack(cfg, hi[v], lo[v], k[v], scan.t_map_velo[v], scan.t_map_base[v],
                             scan.t_base_map[v])
        assert _equal(one, rows[v]), v
    assert rows.view(np.int32)[:, scalarlib.K0].tolist() == [3, n, 0]
    consts = scalarlib.binning_constants(cfg, hi, None)
    assert all(c.dtype == np.float32 and c.shape == (3,) for c in consts)
