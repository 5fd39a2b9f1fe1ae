"""Point binning and sorted rasterization (PyTorch).

The torch counterpart of ``groundgrid_tpu/core/rasterize.py``, itself the
replacement of ``GroundSegmentation::insert_cloud``
(``GroundSegmentation.cpp:200-311``): per-cell count, mean z, the shifted
two-pass M2 of z - origin.z, min z (with the reference's -1e-4 epsilon) and
max z, produced deterministically.

Only the sorted path exists here: scans arrive sorted by flat cell id
(``pipeline.prepare_scan``), and K1 (``ops/raster.py``) reduces each cell's
run directly -- sums in point order, min/max exactly -- so the JAX package's
segmented run-end scans (``seg_end_reduce``, ``seg_first_valid``) have no
counterpart: the min layer and the pd-spread flag both come from a min and
a max column of the accepted z.

Everything point-indexed is a flat (P,) tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import exactf32

FLT_MAX = float(np.finfo(np.float32).max)
FLT_TINY = float(np.finfo(np.float32).tiny)  # C++ FLT_MIN
# sentinel for "no accepted point" in the min column (as the JAX package)
MIN_SENT = float(2.0 ** 126)


class RasterLayers(NamedTuple):
    """Per-scan scratch layers, names as in the reference grid map."""

    points: torch.Tensor  # accepted point count per cell
    points_raw: torch.Tensor  # all in-map points
    ground_candidates: torch.Tensor  # mean z
    plane_dist: torch.Tensor  # mean (z - origin.z)
    mean_variance: torch.Tensor  # == plane_dist
    m2: torch.Tensor  # Welford M2
    min_ground_height: torch.Tensor
    max_ground_height: torch.Tensor
    variance: torch.Tensor  # m2 / (points + FLT_MIN)  (GroundSegmentation.cpp:323)


class Binning(NamedTuple):
    """Per-point cell assignment shared by all stages (all (P,) flat)."""

    gi0: torch.Tensor  # int32 row index
    gi1: torch.Tensor  # int32 col index
    cell: torch.Tensor  # int32 flat cell id; == n*n for out-of-map/padding
    inmap: torch.Tensor  # bool valid & inside grid
    ignored: torch.Tensor  # bool in-map but ring/near-field ignored
    sqdist: torch.Tensor  # f32 squared xy distance to the sensor origin

    def permute(self, order) -> "Binning":
        return Binning(*(t[order] for t in self))


def faithful_cells(config: GroundGridConfig, center, center_lo, x, y):
    """(gi0, gi1) int32 cell indices, faithful to the f64 oracle binning.

    ``floor((center + half - coord) / res)`` in ds arithmetic
    (core/exactf32.ds_bin). ``center``/``center_lo``: host (2,) f32 pair
    (``center_lo`` None = zero tail). The same op sequence runs for the host
    prep on CPU tensors and for the device step, so the ids agree bitwise.
    """
    rh, rl, inv = exactf32.res_ds(config.resolution)
    hh, hl = exactf32.f64_to_ds(np.float64(config.half_length))
    c = np.asarray(center, np.float32)
    cl = np.zeros(2, np.float32) if center_lo is None else np.asarray(center_lo, np.float32)
    sh0, sl0 = exactf32.ds_add(c[0], cl[0], np.float32(hh), np.float32(hl))
    sh1, sl1 = exactf32.ds_add(c[1], cl[1], np.float32(hh), np.float32(hl))
    gi0 = exactf32.ds_bin(sh0, sl0, x, rh, rl, inv)
    gi1 = exactf32.ds_bin(sh1, sl1, y, rh, rl, inv)
    return gi0, gi1


def flat_cells(config: GroundGridConfig, gi0, gi1, valid):
    """Flat cell id ``gi0 * n + gi1`` of in-map points, ``n * n`` otherwise."""
    n = config.cell_count
    inmap = (gi0 >= 0) & (gi0 < n) & (gi1 >= 0) & (gi1 < n) & valid
    cell = torch.where(inmap, gi0 * n + gi1, torch.full_like(gi0, n * n))
    return cell, inmap


def bin_points(config: GroundGridConfig, center, center_lo, x, y, rings, valid,
               origin) -> Binning:
    """Assign points to cells and flag ignored points.

    Ignore rule (GroundSegmentation.cpp:237-240): ring > max_ring or squared
    xy distance to the sensor below min_dist_squared; such points skip all
    statistics but are still classified. ``origin``: host (3,) f32.
    """
    gi0, gi1 = faithful_cells(config, center, center_lo, x, y)
    cell, inmap = flat_cells(config, gi0, gi1, valid)
    o = np.asarray(origin, np.float32)
    dx = x - float(o[0])
    dy = y - float(o[1])
    sqdist = dx * dx + dy * dy
    ignored = inmap & (
        (rings > config.max_ring) | (sqdist < float(np.float32(config.min_dist_squared)))
    )
    return Binning(gi0=gi0, gi1=gi1, cell=cell, inmap=inmap, ignored=ignored, sqdist=sqdist)


def _plane_shift_point(config: GroundGridConfig, center, t_base_map, origin, gi0, gi1):
    """Per-point conditioning shift: the ego base-plane pd at the point's CELL.

    Constant within a cell, so it leaves m2 invariant in real arithmetic
    while keeping the f32 sums small on graded terrain (see the JAX
    package's docstring of the same name).
    """
    res = float(np.float32(config.resolution))
    half = np.float32(config.half_length)
    c = np.asarray(center, np.float32)
    t = np.asarray(t_base_map, np.float32)
    o = np.asarray(origin, np.float32)
    xc = float(c[0] + half) - (gi0.to(torch.float32) + 0.5) * res
    yc = float(c[1] + half) - (gi1.to(torch.float32) + 0.5) * res
    zb = (float(t[2, 0]) * xc + float(t[2, 1]) * yc) + float(t[2, 3])
    return (-zb) - float(o[2])


def _plane_shift_map(config: GroundGridConfig, center, t_base_map, origin, device):
    """(N*N,) flat map of :func:`_plane_shift_point` over all cells."""
    n = config.cell_count
    idx = torch.arange(n, dtype=torch.int32, device=device)
    gi0 = idx[:, None].expand(n, n)
    gi1 = idx[None, :].expand(n, n)
    return _plane_shift_point(config, center, t_base_map, origin, gi0, gi1).reshape(-1)


def raster_columns(config: GroundGridConfig, binning: Binning, z, origin, accept,
                   center, t_base_map):
    """The seven K1 columns of a scan and their reductions.

    In-map count, accepted count, sum z, sum pdc, sum pdc^2 (sums), and the
    minimum and maximum of the accepted z (``MIN_SENT`` and ``-MIN_SENT``
    where a point is not accepted). Rounding is monotone, so the per-cell
    minimum of ``z - 1e-4`` (the reference's epsilon) and the extrema of
    ``pd = z - origin.z`` follow bitwise from the z extrema.
    Returns ``(cols, ops, shift)``, ``shift`` the (N*N,) plane-shift map.
    """
    o2 = float(np.float32(np.asarray(origin, np.float32)[2]))
    pd = z - o2
    zero = torch.zeros_like(z)
    s_pt = _plane_shift_point(config, center, t_base_map, origin, binning.gi0, binning.gi1)
    shift = _plane_shift_map(config, center, t_base_map, origin, z.device)
    pdc = torch.where(accept, pd - s_pt, zero)
    cols = [
        binning.inmap.to(torch.float32),
        accept.to(torch.float32),
        torch.where(accept, z, zero),
        pdc,
        pdc * pdc,
        torch.where(accept, z, torch.full_like(z, MIN_SENT)),
        torch.where(accept, z, torch.full_like(z, -MIN_SENT)),
    ]
    ops = ["sum", "sum", "sum", "sum", "sum", "min", "max"]
    return cols, ops, shift


def rasterize_sorted(config: GroundGridConfig, binning: Binning, z, origin, accept,
                     center, t_base_map, reduce_fn) -> RasterLayers:
    """Rasterization of a **cell-sorted** scan through one K1 call.

    ``reduce_fn``: ``ops.raster.raster_reduce`` (kernel on CUDA) or its
    plain version, over the columns of :func:`raster_columns`. The pd-spread
    flag of the exact-zero m2 gate is ``min pd < max pd`` over the accepted
    points, the JAX package's "some pd differs from the first" test.
    """
    n2 = config.cell_count ** 2
    cols, ops, shift = raster_columns(config, binning, z, origin, accept, center, t_base_map)
    out = reduce_fn(binning.cell, cols, ops, n2)
    raw, zmin, zmax = out[0], out[5], out[6]
    o2 = float(np.float32(np.asarray(origin, np.float32)[2]))
    # cells with no points read 0, all-ignored cells the sentinel
    mins = torch.where((raw > 0) & (zmin < 1e30), zmin - float(np.float32(1e-4)),
                       torch.full_like(raw, FLT_MAX))
    has_spread = (zmin - o2) < (zmax - o2)
    # the aux max layer is not on this path: its reset value (FLT_MIN quirk)
    maxs = torch.full((n2,), FLT_TINY, dtype=torch.float32, device=z.device)
    return _finish_layers(
        config, points_raw=raw, count=out[1], sum_z=out[2], sum_pdc=out[3],
        sum_pdc2=out[4], min_gh=mins, max_gh=maxs, shift=shift, has_spread=has_spread,
    )


def _finish_layers(config, points_raw, count, sum_z, sum_pdc, sum_pdc2, min_gh, max_gh,
                   shift, has_spread) -> RasterLayers:
    """Moment -> layer math on flat (N*N,) accumulator columns.

    m2 is exactly 0 for cells without spread (one sample, or identical pd),
    and at least 2^-80 otherwise, as sequential Welford gives (see the JAX
    package's ``_finish_layers`` for the forensic history).
    """
    n = config.cell_count

    def grid(a):
        return a.reshape(n, n)

    points_raw, count, sum_z = grid(points_raw), grid(count), grid(sum_z)
    sum_pdc, sum_pdc2 = grid(sum_pdc), grid(sum_pdc2)
    zero = torch.zeros_like(count)
    safe = torch.clamp_min(count, 1.0)
    mean_pdc = sum_pdc / safe
    ground_candidates = sum_z / safe
    mean_pd = torch.where(count > 0, mean_pdc + grid(shift), zero)
    residue = sum_pdc2 - sum_pdc * mean_pdc
    m2 = torch.where(
        (count > 1.0) & grid(has_spread), torch.clamp_min(residue, float(2.0 ** -80)), zero
    )
    variance = m2 / (count + FLT_TINY)
    return RasterLayers(
        points=count, points_raw=points_raw, ground_candidates=ground_candidates,
        plane_dist=mean_pd, mean_variance=mean_pd, m2=m2,
        min_ground_height=grid(min_gh), max_ground_height=grid(max_gh), variance=variance,
    )
