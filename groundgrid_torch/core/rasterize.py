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

Everything point-indexed is a flat (P,) tensor, or a (B, P) batch of
them, one row a vehicle, with the scan scalars as (B, 1) columns
(``core/scalars.py``): every function here then works row by row, and
each row is bitwise the vehicle's own (P,) call. Cell-indexed columns are
(N*N,), or (B, N*N).
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
        return Binning(*(take_points(t, order) for t in self))


def take_points(t, order):
    """``t`` at the point indices ``order`` (or a slice): ``t[order]`` of a
    (P,) tensor, each row of a (B, P) batch at its own row of ``order``."""
    if isinstance(order, torch.Tensor) and order.dim() > 1:
        return torch.take_along_dim(t, order, dim=-1)
    return t[order]


def ds_cells(config: GroundGridConfig, sh0, sl0, sh1, sl1, x, y):
    """(gi0, gi1) int32 cell indices, faithful to the f64 oracle binning.

    ``floor((center + half - coord) / res)`` in ds arithmetic
    (core/exactf32.ds_bin), ``(sh0, sl0, sh1, sl1)`` the ds image of
    ``center + half`` per axis (``scalars.binning_constants``): np.float32
    on the host, 0-dim device tensors in the step (the scan scalars). The
    same op sequence runs for the host prep on CPU tensors and for the
    device step, so the ids agree bitwise.
    """
    rh, rl, inv = exactf32.res_ds(config.resolution)
    gi0 = exactf32.ds_bin(sh0, sl0, x, rh, rl, inv)
    gi1 = exactf32.ds_bin(sh1, sl1, y, rh, rl, inv)
    return gi0, gi1


def flat_cells(config: GroundGridConfig, gi0, gi1, valid):
    """Flat cell id ``gi0 * n + gi1`` of in-map points, ``n * n`` otherwise."""
    n = config.cell_count
    inmap = (gi0 >= 0) & (gi0 < n) & (gi1 >= 0) & (gi1 < n) & valid
    cell = torch.where(inmap, gi0 * n + gi1, torch.full_like(gi0, n * n))
    return cell, inmap


def bin_points(config: GroundGridConfig, s, x, y, rings, valid) -> Binning:
    """Assign points to cells and flag ignored points.

    Ignore rule (GroundSegmentation.cpp:237-240): ring > max_ring or squared
    xy distance to the sensor below min_dist_squared; such points skip all
    statistics but are still classified. ``s``: the scan scalars (the
    binning constants and the sensor origin, ``core/scalars.py``).
    """
    gi0, gi1 = ds_cells(config, s.sh0, s.sl0, s.sh1, s.sl1, x, y)
    cell, inmap = flat_cells(config, gi0, gi1, valid)
    dx = x - s.ox
    dy = y - s.oy
    sqdist = dx * dx + dy * dy
    ignored = inmap & (
        (rings > config.max_ring) | (sqdist < float(np.float32(config.min_dist_squared)))
    )
    return Binning(gi0=gi0, gi1=gi1, cell=cell, inmap=inmap, ignored=ignored, sqdist=sqdist)


def _plane_shift_point(config: GroundGridConfig, s, gi0, gi1):
    """Per-point conditioning shift: the ego base-plane pd at the point's CELL.

    Constant within a cell, so it leaves m2 invariant in real arithmetic
    while keeping the f32 sums small on graded terrain (see the JAX
    package's docstring of the same name). ``s``: the scan scalars.
    """
    res = float(np.float32(config.resolution))
    xc = s.cxh - (gi0.to(torch.float32) + 0.5) * res
    yc = s.cyh - (gi1.to(torch.float32) + 0.5) * res
    zb = (s.b20 * xc + s.b21 * yc) + s.b23
    return (-zb) - s.oz


def _plane_shift_map(config: GroundGridConfig, s, device):
    """(N*N,) flat map of :func:`_plane_shift_point` over all cells ((B,
    N*N) for batched scan scalars)."""
    n = config.cell_count
    idx = torch.arange(n, dtype=torch.int32, device=device)
    gi0 = idx[:, None].expand(n, n).reshape(-1)
    gi1 = idx[None, :].expand(n, n).reshape(-1)
    return _plane_shift_point(config, s, gi0, gi1)


def raster_columns(config: GroundGridConfig, binning: Binning, z, accept, s):
    """The seven K1 columns of a scan and their reductions.

    In-map count, accepted count, sum z, sum pdc, sum pdc^2 (sums), and the
    minimum and maximum of the accepted z (``MIN_SENT`` and ``-MIN_SENT``
    where a point is not accepted). Rounding is monotone, so the per-cell
    minimum of ``z - 1e-4`` (the reference's epsilon) and the extrema of
    ``pd = z - origin.z`` follow bitwise from the z extrema.
    ``s``: the scan scalars. Returns ``(cols, ops)``.
    """
    pd = z - s.oz
    zero = torch.zeros_like(z)
    s_pt = _plane_shift_point(config, s, binning.gi0, binning.gi1)
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
    return cols, list(COLUMN_OPS)


# the reductions of the seven columns of :func:`raster_columns`
COLUMN_OPS = ("sum", "sum", "sum", "sum", "sum", "min", "max")


def raster_partials(config: GroundGridConfig, binning: Binning, z, accept, s,
                    reduce_fn) -> list:
    """One shard's seven (N*N,) K1 columns over its **cell-sorted** points:
    one ``reduce_fn`` call (``ops.raster.raster_reduce``, the kernel on
    CUDA, or its plain version) over :func:`raster_columns`."""
    cols, ops = raster_columns(config, binning, z, accept, s)
    return reduce_fn(binning.cell, cols, ops, config.cell_count ** 2)


def raster_columns_ordered(config: GroundGridConfig, binning: Binning, z, outlier, s,
                           order=None):
    """The K1 inputs of a scan read through ``order``: ``(cell, cols)``.

    ``cell`` is ``binning.cell`` at the points ``order`` names and ``cols``
    the seven columns of :func:`raster_columns` there, with ``accept =
    inmap & ~ignored & ~outlier``: what ``binning.permute(order)``,
    :func:`take_points` and :func:`raster_columns` compute together.
    ``order`` None is the identity (a scan already sorted by cell); a (B,
    P) batch takes a (B, P) ``order``, each row its own. K9's plain
    version (``ops/raster_stage.py``).
    """
    accept = binning.inmap & ~binning.ignored & ~outlier
    if order is not None:
        binning = binning.permute(order)
        z, accept = take_points(z, order), take_points(accept, order)
    cols, _ = raster_columns(config, binning, z, accept, s)
    return binning.cell, cols


# every layer of :class:`RasterLayers`, and those the step reads without
# the aux layers (detect and classify; the spatial step's shards too)
ALL_LAYERS = RasterLayers._fields
MAIN_LAYERS = ("points", "variance", "min_ground_height")


def fold_partials(partials):
    """The seven K1 columns of S shards folded in shard order.

    Columns 0-4 are summed in the given order (so every process that folds
    the same partials gets the same bits), column 5 takes the minimum and
    column 6 the maximum over the shards that hold points of the cell; one
    shard's columns pass through untouched.
    """
    if len(partials) == 1:
        return list(partials[0])
    # K1 leaves a cell without points at 0 in every column: its extrema
    # take the sentinels before they fold
    out = [torch.stack(col) for col in zip(*partials)]
    has = out[0] > 0
    out[5] = torch.where(has, out[5], MIN_SENT).amin(0)
    out[6] = torch.where(has, out[6], -MIN_SENT).amax(0)
    for j in range(5):
        total = out[j][0]
        for part in out[j][1:]:
            total = total + part
        out[j] = total
    return out


def finish_layers(config: GroundGridConfig, partials, s, aux: bool = False) -> RasterLayers:
    """The raster layers from the K1 columns of S shards
    (:func:`fold_partials`): with ``aux`` every layer, the max layer
    filled; without, the three the step reads (:data:`MAIN_LAYERS`) and
    None for the others.

    The pd-spread flag of the exact-zero m2 gate is ``min pd < max pd``
    over the accepted points, the JAX package's "some pd differs from the
    first" test. The plane shift is per cell (the JAX package's ``center``
    / ``t_base_map`` form, from the scan scalars ``s``), so no scalar
    crosses the shards; it feeds the aux layer ``plane_dist`` alone.

    The aux max layer is the max of the accepted z and the reset value
    FLT_MIN (the reference's init quirk, GroundSegmentation.cpp:73),
    FLT_MIN in cells without accepted points. K10's plain version
    (``ops/raster_stage.py``).
    """
    out = fold_partials(partials)
    raw, zmin, zmax = out[0], out[5], out[6]
    # cells with no points read 0, all-ignored cells the sentinel
    mins = torch.where((raw > 0) & (zmin < 1e30), zmin - float(np.float32(1e-4)),
                       torch.full_like(raw, FLT_MAX))
    has_spread = (zmin - s.oz) < (zmax - s.oz)
    maxs = shift = None
    if aux:  # non-accepted points carry -MIN_SENT: they never win the max
        maxs = torch.where(raw > 0, torch.clamp_min(zmax, FLT_TINY), FLT_TINY)
        shift = _plane_shift_map(config, s, raw.device)
    return _finish_layers(
        config, aux, points_raw=raw, count=out[1], sum_z=out[2], sum_pdc=out[3],
        sum_pdc2=out[4], min_gh=mins, max_gh=maxs, shift=shift, has_spread=has_spread,
    )


def finish_partials(config: GroundGridConfig, partials, s,
                    with_max: bool = False) -> RasterLayers:
    """Every raster layer from the K1 columns of S shards, in shard order:
    :func:`finish_layers` with the aux layers; without ``with_max`` the max
    layer holds the reset value FLT_MIN."""
    layers = finish_layers(config, partials, s, aux=True)
    if with_max:
        return layers
    return layers._replace(max_ground_height=torch.full_like(layers.points, FLT_TINY))


def rasterize_sorted(config: GroundGridConfig, binning: Binning, z, accept, s, reduce_fn,
                     with_max: bool = False) -> RasterLayers:
    """Rasterization of a **cell-sorted** scan through one K1 call: the
    one-shard case of :func:`raster_partials` and :func:`finish_partials`."""
    part = raster_partials(config, binning, z, accept, s, reduce_fn)
    return finish_partials(config, [part], s, with_max=with_max)


def _finish_layers(config, aux, points_raw, count, sum_z, sum_pdc, sum_pdc2, min_gh, max_gh,
                   shift, has_spread) -> RasterLayers:
    """Moment -> layer math on flat (N*N,) accumulator columns: the
    :data:`MAIN_LAYERS`, and with ``aux`` the others (None without).

    m2 is exactly 0 for cells without spread (one sample, or identical pd),
    and at least 2^-80 otherwise, as sequential Welford gives (see the JAX
    package's ``_finish_layers`` for the forensic history).
    """
    n = config.cell_count

    def grid(a):
        return a.reshape(*a.shape[:-1], n, n)

    count = grid(count)
    zero = torch.zeros_like(count)
    safe = torch.clamp_min(count, 1.0)
    sum_pdc = grid(sum_pdc)
    mean_pdc = sum_pdc / safe
    residue = grid(sum_pdc2) - sum_pdc * mean_pdc
    m2 = torch.where(
        (count > 1.0) & grid(has_spread), torch.clamp_min(residue, float(2.0 ** -80)), zero
    )
    layers = dict.fromkeys(RasterLayers._fields)
    layers.update(points=count, variance=m2 / (count + FLT_TINY), min_ground_height=grid(min_gh))
    if aux:
        mean_pd = torch.where(count > 0, mean_pdc + grid(shift), zero)
        layers.update(points_raw=grid(points_raw), ground_candidates=grid(sum_z) / safe,
                      plane_dist=mean_pd, mean_variance=mean_pd, m2=m2,
                      max_ground_height=grid(max_gh))
    return RasterLayers(**layers)
