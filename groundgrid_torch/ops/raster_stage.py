"""K9 and K10: the step's raster stage around K1 (``csrc/raster_stage.cu``).

Replace what XLA fuses of the JAX package's rasterization around its
Pallas kernel, ``groundgrid_tpu/core/rasterize.py:rasterize_sorted`` (the
columns, ``_plane_shift_point``) and ``_finish_layers`` (with
``_plane_shift_map``): eager PyTorch runs them as ~50 small kernels and 8
gathers a scan, the card as two launches.

- :func:`raster_columns_ordered` (K9): the cell ids and the seven K1
  columns of a scan read through the sort's order, one thread a sorted
  position. Plain version: ``core/rasterize.py raster_columns_ordered``.
- :func:`finish_layers` (K10): S shards' K1 columns folded in shard order
  and turned into the raster layers, the main path's three or with the
  aux layers all of them, one thread a cell. Plain version:
  ``core/rasterize.py finish_layers``.

Each launches its kernel for CUDA tensors and takes its plain version only
for CPU tensors; the two agree bitwise (every f32 step rounded as its
PyTorch op). The kernels read the scan scalars where they lie
(``scalars.device_rows``), so a captured graph replays on any scan. A batch
of vehicles, (B, P) points or (B, N*N) columns with (B, ``SIZE``) scan
scalars, is one launch, each row bitwise its single call.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import rasterize as rasterlib
from groundgrid_torch.core import scalars as scalarlib
from groundgrid_torch.core.rasterize import ALL_LAYERS, MAIN_LAYERS, Binning, RasterLayers
from groundgrid_torch.ops import _build

__all__ = ["raster_columns_ordered", "raster_columns_ordered_plain", "finish_layers",
           "finish_layers_plain"]

raster_columns_ordered_plain = rasterlib.raster_columns_ordered
finish_layers_plain = rasterlib.finish_layers

MAX_SHARDS = 64  # raster_stage.cu kMaxShards
# the planes of K10's output: the main path's layers, then the aux layers
# (mean_variance is plane_dist)
KERNEL_LAYERS = (*MAIN_LAYERS, "points_raw", "ground_candidates", "plane_dist", "m2",
                 "max_ground_height")


def _resolution(config: GroundGridConfig) -> float:
    return float(np.float32(config.resolution))


def _check_columns_args(binning: Binning, z, outlier, order):
    if z.dim() not in (1, 2) or z.dtype != torch.float32:
        raise ValueError(f"z must be (P,) or (B, P) float32, got {tuple(z.shape)} {z.dtype}")
    fields = [(binning.cell, torch.int32, "cell"), (binning.inmap, torch.bool, "inmap"),
              (binning.ignored, torch.bool, "ignored"), (outlier, torch.bool, "outlier")]
    if order is not None:
        fields.append((order, torch.int64, "order"))
    for t, dtype, name in fields:
        if t.dtype != dtype or t.shape != z.shape or t.device != z.device:
            raise ValueError(f"{name} must be {dtype} of z's shape and device")


def raster_columns_ordered(config: GroundGridConfig, binning: Binning, z, outlier, s,
                           order=None):
    """:func:`~groundgrid_torch.core.rasterize.raster_columns_ordered`:
    ``(cell, cols)``, the (P,) or (B, P) cell ids and the seven K1 columns
    at the points ``order`` names (int64 indices into each row; None: the
    points as they are). ``s``: the scan scalars, views on the points'
    device for the kernel."""
    if z.device.type == "cpu":
        return raster_columns_ordered_plain(config, binning, z, outlier, s, order)
    _check_columns_args(binning, z, outlier, order)
    if z.device.type != "cuda":
        raise RuntimeError(f"raster_columns_ordered: unsupported device {z.device}")
    base, stride = scalarlib.device_rows(s, z)
    cell = torch.empty(z.shape, dtype=torch.int32, device=z.device)
    cols = torch.empty((len(rasterlib.COLUMN_OPS), *z.shape), dtype=torch.float32,
                       device=z.device)
    if z.numel() == 0:
        return cell, list(cols.unbind(0))  # no points (a zero-block launch is invalid)
    inputs = [t.contiguous() for t in (binning.cell, binning.inmap, binning.ignored, outlier, z)]
    order = None if order is None else order.contiguous()
    code = _build.launch(
        "gg_raster_columns", z.device, None if order is None else order.data_ptr(),
        *(t.data_ptr() for t in inputs), z.shape[-1], math.prod(z.shape[:-1]),
        config.cell_count, base, stride, _resolution(config), cell.data_ptr(), cols.data_ptr())
    _build.check(code, "raster_columns_ordered")
    raster_columns_ordered.launches += 1
    return cell, list(cols.unbind(0))


raster_columns_ordered.launches = 0


def finish_layers(config: GroundGridConfig, partials, s, aux: bool = False) -> RasterLayers:
    """:func:`~groundgrid_torch.core.rasterize.finish_layers`: the raster
    layers from ``partials``, S shards' seven K1 columns each (N*N,) or (B,
    N*N), folded in shard order; with ``aux`` all of them, without the
    main path's three (None for the others). ``s``: the scan scalars, views
    on the columns' device."""
    first = partials[0][0]
    if first.device.type == "cpu":
        return finish_layers_plain(config, partials, s, aux)
    n = config.cell_count
    if first.dim() not in (1, 2) or first.shape[-1] != n * n:
        raise ValueError(f"columns must be (N*N,) or (B, N*N), got {tuple(first.shape)}")
    if not 1 <= len(partials) <= MAX_SHARDS:
        raise ValueError(f"1 to {MAX_SHARDS} shards, got {len(partials)}")
    cols = []
    for part in partials:
        if len(part) != len(rasterlib.COLUMN_OPS):
            raise ValueError(f"each shard holds {len(rasterlib.COLUMN_OPS)} columns")
        for c in part:
            if c.dtype != torch.float32 or c.shape != first.shape or c.device != first.device:
                raise ValueError("columns must be float32 of one shape and device")
            cols.append(c.contiguous())
    if first.device.type != "cuda":
        raise RuntimeError(f"finish_layers: unsupported device {first.device}")
    base, stride = scalarlib.device_rows(s, first)
    names = KERNEL_LAYERS if aux else MAIN_LAYERS
    out = torch.empty((len(names), *first.shape[:-1], n, n), dtype=torch.float32,
                      device=first.device)
    col_ptrs = (ctypes.c_void_p * len(cols))(*[c.data_ptr() for c in cols])
    code = _build.launch("gg_raster_finish", first.device, ctypes.addressof(col_ptrs),
                         len(partials), n, math.prod(first.shape[:-1]), base, stride,
                         _resolution(config), int(aux), out.data_ptr())
    _build.check(code, "finish_layers")
    finish_layers.launches += 1
    fields = dict(zip(names, out.unbind(0)))
    if aux:
        fields["mean_variance"] = fields["plane_dist"]
    return RasterLayers(**{name: fields.get(name) for name in ALL_LAYERS})


finish_layers.launches = 0
