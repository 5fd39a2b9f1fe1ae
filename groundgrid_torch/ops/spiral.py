"""K3: spiral terrain interpolation (``csrc/spiral.cu``).

Replaces ``groundgrid_tpu/ops/pallas_spiral.py:spiral_interpolation_pallas``;
the plain version :func:`spiral_interpolation_plain` is the torch port of
``groundgrid_tpu/core/interpolate.py`` (the XLA form), and is the written
spec of the kernel: the walk of GroundSegmentation.cpp:398-465, rings inner
-> outer, four segments per ring in walk order, each segment's heights the
affine recurrence ``h[y] = a[y] + b[y] * h[y-1]``.

:func:`spiral_interpolation` launches the kernel for CUDA tensors and takes
the plain version only for CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.ops import _build

FLT_TINY = float(np.finfo(np.float32).tiny)


def _affine_scan(a, b):
    """h[y] = a[y] + b[y] * h[y-1], h[-1] := 0 (Hillis-Steele, log depth).

    Composition of maps h -> a + b*h; positions before the start compose
    with the identity (0, 1).
    """
    n = a.shape[0]
    d = 1
    while d < n:
        a_prev = torch.cat([a.new_zeros(d), a[:-d]])
        b_prev = torch.cat([b.new_ones(d), b[:-d]])
        a = a + b * a_prev
        b = b * b_prev
        d *= 2
    return a


def _segment_update(config: GroundGridConfig, h, c, fixed, lo, hi, transposed, descending):
    """One ring segment exactly as the sequential walk updates it.

    Row ``fixed`` (column when ``transposed``), cells [lo, hi), walked
    descending when ``descending``. Updates ``h``/``c`` in place.
    """
    n = config.cell_count
    c_idx = config.center_cell
    res2 = float(np.float32(config.resolution ** 2))
    dec = float(np.float32(config.occupied_cells_decrease_factor))
    dev = h.device

    h_view = h.t() if transposed else h
    c_view = c.t() if transposed else c
    bh = h_view[fixed - 1: fixed + 2].clone()
    bc = c_view[fixed - 1: fixed + 2].clone()

    ys = torch.arange(n, dtype=torch.int32, device=dev)
    in_seg = (ys >= lo) & (ys < hi)

    # confidence decay (GroundSegmentation.cpp:462-464): per cell, known
    # for the whole segment upfront
    fi = float(fixed - c_idx)
    yf = (ys - c_idx).to(torch.float32)
    d2 = (fi * fi + yf * yf) * res2
    decay_applies = d2 > float(np.float32(config.min_dist_squared))
    occ = bc[1]
    c_dec = torch.where(
        decay_applies, torch.clamp_min(occ - occ / dec, float(np.float32(0.001))), occ
    )
    c_new_row = torch.where(in_seg, c_dec, occ)

    if descending:
        bh, bc = bh.flip(-1), bc.flip(-1)
        in_seg_f, c_new_f, occ_f = in_seg.flip(-1), c_new_row.flip(-1), occ.flip(-1)
    else:
        in_seg_f, c_new_f, occ_f = in_seg, c_new_row, occ

    hh = bh[1]

    def left(x):  # value at the walk predecessor
        return torch.roll(x, 1, dims=-1)

    def right(x):  # walk successor
        return torch.roll(x, -1, dims=-1)

    w = bc * bh
    num_known = (
        left(w[0]) + w[0] + right(w[0])
        + left(w[2]) + w[2] + right(w[2])
        + w[1] + right(w[1])
    )
    den_known = (
        left(bc[0]) + bc[0] + right(bc[0])
        + left(bc[2]) + bc[2] + right(bc[2])
        + bc[1] + right(bc[1])
    )

    pred_in_seg = left(in_seg_f)
    c_pred = torch.where(pred_in_seg, left(c_new_f), left(bc[1]))
    den = den_known + c_pred + FLT_TINY

    zero = torch.zeros_like(occ_f)
    blend = torch.where(in_seg_f, 1.0 - occ_f, zero)
    b_coef = torch.where(pred_in_seg, blend * c_pred / den, zero)
    num_static = num_known + torch.where(pred_in_seg, zero, c_pred * left(bh[1]))
    a_coef = torch.where(in_seg_f, blend * num_static / den + occ_f * hh, hh)

    h_new = _affine_scan(a_coef, b_coef)
    if descending:
        h_new = h_new.flip(-1)
    h_view[fixed] = h_new
    c_view[fixed] = c_new_row


def spiral_interpolation_plain(config: GroundGridConfig, ground, groundpatch, base_z):
    """Plain PyTorch sweep, in place; returns (ground, groundpatch)."""
    c_idx = config.center_cell
    ground[c_idx, c_idx] = float(np.float32(base_z))
    groundpatch[c_idx, c_idx] = 1.0
    for i in range(c_idx - 1, 0, -1):
        outer = 2 * c_idx - i
        _segment_update(config, ground, groundpatch, i, i, outer, False, False)  # top ->
        _segment_update(config, ground, groundpatch, i, i, outer, True, False)  # left v
        _segment_update(config, ground, groundpatch, outer, i, outer + 1, False, True)  # bottom <-
        _segment_update(config, ground, groundpatch, outer, i, outer + 1, True, True)  # right ^
    return ground, groundpatch


def spiral_interpolation(config: GroundGridConfig, ground, groundpatch, base_z):
    """Center-outward sweep of the (N, N) float32 layers, in place.

    Seeds the center cell with ``base_z`` (the vehicle base height, a host
    float) at confidence 1, then walks rings ``center-1 .. 1``, updating
    ``ground`` and ``groundpatch`` where they lie (the JAX step donated these
    buffers). Returns the two given tensors.
    """
    n = config.cell_count
    for t in (ground, groundpatch):
        if t.shape != (n, n) or t.dtype != torch.float32:
            raise ValueError(f"layers must be ({n}, {n}) float32, got {tuple(t.shape)} {t.dtype}")
    if ground.device.type == "cpu":
        return spiral_interpolation_plain(config, ground, groundpatch, base_z)
    if ground.device.type != "cuda" or groundpatch.device != ground.device:
        raise RuntimeError(f"spiral_interpolation: unsupported device {ground.device}")
    if not (ground.is_contiguous() and groundpatch.is_contiguous()):
        raise ValueError("spiral_interpolation needs contiguous layers")
    lib = _build.library()
    code = lib.lib.gg_spiral(
        ground.data_ptr(), groundpatch.data_ptr(), n, config.center_cell,
        float(np.float32(base_z)), float(np.float32(config.resolution ** 2)),
        float(np.float32(config.occupied_cells_decrease_factor)),
        float(np.float32(config.min_dist_squared)), float(np.float32(0.001)),
        _build.stream_ptr(ground.device),
    )
    _build.check(code, "spiral_interpolation")
    spiral_interpolation.launches += 1
    return ground, groundpatch


spiral_interpolation.launches = 0
