"""Occlusion-based outlier rejection (PyTorch).

The torch counterpart of ``groundgrid_tpu/core/outliers.py``, the
replacement of the per-point while loop in ``GroundSegmentation::
insert_cloud`` (``GroundSegmentation.cpp:242-275``): points >= 0.2 m below
the previous terrain are traced from the sensor in whole-metre steps; if the
line of sight crosses a cell whose 3x3 confidence block sum exceeds
``min_outlier_detection_ground_confidence`` (and the cell's own confidence
and height tests pass), the point is an occluded-return outlier.

What is kept from the JAX package, exactly: the f64-faithful per-point
budget (ray length = correctly rounded f32 sqrt of the f64 sum of squares,
IEEE-rounded direction, the oracle's ``step^2 < fl32(length^2)`` loop test),
the ``max_outlier_candidates`` cap, and the selection keys, so overflow
sheds the same candidates: up to 2^17 points, the truncated 15-bit monotone
budget in the high bits and the point index in the low 17 (ties: the higher
index first); above, the exact budget, descending, ties to the lower index,
as ``lax.top_k`` orders them. Both keys are unique int64s, so
``torch.topk`` has no tie to break. The three per-sample table tests fold
into one monotone u32 key per cell.

What is not: the tier/peel lattice, the while loops, the 2-wide pair table
and the sort/unsort around the lattice lookups were TPU loop-cost and
gather workarounds. Here one host read fetches the active candidate count,
the buffered candidates march the whole (step x candidate) lattice, and
every key read goes through K2 (``ops/lookup.py``), which takes unsorted
cells.
"""

from __future__ import annotations

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import exactf32
from groundgrid_torch.core.rasterize import Binning, faithful_cells

U32 = 0xFFFFFFFF
U32_TOP = 0x80000000
IDX_BITS = 17  # point index bits of the truncated selection key
# lattice elements per K2 read: the default geometry's full 8192-candidate
# lattice (93 steps) fits one read; larger caps march in chunks
LATTICE_ELEMS = 1 << 21


def _mono_u32(f):
    """Order-preserving f32 -> u32 (as int64): total order on non-NaN floats."""
    u = f.view(torch.int32).to(torch.int64) & U32
    return torch.where(f >= 0, u | U32_TOP, (~u) & U32)


def _u32_bits(f):
    """The 32 bits of an f32 tensor as a nonnegative int64."""
    return f.view(torch.int32).to(torch.int64) & U32


def box3_sum(x):
    """3x3 SAME box sum, zero padding, added in row-major window order."""
    n0, n1 = x.shape
    p = torch.nn.functional.pad(x, (1, 1, 1, 1))
    out = None
    for di in range(3):
        for dj in range(3):
            v = p[di:di + n0, dj:dj + n1]
            out = v if out is None else out + v
    return out


def occlusion_key_table(config: GroundGridConfig, ground, groundpatch):
    """Per-cell monotone occlusion key, (N*N,) u32 bits in an f32 tensor.

    key = mono(ground) where [3x3 confidence block sum > min_conf AND
    confidence > 0.01], else 0. The block sum uses the reference's low-side
    index clamp (GroundSegmentation.cpp:268): rows/cols 0..2 read the
    row/col-3 block sum. Stored as f32 bits so K2 reads it like any table.
    """
    box = box3_sum(groundpatch)
    box = torch.cat([box[3:4, :].expand(3, -1), box[3:]], dim=0)
    box = torch.cat([box[:, 3:4].expand(-1, 3), box[:, 3:]], dim=1)
    ok = (box > float(np.float32(config.min_outlier_detection_ground_confidence))) & (
        groundpatch > float(np.float32(0.01))
    )
    key = torch.where(ok, _mono_u32(ground), torch.zeros((), dtype=torch.int64,
                                                         device=ground.device))
    key = torch.where(key > 0x7FFFFFFF, key - (1 << 32), key)  # u32 -> i32 bits
    return key.to(torch.int32).view(torch.float32).reshape(-1)


def _ray(x, y, z, o):
    """(dx, dy, dz, length) of the rays from the origin, f64-faithful."""
    dx = x - float(o[0])
    dy = y - float(o[1])
    dz = z - float(o[2])
    ssh, ssl = exactf32.sumsq3_ds(dx, dy, dz)
    return dx, dy, dz, exactf32.sqrt_rn_ds(ssh, ssl)


def selection_key(budget):
    """(P,) unique int64 keys whose descending order is the JAX package's
    candidate order over the nonnegative f32 ``budget``.

    Up to ``2^IDX_BITS`` points: the truncated monotone budget | index
    (``outliers.py:235-246`` of the JAX package). Above: the exact budget's
    bits (monotone for nonnegative floats) over ``2^32 - 1 - index``, so
    equal budgets rank the lower index first, the order of its
    ``lax.top_k`` (``outliers.py:248``).
    """
    p_total = budget.shape[0]
    idx = torch.arange(p_total, dtype=torch.int64, device=budget.device)
    if p_total <= 1 << IDX_BITS:
        return (_mono_u32(budget) & ~((1 << IDX_BITS) - 1)) | idx
    return (_u32_bits(budget) << 32) | (U32 - idx)


def detect_outliers(config: GroundGridConfig, center, center_lo, ground, groundpatch,
                    binning: Binning, x, y, z, origin, old_h, lookup_fn):
    """``((P,) bool, int)``: True for occluded-return outliers, and the
    number of marchable candidates (before the ``max_outlier_candidates``
    cap; 0 when the cap is 0), which the one host read already fetched.

    ``ground``/``groundpatch``: the previous scan's layers (after the move).
    ``old_h``: per-point ``ground[cell]`` (K2). ``center``/``center_lo``/
    ``origin``: host f32. ``lookup_fn``: ``ops.lookup.lookup`` or its plain
    version.
    """
    n = config.cell_count
    p_total = x.shape[0]
    dev = x.device
    out = torch.zeros(p_total, dtype=torch.int32, device=dev)
    k_max = min(config.max_outlier_candidates, p_total)
    if k_max == 0:
        return out > 0, 0
    o = np.asarray(origin, np.float32)
    tol = float(np.float32(config.outlier_tolerance))

    cand = binning.inmap & ~binning.ignored & (z < old_h - float(np.float32(0.2)))
    _, _, dza, length = _ray(x, y, z, o)
    len2 = length * length
    vz = exactf32.div_rn(dza, length)
    budget = torch.where(cand & (vz < float(np.float32(-0.01))), len2, torch.zeros_like(len2))

    # candidate selection; a positive budget always outranks a zero one, so
    # the top min(k_max, #positive) keys are exactly the JAX package's
    # marchable buffer
    key = selection_key(budget)
    n_marchable = int((budget > 0).sum())  # the one host read
    n_act = min(n_marchable, k_max)
    if n_act == 0:
        return out > 0, n_marchable
    pidx = torch.topk(key, n_act, sorted=False).indices

    key_table = occlusion_key_table(config, ground, groundpatch)
    steps = torch.arange(3, config.ray_steps, dtype=torch.float32, device=dev)[:, None]
    chunk = max(1, LATTICE_ELEMS // max(1, steps.shape[0]))
    for start in range(0, n_act, chunk):
        cp = pidx[start:start + chunk]
        dx, dy, dz, clen = _ray(x[cp], y[cp], z[cp], o)
        vx = exactf32.div_rn(dx, clen)
        vy = exactf32.div_rn(dy, clen)
        vz_c = exactf32.div_rn(dz, clen)
        within = steps * steps < budget[cp][None, :]
        sx = float(o[0]) + steps * vx[None, :]
        sy = float(o[1]) + steps * vy[None, :]
        i0, i1 = faithful_cells(config, center, center_lo, sx, sy)
        inside = (i0 > 0) & (i1 > 0) & (i0 < n - 1) & (i1 < n - 1)
        flat = torch.clamp(i0, 0, n - 1) * n + torch.clamp(i1, 0, n - 1)
        thr = _mono_u32((steps * vz_c[None, :] + float(o[2])) + tol)
        (vals,) = lookup_fn(flat.reshape(-1), [key_table], n * n)
        key_hit = _u32_bits(vals).reshape(flat.shape) >= thr
        hit = (within & inside & key_hit).any(dim=0).to(torch.int32)
        out.scatter_reduce_(0, cp, hit, reduce="amax")
    return out > 0, n_marchable
