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
as ``lax.top_k`` orders them. Both keys are unique int64s, so the
selection has no tie to break. The three per-sample table tests fold
into one monotone u32 key per cell.

What is not: the tier/peel lattice, the while loops, the 2-wide pair table
and the sort/unsort around the lattice lookups were TPU loop-cost and
gather workarounds. Here the fixed ``k_max`` buffer of the JAX package
(``outliers.py:225-246`` there) marches the whole (step x candidate)
lattice. A candidate with a zero budget never fires (``step^2 < 0`` is
false), so the padded buffer marks the outliers of the marchable ones
alone, and the march reads nothing back to the host.

:func:`detect_outliers` is three stages: the per-point budgets, keys and
ray directions (:func:`march_budget`), the candidate selection over the
keys (``ops/select.py select_candidates_plain``: the marchable points, or
the top keys past the cap, as a stable partition of the point indices),
and the march of the selected candidates along those directions
(:func:`march`) against the moved ground and groundpatch. The first and
the last are the plain versions of K6 and K7 (``ops/march.py``), the
selection that of K11 (``ops/select.py``); each fuses its chain into one
launch on the card, as XLA fuses it for the JAX package. K7 folds the
occlusion key of each cell it reads into the walk, where the plain march
builds the whole key table (:func:`occlusion_key_table`) and reads it
through K2's plain version, which takes unsorted cells.

A batch of vehicles, (B, P) points, (B, N, N) layers and (B, 1) scan
scalars, marches each row against its own grid: the selection takes each
row's top keys, the lattice is (B, steps, candidates); every row is
bitwise its vehicle's own march.
"""

from __future__ import annotations

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import exactf32
from groundgrid_torch.core import scalars as scalarlib
from groundgrid_torch.core.rasterize import Binning, ds_cells, take_points

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
    """3x3 SAME box sum over the last two axes, zero padding, added in
    row-major window order."""
    n0, n1 = x.shape[-2:]
    p = torch.nn.functional.pad(x, (1, 1, 1, 1))
    out = None
    for di in range(3):
        for dj in range(3):
            v = p[..., di:di + n0, dj:dj + n1]
            out = v if out is None else out + v
    return out


def occlusion_key_table(config: GroundGridConfig, ground, groundpatch):
    """Per-cell monotone occlusion key, (N*N,) u32 bits in an f32 tensor
    ((B, N*N) of (B, N, N) layers).

    key = mono(ground) where [3x3 confidence block sum > min_conf AND
    confidence > 0.01], else 0. The block sum uses the reference's low-side
    index clamp (GroundSegmentation.cpp:268): rows/cols 0..2 read the
    row/col-3 block sum. Stored as f32 bits so K2 reads it like any table.
    """
    box = box3_sum(groundpatch)
    box = torch.cat([box[..., 3:4, :].expand(*box.shape[:-2], 3, -1), box[..., 3:, :]], dim=-2)
    box = torch.cat([box[..., :, 3:4].expand(*box.shape[:-1], 3), box[..., :, 3:]], dim=-1)
    ok = (box > float(np.float32(config.min_outlier_detection_ground_confidence))) & (
        groundpatch > float(np.float32(0.01))
    )
    key = torch.where(ok, _mono_u32(ground), torch.zeros((), dtype=torch.int64,
                                                         device=ground.device))
    key = torch.where(key > 0x7FFFFFFF, key - (1 << 32), key)  # u32 -> i32 bits
    return key.to(torch.int32).view(torch.float32).flatten(-2)


def _ray(x, y, z, s):
    """(dx, dy, dz, length) of the rays from the origin (the scan scalars'
    ``ox, oy, oz``), f64-faithful."""
    dx = x - s.ox
    dy = y - s.oy
    dz = z - s.oz
    ssh, ssl = exactf32.sumsq3_ds(dx, dy, dz)
    return dx, dy, dz, exactf32.sqrt_rn_ds(ssh, ssl)


def selection_key(budget):
    """(P,) unique int64 keys whose descending order is the JAX package's
    candidate order over the nonnegative f32 ``budget`` (each row of a
    (B, P) batch keyed as its own).

    Up to ``2^IDX_BITS`` points: the truncated monotone budget | index
    (``outliers.py:235-246`` of the JAX package). Above: the exact budget's
    bits (monotone for nonnegative floats) over ``2^32 - 1 - index``, so
    equal budgets rank the lower index first, the order of its
    ``lax.top_k`` (``outliers.py:248``).
    """
    p_total = budget.shape[-1]
    idx = torch.arange(p_total, dtype=torch.int64, device=budget.device)
    if p_total <= 1 << IDX_BITS:
        return (_mono_u32(budget) & ~((1 << IDX_BITS) - 1)) | idx
    return (_u32_bits(budget) << 32) | (U32 - idx)


def march_budget(config: GroundGridConfig, s, binning: Binning, x, y, z, old_h):
    """``((P,) f32 budget, (P,) int64 key, (3, P) f32 directions)``: each
    point's march budget, its selection key (:func:`selection_key`) and its
    ray's unit direction ``(vx, vy, vz)`` where the budget is positive (0
    elsewhere); of a (B, P) batch, row by row ((3, B, P) directions).

    The budget is the squared ray length, f64-faithful, of an in-map,
    unignored point at least 0.2 m below the previous terrain (``old_h``,
    ``ground[cell]``) whose ray points down (``vz < -0.01``), else 0. Each
    direction is the ray's difference over its length, correctly rounded
    (``exactf32.div_rn``). The plain version of K6 (``ops/march.py``).
    ``s``: the scan scalars.
    """
    cand = binning.inmap & ~binning.ignored & (z < old_h - float(np.float32(0.2)))
    dxa, dya, dza, length = _ray(x, y, z, s)
    len2 = length * length
    vz = exactf32.div_rn(dza, length)
    zero = torch.zeros_like(len2)
    budget = torch.where(cand & (vz < float(np.float32(-0.01))), len2, zero)
    marchable = budget > 0
    dirs = torch.stack([torch.where(marchable, v, zero) for v in (
        exactf32.div_rn(dxa, length), exactf32.div_rn(dya, length), vz)])
    return budget, selection_key(budget), dirs


def march(config: GroundGridConfig, s, ground, groundpatch, pidx, budget, dirs, lookup_fn):
    """(P,) bool, True at the candidates ``pidx`` (unique point indices,
    (K,), or (B, K) of a (B, P) batch) whose line of sight crosses an
    occluding cell, False elsewhere.

    Marches the (steps x candidates) lattice, ``LATTICE_ELEMS`` elements a
    chunk, along each candidate's direction (``dirs``, :func:`march_budget`'s):
    a step is live while ``step^2 < budget``; a live sample inside the grid
    hits where its cell's key (:func:`occlusion_key_table` of ``ground`` and
    ``groundpatch``, the moved layers) reaches the monotone image of its
    height plus the tolerance. Key reads go through ``lookup_fn`` (K2 or
    its plain version). The plain version of K7 (``ops/march.py``).
    """
    n = config.cell_count
    batch = budget.shape[:-1]
    dev = budget.device
    key_table = occlusion_key_table(config, ground, groundpatch)
    out = torch.zeros(budget.shape, dtype=torch.bool, device=dev)
    k_max = pidx.shape[-1]
    tol = float(np.float32(config.outlier_tolerance))
    steps = torch.arange(3, config.ray_steps, dtype=torch.float32, device=dev)[:, None]
    # the lattice is (..., steps, candidates): the scan scalars broadcast
    # as the grid form, the per-candidate values as (..., 1, candidates)
    ox, oy, oz = (scalarlib.grid(v) for v in (s.ox, s.oy, s.oz))
    sh0, sl0, sh1, sl1 = (scalarlib.grid(v) for v in (s.sh0, s.sl0, s.sh1, s.sl1))
    chunk = max(1, LATTICE_ELEMS // max(1, steps.shape[0]))
    for start in range(0, k_max, chunk):
        cp = pidx[..., start:start + chunk]
        vx, vy, vz_c = (take_points(d, cp)[..., None, :] for d in dirs)
        within = steps * steps < take_points(budget, cp)[..., None, :]
        sx = ox + steps * vx
        sy = oy + steps * vy
        i0, i1 = ds_cells(config, sh0, sl0, sh1, sl1, sx, sy)
        inside = (i0 > 0) & (i1 > 0) & (i0 < n - 1) & (i1 < n - 1)
        flat = torch.clamp(i0, 0, n - 1) * n + torch.clamp(i1, 0, n - 1)
        thr = _mono_u32((steps * vz_c + oz) + tol)
        (vals,) = lookup_fn(flat.reshape(*batch, -1), [key_table], n * n)
        key_hit = _u32_bits(vals).reshape(flat.shape) >= thr
        out.scatter_(-1, cp, (within & inside & key_hit).any(dim=-2))  # cp: unique
    return out


def detect_outliers(config: GroundGridConfig, s, ground, groundpatch, binning: Binning, x, y,
                    z, budget_fn, select_fn, march_fn):
    """``((P,) bool, () int64)``: True for occluded-return outliers, and the
    number of marchable candidates (before the ``max_outlier_candidates``
    cap; 0 when the cap is 0) as a tensor on the points' device, unread.
    Of a (B, P) batch: ``((B, P) bool, (B,) int64)``, row by row.

    ``ground``/``groundpatch``: the previous scan's layers (after the move).
    ``s``: the scan scalars (the sensor origin and the binning constants,
    ``core/scalars.py``). ``budget_fn`` / ``select_fn`` / ``march_fn``:
    ``ops.march.march_budget`` (K6, which reads each point's ``ground[cell]``
    itself), ``ops.select.select_candidates`` (K11) and
    ``ops.march.march`` (K7), or their plain versions (K2's plain gather
    and :func:`march_budget`, ``select_candidates_plain``, and
    :func:`march` over the plain K2); ``budget_fn`` takes ``ground`` where
    :func:`march_budget` takes the gathered ``old_h``, and returns the
    outlier flags zeroed beside the budgets, keys and directions, which
    ``march_fn`` sets at the hits (given K11's marchable counts, past which
    no candidate marches), so the stage is three launches. ``select_fn(budget,
    key, k_max)`` picks the ``k_max`` candidates and counts the marchable
    points (the JAX package's sort or ``lax.top_k``: the same marchable
    set); the march reads the occlusion keys of ``ground`` and
    ``groundpatch`` (K7 cell by cell, the plain march through the whole
    key table).
    """
    p_total = x.shape[-1]
    batch = x.shape[:-1]
    k_max = min(config.max_outlier_candidates, p_total)
    if k_max == 0:
        return (torch.zeros(x.shape, dtype=torch.bool, device=x.device),
                torch.zeros(batch, dtype=torch.int64, device=x.device))
    budget, key, dirs, flags = budget_fn(config, s, binning, x, y, z, ground)
    # candidate selection: the JAX package's marchable buffer (every
    # marchable point, or past the cap those of the top k_max keys), padded
    # with zero budgets that never fire
    pidx, n_marchable = select_fn(budget, key, k_max)
    return march_fn(config, s, ground, groundpatch, pidx, budget, dirs, n_marchable,
                    flags), n_marchable
