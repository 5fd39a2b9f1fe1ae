"""K3: spiral terrain interpolation (``csrc/spiral.cu``).

Replaces ``groundgrid_tpu/ops/pallas_spiral.py:spiral_interpolation_pallas``;
the plain version :func:`spiral_interpolation_plain` is the torch port of
``groundgrid_tpu/core/interpolate.py`` (the XLA form), and is the written
spec of the kernel: the walk of GroundSegmentation.cpp:398-465, rings inner
-> outer, four segments per ring in walk order, each segment's heights the
affine recurrence ``h[y] = a[y] + b[y] * h[y-1]``.

On the card the kernel is bound by the walk's serial chain, m - 1 rings
(180 at 364^2) in one thread block, not by its 2.1 MB of HBM traffic (~0.6
us at 3.35 TB/s). It keeps a ring band in shared memory, the three rings a
3x3 stencil on ring ``D`` reads (D-1, D, D+1), each in the slot order of
:func:`ring_slot` / :func:`slot_cell` (the twins of the ``.cu``'s), so that
no stencil read or write on the chain leaves the SM; memory warps store
each finished ring and fetch the ring two ahead into the buffer of the ring
the walkers have just read; and all four segments of a ring are solved by
one warp-shuffle affine scan over coefficients kept in registers, with the
few visits that read an earlier segment's cells redone around it (their
ring D-1 cells, :func:`junction_cells`, cached before that ring's buffer is
refilled). :func:`band_layout` sizes the launch: ``8 (3 (8 m + 1) + 9) +
4 * 192`` bytes of shared memory (m = n // 2 - 1); a block holds at most
232,448, so the band takes grids up to 2415 cells a side.

Above that, :func:`spiral_variant` picks ``csrc/spiral_global.cu``: the same
walk in one block with the layers in global memory / L2, one segment at a
time (coefficients, a Hillis-Steele scan, the write-back), its three
per-segment arrays in shared memory or, where they do not fit a block
(:func:`global_layout`), in a global scratch buffer. So every grid that fits
in device memory runs on the card.

:func:`spiral_interpolation` launches the kernel for CUDA tensors and takes
the plain version only for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.ops import _build

FLT_TINY = float(np.finfo(np.float32).tiny)


# the kernel's launch (csrc/spiral.cu): shared memory a block can hold on
# Hopper, the memory warps' threads, the (height, confidence) pairs after
# the three ring buffers (the center, the junction cache), the scratch
# floats (the scan's warp totals, the junction exchange, two rings' segment
# plans), the visits a walker keeps in registers
SMEM_LIMIT = 232_448
MEM_THREADS = 128
BAND_EXTRA = 9
SCRATCH_FLOATS = 192
MAX_PER_THREAD = 12


def ring_slot(dr: int, dc: int, d: int) -> int:
    """Slot of the cell ``(dr, dc)`` from the center on its ring ``d``.

    Clockwise from the top-left corner: top row (dc -d .. d-1), right column
    (dr -d .. d-1), bottom row (dc d .. -d+1), left column (dr d .. -d+1);
    ``8 d`` slots, the center's 0. The band also keeps slot ``8 d``, a copy
    of slot 0 (the top-left corner), so that the left column's run of slots
    does not wrap. The inverse of :func:`slot_cell`.
    """
    if dr == -d and dc < d:
        return dc + d
    if dc == d and dr < d:
        return 3 * d + dr
    if dr == d and dc > -d:
        return 5 * d - dc
    return 7 * d - dr


def slot_cell(s: int, d: int, m: int) -> tuple[int, int]:
    """Grid cell (row, column) of slot ``s`` on ring ``d`` around ``(m, m)``:
    the twin of ``slot_cell`` in the ``.cu``."""
    lo, hi = m - d, m + d
    if s < 2 * d:
        return lo, lo + s
    if s < 4 * d:
        return lo + s - 2 * d, hi
    if s < 6 * d:
        return hi, hi - (s - 4 * d)
    return hi - (s - 6 * d), lo


# a segment's line of ring D: slot a + s*j at walk position j, s = +1 for
# top and bottom, -1 for left and right; the outer line (ring D+1) starts
# SEGMENT_DIST[kind] slots past the own line's a, the inner line (ring D-1)
# as far before it. SEGMENT_SPECIAL: (r, alpha, beta) of the cells that
# leave their line's run (own j = -1, L; inner j = -1, 0, L-1, L), slot
# alpha*D + beta on ring D + r. Twins of kDist and kSpecial in the .cu.
SEGMENT_DIST = (1, 7, 5, 3)
SEGMENT_SPECIAL = (
    ((1, 8, 7), (0, 2, 0), (1, 8, 6), (0, 8, -1), (-1, 2, -2), (0, 2, 1)),
    ((1, 0, 1), (0, 6, 0), (1, 0, 2), (0, 0, 1), (-1, 6, -6), (0, 6, -1)),
    ((1, 4, 3), (1, 6, 7), (1, 4, 2), (0, 4, -1), (0, 6, 1), (1, 6, 8)),
    ((1, 4, 5), (1, 2, 1), (1, 4, 6), (0, 4, 1), (0, 2, -1), (1, 2, 0)),
)


def stencil_slots(d: int, kind: int, k: int) -> list[tuple[int, int]]:
    """(ring, slot) of the nine cells that visit ``k`` of segment ``kind``
    (0 top, 1 left, 2 bottom, 3 right) of ring ``d`` reads, as the kernel
    addresses them: lines f-1, f, f+1, each at the walk predecessor, the
    cell and the successor. Slot ``8 r`` of ring r is the corner copy of 0."""
    length = 2 * d + 1 if kind >= 2 else 2 * d
    step = -1 if kind & 1 else 1
    a_own = (0, 8 * d, 4 * d, 4 * d)[kind]
    dist = SEGMENT_DIST[kind]
    special = [(d + r, alpha * d + beta) for r, alpha, beta in SEGMENT_SPECIAL[kind]]

    def own(j):
        return {-1: special[0], length: special[1]}.get(j, (d, a_own + step * j))

    def outer(j):
        return d + 1, a_own + dist + step * j

    def inner(j):
        ends = {-1: special[2], 0: special[3], length - 1: special[4], length: special[5]}
        return ends.get(j, (d - 1, a_own - dist + step * j))

    before, after = (inner, outer) if kind >= 2 else (outer, inner)  # lines f-1, f+1
    return [line(j) for line in (before, own, after) for j in (k - 1, k, k + 1)]


# the junction cache: pair p holds inner-line positions j0, j0 + 1 of
# segment JUNCTION_KIND[p], read by the redone visits of its start (p 0, 1:
# positions 0, 1) or end (p 2, 3: positions L-2, L-1). Twin of kJunctionKind.
JUNCTION_KIND = (1, 3, 2, 3)


def junction_visits(d: int, p: int) -> tuple[int, int]:
    """Walk positions of segment ``JUNCTION_KIND[p]`` that warp 0 redoes."""
    return (0, 1) if p < 2 else (2 * d - 1, 2 * d)


def junction_cells(d: int, p: int) -> list[tuple[int, int]]:
    """(ring, slot) of the two inner-line cells junction pair ``p`` of ring
    ``d`` caches: positions 1, 2 (p 0, 1) or L-3, L-2 (p 2, 3)."""
    kind = JUNCTION_KIND[p]
    step = -1 if kind & 1 else 1
    a_inner = (0, 8 * d, 4 * d, 4 * d)[kind] - SEGMENT_DIST[kind]
    j0 = 1 if p < 2 else 2 * d - 2
    return [(d - 1, a_inner + step * j) for j in (j0, j0 + 1)]


def ring_walk(m: int, d: int) -> list[tuple[int, int]]:
    """The cells of ring ``d`` in walk order, 8 d + 2 visits: top row ->,
    left column v, bottom row <-, right column ^ (``spiral_interpolation_plain``)."""
    i, outer = m - d, m + d
    top = [(i, y) for y in range(i, outer)]
    left = [(y, i) for y in range(i, outer)]
    bottom = [(outer, y) for y in range(outer, i - 1, -1)]
    right = [(y, outer) for y in range(outer, i - 1, -1)]
    return top + left + bottom + right


def _band_smem_bytes(n: int) -> int:
    stride = 8 * max(n // 2 - 1, 0) + 1
    return 8 * (3 * stride + BAND_EXTRA) + 4 * SCRATCH_FLOATS


def spiral_variant(n: int) -> str:
    """``"band"`` where the ring band of an ``n``-cell grid fits one block's
    shared memory (n <= 2415), else ``"global"``."""
    return "band" if _band_smem_bytes(n) <= SMEM_LIMIT else "global"


class BandLayout(NamedTuple):
    """The kernel's launch geometry for an ``n``-cell grid."""

    threads: int  # one block: the walkers, then MEM_THREADS memory threads
    stride: int  # cells per band buffer: 8 m + 1, the largest ring and its corner copy
    smem_bytes: int  # 3 buffers and BAND_EXTRA (height, confidence) pairs; scratch
    per_thread: int  # visits of ring m-1, the largest walked, per walker


def band_layout(n: int) -> BandLayout:
    """Threads and shared-memory bytes of the K3 launch; ``ValueError`` where
    the band does not fit one block's shared memory (n above 2415)."""
    m = max(n // 2 - 1, 0)
    stride = 8 * m + 1
    visits = max(8 * m - 6, 1)  # ring m-1, the largest walked
    walkers = min(1024 - MEM_THREADS, -(-visits // 32) * 32)
    smem = _band_smem_bytes(n)
    if smem > SMEM_LIMIT:
        raise ValueError(f"spiral_interpolation: a {n}^2 grid needs a {smem}-byte ring band; "
                         f"one block holds {SMEM_LIMIT} bytes (n <= 2415)")
    return BandLayout(walkers + MEM_THREADS, stride, smem, -(-visits // walkers))


class GlobalLayout(NamedTuple):
    """The launch geometry of the global-band variant for an ``n``-cell grid."""

    threads: int  # one block, one thread per segment cell up to 1024
    smem_bytes: int  # the scan's 2 floats per thread (+ 3 n floats unless scratch)
    scratch_floats: int  # 3 n where the per-segment arrays leave shared memory, else 0


def global_layout(n: int) -> GlobalLayout:
    """Threads, shared-memory bytes and global scratch of the global-band
    variant: the per-segment arrays (a, b, confidence) stay in shared memory
    where ``3 n + 2 threads`` floats fit a block (n up to 18,688)."""
    threads = min(1024, -(-max(n, 1) // 32) * 32)
    scan = 4 * 2 * threads
    if scan + 4 * 3 * n <= SMEM_LIMIT:
        return GlobalLayout(threads, scan + 4 * 3 * n, 0)
    return GlobalLayout(threads, scan, 3 * n)


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
    consts = (n, config.center_cell, float(np.float32(base_z)),
              float(np.float32(config.resolution ** 2)),
              float(np.float32(config.occupied_cells_decrease_factor)),
              float(np.float32(config.min_dist_squared)), float(np.float32(0.001)))
    stream = _build.stream_ptr(ground.device)
    variant = spiral_variant(n)
    if variant == "band":
        layout = band_layout(n)
        code = lib.lib.gg_spiral(ground.data_ptr(), groundpatch.data_ptr(), *consts,
                                 layout.threads, layout.smem_bytes, stream)
    else:
        glayout = global_layout(n)
        scratch = (torch.empty(glayout.scratch_floats, dtype=torch.float32,
                               device=ground.device) if glayout.scratch_floats else None)
        code = lib.lib.gg_spiral_global(
            ground.data_ptr(), groundpatch.data_ptr(), *consts, glayout.threads,
            glayout.smem_bytes, None if scratch is None else scratch.data_ptr(), stream)
    _build.check(code, "spiral_interpolation")
    spiral_interpolation.launches += 1
    if variant == "global":
        spiral_interpolation.global_launches += 1
    return ground, groundpatch


# launches of either variant; global_launches: those of the global-band one
spiral_interpolation.launches = 0
spiral_interpolation.global_launches = 0
