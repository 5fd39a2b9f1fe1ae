"""K4: fused ground-patch detection stencil (``csrc/detect.cu``).

Replaces ``groundgrid_tpu/ops/pallas_detect.py:detect_ground_patches_fused``,
the opt-in (``config.fused_detect``) form of the detection stage: the 3x3 and
5x5 box sums of points, points*variance and points*min_ground_height, the
min-pools of min_ground_height, the per-cell ``use3`` select and the branch
ladder of GroundSegmentation.cpp:343-395, in one pass over the grid.

:func:`detect_fused` launches the kernel for CUDA tensors and takes the plain
version, :func:`detect_fused_plain`, only for CPU tensors. The plain version
sums in the TPU kernel's order (rows, then columns, each left to right), so
on the card it agrees with the kernel bitwise. The non-fused stage,
``core/detect.py``, keeps the row-major order of the JAX package's XLA path.

The kernel gives each block a tile of ``TILE_W`` output columns and a strip
of rows, which it walks top down through a ring of staged rows.
:func:`strip_rows` picks the strip height for the grid (the kernel takes it
as an argument); :func:`tile_plan` is the Python twin of the split. A batch
of grids, (B, N, N) layers with the tables shared (the fleet's batched
step), is one launch with a grid axis over them, each grid bitwise its own
launch; the plain version runs the batch over its leading axes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core.detect import DetectTables
from groundgrid_torch.core.exactf32 import div_const
from groundgrid_torch.ops import _build


# the kernel's shape (detect.cu kTileW, kThreads, kRing, kUse3Words, kColVals)
TILE_W = 124
STAGED_COLS = TILE_W + 4
RING = 5
SHARED_BYTES = 4 * (RING * ((3 + 5) * STAGED_COLS + 32) + 10 * STAGED_COLS)
SHARED_LIMIT = 48 * 1024  # static shared memory: the launch sets no attribute


class Block(NamedTuple):
    """One block of the kernel: its output cells ``rows x cols`` (interior),
    the rows and columns it stages, and the ranges whose border cells it
    passes through (its rows and columns, widened to the grid's edges for
    the first and last tiles)."""

    rows: range
    cols: range
    staged_rows: range
    staged_cols: range
    owned_rows: range
    owned_cols: range


class TilePlan(NamedTuple):
    rows: int  # strip height, the kernel's ``rows`` argument
    grid: tuple[int, int]  # (column tiles, strips)
    blocks: list[Block]


def strip_rows(n: int) -> int:
    """Rows per block for an (n, n) grid: 2 up to n = 599, n // 200 above,
    at most 8. A block's rows run one after another, so short strips keep
    the serial chain short where the grid gives few blocks; on large grids
    longer strips stage fewer halo rows (the choice the card's timings
    favoured: PERF.md, section 6)."""
    return min(8, max(2, n // 200))


def tile_plan(n: int) -> TilePlan:
    """The kernel's split of an (n, n) grid, block by block, as ``detect.cu``
    computes it from ``blockIdx`` and the strip height."""
    if n < 5:
        raise ValueError(f"the detect stencil needs n >= 5, got {n}")
    rows = strip_rows(n)
    inner = n - 4
    gx, gy = -(-inner // TILE_W), -(-inner // rows)
    blocks = []
    for by in range(gy):
        r0 = 2 + by * rows
        r1 = min(r0 + rows, n - 2)
        for bx in range(gx):
            c0 = 2 + bx * TILE_W
            c1 = c0 + min(TILE_W, n - 2 - c0)
            blocks.append(Block(
                range(r0, r1), range(c0, c1), range(r0 - 2, r1 + 2),
                range(c0 - 2, min(c0 - 2 + STAGED_COLS, n)),
                range(0 if by == 0 else r0, n if by == gy - 1 else r1),
                range(0 if bx == 0 else c0, n if bx == gx - 1 else c1)))
    return TilePlan(rows, (gx, gy), blocks)


def _constants(config: GroundGridConfig):
    """(point-count variance threshold, outlier tolerance, ocpcf) as f32 values."""
    return (float(np.float32(config.point_count_cell_variance_threshold)),
            float(np.float32(config.outlier_tolerance)),
            float(np.float32(config.occupied_cells_point_count_factor)))


def _check_args(config, tables, layers):
    n = config.cell_count
    dev = layers[0].device
    shape = layers[0].shape
    if len(shape) not in (2, 3) or shape[-2:] != (n, n):
        raise ValueError(f"detect layers must be ({n}, {n}) or (B, {n}, {n}), got "
                         f"{tuple(shape)}")
    tabs = [tables.var_thr_sq, tables.skip_thr, tables.min_expected_s]
    for t, want in [(t, shape) for t in layers] + [(t, (n, n)) for t in tabs]:
        if t.shape != want or t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"detect layers {tuple(shape)} and tables ({n}, {n}) must be "
                             f"float32 on one device, got {tuple(t.shape)} {t.dtype} {t.device}")
    use3 = tables.use3
    if use3.shape != (n, n) or use3.dtype != torch.bool or use3.device != dev:
        raise ValueError(f"tables.use3 must be ({n}, {n}) bool on {dev}")


def _min_acc(acc, v):
    """``v < acc ? v : acc``, the kernel's min."""
    return torch.where(v < acc, v, acc)


def _rows(x, h: int, combine):
    """Rows r-h..r+h of every column, folded left to right, for r in [2, n-2)."""
    n = x.shape[-2]
    acc = x[..., 2 - h:n - 2 - h, :]
    for i in range(1, 2 * h + 1):
        acc = combine(acc, x[..., 2 - h + i:n - 2 - h + i, :])
    return acc


def _box(x, h: int):
    """Box sum over the (2h+1)^2 window of each interior cell: rows, then columns."""
    t = _rows(x, h, torch.add)
    n = t.shape[-1]
    acc = t[..., 2 - h:n - 2 - h]
    for j in range(1, 2 * h + 1):
        acc = acc + t[..., 2 - h + j:n - 2 - h + j]
    return acc


def _minpool(x, h: int):
    """Min-pool of each interior cell, the TPU kernel's column order:
    min(min(t[c-1], t[c]), t[c+1]), then min(min(t[c-2], .), t[c+2])."""
    t = _rows(x, h, _min_acc)
    n = t.shape[-1]

    def col(d):
        return t[..., 2 + d:n - 2 + d]

    m3 = _min_acc(_min_acc(col(-1), col(0)), col(1))
    return m3 if h == 1 else _min_acc(_min_acc(col(-2), m3), col(2))


def detect_fused_plain(config: GroundGridConfig, tables: DetectTables, points, variance,
                       min_gh, ground, groundpatch):
    """Plain PyTorch version of :func:`detect_fused`, bitwise the kernel's.

    Computes the interior cells [2, n-2)^2 only (an interior window never
    leaves the grid); every other cell passes through. Divisions by
    constants go through ``exactf32.div_const``, IEEE-rounded as the kernel's.
    """
    _check_args(config, tables, [points, variance, min_gh, ground, groundpatch])
    n = config.cell_count
    pccvt, out_tol, ocpcf = _constants(config)
    pv = points * variance
    pm = points * min_gh  # empty cells: 0 * FLT_MAX == 0
    inner = (..., slice(2, n - 2), slice(2, n - 2))
    use3 = tables.use3[inner]
    psum = torch.where(use3, _box(points, 1), _box(points, 2))
    pvsum = torch.where(use3, _box(pv, 1), _box(pv, 2))
    pmsum = torch.where(use3, _box(pm, 1), _box(pm, 2))
    localmin = torch.where(use3, _minpool(min_gh, 1), _minpool(min_gh, 2))

    g, cf = ground[inner], groundpatch[inner]
    process = psum >= tables.skip_thr[inner]
    safe = torch.clamp_min(psum, 1.0)
    max_var = torch.where(points[inner] >= pccvt, variance[inner], pvsum / safe)
    groundlevel = pmsum / safe

    ground_diff = torch.clamp_min((groundlevel - g) * (2.0 * cf), 1.0)
    guard = (cf > 0.5) & (groundlevel >= g + out_tol)
    branch1 = ((tables.var_thr_sq[inner] > max_var * max_var) & (max_var > 0)
               & (psum > ground_diff * tables.min_expected_s[inner]))
    new_c = torch.clamp_max(div_const(psum, ocpcf), 1.0)
    h1 = (groundlevel * new_c + cf * g * 2.0) / (new_c + cf * 2.0)
    c1 = torch.clamp_max(div_const(div_const(psum, ocpcf * 2.0) + cf, 2.0), 1.0)
    branch2 = localmin < g
    take1 = process & ~guard & branch1
    take2 = process & ~guard & ~branch1 & branch2

    out_g, out_c = ground.clone(), groundpatch.clone()
    out_g[inner] = torch.where(take1, h1, torch.where(take2, localmin, g))
    out_c[inner] = torch.where(
        take1, c1, torch.where(take2, torch.clamp_max(cf + float(np.float32(0.1)), 0.5), cf))
    return out_g, out_c


def detect_fused(config: GroundGridConfig, tables: DetectTables, points, variance, min_gh,
                 ground, groundpatch):
    """One fused detection sweep; returns new (ground, groundpatch).

    All layers (N, N) float32 on one device, or all (B, N, N), one grid a
    vehicle; ``tables`` from ``core.detect.make_tables`` on the same device.
    The inputs are not modified; the outputs are fresh tensors (the spiral
    writes into them).
    """
    if points.device.type == "cpu":
        return detect_fused_plain(config, tables, points, variance, min_gh, ground,
                                  groundpatch)
    layers = [points, variance, min_gh, ground, groundpatch]
    _check_args(config, tables, layers)
    if points.device.type != "cuda":
        raise RuntimeError(f"detect_fused: unsupported device {points.device}")
    n = config.cell_count
    pccvt, out_tol, ocpcf = _constants(config)
    ins = [t.contiguous() for t in layers + [tables.var_thr_sq, tables.skip_thr,
                                             tables.min_expected_s, tables.use3]]
    out_g, out_c = torch.empty_like(ins[3]), torch.empty_like(ins[4])
    batch = points.shape[0] if points.dim() == 3 else 1
    code = _build.launch("gg_detect", points.device, *(t.data_ptr() for t in ins), n, batch,
                         pccvt, out_tol, ocpcf, out_g.data_ptr(), out_c.data_ptr(),
                         strip_rows(n))
    _build.check(code, "detect_fused")
    detect_fused.launches += 1
    return out_g, out_c


detect_fused.launches = 0
