"""K1: per-cell reductions over cell-sorted points (``csrc/raster.cu``).

Replaces ``groundgrid_tpu/ops/pallas_raster.py:raster_sums``. There, one-hot
MXU matmuls over bf16 3-way splits summed the columns, and min/max reached
the kernel as pre-reduced run-end columns. Here each column names its own
reduction, so sums, minima and maxima are all taken directly over each
cell's sorted run, in point order (see the kernel source for its bound on
the card).

The kernel splits the work by a merge path over points and cells: block b
takes ``TILE`` items of the order "cell c's points, then c's end", so at
most ``TILE`` points and cells (a fixed point count would leave a block in
the sparse far field thousands of empty cells to write). It folds each run
that starts among its points (one thread per run and column, the run's
continuation past its points staged too) and writes zeros in the empty
cells whose ends it holds. :func:`tile_plan` is the Python twin of that
split.

:func:`raster_reduce` launches the kernel for CUDA tensors and takes the
plain version, :func:`raster_reduce_plain`, only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from groundgrid_torch.ops import _build

OPS = {"sum": 0, "min": 1, "max": 2}
MAX_COLS = 16
# points and cells per block of the kernel (raster.cu kTile)
TILE = 1024


def _check_args(cell, cols, ops, n2):
    if cell.dtype != torch.int32 or cell.dim() != 1:
        raise ValueError(f"cell must be (P,) int32, got {tuple(cell.shape)} {cell.dtype}")
    if len(cols) != len(ops) or not cols:
        raise ValueError("need one op per column and at least one column")
    if len(cols) > MAX_COLS:
        raise ValueError(f"at most {MAX_COLS} columns")
    for c in cols:
        if c.dtype != torch.float32 or c.shape != cell.shape or c.device != cell.device:
            raise ValueError("columns must be (P,) float32 on the cell tensor's device")
    bad = [o for o in ops if o not in OPS]
    if bad:
        raise ValueError(f"unknown ops {bad}; expected {sorted(OPS)}")
    if n2 <= 0:
        raise ValueError("n2 must be positive")


def raster_reduce_plain(cell, cols, ops, n2: int):
    """Plain PyTorch version of :func:`raster_reduce`, bitwise the kernel's.

    Walks all runs at once, one run position per step: step ``k`` folds the
    ``k``-th point of every run longer than ``k`` into that run's
    accumulators, so each sum is taken in point order from 0.0 and each
    min/max keeps the earlier value on ties, exactly as the kernel's loop.
    Costs one step per point of the longest run.
    """
    _check_args(cell, cols, ops, n2)
    lengths = torch.bincount(cell.to(torch.int64), minlength=n2 + 1)[:n2]
    starts = torch.cumsum(lengths, 0) - lengths
    vals = torch.stack(cols)  # (k, P)
    p = vals.shape[1]
    code = torch.tensor([OPS[o] for o in ops], device=cell.device)[:, None]
    acc = torch.zeros((len(cols), n2), dtype=torch.float32, device=cell.device)
    for k in range(int(lengths.max())):
        active = lengths > k
        v = vals[:, (starts + k).clamp(max=max(p - 1, 0))]
        folded = torch.where(code == 0, acc + v,
                             torch.where(code == 1, torch.where(v < acc, v, acc),
                                         torch.where(v > acc, v, acc)))
        if k == 0:  # min/max start from the run's first value
            folded = torch.where(code == 0, folded, v)
        acc = torch.where(active, folded, acc)
    return tuple(acc.unbind(0))


class Tile(NamedTuple):
    """What block ``b`` of the K1 launch does (:func:`tile_plan`)."""

    start: int  # its points [start, end)
    end: int
    cells: tuple[int, int]  # the cells [lo, hi) whose ends it holds: it zeroes the empty ones
    runs: tuple[tuple[int, int, int], ...]  # (cell, first, stop): the runs it folds


def tile_plan(cell, n2: int, tile: int = TILE) -> list[Tile]:
    """The Python twin of the kernel's split of (P,) nondecreasing ids.

    In the merged order of points and cell ends (cell c's points, then its
    end: point p at ``p + cell[p]``), block b takes the items ``[b tile,
    (b+1) tile)``: the points ``[i_b, i_{b+1})``, ``i_b`` the number of
    points before item ``b tile``, and the cell ends ``[j_b, j_{b+1})``,
    ``j_b = b tile - i_b``. A run belongs to the block holding its first
    point (p = 0 or ``cell[p-1] != cell[p]``) and is folded from there to
    its end, past the block if it goes on (``stop``); a run of the overflow
    id n2 is not folded. The block writes 0 in the cells of ``[j_b,
    j_{b+1})`` that hold no point. Ids outside [0, n2] count as n2.
    """
    cell = np.asarray(cell, np.int64)
    cell = np.where((cell >= 0) & (cell < n2), cell, n2)
    p = cell.shape[0]
    items = p + n2
    bounds = np.minimum(np.arange(-(-items // tile) + 1) * tile, items)
    first = np.searchsorted(np.arange(p) + cell, bounds)  # the points before each bound
    head = np.ones(p, bool)  # a run starts at p
    head[1:] = cell[1:] != cell[:-1]
    # run_stop[q]: one past the last point of the run holding point q
    ends = np.concatenate([np.flatnonzero(head)[1:], [p]])
    run_stop = ends[np.searchsorted(ends, np.arange(p), side="right")]
    plan = []
    for b in range(bounds.size - 1):
        start, end = int(first[b]), int(first[b + 1])
        heads = start + np.flatnonzero(head[start:end])
        runs = tuple((int(cell[q]), int(q), int(run_stop[q])) for q in heads if cell[q] < n2)
        plan.append(Tile(start, end, (int(bounds[b] - start), int(bounds[b + 1] - end)), runs))
    return plan


def raster_reduce(cell, cols, ops, n2: int):
    """Per-cell reductions of (P,) columns over points sorted by cell id.

    Args:
      cell: (P,) int32 flat cell ids, **nondecreasing**, in [0, n2]; id n2
        is the overflow/padding bin and is dropped.
      cols: list of (P,) float32 columns.
      ops: one of "sum", "min", "max" per column.
      n2: number of real cells.

    Returns a tuple of (n2,) float32 tensors. Cells without points read 0.
    Sums are taken in point order within each cell; min and max are exact.
    The kernel reads each column where it lies (no stacked copy).
    """
    if cell.device.type == "cpu":
        return raster_reduce_plain(cell, cols, ops, n2)
    _check_args(cell, cols, ops, n2)
    if cell.device.type != "cuda":
        raise RuntimeError(f"raster_reduce: unsupported device {cell.device}")
    out = torch.empty((len(cols), n2), dtype=torch.float32, device=cell.device)
    if cell.numel() == 0:
        return tuple(out.zero_().unbind(0))  # no points: every cell empty, no launch
    lib = _build.library()
    cell = cell.contiguous()
    cols = [c.contiguous() for c in cols]
    ptrs = (ctypes.c_void_p * MAX_COLS)(*[c.data_ptr() for c in cols])
    mask = 0
    for j, op in enumerate(ops):
        mask |= OPS[op] << (2 * j)
    code = lib.lib.gg_raster_reduce(
        cell.data_ptr(), ctypes.addressof(ptrs), cell.shape[0], len(cols), mask, n2,
        out.data_ptr(), _build.stream_ptr(cell.device),
    )
    _build.check(code, "raster_reduce")
    raster_reduce.launches += 1
    return tuple(out.unbind(0))


raster_reduce.launches = 0
