"""K1: per-cell reductions over cell-sorted points (``csrc/raster.cu``).

Replaces ``groundgrid_tpu/ops/pallas_raster.py:raster_sums``. There, one-hot
MXU matmuls over bf16 3-way splits summed the columns, and min/max reached
the kernel as pre-reduced run-end columns. Here each column names its own
reduction, so sums, minima and maxima are all taken directly over each
cell's sorted run (see the kernel source for its bound on the card).

:func:`raster_reduce` launches the kernel for CUDA tensors and takes the
plain version, :func:`raster_reduce_plain`, only for CPU tensors.
"""

from __future__ import annotations

import torch

from groundgrid_torch.ops import _build

OPS = {"sum": 0, "min": 1, "max": 2}


def _check_args(cell, cols, ops, n2):
    if cell.dtype != torch.int32 or cell.dim() != 1:
        raise ValueError(f"cell must be (P,) int32, got {tuple(cell.shape)} {cell.dtype}")
    if len(cols) != len(ops) or not cols:
        raise ValueError("need one op per column and at least one column")
    if len(cols) > 16:
        raise ValueError("at most 16 columns")
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
    """
    if cell.device.type == "cpu":
        return raster_reduce_plain(cell, cols, ops, n2)
    _check_args(cell, cols, ops, n2)
    if cell.device.type != "cuda":
        raise RuntimeError(f"raster_reduce: unsupported device {cell.device}")
    lib = _build.library()
    cell = cell.contiguous()
    stacked = torch.stack(cols).contiguous()
    out = torch.empty((len(cols), n2), dtype=torch.float32, device=cell.device)
    mask = 0
    for j, op in enumerate(ops):
        mask |= OPS[op] << (2 * j)
    code = lib.lib.gg_raster_reduce(
        cell.data_ptr(), stacked.data_ptr(), cell.shape[0], len(cols), mask, n2,
        out.data_ptr(), _build.stream_ptr(cell.device),
    )
    _build.check(code, "raster_reduce")
    raster_reduce.launches += 1
    return tuple(out.unbind(0))


raster_reduce.launches = 0
