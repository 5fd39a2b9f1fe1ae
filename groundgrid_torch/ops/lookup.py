"""K2: per-point table lookups (``csrc/lookup.cu``).

Replaces ``groundgrid_tpu/ops/pallas_lookup.py:sorted_lookup``, whose
per-group tile loops existed because the TPU has no fast per-element
gather. On the card it is one gather launch for one or two tables.

A batch of vehicles, (B, P) ids and each table (B, N, N) or (B, N*N)
(the fleet's batched step), is one launch too: each row reads its own
vehicle's tables, bitwise its single call.

:func:`lookup` launches the kernel for CUDA tensors and takes the plain
version, :func:`lookup_plain`, only for CPU tensors. Both copy table words
bit for bit (the occlusion key table is a u32 key stored as f32 bits).
"""

from __future__ import annotations

import math

import torch

from groundgrid_torch.ops import _build


def _check_args(cell, tables, n2):
    if cell.dtype != torch.int32 or cell.dim() not in (1, 2):
        raise ValueError(f"cell must be (P,) or (B, P) int32, got {tuple(cell.shape)} "
                         f"{cell.dtype}")
    if not 1 <= len(tables) <= 2:
        raise ValueError("lookup takes one or two tables")
    words = math.prod(cell.shape[:-1]) * n2
    for t in tables:
        if t.dtype != torch.float32 or t.numel() != words or t.device != cell.device or (
                cell.dim() == 2 and t.shape[0] != cell.shape[0]):
            raise ValueError(f"tables must hold n2={n2} float32 values (per vehicle of a "
                             f"batch) on the cell device")


def lookup_plain(cell, tables, n2: int):
    """Plain PyTorch version of :func:`lookup` (an integer-word gather, row
    by row for a batch)."""
    _check_args(cell, tables, n2)
    ok = (cell >= 0) & (cell < n2)
    idx = torch.where(ok, cell, torch.zeros_like(cell)).to(torch.int64)
    outs = []
    for t in tables:
        words = t.reshape(*cell.shape[:-1], n2).view(torch.int32)
        words = torch.take_along_dim(words, idx, dim=-1)
        outs.append(torch.where(ok, words, torch.zeros_like(words)).view(torch.float32))
    return tuple(outs)


def lookup(cell, tables, n2: int):
    """``out[c][p] = tables[c].flat[cell[p]]`` for one or two float32 tables.

    ``cell``: (P,) int32; ids outside [0, n2) (the overflow bin n2) read 0.0.
    Correct for unsorted ids; sorted ids only make the reads more local. Or
    a batch: (B, P) ids and tables of B vehicles' n2 values each, row b
    reading vehicle b's. Returns a tuple of float32 tensors of ``cell``'s
    shape.
    """
    if cell.device.type == "cpu":
        return lookup_plain(cell, tables, n2)
    _check_args(cell, tables, n2)
    if cell.device.type != "cuda":
        raise RuntimeError(f"lookup: unsupported device {cell.device}")
    cell = cell.contiguous()
    tabs = [t.contiguous() for t in tables]
    outs = [torch.empty(cell.shape, dtype=torch.float32, device=cell.device) for _ in tabs]
    batch = cell.shape[0] if cell.dim() == 2 else 1
    if cell.numel() == 0:
        return tuple(outs)  # nothing to read (a zero-block launch is invalid)
    t1 = tabs[1].data_ptr() if len(tabs) > 1 else None
    o1 = outs[1].data_ptr() if len(outs) > 1 else None
    code = _build.launch("gg_lookup", cell.device, cell.data_ptr(), cell.shape[-1], batch,
                         tabs[0].data_ptr(), t1, n2, n2, outs[0].data_ptr(), o1)
    _build.check(code, "lookup")
    lookup.launches += 1
    return tuple(outs)


lookup.launches = 0
