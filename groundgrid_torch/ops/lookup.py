"""K2: per-point table lookups (``csrc/lookup.cu``).

Replaces ``groundgrid_tpu/ops/pallas_lookup.py:sorted_lookup``, whose
per-group tile loops existed because the TPU has no fast per-element
gather. On the card it is one gather launch for one or two tables.

:func:`lookup` launches the kernel for CUDA tensors and takes the plain
version, :func:`lookup_plain`, only for CPU tensors. Both copy table words
bit for bit (the occlusion key table is a u32 key stored as f32 bits).
"""

from __future__ import annotations

import torch

from groundgrid_torch.ops import _build


def _check_args(cell, tables, n2):
    if cell.dtype != torch.int32 or cell.dim() != 1:
        raise ValueError(f"cell must be (P,) int32, got {tuple(cell.shape)} {cell.dtype}")
    if not 1 <= len(tables) <= 2:
        raise ValueError("lookup takes one or two tables")
    for t in tables:
        if t.dtype != torch.float32 or t.numel() != n2 or t.device != cell.device:
            raise ValueError(f"tables must hold n2={n2} float32 values on the cell device")


def lookup_plain(cell, tables, n2: int):
    """Plain PyTorch version of :func:`lookup` (an integer-word gather)."""
    _check_args(cell, tables, n2)
    ok = (cell >= 0) & (cell < n2)
    idx = torch.where(ok, cell, torch.zeros_like(cell)).to(torch.int64)
    outs = []
    for t in tables:
        words = t.reshape(-1).view(torch.int32)[idx]
        outs.append(torch.where(ok, words, torch.zeros_like(words)).view(torch.float32))
    return tuple(outs)


def lookup(cell, tables, n2: int):
    """``out[c][p] = tables[c].flat[cell[p]]`` for one or two float32 tables.

    ``cell``: (P,) int32; ids outside [0, n2) (the overflow bin n2) read 0.0.
    Correct for unsorted ids; sorted ids only make the reads more local.
    Returns a tuple of (P,) float32 tensors.
    """
    if cell.device.type == "cpu":
        return lookup_plain(cell, tables, n2)
    _check_args(cell, tables, n2)
    if cell.device.type != "cuda":
        raise RuntimeError(f"lookup: unsupported device {cell.device}")
    cell = cell.contiguous()
    tabs = [t.contiguous() for t in tables]
    outs = [torch.empty(cell.shape, dtype=torch.float32, device=cell.device) for _ in tabs]
    if cell.numel() == 0:
        return tuple(outs)  # nothing to read (a zero-block launch is invalid)
    lib = _build.library()
    t1 = tabs[1].data_ptr() if len(tabs) > 1 else None
    o1 = outs[1].data_ptr() if len(outs) > 1 else None
    code = lib.lib.gg_lookup(
        cell.data_ptr(), cell.shape[0], tabs[0].data_ptr(), t1, n2,
        outs[0].data_ptr(), o1, _build.stream_ptr(cell.device),
    )
    _build.check(code, "lookup")
    lookup.launches += 1
    return tuple(outs)


lookup.launches = 0
