"""K8: the main path's detect stage (``csrc/detect_stage.cu``).

Replaces what XLA fuses of the JAX package's non-fused detection stage,
``groundgrid_tpu/core/detect.py:detect_ground_patches``: the 3x3 and 5x5
box sums and min-pools in row-major order, the ``use3`` select and the
branch ladder of GroundSegmentation.cpp:343-395, in one launch. Its plain
version is ``core/detect.py`` itself (``_update``), which stays the stage of
``use_pallas=False``; the kernel is bitwise it on the card. K4
(``ops/detect.py``) is the opt-in ``fused_detect`` form, which sums rows
then columns.

:func:`detect_stage` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors. With ``halo=2`` it is ``detect_block``:
the stencil inputs carry two ghost rows on each side of the output rows
(the spatial step's shards). A batch of grids, (B, R, N) layers with the
tables shared (the fleet's batched step), is one launch, each grid bitwise
its own.

The kernel gives each block a tile of ``TILE_H`` x ``TILE_W`` output cells
and stages their input rows and columns with a rim of 2 rows and 4
columns; each thread folds a strip of ``STRIP`` consecutive cells of a row
from registers, and reads its cells' tables as one 16-byte record each
(``DetectTables.records``). :func:`tile_plan` is the Python twin of that
split.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import detect as detectlib
from groundgrid_torch.core.detect import DetectTables
from groundgrid_torch.ops import _build
from groundgrid_torch.ops.detect import _constants

# the kernel's shape (detect_stage.cu kTileW, kTileH, kStrip)
TILE_W = 64
TILE_H = 8
STRIP = 2
THREADS = TILE_W // STRIP * TILE_H
STAGED = (TILE_H + 4) * (TILE_W + 8)
SHARED_BYTES = 4 * 4 * STAGED  # points, p*v, p*m, min_gh
HALOS = (0, detectlib.HALO)


class Block(NamedTuple):
    """One block of the kernel: its output cells ``rows x cols``, the
    input rows and columns it stages (clipped to the input; the rest of the
    staged tile holds the plain stage's pads) and its threads' strips, ``(row,
    cols)`` for each thread with a cell on the grid, in thread order."""

    rows: range
    cols: range
    staged_rows: range
    staged_cols: range
    strips: list[tuple[int, range]]


def tile_plan(rows: int, n: int, halo: int) -> list[Block]:
    """The kernel's split of ``rows`` output rows of an ``n``-column grid
    whose stencil inputs carry ``halo`` ghost rows a side, block by block
    and thread by thread, as ``detect_stage.cu`` computes it from
    ``blockIdx`` and ``threadIdx``."""
    blocks = []
    for r0 in range(0, rows, TILE_H):
        k0 = r0 + halo - 2
        for c0 in range(0, n, TILE_W):
            # thread t: row r0 + t // (TILE_W // STRIP), first column c0 + (t %
            # (TILE_W // STRIP)) * STRIP
            strips = [(r, range(first, min(first + STRIP, n)))
                      for r in range(r0, min(r0 + TILE_H, rows))
                      for first in range(c0, min(c0 + TILE_W, n), STRIP)]
            blocks.append(Block(
                range(r0, min(r0 + TILE_H, rows)), range(c0, min(c0 + TILE_W, n)),
                range(max(k0, 0), min(k0 + TILE_H + 4, rows + 2 * halo)),
                range(max(c0 - 4, 0), min(c0 + TILE_W + 4, n)), strips))
    return blocks


def _check_args(config, tables, stencil, ground, groundpatch, halo):
    if halo not in HALOS:
        raise ValueError(f"detect_stage: halo must be one of {HALOS}, got {halo}")
    n = config.cell_count
    if n < 5:
        raise ValueError(f"detect_stage needs n >= 5, got {n}")
    shape = tuple(ground.shape)
    if len(shape) not in (2, 3) or shape[-1] != n or shape[-2] < 1:
        raise ValueError(f"detect_stage: ground must be (R, {n}) or (B, R, {n}), got {shape}")
    if len(shape) == 3 and not 1 <= shape[0] <= 65535:
        raise ValueError(f"detect_stage: a batch of 1 to 65535 grids, got {shape[0]}")
    rows, dev = shape[-2], ground.device
    halod = shape[:-2] + (rows + 2 * halo, n)
    checks = ([(t, halod, torch.float32) for t in stencil]
              + [(t, shape, torch.float32) for t in (ground, groundpatch)]
              + [(t, (rows, n), torch.float32)
                 for t in (tables.var_thr_sq, tables.skip_thr, tables.min_expected_s)]
              + [(t, (rows, n), torch.bool) for t in (tables.use3, tables.interior)]
              + [(tables.records, (rows, n, 4), torch.int32)])
    for t, want, dtype in checks:
        if tuple(t.shape) != want or t.dtype != dtype or t.device != dev:
            raise ValueError(f"detect_stage: want {want} {dtype} on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device} (stencil inputs {halod}, "
                             f"ground and groundpatch {shape}, tables {(rows, n)})")


def detect_stage(config: GroundGridConfig, tables: DetectTables, points_h, variance_h, min_gh_h,
                 ground, groundpatch, halo: int = 0):
    """One detection sweep; returns new (ground, groundpatch).

    ``points_h``, ``variance_h``, ``min_gh_h``: (R + 2 halo, N) f32, or (B,
    R + 2 halo, N); ``ground``, ``groundpatch``: (R, N) or (B, R, N) f32;
    ``tables``: the output rows' (``core.detect.row_tables``), on the same
    device. ``halo`` 0 (the whole grid, R = N) or 2 (a row block,
    ``detect_block``). The inputs are not modified; the outputs are fresh
    tensors (the spiral writes into them).
    """
    stencil = (points_h, variance_h, min_gh_h)
    _check_args(config, tables, stencil, ground, groundpatch, halo)
    if ground.device.type == "cpu":
        return detectlib._update(config, tables, *stencil, ground, groundpatch, halo)
    if ground.device.type != "cuda":
        raise RuntimeError(f"detect_stage: unsupported device {ground.device}")
    ins = [t.contiguous() for t in (*stencil, ground, groundpatch, tables.records)]
    out_g, out_c = torch.empty_like(ins[3]), torch.empty_like(ins[4])
    pccvt, out_tol, ocpcf = _constants(config)
    batch = ground.shape[0] if ground.dim() == 3 else 1
    code = _build.launch("gg_detect_stage", ground.device, *(t.data_ptr() for t in ins),
                         ground.shape[-2], config.cell_count, halo, batch, pccvt, out_tol, ocpcf,
                         ocpcf * 2.0, out_g.data_ptr(), out_c.data_ptr())
    _build.check(code, "detect_stage")
    detect_stage.launches += 1
    return out_g, out_c


detect_stage.launches = 0
