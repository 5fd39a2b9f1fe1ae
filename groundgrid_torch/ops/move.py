"""K12: the grid relocation (``csrc/move.cu``).

Replaces what XLA fuses of the JAX package's grid move,
``groundgrid_tpu/core/grid.py:143 move`` (``jnp.roll`` of both layers,
``exposed_mask``, ``cell_positions`` and the re-initialisation of the
exposed cells), which eager PyTorch runs as ~50 small kernels a scan; the
card runs one.

:func:`move` launches the kernel for CUDA tensors and takes the plain
version, ``core/grid.py move`` (:data:`move_plain`), only for CPU tensors;
the two agree bitwise: the kept cells' bits move as ``torch.roll`` moves
them (NaN and -0.0 too), and the exposed cells' base plane rounds every f32
operation as its PyTorch op does. The kernel reads the shift, the centre
and the base plane from the scan scalars where they lie
(``scalars.device_rows``), so a captured graph replays on any scan. A batch
of vehicles, (B, N, N) layers with (B, ``SIZE``) scan scalars, is one
launch, each grid moved by its own shift and plane, bitwise its single call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import grid as gridlib
from groundgrid_torch.core import scalars as scalarlib
from groundgrid_torch.ops import _build

move_plain = gridlib.move


def move(config: GroundGridConfig, ground, groundpatch, s):
    """``core/grid.py move``: the new ``(ground, groundpatch)`` of (N, N) or
    (B, N, N) float32 layers moved by the scan scalars ``s`` (views on the
    layers' device for the kernel); the inputs are untouched."""
    if ground.device.type == "cpu":
        return move_plain(config, ground, groundpatch, s)
    n = config.cell_count
    if (ground.dim() not in (2, 3) or ground.shape[-2:] != (n, n)
            or ground.dtype != torch.float32):
        raise ValueError(f"ground must be (N, N) or (B, N, N) float32 with N = {n}, got "
                         f"{tuple(ground.shape)} {ground.dtype}")
    if (groundpatch.dtype != torch.float32 or groundpatch.shape != ground.shape
            or groundpatch.device != ground.device):
        raise ValueError("groundpatch must be float32 of the ground's shape and device")
    if ground.device.type != "cuda":
        raise RuntimeError(f"move: unsupported device {ground.device}")
    base, stride = scalarlib.device_rows(s, ground.flatten(-2))
    ground, groundpatch = ground.contiguous(), groundpatch.contiguous()
    out_g, out_c = torch.empty_like(ground), torch.empty_like(groundpatch)
    if ground.numel() == 0:
        return out_g, out_c  # no grid (a zero-block launch is invalid)
    code = _build.launch("gg_move", ground.device, ground.data_ptr(), groundpatch.data_ptr(), n,
                         math.prod(ground.shape[:-2]), base, stride,
                         float(np.float32(config.half_length)),
                         float(np.float32(config.resolution)), out_g.data_ptr(),
                         out_c.data_ptr())
    _build.check(code, "move")
    move.launches += 1
    return out_g, out_c


move.launches = 0
