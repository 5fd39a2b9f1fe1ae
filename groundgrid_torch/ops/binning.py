"""K5: the step's point binning in one launch (``csrc/binning.cu``).

Replaces what XLA fuses for the JAX package of its binning,
``groundgrid_tpu/core/rasterize.py:bin_points`` (``faithful_cells``, the ds
``ds_bin`` of ``core/exactf32.py`` on both axes): eager PyTorch runs that
chain as ~230 elementwise kernels a scan, the card runs it as one.

:func:`bin_points` launches the kernel for CUDA tensors and takes the plain
version, :func:`bin_points_plain` (``core/rasterize.py bin_points``), only
for CPU tensors. The two agree bitwise: the kernel rounds every operation
as its PyTorch kernel does, and the sorted-scan host prep sorts the points
by the plain version's ids. The kernel reads the scan scalars where they lie
(``scalars.device_rows``). A batch of vehicles, (B, P) points and (B,
``SIZE``) scan scalars, is one launch, each row bitwise its single call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import exactf32
from groundgrid_torch.core import scalars as scalarlib
from groundgrid_torch.core.rasterize import Binning
from groundgrid_torch.core.rasterize import bin_points as bin_points_plain
from groundgrid_torch.ops import _build

__all__ = ["bin_points", "bin_points_plain"]


def _check_args(x, y, rings, valid):
    if x.dim() not in (1, 2):
        raise ValueError(f"points must be (P,) or (B, P), got {tuple(x.shape)}")
    for t, dtype, name in ((x, torch.float32, "x"), (y, torch.float32, "y"),
                           (rings, torch.int32, "rings"), (valid, torch.bool, "valid")):
        if t.dtype != dtype or t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{name} must be {dtype} of the points' shape and device")


def bin_points(config: GroundGridConfig, s, x, y, rings, valid) -> Binning:
    """:func:`~groundgrid_torch.core.rasterize.bin_points` of (P,) or (B, P)
    points: each point's cell (f64-faithful), flat id, in-map and ignored
    flags and squared xy distance to the sensor. ``s``: the scan scalars,
    views on the points' device for the kernel."""
    if x.device.type == "cpu":
        return bin_points_plain(config, s, x, y, rings, valid)
    _check_args(x, y, rings, valid)
    if x.device.type != "cuda":
        raise RuntimeError(f"bin_points: unsupported device {x.device}")
    base, stride = scalarlib.device_rows(s, x)
    x, y, rings, valid = (t.contiguous() for t in (x, y, rings, valid))

    def empty(dtype):
        return torch.empty(x.shape, dtype=dtype, device=x.device)

    out = Binning(gi0=empty(torch.int32), gi1=empty(torch.int32), cell=empty(torch.int32),
                  inmap=empty(torch.bool), ignored=empty(torch.bool), sqdist=empty(torch.float32))
    if x.numel() == 0:
        return out  # no points (a zero-block launch is invalid)
    rh, rl, inv = exactf32.res_ds(config.resolution)
    code = _build.launch(
        "gg_bin", x.device, x.data_ptr(), y.data_ptr(), rings.data_ptr(), valid.data_ptr(),
        x.shape[-1], math.prod(x.shape[:-1]), base, stride, config.cell_count, float(rh),
        float(rl), float(inv), int(config.max_ring), float(np.float32(config.min_dist_squared)),
        *(t.data_ptr() for t in out))
    _build.check(code, "bin_points")
    bin_points.launches += 1
    return out


bin_points.launches = 0
