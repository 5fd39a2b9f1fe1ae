"""K6 and K7: the occlusion march in two launches (``csrc/march.cu``).

Replace what XLA fuses for the JAX package of its outlier rejection,
``groundgrid_tpu/core/outliers.py:detect_outliers``: K6 :func:`march_budget`
the per-point budgets, selection keys and ray directions, and the zeroed
outlier flags, before K11 (``ops/select.py``) picks the candidates (the
JAX package's sort or ``lax.top_k``),
reading each point's previous terrain ``ground[cell]`` from the moved
ground itself (the JAX step gathers it with its sorted-lookup kernel), and
K7 :func:`march` the walk of the selected candidates' rays over the grid,
with the occlusion key of each cell it reads computed from the moved
ground and groundpatch (the JAX package reads a key table through its
sorted-lookup kernel), setting the flags at the hits and ending at once for
the positions past K11's marchable count. Eager PyTorch runs the two chains
and the key table as ~1,480 elementwise kernels and two K2 launches a scan;
on the card the stage is the three launches K6, K11 and K7.

Each wrapper launches its kernel for CUDA tensors and takes its plain
version (:func:`march_budget_plain`, :func:`march_plain`: ``core/
outliers.py``'s ``march_budget`` after K2's plain gather of the old ground,
and ``march`` over the key table and K2's plain version) only for CPU
tensors. Kernel and plain
version agree bitwise: the kernels round every operation as its PyTorch
kernel does (``csrc/exactf32.cuh``). Both kernels read the scan scalars
where they lie (``scalars.device_rows``) and take a batch of vehicles, (B,
P) points, (B, K) candidates and (B, N, N) layers, in one launch, each row
bitwise its single call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import exactf32
from groundgrid_torch.core import outliers
from groundgrid_torch.core import scalars as scalarlib
from groundgrid_torch.core.rasterize import Binning
from groundgrid_torch.ops import _build
from groundgrid_torch.ops.lookup import lookup_plain

def march_budget_plain(config: GroundGridConfig, s, binning: Binning, x, y, z, ground):
    """Plain version of :func:`march_budget`: ``old_h``, ``ground[cell]``
    by K2's plain version, then ``core/outliers.py march_budget``, and the
    outlier flags, all False."""
    n2 = ground.shape[-2] * ground.shape[-1]
    (old_h,) = lookup_plain(binning.cell, [ground], n2)
    return (*outliers.march_budget(config, s, binning, x, y, z, old_h),
            torch.zeros(x.shape, dtype=torch.bool, device=x.device))


def march_plain(config: GroundGridConfig, s, ground, groundpatch, pidx, budget, dirs,
                n_marchable, flags):
    """Plain version of :func:`march`: ``core/outliers.py march``, its
    occlusion key table read through K2's plain version, set into
    ``flags``. It needs no ``n_marchable``: the candidates past it have
    zero budgets and never hit."""
    return flags.logical_or_(outliers.march(config, s, ground, groundpatch, pidx, budget, dirs,
                                            lookup_plain))


def _check_points(*tensors):
    x = tensors[0]
    if x.dim() not in (1, 2) or x.dtype != torch.float32:
        raise ValueError(f"points must be (P,) or (B, P) float32, got {tuple(x.shape)} {x.dtype}")
    for t in tensors[1:]:
        if t.shape != x.shape or t.device != x.device:
            raise ValueError("every per-point tensor must have the points' shape and device")


def march_budget(config: GroundGridConfig, s, binning: Binning, x, y, z, ground):
    """``(budget, key, dirs, flags)``: ``core/outliers.py march_budget`` of
    (P,) or (B, P) points, the f32 march budget and the unique int64
    selection key of every point, the (3, ...) f32 ray directions, defined
    where the budget is positive (the kernel writes nothing elsewhere), and
    the points' bool outlier flags, all False, for :func:`march`. ``ground``:
    the moved ground, (N, N) or (B, N, N) f32, whose word at each point's
    ``binning.cell`` is its previous terrain (0 for an id outside [0, N^2),
    as K2 reads it); the kernel reads it for in-map, unignored points."""
    if x.device.type == "cpu":
        return march_budget_plain(config, s, binning, x, y, z, ground)
    _check_points(x, y, z, binning.cell, binning.inmap, binning.ignored)
    if any(t.dtype != torch.float32 for t in (y, z)) or binning.cell.dtype != torch.int32 or any(
            t.dtype != torch.bool for t in (binning.inmap, binning.ignored)):
        raise ValueError("march_budget takes float32 coordinates, int32 cell ids, bool flags")
    n = config.cell_count
    if (ground.dtype != torch.float32 or ground.shape != (*x.shape[:-1], n, n)
            or ground.device != x.device):
        raise ValueError(f"ground must be the {(*x.shape[:-1], n, n)} float32 moved ground on "
                         f"the points' device, got {tuple(ground.shape)} {ground.dtype}")
    if x.device.type != "cuda":
        raise RuntimeError(f"march_budget: unsupported device {x.device}")
    base, stride = scalarlib.device_rows(s, x)
    ins = [t.contiguous() for t in (x, y, z, binning.cell, binning.inmap, binning.ignored)]
    ground = ground.contiguous()
    budget = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    key = torch.empty(x.shape, dtype=torch.int64, device=x.device)
    dirs = torch.empty((3, *x.shape), dtype=torch.float32, device=x.device)
    flags = torch.empty(x.shape, dtype=torch.bool, device=x.device)
    if x.numel() == 0:
        return budget, key, dirs, flags
    code = _build.launch("gg_march_budget", x.device, *(t.data_ptr() for t in ins),
                         x.shape[-1], math.prod(x.shape[:-1]), ground.data_ptr(), n * n, base,
                         stride, budget.data_ptr(), key.data_ptr(), dirs.data_ptr(),
                         flags.data_ptr())
    _build.check(code, "march_budget")
    march_budget.launches += 1
    return budget, key, dirs, flags


def march(config: GroundGridConfig, s, ground, groundpatch, pidx, budget, dirs, n_marchable,
          flags):
    """``core/outliers.py march`` into ``flags`` ((P,) or (B, P) bool, all
    False: :func:`march_budget`'s), which it returns: True at the
    candidates ``pidx`` (unique int64 point indices a row, (K,) or (B, K),
    the marchable ones first: K11's) whose ray, along ``dirs``
    (:func:`march_budget`'s) for ``budget``, crosses an occluding cell of
    the moved ``ground`` and ``groundpatch`` ((N, N) or (B, N, N) f32). The
    kernel ends at once for the positions at or past ``n_marchable`` (K11's
    () or (B,) int64 counts)."""
    if budget.device.type == "cpu":
        return march_plain(config, s, ground, groundpatch, pidx, budget, dirs, n_marchable,
                           flags)
    _check_points(budget)
    n = config.cell_count
    batch = budget.shape[:-1]
    if n < 5:
        raise ValueError(f"march: cell_count {n} < 5 (the clamped 3x3 block would leave the "
                         f"grid)")
    if (pidx.dtype != torch.int64 or pidx.dim() != budget.dim()
            or pidx.shape[:-1] != batch or pidx.device != budget.device):
        raise ValueError(f"pidx must be int64 candidates a row of the points, got "
                         f"{tuple(pidx.shape)} {pidx.dtype}")
    if dirs.dtype != torch.float32 or dirs.shape != (3, *budget.shape) or (
            dirs.device != budget.device):
        raise ValueError(f"dirs must be (3, *budget.shape) float32, got {tuple(dirs.shape)} "
                         f"{dirs.dtype}")
    if (n_marchable.dtype != torch.int64 or n_marchable.shape != batch
            or n_marchable.device != budget.device):
        raise ValueError(f"n_marchable must be int64 of shape {tuple(batch)} on the points' "
                         f"device, got {tuple(n_marchable.shape)} {n_marchable.dtype}")
    if (flags.dtype != torch.bool or flags.shape != budget.shape or flags.device != budget.device
            or not flags.is_contiguous()):
        raise ValueError(f"flags must be contiguous bool of the budget's shape, got "
                         f"{tuple(flags.shape)} {flags.dtype}")
    for layer in (ground, groundpatch):
        if (layer.dtype != torch.float32 or layer.shape != (*batch, n, n)
                or layer.device != budget.device):
            raise ValueError(f"ground and groundpatch must be {(*batch, n, n)} float32 layers "
                             f"on the points' device, got {tuple(layer.shape)} {layer.dtype}")
    if budget.device.type != "cuda":
        raise RuntimeError(f"march: unsupported device {budget.device}")
    base, stride = scalarlib.device_rows(s, budget)
    ins = [t.contiguous() for t in (pidx, n_marchable, budget, dirs, ground, groundpatch)]
    if pidx.shape[-1] == 0 or budget.numel() == 0:
        return flags  # no candidate marches
    rh, rl, inv = exactf32.res_ds(config.resolution)
    code = _build.launch(
        "gg_march", budget.device, ins[0].data_ptr(), pidx.shape[-1],
        *(t.data_ptr() for t in ins[1:]), budget.shape[-1], math.prod(batch), n, base, stride,
        float(rh), float(rl), float(inv), float(np.float32(config.outlier_tolerance)),
        float(np.float32(config.min_outlier_detection_ground_confidence)),
        int(config.ray_steps), flags.data_ptr())
    _build.check(code, "march")
    march.launches += 1
    return flags


march_budget.launches = 0
march.launches = 0
