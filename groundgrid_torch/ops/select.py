"""K11: the occlusion march's candidate selection (``csrc/select.cu``).

Replaces what XLA fuses of the JAX package's candidate selection,
``groundgrid_tpu/core/outliers.py:228-248`` (the packed-key ``lax.sort``
and slice up to 2^17 points, ``lax.top_k`` above), which eager PyTorch ran
as ``torch.topk`` over the selection keys and a marchable count, ~39
launches a scan; the card runs one.

:func:`select_candidates_plain` fixes the function: of the budgets and the
unique int64 selection keys (``core/outliers.py selection_key``), the
``k_max`` candidates a row as the stable partition of the point indices,
the selected points first in point order, then the rest in point order,
and each row's count of marchable points (budget > 0). The selected points
are the marchable ones while there are at most ``k_max`` of them, else the
``k_max`` largest keys. Its marchable members are ``torch.topk``'s and the
JAX package's set, on both key forms; being a function of the inputs
alone, the kernel's indices are held to it bitwise.

:func:`select_candidates` launches the kernel for CUDA tensors and takes
the plain version only for CPU tensors. A batch of vehicles, (B, P)
budgets and keys, is one launch, a cluster of blocks a row, each row
bitwise its single call. The cluster's size is the kernel's own rule
(:func:`cluster_size`): 16 blocks for a single row, fewer as the batch
grows, so that every row's cluster is on the card at once. A shape the
card cannot place raises; there is no other shape to fall back to.
"""

from __future__ import annotations

import math

import torch

from groundgrid_torch.ops import _build

MAX_POINTS = 1 << 23  # select.cu's bound on a row: 16 chunks of 16,384 words


def select_candidates_plain(budget, key, k_max: int):
    """``(pidx, n_marchable)``: ``(..., k_max)`` int64 point indices, the
    stable partition of each row's points by selection cut at ``k_max``,
    and the ``(...)`` int64 count of positive budgets a row. Selected: the
    marchable points (``budget > 0``) where a row has at most ``k_max`` of
    them, else the points whose key is at least the row's ``k_max``-th
    largest (exactly ``k_max``: the keys are unique)."""
    marchable = budget > 0
    n_marchable = marchable.sum(-1)
    kth = torch.topk(key, k_max, dim=-1).values[..., -1:]
    sel = torch.where((n_marchable <= k_max)[..., None], marchable, key >= kth)
    pidx = torch.argsort((~sel).to(torch.int8), dim=-1, stable=True)[..., :k_max]
    return pidx, n_marchable


def select_candidates(budget, key, k_max: int):
    """:func:`select_candidates_plain` of (P,) or (B, P) float32 budgets and
    int64 keys: the kernel for CUDA tensors, the plain version for CPU
    ones. ``1 <= k_max <= P``."""
    if budget.device.type == "cpu":
        return select_candidates_plain(budget, key, k_max)
    if budget.dim() not in (1, 2) or budget.dtype != torch.float32:
        raise ValueError(f"budget must be (P,) or (B, P) float32, got {tuple(budget.shape)} "
                         f"{budget.dtype}")
    if key.dtype != torch.int64 or key.shape != budget.shape or key.device != budget.device:
        raise ValueError(f"key must be int64 of the budget's shape and device, got "
                         f"{tuple(key.shape)} {key.dtype}")
    p = budget.shape[-1]
    if not 1 <= k_max <= p or p > MAX_POINTS:
        raise ValueError(f"select_candidates: need 1 <= k_max <= P <= {MAX_POINTS}, got "
                         f"k_max {k_max}, P {p}")
    if budget.device.type != "cuda":
        raise RuntimeError(f"select_candidates: unsupported device {budget.device}")
    batch = budget.shape[:-1]
    pidx = torch.empty((*batch, k_max), dtype=torch.int64, device=budget.device)
    n_marchable = torch.empty(batch, dtype=torch.int64, device=budget.device)
    if budget.numel() == 0:
        return pidx, n_marchable  # no row (a zero-block launch is invalid)
    budget, key = budget.contiguous(), key.contiguous()
    code = _build.launch("gg_select", budget.device, budget.data_ptr(), key.data_ptr(), p,
                         math.prod(batch), k_max, 0, pidx.data_ptr(), n_marchable.data_ptr())
    _build.check(code, "select_candidates")
    select_candidates.launches += 1
    return pidx, n_marchable


select_candidates.launches = 0


def cluster_size(p: int, batch: int, device) -> int:
    """The blocks a row :func:`select_candidates` launches for ``batch`` rows
    of ``p`` points on the CUDA ``device``: the largest of 16, 8, 4, 2 and 1
    (at least 32 words of 32 points a block above 1) of which the card
    holds ``batch`` clusters at once (``cudaOccupancyMaxActiveClusters``),
    else the one holding the most blocks. Raises where none is placed."""
    if not 1 <= p <= MAX_POINTS or batch < 1:
        raise ValueError(f"cluster_size: need 1 <= P <= {MAX_POINTS} and a batch, got P {p}, "
                         f"batch {batch}")
    with torch.cuda.device(device):
        size = _build.library().lib.gg_select_cluster(p, batch)
    if size <= 0:
        raise RuntimeError(f"select_candidates: no cluster shape for {batch} rows of {p} points "
                           f"(code {size})")
    return size
