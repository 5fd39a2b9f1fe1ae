"""On-device evaluation accumulator (PyTorch).

The torch counterpart of ``groundgrid_tpu/eval/device.py``. The host
:class:`~groundgrid_torch.eval.metrics.Evaluator` needs every scan's labels
on the host; this accumulator keeps the confusion counts on the device
instead: one ``index_add_`` of a (P, 4) integer column block per scan into a
(MAX_LABEL_ID, 4) table, fetched when the caller asks for it. Unscored
points (prediction 0) go to one extra row that is never read, as the JAX
scatter drops them (``mode="drop"``). Integer adds make the counts
deterministic on the card and bitwise those of the host evaluator.

Plain torch: the JAX accumulator is an XLA scatter, not a Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from groundgrid_torch.data import labels as L
from groundgrid_torch.eval.metrics import PRED_GROUND, PRED_NONGROUND, Evaluator

# column order in the accumulator table
_NONGROUND, _TP, _FP, _TOTAL = range(4)


def accumulate(table: torch.Tensor, ground_set: torch.Tensor, pred_labels: torch.Tensor,
               gt_labels: torch.Tensor) -> None:
    """``table += `` one scan's confusion contributions, in place, on its device.

    table:       (MAX_LABEL_ID + 1, 4) int32; the last row takes unscored points.
    pred_labels: (P,) int 49 / 99 / 0 (0 = dropped, not scored).
    gt_labels:   (P,) int SemanticKITTI ids (the scan's ring channel; int16
                 in the wire format), clipped to the table.
    """
    gt = gt_labels.to(torch.int64).clamp(0, L.MAX_LABEL_ID - 1)
    gset = ground_set[gt]
    scored = pred_labels > 0
    is_g = pred_labels == PRED_GROUND
    vals = torch.stack([pred_labels == PRED_NONGROUND, is_g & gset, is_g & ~gset, scored],
                       dim=-1).to(table.dtype)
    tgt = torch.where(scored, gt, torch.full_like(gt, L.MAX_LABEL_ID))
    table.index_add_(0, tgt, vals)


class DeviceEvaluator:
    """Drop-in for :class:`Evaluator` that defers all host reads.

    Feed it device tensors (the step's ``labels`` output and the scan's
    ``rings``); :meth:`to_host` returns a populated :class:`Evaluator` with
    identical counts. ``device`` is required.

    The device table is int32. A multi-sequence aggregate can pass 2^31
    points per label (sequences 00-10 score ~3e9), so every ``drain_every``
    clouds the table is folded into a host int64 table and zeroed; pick
    ``drain_every`` with :func:`safe_drain_interval`.
    """

    def __init__(self, sequence: str = "00", device=None, drain_every: int = 2048):
        if device is None:
            raise TypeError("DeviceEvaluator needs an explicit device")
        self.sequence = sequence
        self.device = torch.device(device)
        self._table = torch.zeros((L.MAX_LABEL_ID + 1, 4), dtype=torch.int32, device=self.device)
        # the reference's ground ids (vegetation excluded)
        ground_set = np.zeros(L.MAX_LABEL_ID, np.bool_)
        ground_set[L.ALL_GROUND_IDS] = True
        self._ground_set = torch.from_numpy(ground_set).to(self.device)
        self.host_counts = np.zeros((L.MAX_LABEL_ID, 4), np.int64)
        self.clouds = 0
        self.drain_every = int(drain_every)
        self._since_drain = 0

    def add_cloud_device(self, pred_labels: torch.Tensor, gt_labels: torch.Tensor) -> None:
        accumulate(self._table, self._ground_set, pred_labels, gt_labels)
        self.clouds += 1
        self._since_drain += 1
        if self.drain_every > 0 and self._since_drain >= self.drain_every:
            self.drain()

    def _fetch(self) -> np.ndarray:
        """The device table since the last drain, without its unscored row."""
        return self._table[: L.MAX_LABEL_ID].cpu().numpy().astype(np.int64)

    def drain(self) -> None:
        """Fold the device table into the host int64 table and zero it."""
        self.host_counts += self._fetch()
        self._table.zero_()
        self._since_drain = 0

    def to_host(self) -> Evaluator:
        """Snapshot into a host :class:`Evaluator` (non-destructive)."""
        ev = Evaluator(self.sequence)
        c = self.host_counts + self._fetch()
        ev.nonground_count = c[:, _NONGROUND]
        ev.true_positive = c[:, _TP]
        ev.false_positive = c[:, _FP]
        ev.total = c[:, _TOTAL]
        ev.clouds = self.clouds
        return ev


def safe_drain_interval(max_points_per_scan: int, headroom: int = 8) -> int:
    """Largest drain interval that provably cannot overflow int32.

    Per scan no cell grows by more than the scan's point count, so
    ``drain_every * max_points < 2^31 / headroom`` leaves ``headroom``x
    margin. The defaults give 2047 scans at the 131072-point cap.
    """
    cap = (2**31 - 1) // (headroom * max(int(max_points_per_scan), 1))
    return max(1, min(cap, 4096))
