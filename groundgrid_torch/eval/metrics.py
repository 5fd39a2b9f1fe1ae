"""Ground-segmentation evaluation: the reference scorer, ROS-free.

A copy of ``groundgrid_tpu/eval/metrics.py``, held to it (counts, metrics
and the ``format_statistics`` text) by ``tests/test_torch_shared.py``.

Byte-for-byte equivalent of ``scripts/eval_groundpoint_classifier.py``
(format pinned by the hand-derived golden transcript in
``tests/test_eval.py::test_statistics_format_golden_transcript``):
per-label confusion accumulation keyed on the predicted class channel
(49 = ground, 99 = non-ground) against the SemanticKITTI ground truth riding
in the ring field, the per-label table, and the headline
Precision/Recall/F1/Accuracy/IoUg block with vegetation excluded and
``IoUg = TP / (FP + total GT ground)`` (:180-195).

Points the pipeline drops (label 0) are absent from the reference's published
cloud and therefore never reach its scorer; passing them here with
``pred == 0`` reproduces that by skipping them.

Vectorized with ``np.bincount`` -- the reference's per-point Python loop over
130k points (:99-118) is the slowest part of its eval harness.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from groundgrid_torch.data import labels as L

PRED_GROUND = 49
PRED_NONGROUND = 99


@dataclasses.dataclass
class Metrics:
    precision: float
    recall: float
    f1: float
    accuracy: float
    ioug: float
    true_positive: int
    true_negative: int
    false_positive: int
    false_negative: int
    gt_ground_total: int
    clouds: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Evaluator:
    """Streaming confusion accumulator (one per evaluation run)."""

    def __init__(self, sequence: str = "00"):
        self.sequence = sequence
        m = L.MAX_LABEL_ID
        self.nonground_count = np.zeros(m, np.int64)  # predicted non-ground
        self.true_positive = np.zeros(m, np.int64)  # predicted ground & GT ground
        self.false_positive = np.zeros(m, np.int64)  # predicted ground & GT non-ground
        self.total = np.zeros(m, np.int64)  # all scored points
        self.clouds = 0

        self._ground_set = np.zeros(m, bool)
        self._ground_set[L.ALL_GROUND_IDS] = True
        self._nonground_set = np.zeros(m, bool)
        self._nonground_set[L.NON_GROUND_IDS] = True

    def add_cloud(self, pred: np.ndarray, gt: np.ndarray) -> None:
        """Score one segmented cloud.

        pred: (P,) predicted channel (49/99; 0 = dropped, skipped).
        gt:   (P,) SemanticKITTI semantic ids.
        """
        pred = np.asarray(pred)
        gt = np.asarray(gt).astype(np.int64)
        keep = pred != 0
        pred = pred[keep]
        gt = np.clip(gt[keep], 0, L.MAX_LABEL_ID - 1)

        m = L.MAX_LABEL_ID
        self.total += np.bincount(gt, minlength=m)
        is_ng = pred == PRED_NONGROUND
        self.nonground_count += np.bincount(gt[is_ng], minlength=m)
        is_g = pred == PRED_GROUND
        gt_g = gt[is_g]
        gt_is_ground = self._ground_set[gt_g]
        self.true_positive += np.bincount(gt_g[gt_is_ground], minlength=m)
        self.false_positive += np.bincount(gt_g[~gt_is_ground], minlength=m)
        self.clouds += 1

    # -- checkpoint/resume (runtime/checkpoint.py stores this as JSON) -------
    def state_dict(self) -> dict:
        """JSON-serializable accumulator state (exact integer counts)."""
        return dict(
            sequence=self.sequence,
            clouds=self.clouds,
            nonground_count=self.nonground_count.tolist(),
            true_positive=self.true_positive.tolist(),
            false_positive=self.false_positive.tolist(),
            total=self.total.tolist(),
        )

    def load_state_dict(self, d: dict) -> None:
        self.sequence = d["sequence"]
        self.clouds = int(d["clouds"])
        self.nonground_count = np.asarray(d["nonground_count"], np.int64)
        self.true_positive = np.asarray(d["true_positive"], np.int64)
        self.false_positive = np.asarray(d["false_positive"], np.int64)
        self.total = np.asarray(d["total"], np.int64)

    # -- headline metrics (eval_groundpoint_classifier.py:154-195) ----------
    def compute(self) -> Metrics:
        g = self._ground_set
        ng = self._nonground_set
        tp = int(self.true_positive[g].sum())
        fn = int(self.nonground_count[g].sum())
        fp = int(self.false_positive[ng].sum())
        tn = int(self.nonground_count[ng].sum())
        gt_ground = int(self.total[g].sum())

        def safe(a, b):
            return float(a) / float(b) if b else float("nan")

        return Metrics(
            precision=safe(tp, tp + fp),
            recall=safe(tp, tp + fn),
            f1=safe(2 * tp, 2 * tp + fp + fn),
            accuracy=safe(tp + tn, tp + tn + fp + fn),
            ioug=safe(tp, fp + gt_ground),
            true_positive=tp,
            true_negative=tn,
            false_positive=fp,
            false_negative=fn,
            gt_ground_total=gt_ground,
            clouds=self.clouds,
        )

    def per_label_table(self) -> list[tuple[str, float, float, int, int]]:
        """Rows (label, nonground%, ground%, nonground, total), nonzero only."""
        rows = []
        for lid, name in L.LABELS.items():
            total = int(self.total[lid])
            if total == 0:
                continue
            ngc = int(self.nonground_count[lid])
            rows.append((name, ngc / total, 1.0 - ngc / total, ngc, total))
        return rows

    def format_statistics(self) -> str:
        """The reference's print_statistics block (:138-195), as a string."""
        lines = ["Stats"]
        lines.append(
            f"Received {self.clouds} point clouds. KITTI sequence {self.sequence}."
        )
        lines.append("label\t\t\tnonground %\tground %\tnonground\ttotal")
        for name, ngp, gp, ngc, total in self.per_label_table():
            pad = name + ("\t" if len(name) < 8 else "")
            pad = pad + ("\t" if len(name) < 16 else "")
            lines.append(f"{pad}\t{ngp:2.2%}\t\t{gp:2.2%}\t\t{ngc}\t\t{total}")
        m = self.compute()
        tp, tn, fp, fn = m.true_positive, m.true_negative, m.false_positive, m.false_negative
        lines.append(f"Precision\t\t{m.precision:2.2%}\t\t{tp}\t{fp}")
        lines.append(f"Recall\t\t\t{m.recall:2.2%}\t\t{tp}\t{fn}")
        lines.append(f"F1\t\t\t{m.f1:2.2%}\t\t{fp}\t\t{fn}")
        lines.append(
            f"Accuracy\t\t{m.accuracy:2.2%}\t\t{tp + tn}\t{tp + tn + fp + fn}"
        )
        lines.append(f"IoUg\t\t\t{m.ioug:2.2%}")
        return "\n".join(lines)
