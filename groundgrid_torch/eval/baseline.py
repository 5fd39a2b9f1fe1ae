"""Reference-published baseline numbers + comparison-table formatter.

A copy of ``groundgrid_tpu/eval/baseline.py``, held to it by
``tests/test_torch_shared.py``.

The reference's entire published result is the SemanticKITTI seq-00
evaluation table (the reference README.md:56-94, 4540 scans, lock-step
playback via launch/KITTIEvaluate.launch). This module holds those headline
numbers and renders the side-by-side comparison the acceptance criterion is
stated in (BASELINE.md: each metric within 0.5 pt).
"""

from __future__ import annotations

# Ground-class metrics, vegetation excluded (README.md:90-94).
REFERENCE_SEQ00 = {
    "precision": 0.9605,
    "recall": 0.9870,
    "f1": 0.9735,
    "accuracy": 0.9724,
    "ioug": 0.9484,
}
REFERENCE_SEQ00_SCANS = 4540
TOLERANCE_PT = 0.5  # acceptance budget, percentage points (BASELINE.md)


def format_baseline_comparison(metrics: dict, scans: int | None = None) -> str:
    """Side-by-side table: this run vs the reference's seq-00 numbers.

    ``metrics`` is ``Metrics.as_dict()`` output (fractions in [0, 1]).
    """
    lines = [
        "=== seq-00 comparison vs reference (README.md:56-94, "
        f"{REFERENCE_SEQ00_SCANS} scans) ===",
        f"{'metric':<10} {'this run':>9} {'reference':>10} {'delta(pt)':>10}  "
        f"within {TOLERANCE_PT} pt?",
    ]
    all_ok = True
    for key, ref in REFERENCE_SEQ00.items():
        got = float(metrics[key])
        delta_pt = (got - ref) * 100.0
        ok = abs(delta_pt) <= TOLERANCE_PT or delta_pt > 0
        all_ok = all_ok and ok
        lines.append(
            f"{key:<10} {got:>9.2%} {ref:>10.2%} {delta_pt:>+10.2f}  "
            f"{'yes' if ok else 'NO'}"
        )
    if scans is not None and scans != REFERENCE_SEQ00_SCANS:
        lines.append(
            f"note: {scans} scans evaluated vs the reference's "
            f"{REFERENCE_SEQ00_SCANS} -- partial-sequence numbers are not "
            "directly comparable"
        )
    lines.append(
        "PASS: all metrics within budget" if all_ok
        else "FAIL: at least one metric below budget"
    )
    return "\n".join(lines)
