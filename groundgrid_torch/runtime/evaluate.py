"""Sequence evaluation with on-device scoring.

The torch counterpart of ``groundgrid_tpu/runtime/evaluate.py``: the
lock-step evaluation loop with no per-scan label fetch. Each scan is stepped
by a :class:`StreamingDriver` and its labels are scored against the scan's
ring channel (the ground-truth ids) by a :class:`DeviceEvaluator` on the same
device; the host reads the confusion table only at the reference's
500-cloud prints, the int32 drains and the end.
"""

from __future__ import annotations

import time
from typing import Iterable, Tuple

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.eval.device import DeviceEvaluator, safe_drain_interval
from groundgrid_torch.eval.metrics import Evaluator
from groundgrid_torch.runtime.driver import StreamingDriver, TimingStats


def evaluate_records(
    config: GroundGridConfig,
    records: Iterable,
    sequence: str = "00",
    device=None,
    progress_every: int = 500,
    progress=print,
) -> Tuple[Evaluator, TimingStats]:
    """Stream ``records`` (``ScanRecord`` or ``PreparedRecord``) through the
    step on ``device``, scoring on the device.

    Returns the populated host :class:`Evaluator` and the timing: the clock
    runs from the first completed scan to the final ``to_host()``, which
    waits for the whole stream, so the first scan (kernel builds, warm-up)
    is excluded and ``avg_ms`` is the mean over the remaining scans.
    """
    driver = StreamingDriver(config, device)
    dev_eval = DeviceEvaluator(sequence, driver.device,
                               drain_every=safe_drain_interval(config.max_points))
    n = 0
    t0 = time.perf_counter()
    for rec in records:
        tok = driver.dispatch(rec)
        if tok is None:
            continue
        dev_eval.add_cloud_device(tok.step_out.labels, tok.rings)
        n += 1
        if n == 1:
            tok.step_out.labels.cpu()  # wait for the first scan
            t0 = time.perf_counter()
        if progress_every and dev_eval.clouds % progress_every == 0:
            # the reference's 500-cloud print (eval_groundpoint_classifier.py:123)
            progress(dev_eval.to_host().format_statistics())

    host_eval = dev_eval.to_host()  # waits for the whole stream
    elapsed_ms = (time.perf_counter() - t0) * 1000.0
    stats = TimingStats()
    if n > 1:
        stats.scans = n - 1
        stats.total_ms = elapsed_ms
        stats.avg_ms = elapsed_ms / (n - 1)
    return host_eval, stats
