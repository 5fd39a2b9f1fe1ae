"""The per-layer metrics read from the port's own tracer
(``groundgrid_torch/trace.py``): host spans inside the program and the
device stamps of the captured step's stages.

The first reader's call runs a stretch of its own, after the profiled
stretch and outside the window, and keeps its result on the run's context:
an untraced stretch of ``SECONDS`` (to set the tracer's host cost against),
then tracing on, ``WARMUP_SECONDS`` of warm-up (which captures the captured
step's stamped twin), the record reset, ``SECONDS`` traced, and the
snapshot. The span and stage tables go to standard error. A port without
the tracer, or a run without a card for the device stages, gives None and
the reader's metric is left out.
"""

from __future__ import annotations

import sys

WARMUP_SECONDS = 0.5
SECONDS = 2.0


def _stretch(cx):
    """The traced stretch's snapshot and rates, run once a context."""
    if getattr(cx, "program_trace", False) is not False:
        return cx.program_trace
    cx.program_trace = None
    try:
        from groundgrid_torch import ops, trace
    except ImportError:
        return None
    from portbench.trace import sync as sync_cards

    def sync():
        if cx.device.type == "cuda":
            sync_cards(cx.devices)

    sync()
    plain = cx.loop.run(SECONDS, keep=False)
    trace.enable()
    try:
        cx.loop.run(WARMUP_SECONDS, keep=False)
        sync()
        trace.reset()
        before = ops.launch_counts()
        traced = cx.loop.run(SECONDS, keep=False)
        sync()
        snap = trace.snapshot()
    finally:
        trace.disable()
    launched = {k: v - before[k] for k, v in snap["launches"].items()}
    cx.program_trace = {"snapshot": snap, "units": traced.units, "scans": traced.scans,
                        "launched": launched,
                        "plain_ms": 1e3 * plain.elapsed / max(plain.units, 1),
                        "traced_ms": 1e3 * traced.elapsed / max(traced.units, 1)}
    _print(cx.program_trace, getattr(cx.loop, "unit_name", "scan"))
    return cx.program_trace


def _print(t, unit: str) -> None:
    snap = t["snapshot"]
    out = [f"program trace: {t['units']} {unit}s traced, {t['traced_ms']:.4f} ms a {unit} "
           f"(untraced stretch {t['plain_ms']:.4f}); spans overwritten "
           f"{snap['overwritten']}", "span count total_ms self_ms ms_per_unit"]
    for name, s in sorted(snap["spans"].items()):
        out.append(f"  {name} {s['count']} {s['total_ns'] / 1e6:.3f} {s['self_ns'] / 1e6:.3f} "
                   f"{s['total_ns'] / 1e6 / max(t['units'], 1):.4f}")
    for st in snap["stages"]:
        scans = st["replays"] * st["batch"]
        out.append(f"device stages: {st['replays']} replays of {st['batch']} (overwritten "
                   f"{st['overwritten']}), stage total_ms ms_per_scan")
        for name, ns in st["ns"].items():
            out.append(f"  {name} {ns / 1e6:.3f} {ns / 1e6 / scans:.6f}")
    units = max(t["units"], 1)
    out.append("kernel launches a unit, traced: "
               + ", ".join(f"{k} {v / units:g}" for k, v in t["launched"].items()))
    print("\n".join(out), file=sys.stderr, flush=True)


def host_ms(cx, span: str, per: str | None = None):
    """Host milliseconds of the program's span ``span`` in the traced
    stretch, over the count of span ``per`` (else its own count)."""
    t = _stretch(cx)
    if t is None:
        return None
    spans = t["snapshot"]["spans"]
    count = spans.get(per or span, {}).get("count", 0)
    if span not in spans or not count:
        return None
    return spans[span]["total_ns"] / 1e6 / count


def device_ms(cx, stage: str):
    """Device milliseconds a scan of stage ``stage`` (with its parts,
    ``<stage>.<part>``) in the traced stretch, by the captured step's stage
    stamps: their sum over the stamped replays' scans."""
    t = _stretch(cx)
    if t is None or not t["snapshot"]["stages"]:
        return None
    ns = scans = 0
    for st in t["snapshot"]["stages"]:
        found = [v for k, v in st["ns"].items() if k == stage or k.startswith(stage + ".")]
        if found:
            ns += sum(found)
            scans += st["replays"] * st["batch"]
    return ns / 1e6 / scans if scans else None
