"""What the per-layer metric readers (``portbench/metrics/<name>.py``) share:
each reader file names its metric and calls one of these on the run's
context. A reader that finds nothing to read returns None, and the run
leaves its metric out."""

from __future__ import annotations

from portbench import roofline
from portbench.trace import kernel_base


def host_span_ms(cx, span: str):
    """Mean host milliseconds of the benchmark's own span ``span`` over the
    window."""
    spans = cx.tracer.spans.get(span) if cx.tracer is not None else None
    return 1000.0 * sum(spans) / len(spans) if spans else None


def _profile(cx):
    p = cx.profile
    return p if p and p["scans"] and p["activities"] else None


def _busy_us(p) -> float:
    """Device microseconds of the profiled stretch, each card's union of
    its own activities (CUPTI's kernel, copy and set records), summed over
    the cards."""
    return sum(p["card_busy_us"].values())


def device_busy_ms(cx):
    """Device milliseconds a scan: the cards' busy time over the profiled
    stretch (``_busy_us``), over the scans completed in it. On several cards
    of equal blocks it is the mean over the cards of a card's busy time a
    scan of its block."""
    p = _profile(cx)
    return None if p is None else _busy_us(p) / 1000.0 / p["scans"]


def activities_per_scan(cx):
    """Device activities a scan in the profiled stretch."""
    p = _profile(cx)
    return None if p is None else p["activities"] / p["scans"]


def device_idle_share(cx):
    """Percent of the window in which a card ran nothing, as ``1 -
    device_busy_ms x scans_per_s / cards``: the device time a scan from the
    profiled stretch, times the scans a second of the same run's unprofiled
    window, so that the profiler's own host work does not read as idle;
    over several cards, the mean of the cards' idle shares."""
    p = _profile(cx)
    if p is None or not cx.window.elapsed:
        return None
    busy_s = _busy_us(p) / 1e6 / p["scans"]
    return 100.0 * (1.0 - busy_s * cx.window.scans / cx.window.elapsed / len(cx.devices))


def _kernel_us(p, kernel: str):
    us, launches = 0.0, 0
    for name, (t, count) in p["by_name"].items():
        if kernel_base(name) == kernel:
            us, launches = us + t, launches + count
    return us, launches


def k3_roofline(cx):
    """K3's share of its roofline, in percent: the least time of the work,
    ``roofline.k3_bytes`` a grid for each scan stepped in the profiled
    stretch (its units times the scans a unit), over the ring-band
    kernel's device time, summed over its launches there (on every card).
    Counted from the work, not the launches, so a fleet tick read as one
    launch a card's block or as one a vehicle reads the same bytes."""
    p = _profile(cx)
    if p is None:
        return None
    us, launches = _kernel_us(p, "spiral_kernel")
    if not launches or us <= 0:
        return None
    n_bytes = roofline.k3_bytes(cx.cfg.cell_count) * p["scans"]
    return 100.0 * roofline.bound_s(n_bytes) / (us / 1e6)


def k1_roofline(cx):
    """K1's share of its roofline, in percent: the least time of the work
    (``roofline.k1_bytes`` of each scan of the profiled stretch, with the
    points inside the grid counted from the scan and its grid center), over
    the raster kernel's device time there."""
    p = _profile(cx)
    if p is None or not p["units"]:
        return None
    us, _ = _kernel_us(p, "raster_reduce_kernel")
    if us <= 0:
        return None
    n = cx.cfg.cell_count
    ticks = p["units"]
    inside = roofline.inside_counts(cx.pool, cx.loop.schedule, ticks, n, cx.cfg.resolution,
                                    cx.device)
    scans = cx.loop.unit_scans * len(ticks)
    n_bytes = (4 * cx.cfg.max_points * scans
               + 4 * roofline.K1_COLUMNS * (inside + n * n * scans))
    return 100.0 * roofline.bound_s(n_bytes) / (us / 1e6)
