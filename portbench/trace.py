"""The traced run: host spans from the benchmark's own calls, and a
``torch.profiler`` window over the first part of the measured window.

Spans: every timed unit and the calls named by the loops (``fleet.prep``,
``fleet.step``, ``fleet.summary``, ``dispatch``) as host-clock durations
over the window, kept in memory; in the profiled stretch they are
``record_function`` ranges instead, so the profiler's timeline names what
the host was doing in each idle gap of the device.

The profile is a stretch of its own after the window, ``profile_seconds``
long, so that neither the profiler's host overhead nor reading its trace
lands in the measured window; two marks on the profiler's clock bound it,
and device work after the closing mark (scans still in flight) is left out
of it. Its device activities (kernels, copies,
sets: CUPTI's records) are summed as in the port's
``runtime/kernel_timing.device_us`` and checked against the port's own
launch counters: a profile that kept fewer of the port's kernels than were
launched lost records, and another stretch is profiled. On a cell over
several cards the stretch waits for every card at both ends; busy time is
each card's own (the union of its activities), and the idle gaps are those
of every card's activities at once.
"""

from __future__ import annotations

import contextlib
import time

import torch

ATTEMPTS = 3
# zero-length ranges that mark the profiled part's ends on the profiler's clock
OPEN, CLOSE = "portbench.window.open", "portbench.window.close"


class Tracer:
    """Host spans of the window, then a profiled stretch of its own."""

    def __init__(self, profile_seconds: float, kernel_names):
        self.profile_seconds = profile_seconds
        self.kernel_names = tuple(kernel_names)
        self.spans: dict[str, list[float]] = {}
        self.prof = None
        self.profile = None  # the accepted profile's summary
        self.attempts = 0

    @contextlib.contextmanager
    def span(self, name: str):
        """A host-clock span in the window; a ``record_function`` range (and
        no span) while profiling."""
        if self.prof is not None:
            with torch.profiler.record_function(name):
                yield
            return
        t0 = time.perf_counter()
        yield
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def profile_stretch(self, loop) -> None:
        """Profile ``profile_seconds`` more of the loop's units (outputs not
        kept), again while the profile kept fewer of the port's kernels than
        its launch counters counted, at most ATTEMPTS times."""
        from groundgrid_torch import ops

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        while self.profile is None:
            self.attempts += 1
            sync(loop.devices)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            with torch.profiler.record_function(OPEN):
                pass
            before = ops.counter_values()
            stretch = loop.run(self.profile_seconds, keep=False)
            with torch.profiler.record_function(CLOSE):
                pass
            sync(loop.devices)
            launched = [a - b for a, b in zip(ops.counter_values(), before)]
            prof, self.prof = self.prof, None
            prof.__exit__(None, None, None)
            summary = summarize(prof, self.kernel_names)
            summary["scans"] = stretch.scans
            summary["units"] = list(stretch.indices)
            # the last counter (K3's global-band launches) also counts in K3's
            summary["port_launches"] = sum(launched[:-1])
            if summary["port_kernels_seen"] >= summary["port_launches"] \
                    or self.attempts >= ATTEMPTS:
                self.profile = summary


def sync(devices) -> None:
    """Wait for the work queued on every card of ``devices``."""
    for d in devices:
        torch.cuda.synchronize(d)


def kernel_base(name: str) -> str:
    """A device activity's kernel name without its namespace, template
    arguments and parameter list: ``spiral_kernel`` of ``(anonymous
    namespace)::spiral_kernel(float*, ...)``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in ("(", "<"):
        name = name.split(stop, 1)[0]
    return name.rsplit("::", 1)[-1].strip()


def _union(acts, w0: float, w1: float) -> tuple[float, list]:
    """Busy time and idle gaps of the time-sorted activities ``acts``
    (start, end, ...) inside the window [w0, w1]: the length of their union
    and the stretches it leaves out."""
    busy, gaps, cur_s, cur_e = 0.0, [], None, None
    for s, e, *_ in acts:
        s, e = max(s, w0), min(e, w1)
        if cur_e is None:
            if s > w0:
                gaps.append((w0, s))
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        if cur_e < w1:
            gaps.append((cur_e, w1))
    return busy, gaps


def summarize(prof, kernel_names) -> dict:
    """Device activities, busy time and idle gaps of a finished profile, in
    microseconds on the profiler's clock: each card's busy time, the union
    of its own activities (``card_busy_us``, keyed by the device index),
    and the idle gaps of every card's activities at once."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    acts = sorted(((e.time_range.start, e.time_range.end, e.name, e.device_index) for e in events
                   if e.device_type == cuda and not e.is_user_annotation),
                  key=lambda a: a[0])
    ranges = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                    if e.device_type == cpu and e.is_user_annotation)
    marks = {name: s for s, _, name in ranges if name in (OPEN, CLOSE)}
    w0, w1 = marks[OPEN], marks[CLOSE]
    ranges = [r for r in ranges if r[2] not in marks]
    inside = [a for a in acts if a[1] > w0 and a[0] < w1]
    _, gaps = _union(inside, w0, w1)
    card_busy = {card: _union([a for a in inside if a[3] == card], w0, w1)[0]
                 for card in sorted({a[3] for a in inside})}
    by_name: dict[str, list] = {}
    for s, e, name, _ in inside:
        entry = by_name.setdefault(name, [0.0, 0])
        entry[0] += e - s
        entry[1] += 1

    def host_doing(t):
        best = None
        for s, e, name in ranges:
            if s <= t <= e and (best is None or s >= best[0]):
                best = (s, name)
        return best[1] if best else "outside the benchmark's spans"

    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return {
        "window_us": w1 - w0,
        "card_busy_us": card_busy,
        "activities": len(inside),
        "by_name": by_name,
        "port_kernels_seen": sum(kernel_base(name) in kernel_names for _, _, name, _ in acts),
        "idle_gaps": [[host_doing((s + e) / 2), (e - s) / 1e6] for s, e in gaps[:10]],
        "device_ops": [[name, us / 1e6] for name, (us, _) in
                       sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:10]],
    }
