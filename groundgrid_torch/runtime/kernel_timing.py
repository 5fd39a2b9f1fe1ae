"""Kernel times on the card: the device time of named kernels by
``torch.profiler``, the wrapper's cost per call by CUDA events, and the
least time the card could take for the same work.

``chip_smoke.py`` phase 2 times each kernel with these; ``kernel_turns.py``
runs that phase in several source trees, in turns.
"""

from __future__ import annotations

import bisect
import sys
import time
from contextlib import contextmanager

import torch

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s, 67 TFLOP/s float32 outside
# the tensor cores (per millisecond below)
HBM_BYTES_PER_MS = 3.35e9
F32_FLOPS_PER_MS = 67e9

# torch.profiler keeps only the device activities whose timestamps lie inside
# its window on the host's clock, and the card's clock can sit milliseconds
# off it: an idle pad on each side of the window keeps a short window's
# launches inside, and a window that kept none of them is run again
PAD_S = 0.02
ATTEMPTS = 3


@contextmanager
def profiled():
    """A ``torch.profiler`` window over CPU and CUDA activity, padded on
    each side by PAD_S of an idle card; the body's work is synchronized
    before the window closes."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(PAD_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(PAD_S)


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """The least time for moving ``n_bytes`` and doing ``n_flops`` f32
    operations on the card, and which of the two bounds it."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_MS, n_flops / F32_FLOPS_PER_MS
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def event_ms(fn, reps: int) -> float:
    """Mean CUDA-event milliseconds of ``fn()`` over ``reps`` back-to-back
    calls, warmed: the wrapper's cost per call, host dispatch included."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, name: str | None = None,
              per: str | None = None, per_call: int = 1) -> tuple[float, int]:
    """Device milliseconds per call of ``fn()`` by ``torch.profiler`` over
    ``reps`` warm calls, and the number of device activities counted.

    Sums the device activities whose name contains ``name`` (every one:
    kernels, copies, sets, if None) and divides by the calls the profiler
    kept, counted as the launches of kernel ``per`` (or ``name``),
    ``per_call`` per call, else taken as ``reps``. The profiler can drop a launch of a long
    kernel from its window (K3's global-band kernel: 4 of 5 kept). A window
    that kept none is run again; raises if ATTEMPTS windows kept none.
    """
    fn()
    count = per or name
    for attempt in range(1, ATTEMPTS + 1):
        with profiled() as prof:
            for _ in range(reps):
                fn()
        us, seen = device_us(prof, name)
        calls = device_us(prof, count)[1] / per_call if count else reps
        if seen and calls:
            break
        print(f"torch.profiler kept no device activity named {count!r} in window {attempt} "
              f"of {ATTEMPTS} ({device_us(prof)[1]} device activities in all)", file=sys.stderr)
    else:
        raise RuntimeError(f"torch.profiler recorded no device activity named {count!r} in "
                           f"{ATTEMPTS} windows")
    if calls > reps:
        raise RuntimeError(f"torch.profiler recorded {calls * per_call} launches of {count!r} in "
                           f"{reps} calls")
    return us / 1000.0 / calls, seen


def device_us(prof, name: str | None = None) -> tuple[float, int]:
    """Summed microseconds and count of the device activities in a finished
    ``torch.profiler`` run whose name contains ``name`` (every one if None).
    A ``record_function`` range's own span on the device timeline is no
    activity."""
    cuda = torch.autograd.DeviceType.CUDA
    seen = [e for e in prof.events()
            if e.device_type == cuda and not e.is_user_annotation
            and (name is None or name in e.name)]
    return sum(e.time_range.end - e.time_range.start for e in seen), len(seen)


def stage_us(prof, names) -> dict[str, tuple[float, int]]:
    """Summed microseconds and count of the device activities launched
    inside each ``record_function`` range named in ``names``
    (``pipeline.STAGES``, ``pipeline.RASTER_PARTS``) in a finished
    ``torch.profiler`` run. An activity belongs to every named range whose
    host-clock span holds the CUDA runtime call that launched it (the call
    of the same correlation id; ranges may nest), so a kernel launched
    outside any PyTorch op (the port's ctypes launches) counts."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == cpu and e.is_user_annotation and e.name in names)
    starts = [span[0] for span in spans]
    launched_at = {e.id: e.time_range.start for e in events
                   if e.device_type == cpu and e.name.startswith("cu")}  # runtime calls
    out = {name: (0.0, 0) for name in names}
    for e in events:
        at = launched_at.get(e.id)
        if e.device_type != cuda or e.is_user_annotation or at is None:
            continue
        for _, end, name in spans[:bisect.bisect_right(starts, at)]:
            if at <= end:
                us, count = out[name]
                out[name] = (us + e.time_range.end - e.time_range.start, count + 1)
    return out
