"""Kernel times on the card: the device time of named kernels by
``torch.profiler``, the wrapper's cost per call by CUDA events, and the
least time the card could take for the same work.

``chip_smoke.py`` phase 2 times each kernel with these; ``kernel_turns.py``
runs that phase in several source trees, in turns.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s, 67 TFLOP/s float32 outside
# the tensor cores (per millisecond below)
HBM_BYTES_PER_MS = 3.35e9
F32_FLOPS_PER_MS = 67e9


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
              per: str | None = None) -> tuple[float, int]:
    """Device milliseconds per call of ``fn()`` by ``torch.profiler`` over
    ``reps`` warm calls, and the number of device activities counted.

    Sums the device activities whose name contains ``name`` (every one:
    kernels, copies, sets, if None) and divides by the calls the profiler
    kept, counted as the launches of kernel ``per`` (or ``name``), one per
    call, else taken as ``reps``. The profiler can drop a launch of a long
    kernel from its window (K3's global-band kernel: 4 of 5 kept). Raises
    if it kept none.
    """
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, seen = device_us(prof, name)
    count = per or name
    calls = device_us(prof, count)[1] if count else reps
    if not seen or not calls:
        raise RuntimeError(f"torch.profiler recorded no device activity named {count!r}")
    if calls > reps:
        raise RuntimeError(f"torch.profiler recorded {calls} launches of {count!r} in {reps} calls")
    return us / 1000.0 / calls, seen


def device_us(prof, name: str | None = None) -> tuple[float, int]:
    """Summed microseconds and count of the device activities in a finished
    ``torch.profiler`` run whose name contains ``name`` (every one if None)."""
    cuda = torch.autograd.DeviceType.CUDA
    seen = [e for e in prof.events()
            if e.device_type == cuda and (name is None or name in e.name)]
    return sum(e.time_range.end - e.time_range.start for e in seen), len(seen)
