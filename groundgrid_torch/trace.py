"""The port's tracer: host spans at its layer boundaries, and device
stamps at the stage boundaries of a captured step.

``span(name, id=None)`` is a context manager placed at a layer boundary
(the fleet's tick, the runtime's dispatch and fetch, the captured step's
replay, every stage of the step's body). It has three modes:

* tracing off (the default): it checks one module flag and
  ``torch.autograd._profiler_enabled()`` and does nothing else: no
  allocation, no clock read;
* a ``torch.profiler`` running: tracing on or off, it also opens a
  ``torch.profiler.record_function(name)`` range, so the program's host
  spans lie on the profiler's clock beside the device's activities (a
  replayed CUDA graph opens none: its body does not run on the host);
* tracing on (:func:`enable`): it records its name, its start and end on
  ``time.perf_counter_ns()``, its parent span and its request id (given,
  or else its parent's) into a ring of ``CAPACITY`` records allocated by
  :func:`enable`, and adds its total and self time (the total less what
  its child spans cover) to its name's sums, which cover every span, also
  those the ring has overwritten.

Spans are recorded on one thread: the one that opened the first span since
:func:`enable` or :func:`reset`. A span opened on any other thread (the
native loader's worker threads, for one) is not recorded; it still opens
its profiler range.

While tracing is on, a captured step (``pipeline.CapturedStep``) replays a
stamped twin of its graph, captured from the same body inside
:class:`Stamps`: a one-thread kernel (``csrc/stamp.cu``) writes the
device's ``%globaltimer`` at each stage boundary, S + 1 stamps for the S
stages in sequence, into a row of a device ring whose row index lives in
device memory and is advanced by the replay's last stamp. Nothing is read
back per replay; :func:`snapshot` copies each ring out once. Device stamps
are on the device's clock, not aligned to the host's. On the CPU there is
no graph, and no device stage is reported.

:func:`snapshot` returns the spans' sums by name, the ring, the device
stages and the kernel launch counters (``ops.launch_counts``), which stay
the program's only counters.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref
from typing import NamedTuple

import torch

CAPACITY = 65536  # span records the ring holds
STAMP_ROWS = 4096  # replays a device ring holds

_NULL = contextlib.nullcontext()
_rec: "_Recorder | None" = None  # tracing is on while this is set
_stamps: "Stamps | None" = None  # the twin being captured
_twins: "weakref.WeakSet[Stamps]" = weakref.WeakSet()  # every captured twin's stamps


class Span(NamedTuple):
    """One recorded span: ``seq`` numbers spans in the order they opened;
    ``parent`` is the enclosing span's ``seq`` (-1 for none); times are
    ``perf_counter_ns``."""

    seq: int
    name: str
    start_ns: int
    end_ns: int
    parent: int
    id: object


class _Recorder:
    """The state of one tracing session: the ring, the open spans and the
    sums by name."""

    def __init__(self):
        self.ring: list = [None] * CAPACITY
        self.written = 0
        self.opened = 0
        self.stack: list = []
        self.sums: dict[str, list] = {}  # name -> [count, total ns, self ns]
        self.owner: int | None = None


class _Open:
    """A span while it is open (tracing on)."""

    __slots__ = ("name", "id", "seq", "parent", "start", "child", "prof")

    def __init__(self, name: str, id):
        self.name, self.id = name, id

    def __enter__(self):
        if _stamps is not None:
            _stamps.boundary(self.name)
        self.prof = None
        if torch.autograd._profiler_enabled():
            self.prof = torch.profiler.record_function(self.name)
            self.prof.__enter__()
        rec = _rec
        self.seq = None
        if rec is None:
            return self
        thread = threading.get_ident()
        if rec.owner is None:
            rec.owner = thread
        elif rec.owner != thread:
            return self
        parent = rec.stack[-1] if rec.stack else None
        self.parent = -1 if parent is None else parent.seq
        if self.id is None and parent is not None:
            self.id = parent.id
        self.seq, rec.opened = rec.opened, rec.opened + 1
        self.child = 0
        rec.stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        rec = _rec
        if self.seq is not None and rec is not None and rec.stack and rec.stack[-1] is self:
            rec.stack.pop()
            total = end - self.start
            if rec.stack:
                rec.stack[-1].child += total
            sums = rec.sums.get(self.name)
            if sums is None:
                sums = rec.sums[self.name] = [0, 0, 0]
            sums[0] += 1
            sums[1] += total
            sums[2] += total - self.child
            rec.ring[rec.written % CAPACITY] = Span(self.seq, self.name, self.start, end,
                                                    self.parent, self.id)
            rec.written += 1
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False


def span(name: str, id=None):
    """A span at a layer boundary (see the module); ``id`` the request
    id, else the enclosing span's."""
    if _rec is None:
        if torch.autograd._profiler_enabled():
            return torch.profiler.record_function(name)
        return _NULL
    return _Open(name, id)


def enabled() -> bool:
    return _rec is not None


def enable() -> None:
    """Turn tracing on, with an empty ring (a no-op while it is on)."""
    global _rec
    if _rec is None:
        _rec = _Recorder()


def disable() -> None:
    """Turn tracing off; what was recorded is dropped."""
    global _rec
    _rec = None


def reset() -> None:
    """Drop what was recorded (spans and device stamps); tracing stays as
    it is."""
    global _rec
    if _rec is not None:
        _rec = _Recorder()
    for stamps in list(_twins):
        stamps.count.zero_()


class Stamps:
    """The device stamps of one stamped twin: ``names`` lists the stages
    that get a boundary (the body's innermost stages, in any order); the
    ring holds ``STAMP_ROWS`` replays of at most ``len(names) + 1`` stamps.
    Used as a context manager around the twin's capture, it stamps the
    start of each named stage as its span opens, and the end of the last
    on exit; ``batch`` is the vehicles a replay steps."""

    def __init__(self, device, names, batch: int):
        self.names = frozenset(names)
        self.batch = batch
        self.stages: list[str] = []  # the stage each boundary but the last starts
        self.width = len(self.names) + 1
        self.ring = torch.zeros((STAMP_ROWS, self.width), dtype=torch.int64, device=device)
        self.count = torch.zeros((), dtype=torch.int64, device=device)

    def boundary(self, name: str) -> None:
        if name in self.names:
            self.stages.append(name)
            self._stamp(len(self.stages) - 1, last=False)

    def _stamp(self, slot: int, last: bool) -> None:
        from groundgrid_torch.ops import _build

        if slot >= self.width:
            raise RuntimeError(f"more stage boundaries than the {self.width} a row holds")
        code = _build.launch("gg_stamp", self.ring.device, self.ring.data_ptr(),
                             self.count.data_ptr(), STAMP_ROWS, self.width, slot, int(last))
        _build.check(code, "gg_stamp")

    def __enter__(self):
        global _stamps
        if self.ring.device.type != "cuda":
            raise ValueError("device stamps need a CUDA device")
        self.stages = []
        _stamps = self
        return self

    def __exit__(self, *exc):
        global _stamps
        _stamps = None
        if exc[0] is None:
            self._stamp(len(self.stages), last=True)
            _twins.add(self)
        return False

    def read(self) -> dict:
        """The device ns of each stage summed over the replays the ring
        holds: ``{"batch", "replays", "overwritten", "ns": {stage: ns}}``."""
        count = int(self.count)
        rows = min(count, STAMP_ROWS)
        s = len(self.stages)
        ring = self.ring[:rows, :s + 1].cpu()
        ns = (ring[:, 1:] - ring[:, :-1]).sum(0).tolist() if rows else [0] * s
        out: dict[str, int] = {}
        for stage, t in zip(self.stages, ns):
            out[stage] = out.get(stage, 0) + int(t)
        return {"batch": self.batch, "replays": rows, "overwritten": count - rows, "ns": out}


def snapshot() -> dict:
    """What tracing recorded since :func:`enable` or :func:`reset`:
    ``spans`` (by name: ``count``, ``total_ns``, ``self_ns``), ``ring``
    (the :class:`Span` records held, oldest first) and ``overwritten``,
    ``stages`` (one :meth:`Stamps.read` a twin that replayed), and
    ``launches`` (``ops.launch_counts()``). Reads each device ring, so it
    waits for the replays in flight."""
    from groundgrid_torch import ops

    rec = _rec
    spans, ring, overwritten = {}, [], 0
    if rec is not None:
        spans = {name: {"count": c, "total_ns": t, "self_ns": s}
                 for name, (c, t, s) in rec.sums.items()}
        held = min(rec.written, CAPACITY)
        overwritten = rec.written - held
        ring = [rec.ring[i % CAPACITY] for i in range(rec.written - held, rec.written)]
    stages = [r for r in (stamps.read() for stamps in list(_twins)) if r["replays"]]
    return {"spans": spans, "ring": ring, "overwritten": overwritten, "stages": stages,
            "launches": ops.launch_counts()}
