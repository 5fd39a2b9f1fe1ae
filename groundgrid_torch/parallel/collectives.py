"""The local shards of a spatial mesh run in lock-step, eagerly or captured.

A shard's body (the spatial step's, the sharded detect's, the band relay's)
is a generator, the counterpart of the JAX package's ``shard_map`` body: it
runs its shard's ops and, at each collective, yields a request
(:class:`Gather`, :class:`Sum` or :class:`Relay`) and receives its result.
Every shard yields the same requests in the same order; its return value is
its output. :func:`drive` runs the local shards' bodies eagerly, one
:func:`exchange` (a ``LocalMesh`` or ``GroupMesh`` collective) per request.

:class:`CapturedShards` is the port's ``jax.jit`` over ``shard_map``. A
CUDA graph is captured on one device's stream (``capture.Graph``), and a
collective that crosses devices (a copy to another card, an NCCL call) can
join a capture only on NCCL's terms. So, by ``collectives``
(``spatial.default_collectives`` picks it from the mesh):

  * ``"inside"``: one graph for the whole step, the collectives captured
    with the rest. Only for a mesh whose shards are all in this process on
    one device (``["cuda:0"] * S``), where the collectives are copies on
    that device.
  * ``"between"``: per device, one graph for each segment between two
    collectives (a device with no work in a segment captures an empty
    graph, whose replay does nothing), and the collectives run eagerly
    between the replays, from the tensors the graphs wrote into static
    results that the next graphs read (a copy each where the collective
    returns fresh tensors). Everywhere else: across cards, and on a
    ``GroupMesh`` rank, whose NCCL calls stay out of the graphs.

A replay keeps the capture's order: segment k's graphs, device by device,
then collective k. On the CPU the bodies run where the card replays, their
outputs copied into the static tensors, so the same plumbing is tested
there.
"""

from __future__ import annotations

import warnings
from functools import partial
from typing import NamedTuple

import torch

from groundgrid_torch.capture import Graph


class Gather(NamedTuple):
    """``all_gather`` of each value: the shard receives, per value, every
    shard's in shard order."""

    values: tuple


class Sum(NamedTuple):
    """``all_reduce_sum`` of ``value``, added in shard order."""

    value: torch.Tensor


class Relay(NamedTuple):
    """Shard ``src``'s ``value`` (None on the other shards), delivered to
    shard ``src + 1``; every shard receives it (or an (8, N) buffer)."""

    value: torch.Tensor | None
    src: int
    shape: tuple


def exchange(mesh, requests) -> list:
    """One collective over the mesh: each local shard's request, in local
    order, to its result."""
    first = requests[0]
    if isinstance(first, Gather):
        per_value = [mesh.all_gather([r.values[j] for r in requests])
                     for j in range(len(first.values))]
        return [tuple(got[k] for got in per_value) for k in range(len(requests))]
    if isinstance(first, Sum):
        return mesh.all_reduce_sum([r.value for r in requests])
    value = next((r.value for r in requests if r.value is not None), None)
    return [mesh.relay(value, first.src, first.shape)] * len(requests)


def _leaves(tree) -> list:
    """The tensors of nested tuples and lists, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return []


class _Lockstep:
    """The local shards' bodies, advanced together."""

    def __init__(self, bodies, inline=None):
        self.bodies = list(bodies)
        self.inline = inline  # a mesh: run the collectives in the same segment
        self.sent = [None] * len(self.bodies)  # each body's last collective result
        self.requests = [None] * len(self.bodies)
        self.results = [None] * len(self.bodies)  # each body's return value
        self.ended = False

    def send(self, results) -> None:
        self.sent = list(results)

    def advance(self, idx) -> list:
        """Run the bodies ``idx`` to their next request (through the
        collectives, with an ``inline`` mesh) or to their end; the tensors of
        their requests, or of their outputs."""
        while True:
            for k in idx:
                try:
                    self.requests[k] = self.bodies[k].send(self.sent[k])
                except StopIteration as stop:
                    self.requests[k], self.results[k] = None, stop.value
            ended = [self.requests[k] is None for k in idx]
            if any(ended):
                if not all(ended):
                    raise RuntimeError("the shards' bodies left lock-step")
                self.ended = True
                return _leaves([self.results[k] for k in idx])
            if self.inline is None:
                return _leaves([self.requests[k] for k in idx])
            for k, got in zip(idx, exchange(self.inline, self.requests)):
                self.sent[k] = got


def drive(mesh, bodies) -> list:
    """Run the local shards' bodies eagerly; their outputs, in local order."""
    lock = _Lockstep(bodies)
    every = range(len(lock.bodies))
    while True:
        lock.advance(every)
        if lock.ended:
            return lock.results
        lock.send(exchange(mesh, lock.requests))


class CapturedShards:
    """The local shards' bodies captured (see the module): :meth:`first`
    after one eager run on the card (the lazy set-up), :meth:`replay` from
    then on. Both take fresh bodies over the same static inputs and return
    the static outputs, in local order."""

    def __init__(self, mesh, collectives: str):
        if collectives not in ("inside", "between"):
            raise ValueError(f"collectives {collectives!r}: 'inside' or 'between'")
        groups: dict = {}
        for k, dev in enumerate(mesh.devices):
            groups.setdefault(dev, []).append(k)
        if collectives == "inside" and (len(groups) > 1 or len(mesh.shards) < mesh.size):
            raise ValueError("collectives inside the capture need every shard in this process "
                             f"on one device, not {list(groups)} for {len(mesh.shards)} of "
                             f"{mesh.size} shards")
        self.mesh, self.collectives = mesh, collectives
        self._groups = list(groups.items())
        self._schedule: list | None = None  # per segment: graphs, requests, results
        self._outputs: list | None = None

    @property
    def captured(self) -> bool:
        """Whether a CUDA graph was captured (never on the CPU)."""
        return any(g.graph is not None for g in self.graphs())

    def graphs(self) -> list[Graph]:
        return [g for graphs, _, _ in self._schedule or () for g, _ in graphs]

    @property
    def capture_seconds(self) -> float | None:
        return None if self._schedule is None else sum(g.seconds or 0.0 for g in self.graphs())

    @property
    def pool_bytes(self) -> int | None:
        return None if self._schedule is None else sum(g.pool_bytes or 0 for g in self.graphs())

    def __call__(self, make_bodies) -> list:
        """One run of fresh bodies (``make_bodies()``, over the static
        inputs): the first eagerly on the card (the lazy set-up, and this
        run's outputs), then the capture, which on the CPU runs them; a
        replay from then on."""
        if self._schedule is not None:
            return self.replay(make_bodies())
        if self._groups[0][0].type == "cuda":
            out = drive(self.mesh, make_bodies())
            self.first(make_bodies())
            return out
        return self.first(make_bodies())

    def _lockstep(self, bodies) -> _Lockstep:
        return _Lockstep(bodies, self.mesh if self.collectives == "inside" else None)

    def first(self, bodies) -> list:
        """The capture: segment by segment, each device's graph, then the
        collective, run eagerly into the static results (on the card the
        graphs ran nothing yet: it moves what the buffers hold)."""
        lock = self._lockstep(bodies)
        schedule = []
        while True:
            graphs = []
            for dev, idx in self._groups:
                graph = Graph(dev)
                with warnings.catch_warnings():
                    # a device with no work in this segment
                    warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                    graph.capture(partial(lock.advance, idx))
                graphs.append((graph, idx))
            if lock.ended:
                schedule.append((graphs, None, None))
                break
            requests = list(lock.requests)
            results = exchange(self.mesh, requests)
            schedule.append((graphs, requests, results))
            lock.send(results)
        self._schedule, self._outputs = schedule, lock.results
        return self._outputs

    def replay(self, bodies) -> list:
        lock = self._lockstep(bodies)  # run only on the CPU
        for graphs, requests, results in self._schedule:
            for graph, idx in graphs:
                graph.replay(partial(lock.advance, idx))
            if requests is not None:
                for dst, src in zip(_leaves(results), _leaves(exchange(self.mesh, requests)),
                                    strict=True):
                    if dst is not src:
                        dst.copy_(src)
                lock.send(results)
        return self._outputs
