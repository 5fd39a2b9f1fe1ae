"""Fleet (batch) parallelism over a list of devices.

The torch counterpart of ``groundgrid_tpu/parallel/sharding.py``: the
scaling axis of BASELINE.json config 5 is the *fleet*, B independent ego
vehicles (sequences) stepped in lock-step, one grid state each. The mesh is
an explicit list of devices; device k owns the vehicles ``[k b, (k+1) b)``,
``b = B / len(mesh)``. Repeats are allowed: ``["cpu"] * 8`` mirrors the JAX
tests' 8 virtual CPU devices, and one H100 is ``["cuda:0"]``.

A fleet value is a list with one block per mesh device, each block a
``GridState`` or ``Scan`` whose leaves are stacked over its vehicles
(:func:`stack_fleet_pytree`, :func:`shard_fleet_pytree`). Tensors live on
the block's device; NumPy leaves (poses, scan centers) and the grid
centers, host values by design (``core/grid.py``), stay on the host.

How a device steps its block follows the JAX package's choice
(``groundgrid_tpu/parallel/sharding.py:58-62``), by ``config.sorted_scans``:

* sorted scans: the vehicles in order, the counterpart of its ``lax.map``:
  one captured vehicle step per device (``pipeline.CapturedStep``), and
  per vehicle its block slices copied into the step's static buffers, one
  replay, its layers and outputs copied back;
* unsorted scans (the config default): the whole block as one batched
  body, the counterpart of its ``jax.vmap``: one captured step per device
  on (B, ...) static buffers, one replay a tick, each kernel launched once
  for all of the device's vehicles (K3 one block a grid). The block's
  state is the step's static layers, updated in place.

Either way each vehicle is bitwise its single step, the scan scalars of a
block are computed in one NumPy pass over its vehicles
(``pipeline.scan_scalars`` on the stacked centers and scan) and ship in
one copy a tick, and the step reads nothing back to the host, so a tick
is one stream of launches and replays per device. The
fleet summary is summed on the device and, when ``torch.distributed`` is
initialized, reduced over the group by one ``all_reduce`` (the JAX
``psum``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from groundgrid_torch import trace
from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core.classify import LABEL_GROUND, LABEL_NONGROUND
from groundgrid_torch.core.grid import GridState
from groundgrid_torch.pipeline import StepOutput, make_step, to_device

# leaves that stay on the host whatever the block's device
_HOST_FIELDS = {GridState: ("center", "center_lo")}


class FleetSummary(NamedTuple):
    """Per-tick fleet statistics, summed over the fleet (and the group)."""

    ground_points: torch.Tensor  # () int64, on the mesh's first device
    nonground_points: torch.Tensor
    outliers: torch.Tensor


def make_mesh(devices: Sequence) -> tuple[torch.device, ...]:
    """The fleet's devices, in block order; a CUDA device without CUDA raises."""
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    for d in mesh:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {d} requested but CUDA is not available")
    return mesh


def fleet_sharding(mesh: Sequence[torch.device], batch: int) -> list[tuple[slice, torch.device]]:
    """Each device's block of a ``batch``-vehicle fleet: (vehicles, device)."""
    n = len(mesh)
    if batch < 1 or batch % n:
        raise ValueError(f"batch {batch} not divisible by {n} devices")
    b = batch // n
    return [(slice(k * b, (k + 1) * b), d) for k, d in enumerate(mesh)]


def _leaves(tree) -> dict:
    if dataclasses.is_dataclass(tree):
        return {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    return tree._asdict()


def stack_fleet_pytree(trees: Sequence):
    """One tree of per-vehicle ``GridState`` or ``Scan`` values, stacked
    along a new leading fleet dimension (None leaves stay None)."""
    first = trees[0]

    def stack(name, values):
        if values[0] is None:
            return None
        if isinstance(values[0], torch.Tensor):
            return torch.stack(values)
        return np.stack([np.asarray(v) for v in values])

    return type(first)(**{name: stack(name, [_leaves(t)[name] for t in trees])
                          for name in _leaves(first)})


def _place(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; from the CPU to a card in one copy from pinned memory."""
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def shard_fleet_pytree(tree, mesh: Sequence[torch.device]) -> list:
    """Split a stacked fleet tree into the mesh's blocks, each on its device."""
    leaves = _leaves(tree)
    host = _HOST_FIELDS.get(type(tree), ())
    batch = next(len(v) for v in leaves.values() if v is not None)
    blocks = []
    for rows, device in fleet_sharding(mesh, batch):
        block = {}
        for name, v in leaves.items():
            if v is None:
                block[name] = None
            elif isinstance(v, np.ndarray):
                block[name] = v[rows].copy()
            elif name in host:
                block[name] = v[rows].clone()
            else:
                block[name] = _place(v[rows], device)
        blocks.append(type(tree)(**block))
    return blocks


def _vehicle(scan, i: int):
    """Vehicle ``i`` of a stacked scan block."""
    return type(scan)(*(None if v is None else v[i] for v in scan))


class FleetStep:
    """``(states, scans) -> (states, outs, summary)`` over the mesh's blocks.

    ``states`` and ``scans`` are lists of blocks (:func:`shard_fleet_pytree`).
    Each device steps its block with its own step (``steps``,
    ``pipeline.make_step``'s: captured, or eager for the plain versions):
    vehicle by vehicle for sorted configs, as one batch otherwise
    (``batched``, from ``config.sorted_scans`` as the JAX fleet step
    chooses). ``states`` is updated in place and returned (the JAX fleet
    step donates it): each block's layers and centers are its vehicles'
    new ones. ``outs`` holds one stacked ``StepOutput`` per block; the
    summary's counts are int64 tensors on the mesh's first device.
    """

    def __init__(self, config: GroundGridConfig, mesh: Sequence[torch.device]):
        self.config = config
        self.mesh = tuple(mesh)
        self.steps = [make_step(config) for _ in self.mesh]
        self.batched = not config.sorted_scans
        self.ticks = 0  # calls so far: the tick's id in the trace

    @property
    def fallbacks(self) -> int:
        """Sortedness fallbacks over every device's step (a host read)."""
        return sum(step.fallbacks for step in self.steps)

    def __call__(self, states: list, scans: list):
        if not len(states) == len(scans) == len(self.mesh):
            raise ValueError(f"need one state and one scan block per device ({len(self.mesh)})")
        tick, self.ticks = self.ticks, self.ticks + 1
        with trace.span("fleet.tick", tick):
            outs, totals = [], []
            for step, block, scan in zip(self.steps, states, scans):
                with trace.span("fleet.scalars"):
                    host = step.scalars(block.center.numpy(), block.center_lo.numpy(), scan)
                with trace.span("fleet.copy"):
                    scalars = to_device(host[0], block.ground.device)
                if self.batched:
                    out = self._batch(step, block, scan, scalars, *host[1:])
                else:
                    out = self._vehicles(step, block, scan, scalars, *host[1:])
                outs.append(out)
                totals.append(torch.stack([(out.labels == LABEL_GROUND).sum(),
                                           (out.labels == LABEL_NONGROUND).sum(),
                                           out.outlier.sum(dtype=torch.int64)]))
            total = totals[0]
            for t in totals[1:]:
                total = total + t.to(total.device)
            if dist.is_available() and dist.is_initialized():
                dist.all_reduce(total)
        return states, outs, FleetSummary(*total.unbind(0))

    @staticmethod
    def _batch(step, block: GridState, scan, scalars, center, center_lo) -> StepOutput:
        """The block as one batched step; its layers become the step's
        (static, on a captured step) new ones."""
        state, out = step.run(block, scan, scalars, center, center_lo)
        block.ground, block.groundpatch = state.ground, state.groundpatch
        block.center, block.center_lo = state.center, state.center_lo
        return out

    @staticmethod
    def _vehicles(step, block: GridState, scan, scalars, center, center_lo) -> StepOutput:
        """The block vehicle by vehicle, each copied in and out of the step."""
        per_vehicle = []
        for i in range(block.ground.shape[0]):
            vehicle = GridState(ground=block.ground[i], groundpatch=block.groundpatch[i],
                                center=block.center[i], center_lo=block.center_lo[i])
            vehicle, out = step.run(vehicle, _vehicle(scan, i), scalars[i], center[i],
                                    center_lo[i])
            block.ground[i].copy_(vehicle.ground)
            block.groundpatch[i].copy_(vehicle.groundpatch)
            block.center[i], block.center_lo[i] = vehicle.center, vehicle.center_lo
            per_vehicle.append(out)
        return StepOutput(*(torch.stack(field) for field in zip(*per_vehicle)))


def make_fleet_step(config: GroundGridConfig, mesh: Sequence[torch.device]) -> FleetStep:
    """The batched fleet step over ``mesh`` (:class:`FleetStep`); the
    summary is reduced over the default group when ``torch.distributed`` is
    initialized."""
    return FleetStep(config, make_mesh(mesh))
