"""Multi-process fleet scaling: the cross-host half of BASELINE config 5.

The torch counterpart of ``groundgrid_tpu/parallel/multihost.py``. The
single-process fleet (``parallel/sharding.py``) steps a vehicle batch over
one process's devices; this module runs the same fleet step in every
process of a ``torch.distributed`` group, each process feeding only its own
vehicles (``local_batch = global_batch / processes``), and reduces the
fleet summary over the group with one ``all_reduce``:

  * :func:`init_multihost` initializes ``torch.distributed`` from explicit
    arguments or the environment (``MASTER_ADDR``, ``WORLD_SIZE``,
    ``RANK``), with NCCL for a CUDA device and gloo for the CPU. It is
    idempotent, and a bare single process stays uninitialized;
  * :class:`MultiHostFleet` places a process's local vehicles on its
    devices (:meth:`~MultiHostFleet.from_local`), steps them and reads
    them back (:meth:`~MultiHostFleet.to_local`);
  * :func:`aggregate_host_counts` / :func:`all_hosts_agree` cover the
    eval-side reductions (confusion counts merged across processes).

Process ``r`` owns the global vehicles ``[r local_batch, (r+1)
local_batch)``; the global fleet's labels are those of one process stepping
all of them (``tests/test_torch_multihost.py``, two gloo processes).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.parallel.sharding import (
    _leaves,
    make_fleet_step,
    make_mesh,
    shard_fleet_pytree,
)


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def init_multihost(coordinator_address: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, device=None) -> bool:
    """Initialize ``torch.distributed`` (idempotent).

    Returns True when running multi-process afterwards. The group is
    reached at ``coordinator_address`` (``tcp://host:port`` or
    ``file://path``), else through ``MASTER_ADDR`` / ``MASTER_PORT``; world
    size and rank come from the arguments, else from ``WORLD_SIZE`` and
    ``RANK``. ``device``, this process's device, picks the backend: NCCL
    for CUDA, gloo for the CPU; a CUDA device becomes this process's
    current device, so the group's collectives run on it. With neither an
    address nor ``MASTER_ADDR`` this is a no-op returning False, so call
    sites run unmodified in one process.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None and "MASTER_ADDR" not in os.environ:
        return False
    if device is None:
        raise TypeError("init_multihost needs this process's device (NCCL for CUDA, gloo "
                        "for the CPU)")
    device = make_mesh([device])[0]
    world = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
    rank = int(os.environ["RANK"]) if process_id is None else process_id
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=coordinator_address or "env://",
                            world_size=world, rank=rank)
    return world > 1


class FleetShardInfo(NamedTuple):
    """Static shape bookkeeping for one process's slice of the fleet."""

    global_batch: int
    local_batch: int
    process_index: int
    process_count: int


class MultiHostFleet:
    """Fleet stepper fed from process-local vehicles.

    Usage (identical in 1 or N processes)::

        fleet = MultiHostFleet(config, vehicles_per_device=2, devices=["cuda:0"])
        states = fleet.from_local(local_states)   # leading dim = local_batch
        scans = fleet.from_local(local_scans)
        states, outs, summary = fleet.step(states, scans)
        my_outs = fleet.to_local(outs)            # this process's vehicles

    ``devices``: this process's devices (repeats allowed). The summary is
    reduced over the default group when ``torch.distributed`` is
    initialized.
    """

    def __init__(self, config: GroundGridConfig, vehicles_per_device: int = 1, devices=None):
        if devices is None:
            raise TypeError("MultiHostFleet needs this process's devices")
        self.mesh = make_mesh(devices)
        n_proc = _world()
        local = len(self.mesh) * vehicles_per_device
        self.info = FleetShardInfo(
            global_batch=local * n_proc,
            local_batch=local,
            process_index=dist.get_rank() if n_proc > 1 else 0,
            process_count=n_proc,
        )
        self.step = make_fleet_step(config, self.mesh)

    def from_local(self, tree) -> list:
        """Place this process's stacked vehicles on its devices.

        Every leaf must have leading dim ``info.local_batch``; returns the
        blocks of :func:`~groundgrid_torch.parallel.sharding.shard_fleet_pytree`.
        """
        lb = self.info.local_batch
        for v in _leaves(tree).values():
            if v is not None and v.shape[0] != lb:
                raise ValueError(f"leading dim {v.shape[0]} != local_batch {lb}")
        return shard_fleet_pytree(tree, self.mesh)

    def to_local(self, blocks: list):
        """This process's vehicles of a fleet value (a list of blocks), as one
        tree of stacked NumPy arrays on the host."""
        def gather(values):
            if values[0] is None:
                return None
            return np.concatenate([v.cpu().numpy() if isinstance(v, torch.Tensor)
                                   else np.asarray(v) for v in values])

        first = _leaves(blocks[0])
        return type(blocks[0])(**{name: gather([_leaves(b)[name] for b in blocks])
                                  for name in first})


def _collective_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def aggregate_host_counts(counts: np.ndarray) -> np.ndarray:
    """Sum per-process count arrays (the evaluator's confusion counts) over
    the group: one int64 ``all_reduce``. Single process: ``counts``."""
    if _world() <= 1:
        return np.asarray(counts)
    t = torch.from_numpy(np.asarray(counts, np.int64)).to(_collective_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def all_hosts_agree(value: int) -> bool:
    """True iff every process supplies the same integer (a sync sanity check)."""
    if _world() <= 1:
        return True
    t = torch.tensor([value, -value], dtype=torch.int64).to(_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)  # (max, -min)
    return bool(t[0] == -t[1])
