"""Fleet driver: B ego vehicles stepped in lock-step over a device mesh.

The torch counterpart of ``groundgrid_tpu/runtime/fleet.py``, BASELINE.json
config 5 ("batched streaming: 64 scans/step across a multi-sequence batch
dim") as a runtime API: each vehicle owns its own grid state, and one tick
advances every vehicle one scan (``parallel/sharding.py``). The step reads
nothing back to the host, so a tick makes one blocking device-to-host read
per device, which fetches the labels, the outlier flags and (on the first
device) the fleet summary together. Per-vehicle results are bitwise those
of one :class:`~groundgrid_torch.runtime.driver.StreamingDriver` per
vehicle over the same stream.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.data.semantickitti import ScanRecord
from groundgrid_torch.parallel.sharding import (
    FleetSummary,
    make_fleet_step,
    make_mesh,
    shard_fleet_pytree,
    stack_fleet_pytree,
)
from groundgrid_torch.pipeline import CenterTracker, init_state, pad_scan, prepare_scan


@dataclasses.dataclass
class FleetTickResult:
    """One lock-step tick: per-vehicle labels + the fleet's summed stats."""

    indices: List[int]
    labels: np.ndarray  # (B, P) int32, each row in its scan's point order
    outlier: np.ndarray  # (B, P) int32
    n_points: List[int]
    ground_points: int
    nonground_points: int
    outliers: int


@dataclasses.dataclass
class FleetInFlight:
    """A dispatched tick whose outputs are not fetched yet."""

    records: List[ScanRecord]
    outs: list  # one stacked pipeline.StepOutput per device
    summary: FleetSummary
    orders: List[Optional[np.ndarray]]  # per-vehicle host sort permutation (sorted mode)


class FleetDriver:
    """Drives ``batch`` vehicles in lock-step; one fetch per device per tick.

    Give ``device`` (one device owns the whole fleet) or ``mesh`` (a list of
    devices, each owning ``batch / len(mesh)`` vehicles). A CUDA device when
    none is present raises, and nothing falls back to the CPU. The summary
    is reduced over the default group when ``torch.distributed`` is
    initialized.
    """

    def __init__(self, config: GroundGridConfig, batch: int, device=None, mesh=None):
        if (device is None) == (mesh is None):
            raise TypeError("FleetDriver needs an explicit device or mesh (exactly one)")
        if config.wire_format:
            raise ValueError("the fleet steps Scan records: config.wire_format is not supported")
        self.mesh = make_mesh([device] if mesh is None else mesh)
        if batch < 1 or batch % len(self.mesh):
            raise ValueError(f"batch {batch} not divisible by {len(self.mesh)} devices")
        self.config = config
        self.batch = batch
        self.step = make_fleet_step(config, self.mesh)
        self.states: list | None = None  # one stacked GridState block per device
        # per-vehicle f64 host center trackers, in both modes: grid_map
        # resolves half-cell snap ties in double precision, and an f32-cast
        # position can land on the other side of the tie
        self._trackers: List[CenterTracker] | None = None

    def _batch_scans(self, records: Sequence[ScanRecord]):
        """Host prep of one record per vehicle; the stacked scans placed on
        the mesh and each vehicle's sort permutation (None: unsorted mode)."""
        cfg = self.config
        positions = [np.asarray(r.t_map_velo, np.float64)[:2, 3] for r in records]
        if self._trackers is None:
            self._trackers = [CenterTracker(cfg, pos) for pos in positions]
        scans, orders = [], []
        for tracker, rec, pos in zip(self._trackers, records, positions):
            center = tracker.update(pos)
            if cfg.sorted_scans:
                scan, order = prepare_scan(cfg, rec.points[:, :3], rec.labels, rec.t_map_velo,
                                           center, "cpu")
            else:
                chi, clo = tracker.center_ds()
                scan = pad_scan(cfg, rec.points, rec.labels, rec.t_map_velo, "cpu")
                scan, order = scan._replace(center=chi, center_lo=clo), None
            scans.append(scan)
            orders.append(order)
        return shard_fleet_pytree(stack_fleet_pytree(scans), self.mesh), orders

    def dispatch(self, records: Sequence[ScanRecord]) -> FleetInFlight:
        """Prepare and step one tick (``len(records) == batch``); fetch nothing."""
        if len(records) != self.batch:
            raise ValueError(f"expected {self.batch} records, got {len(records)}")
        if self.states is None:
            per_vehicle = [init_state(self.config, r.t_map_velo, "cpu") for r in records]
            self.states = shard_fleet_pytree(stack_fleet_pytree(per_vehicle), self.mesh)
        scans, orders = self._batch_scans(records)
        self.states, outs, summary = self.step(self.states, scans)
        return FleetInFlight(records=list(records), outs=outs, summary=summary, orders=orders)

    def fetch(self, tick: FleetInFlight) -> FleetTickResult:
        """The tick's one blocking read per device, then each vehicle's labels
        and outlier flags in its scan's own point order."""
        p = self.config.max_points
        labels, outlier = [], []
        for k, out in enumerate(tick.outs):
            words = [out.labels.reshape(-1), out.outlier.reshape(-1)]
            if k == 0:
                words.append(torch.stack(tuple(tick.summary)).view(torch.int32))
            host = torch.cat(words).cpu().numpy()
            b = out.labels.shape[0]
            labels.append(host[:b * p].reshape(b, p))
            outlier.append(host[b * p:2 * b * p].reshape(b, p))
            if k == 0:
                summary = host[2 * b * p:].view(np.int64)
        labels, outlier = np.concatenate(labels), np.concatenate(outlier)
        if self.config.sorted_scans:
            restored_l, restored_o = np.empty_like(labels), np.empty_like(outlier)
            for v, order in enumerate(tick.orders):
                restored_l[v, order] = labels[v]
                restored_o[v, order] = outlier[v]
            labels, outlier = restored_l, restored_o
        return FleetTickResult(
            indices=[r.index for r in tick.records],
            labels=labels,
            outlier=outlier,
            n_points=[min(r.points.shape[0], p) for r in tick.records],
            ground_points=int(summary[0]),
            nonground_points=int(summary[1]),
            outliers=int(summary[2]),
        )

    def process(self, records: Sequence[ScanRecord]) -> FleetTickResult:
        """Advance every vehicle by one scan (``len(records) == batch``)."""
        return self.fetch(self.dispatch(records))

    def run(self, sources: Sequence[Iterable[ScanRecord]]) -> Iterator[FleetTickResult]:
        """Lock-step over B record streams until the shortest is exhausted."""
        if len(sources) != self.batch:
            raise ValueError(f"expected {self.batch} sources, got {len(sources)}")
        iterators = [iter(s) for s in sources]
        while True:
            records = []
            for it in iterators:
                rec = next(it, None)
                if rec is None:
                    return
                records.append(rec)
            yield self.process(records)
