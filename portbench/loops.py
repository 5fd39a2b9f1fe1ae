"""The three ways a traffic file drives the port: ``fleet``, ``live``, ``replay``.

Each loop builds the system under test from the port's public entries, warms
it up on a drive of its own, then steps drives over the pool until the
window closes, timing every unit (a fleet tick, or a scan) on the host clock
from the call to its result on the host. At the positions
:func:`traffic.check_positions` draws, it keeps what the timed path
produced (labels, outlier flags, the grid layers and center after the step)
for the current and the last complete drive, in buffers allocated before
the window, so that keeping them moves no memory inside it.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from portbench.traffic import WARMUP_DRIVE, Schedule


class Kept:
    """What the timed path produced at one checked position of a drive."""

    def __init__(self, labels, outlier, ground, groundpatch, center, summary=None, order=None):
        self.labels, self.outlier = labels, outlier  # (V, P) tensors or arrays
        self.ground, self.groundpatch = ground, groundpatch  # (V, N, N)
        self.center = center  # (V, 2) f64 host
        # the fleet summary's (ground, non-ground, outlier) counts, where kept
        self.summary = summary
        # a prepared scan's (V, P) order (labels and flags in the sorted
        # order, ``sorted = raw[order]``), None where they are in the raw one
        self.order = order


def in_raw_order(kept: Kept) -> Kept:
    """``kept`` with its labels and outlier flags in the raw scans' order:
    scattered back through the prepared scans' order where it has one."""
    if kept.order is None:
        return kept
    order = kept.order.long()

    def back(t):
        return torch.empty_like(t).scatter_(1, order, t)

    return Kept(back(kept.labels), back(kept.outlier), kept.ground, kept.groundpatch,
                kept.center, kept.summary)


class Loop:
    """The parts every loop shares: the schedule, the check positions, the
    record of each drive's kept outputs and of the window."""

    unit_scans = 1  # scans a timed unit completes

    def __init__(self, cx):
        self.cx = cx
        self.cfg, self.device, self.pool = cx.cfg, cx.device, cx.pool
        self.devices = cx.devices
        self.schedule = Schedule(cx.traffic, cx.seed, cx.pool.poses)
        self.positions = set(cx.positions)
        # drive -> position -> Kept (the fleet: a list, one Kept a card)
        self.kept: dict[int, dict[int, Kept | list]] = {}
        self.keeping = True
        self.next_tick = 0  # the tick the next stretch starts at
        self.tracer = None

    def _forget_old(self, drive: int) -> None:
        for old in [d for d in self.kept if d < drive - 1]:
            del self.kept[old]

    def counted(self) -> dict:
        """The check's numbers the loop counts itself, read once after the
        window (``check.NUMBERS``); none here."""
        return {}

    def checked_drive(self, stretch: "Stretch") -> int:
        """The drive the check replays: the stretch's last complete one,
        else the one it ended in."""
        if stretch.complete:
            return stretch.complete[-1]
        if not self.kept:
            raise RuntimeError("the window reached no check position: it is too short")
        return max(self.kept)

    def check_blocks(self, kept: dict) -> list:
        """The vehicles the check compares, as (vehicle slice, device,
        position -> Kept) blocks, from a drive's kept outputs: one block,
        every vehicle, on the run's device."""
        return [(slice(None), self.device, kept)]

    def run(self, seconds: float, keep: bool = True) -> "Stretch":
        """Step units from where the last stretch ended until ``seconds``
        have passed; with ``keep``, keep the outputs at the check
        positions."""
        d = self.schedule.drive_scans
        out = Stretch(self.unit_scans)
        self.keeping = keep
        t0 = time.perf_counter()
        deadline = t0 + seconds
        t = self.next_tick
        while time.perf_counter() < deadline:
            drive, pos = divmod(t, d)
            if pos == 0 and keep:
                self._forget_old(drive)
            start = time.perf_counter()
            with self.span(self.unit_name):
                self._unit(t, drive, pos)
            out.latencies.append(time.perf_counter() - start)
            out.indices.append(t)
            if pos == d - 1:
                out.complete.append(drive)
            t += 1
        self.next_tick = t
        out.elapsed = time.perf_counter() - t0
        return out

    def span(self, name: str):
        return self.tracer.span(name) if self.tracer is not None else contextlib.nullcontext()


class Stretch:
    """The record of one stretch of units: each unit's host latency, its
    index (tick or scan), the drives it completed and its length."""

    def __init__(self, unit_scans: int):
        self.unit_scans = unit_scans
        self.latencies: list[float] = []
        self.indices: list[int] = []
        self.complete: list[int] = []
        self.elapsed = 0.0

    @property
    def units(self) -> int:
        return len(self.indices)

    @property
    def scans(self) -> int:
        return self.units * self.unit_scans


def _pose_sets(poses: np.ndarray, t_sensor_base: np.ndarray):
    """f32 (T_map_velo, T_map_base, T_base_map) of f64 sensor poses (..., 4,
    4), as the port's ``transforms.scan_poses`` derives them, for a whole
    drive at once."""
    mb = poses @ t_sensor_base
    r, t = mb[..., :3, :3], mb[..., :3, 3]
    bm = np.zeros_like(mb)
    bm[..., :3, :3] = np.swapaxes(r, -1, -2)
    bm[..., :3, 3] = -np.einsum("...ji,...j->...i", r, t)
    bm[..., 3, 3] = 1.0
    return poses.astype(np.float32), mb.astype(np.float32), bm.astype(np.float32)


class Fleet(Loop):
    """``fleet``: V vehicles in lock-step on the traffic's ``cards`` cards,
    one ``make_fleet_step(config, mesh)(states, scans)`` a tick and the
    tick's one read, the fleet summary. Card k steps the vehicles of
    ``fleet_sharding``'s block k. The pool's raw scans are staged on every
    card before the window, as a simulator rendering on the cards hands
    them over; each tick gathers each block's scans on its own card. Where
    the cell's check compares the summary (``summary_off``), the tick's
    summary is kept at the checked positions too.

    A sorted-scan configuration steps prepared scans instead
    (``prepare.PreparedDrives``: map frame, cell-sorted, made on each card
    before the window from the staged pool); each tick takes its block's
    rows of the drive's prepared set and the centers they were sorted
    against. Its outputs come back in the sorted order: the check maps them
    back (:func:`in_raw_order`), after the window, and compares the step's
    count of scans that reached it unsorted with the planted scans it
    stepped (``fallbacks_off``)."""

    unit_name = "tick"

    def __init__(self, cx):
        super().__init__(cx)
        from groundgrid_torch import make_fleet_step
        from groundgrid_torch.core import transforms as tf
        from groundgrid_torch.parallel.sharding import fleet_sharding

        self.tf = tf
        v, s = self.schedule.vehicles, self.schedule.pool
        self.step = make_fleet_step(self.cfg, self.devices)
        self.blocks = fleet_sharding(self.step.mesh, v)
        p = self.pool
        rows = torch.zeros((5, s, p.points.shape[1]), dtype=torch.float32, device=self.device)
        rows[:3] = p.points.permute(2, 0, 1)
        rows[3].view(torch.int32)[:] = p.rings
        valid = torch.arange(p.points.shape[1], device=self.device)[None] < torch.tensor(
            p.counts, device=self.device)[:, None]
        rows[4].view(torch.int32)[:] = valid.to(torch.int32)
        tick_rows = torch.tensor([self.schedule.indices(t) for t in range(2 * s)],
                                 device=self.device)
        # each card's copy of the pool and its block's pool indices a tick
        self.rows = [rows.to(d) for _, d in self.blocks]
        self.tick_rows = [tick_rows[:, b].contiguous().to(d) for b, d in self.blocks]
        self.prepared = None
        self.planted = 0  # planted scans stepped (``prepare.plant``)
        if self.cfg.sorted_scans:
            from portbench.prepare import SETS, PreparedDrives

            self.schedule.sets = SETS
            t0 = time.perf_counter()
            self.prepared = PreparedDrives(self.cfg, self.schedule, self.rows, self.blocks,
                                           self.positions)
            self.prepare_seconds = time.perf_counter() - t0
        self.unit_scans = v
        n, points = self.cfg.cell_count, p.points.shape[1]

        def slot(vehicles: slice, d) -> Kept:
            b = vehicles.stop - vehicles.start
            return Kept(torch.empty((b, points), dtype=torch.int32, device=d),
                        torch.empty((b, points), dtype=torch.int32, device=d),
                        torch.empty((b, n, n), dtype=torch.float32, device=d),
                        torch.empty((b, n, n), dtype=torch.float32, device=d), None)

        # one slot a card for each drive parity and checked position
        self.slots = {(key, pos): [slot(b, d) for b, d in self.blocks]
                      for key in range(2) for pos in sorted(self.positions)}
        # the summary's three counts, on the first card, where the check compares it
        self.summary_slots = {
            (key, pos): torch.empty(3, dtype=torch.int64, device=self.step.mesh[0])
            for key in range(2) for pos in sorted(self.positions)
        } if "summary_off" in cx.cell.limits else None

    def _start(self, drive: int) -> None:
        from groundgrid_torch import init_state
        from groundgrid_torch.parallel.sharding import shard_fleet_pytree, stack_fleet_pytree
        from groundgrid_torch.pipeline import CenterTracker

        idx, poses = self.schedule.drive_poses(drive)
        self.drive_sets = _pose_sets(poses, self.tf.T_KITTIBASE_BASE)
        self.drive_poses = poses
        # each block's fresh grids made on its own card
        self.states = [shard_fleet_pytree(stack_fleet_pytree(
            [init_state(self.cfg, poses[0, v], d) for v in range(self.schedule.vehicles)[b]]),
            [d])[0] for b, d in self.blocks]
        if self.prepared is None:
            self.tracker = CenterTracker(self.cfg, poses[0, :, :2, 3])

    def _unit(self, t: int, drive: int, pos: int) -> None:
        from groundgrid_torch import Scan

        with self.span("fleet.prep"):
            if pos == 0:
                self._start(drive)
            if self.prepared is None:
                blks = [rows[:, tick_rows[t % len(tick_rows)]]
                        for rows, tick_rows in zip(self.rows, self.tick_rows)]
                self.tracker.update(self.drive_poses[pos, :, :2, 3])
                chi, clo = self.tracker.center_ds()
            else:
                blks = [self.prepared.block_rows(k, drive, pos) for k in range(len(self.blocks))]
                chi, clo = self.prepared.center(drive, pos)
                self.planted += int(pos == self.prepared.planted_pos)
            mv, mb, bm = (a[pos] for a in self.drive_sets)
            scans = [Scan(px=blk[0], py=blk[1], pz=blk[2], rings=blk[3].view(torch.int32),
                          valid=blk[4].view(torch.int32), t_map_velo=mv[b], t_map_base=mb[b],
                          t_base_map=bm[b], center=chi[b], center_lo=clo[b])
                     for (b, _), blk in zip(self.blocks, blks)]
        with self.span("fleet.step"):
            self.states, outs, summary = self.step(self.states, scans)
        with self.span("fleet.summary"):
            int(summary.ground_points)
        if self.keeping and pos in self.positions:
            self._keep(drive, pos, outs, summary)

    def _keep(self, drive: int, pos: int, outs, summary) -> None:
        kept = []
        for k, (slot, block, out) in enumerate(zip(self.slots[drive % 2, pos], self.states,
                                                   outs)):
            slot.labels.copy_(out.labels)
            slot.outlier.copy_(out.outlier)
            slot.ground.copy_(block.ground)
            slot.groundpatch.copy_(block.groundpatch)
            center = block.center.numpy().astype(np.float64) + block.center_lo.numpy()
            order = None if self.prepared is None else self.prepared.order(k, drive, pos)
            kept.append(Kept(slot.labels, slot.outlier, slot.ground, slot.groundpatch, center,
                             order=order))
        if self.summary_slots is not None:
            kept[0].summary = torch.stack(tuple(summary), out=self.summary_slots[drive % 2, pos])
        self.kept.setdefault(drive, {})[pos] = kept

    def check_blocks(self, kept: dict) -> list:
        """One block a card: its vehicles, its card and what it kept at each
        position (the first block also the summary), in the raw scans'
        order."""
        return [(b, d, {pos: in_raw_order(blocks[k]) for pos, blocks in kept.items()})
                for k, (b, d) in enumerate(self.blocks)]

    def counted(self) -> dict:
        """A sorted fleet's ``fallbacks_off``: how far the scans whose cell
        ids the step found unsorted, over every card
        (``FleetStep.fallbacks``), lie from the planted scans it stepped."""
        if self.prepared is None:
            return {}
        return {"fallbacks_off": abs(self.step.fallbacks - self.planted)}

    def warmup(self) -> None:
        d = self.schedule.drive_scans
        for pos in range(d):
            self._unit(pos, WARMUP_DRIVE, pos)
        self._unit(0, 0, 0)  # a restart
        self.kept.clear()

    def step_objects(self):
        return self.step.steps

    def release(self) -> None:
        """Drop the system under test (its graphs, pools and state); the
        kept outputs stay."""
        del self.step, self.states, self.rows
        if self.prepared is not None:
            self.prepared.rows = None


class _Single(Loop):
    """The parts of the one-vehicle loops: the driver, the records as the
    sensor driver delivers them (raw points, ring channel and pose in host
    memory) and the state slots."""

    def __init__(self, cx):
        super().__init__(cx)
        from groundgrid_torch import StreamingDriver

        self.driver = StreamingDriver(self.cfg, self.device)
        p = self.pool
        self.host_points = [p.points[i, :c].cpu().numpy() for i, c in enumerate(p.counts)]
        self.host_rings = [p.rings[i, :c].cpu().numpy() for i, c in enumerate(p.counts)]
        n = self.cfg.cell_count
        self.slots = {(key, pos): (torch.empty((1, n, n), dtype=torch.float32, device=self.device),
                                   torch.empty((1, n, n), dtype=torch.float32, device=self.device))
                      for key in range(2) for pos in self.positions}
        self.drive_poses = {}

    def record(self, t: int, drive: int, pos: int):
        from groundgrid_torch import ScanRecord

        if drive not in self.drive_poses:
            self.drive_poses = {drive: self.schedule.drive_poses(drive)}
        idx, poses = self.drive_poses[drive]
        i = int(idx[pos, 0])
        return ScanRecord(index=t, timestamp=0.1 * t, points=self.host_points[i],
                          labels=self.host_rings[i], t_map_velo=poses[pos, 0])

    def keep_state(self, drive: int, pos: int) -> None:
        g, c = self.slots[drive % 2, pos]
        state = self.driver.state
        g[0].copy_(state.ground)
        c[0].copy_(state.groundpatch)
        center = (state.center_np.astype(np.float64) + state.center_lo_np)[None]
        self.kept.setdefault(drive, {})[pos] = Kept(None, None, g, c, center)

    def keep_result(self, drive: int, pos: int, res) -> None:
        k = self.kept[drive][pos]
        k.labels, k.outlier = res.labels[None], res.outlier[None]

    def step_objects(self):
        return [self.driver.step]

    def release(self) -> None:
        del self.driver


class Live(_Single):
    """``live``: one vehicle, lock-step: the next record is handed to
    ``StreamingDriver.process`` only after the last scan's labels are on the
    host."""

    unit_name = "scan"

    def _unit(self, t: int, drive: int, pos: int) -> None:
        if pos == 0:
            self.driver.reset()
        rec = self.record(t, drive, pos)
        res = self.driver.process(rec)
        if self.keeping and pos in self.positions:
            self.keep_state(drive, pos)
            self.keep_result(drive, pos, res)

    def warmup(self) -> None:
        for pos in range(self.schedule.drive_scans):
            self._unit(pos, WARMUP_DRIVE, pos)
        self.kept.clear()


class Replay(_Single):
    """``replay``: one vehicle, each drive a sequence handed to
    ``StreamingDriver.run(records, pipeline_depth)``, so host prep of the
    next scans overlaps the device's work on those in flight."""

    def _drive(self, drive: int, first_t: int, deadline: float | None, on_result) -> int:
        d = self.schedule.drive_scans
        depth = int(self.cx.traffic["pipeline_depth"])
        self.driver.reset()

        def records():
            for pos in range(d):
                if deadline is not None and time.perf_counter() >= deadline:
                    return
                yield self.record(first_t + pos, drive, pos)
                # the scan just handed over is dispatched now, the next not yet
                if self.keeping and pos in self.positions:
                    self.keep_state(drive, pos)

        done = 0
        for res in self.driver.run(records(), pipeline_depth=depth):
            pos = res.index - first_t
            if self.keeping and pos in self.positions:
                self.keep_result(drive, pos, res)
            on_result(res)
            done += 1
        return done

    def warmup(self) -> None:
        self._drive(WARMUP_DRIVE, 0, None, lambda res: None)
        self.kept.clear()

    def run(self, seconds: float, keep: bool = True) -> Stretch:
        """Whole drives, each its own ``run`` call, from the next drive on,
        until ``seconds`` have passed (the drive then in progress stops
        handing over records and drains); a unit's latency is the time
        since the result before it."""
        d = self.schedule.drive_scans
        out = Stretch(1)
        self.keeping = keep
        t0 = time.perf_counter()
        deadline = t0 + seconds
        last = [t0]

        def on_result(res):
            now = time.perf_counter()
            out.latencies.append(now - last[0])
            out.indices.append(res.index)
            last[0] = now

        drive = self.next_tick // d
        while time.perf_counter() < deadline:
            if keep:
                self._forget_old(drive)
            with self.span("drive"):
                done = self._drive(drive, drive * d, deadline, on_result)
            if done == d:
                out.complete.append(drive)
            drive += 1
        self.next_tick = drive * d
        out.elapsed = last[0] - t0
        return out


LOOPS = {"fleet": Fleet, "live": Live, "replay": Replay}
