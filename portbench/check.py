"""How ``correct`` is decided: the reference replays the checked drive and
each kept output of the timed path is compared with it.

Three numbers, each held to its limit from the cell's file under
``portbench/checks/``:

* ``point_mismatch``: the share of the checked scans' points whose label
  (ground, non-ground, dropped) or outlier flag (the occlusion march's)
  differs from the reference's;
* ``layer_mismatch``: the share of grid cells whose ground height differs
  by more than ``LAYER_TOL_M`` or whose ground confidence by more than
  ``LAYER_TOL_CONF``, after the step;
* ``center_off``: the grids whose center after the step lies half a cell
  or more from the reference's (the center moves by whole cells, so any
  fault is a cell off); an exact comparison, its limit 0.

and, in a cell whose file gives it a limit, a fourth:

* ``summary_off``: how far the fleet summary a tick kept at each checked
  position (its ground, non-ground and outlier counts, summed over the
  cards) lies from the same counts taken over every vehicle's kept labels
  and flags, summed over the positions and the three counts; an exact
  comparison, its limit 0. The kept labels are each held to the
  reference; the summary is held to their sum, over every card's block.

and, in a sorted-scan cell, a fifth, which the loop counts itself:

* ``fallbacks_off``: how far the scans the step found unsorted by its own
  cell ids (``FleetStep.fallbacks``, the sortedness check's count, read
  once after the window) lie from the planted scans it stepped, one a
  drive, each unsorted by one pair (``prepare.plant``); an exact
  comparison, its limit 0. A prepared scan is sorted by the ids the card
  will compute, so a count above the planted means the card binned a point
  into another cell than the preparation did (the step's fallback sort
  would keep that out of the labels), and one below that the step skipped
  its check or its count.

The reference (``portbench/reference``) imports nothing of the program and
takes nothing it made: it gets the same raw sensor-frame points, ring
channels and f64 poses the program got, and replays the drive from its
first scan.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench.reference.groundgrid import LABEL_GROUND, LABEL_NONGROUND, GroundGridReference

# a cell's layers count as different past these: far above the rounding of
# the f32 spiral (~1e-6 m), far below what a missed or extra patch update
# moves (centimetres to metres)
LAYER_TOL_M = 1e-3
LAYER_TOL_CONF = 1e-3

NUMBERS = ("point_mismatch", "layer_mismatch", "center_off", "summary_off", "fallbacks_off")


class Tally:
    def __init__(self):
        self.points = [0, 0]
        self.cells = [0, 0]
        self.center = 0
        self.scans = 0
        # position -> (ground, non-ground, outlier) counts of the compared
        # vehicles' kept labels and flags, and the fleet summary's where kept
        self.counted: dict[int, np.ndarray] = {}
        self.summaries: dict[int, np.ndarray] = {}

    def add(self, kept, ref, labels, outlier, counts, resolution, pos: int = 0):
        """Compare one checked position's kept outputs with the reference's."""
        counted = self.counted.setdefault(pos, np.zeros(3, np.int64))
        for v, c in enumerate(counts):
            got_l = torch.as_tensor(kept.labels[v][:c]).to(labels.device)
            got_o = torch.as_tensor(kept.outlier[v][:c]).to(labels.device).bool()
            self.points[0] += int(((got_l != labels[v, :c]) | (got_o != outlier[v, :c])).sum())
            self.points[1] += c
            counted += np.array(torch.stack([(got_l == LABEL_GROUND).sum(),
                                             (got_l == LABEL_NONGROUND).sum(),
                                             got_o.sum()]).tolist(), np.int64)
            self.scans += 1
        if kept.summary is not None:
            self.summaries[pos] = np.array(torch.as_tensor(kept.summary).tolist(), np.int64)
        dg = (kept.ground.to(ref.ground.device).float() - ref.ground.float()).abs()
        dc = (kept.groundpatch.to(ref.ground.device).float() - ref.groundpatch.float()).abs()
        bad = ~((dg <= LAYER_TOL_M) & (dc <= LAYER_TOL_CONF))  # NaN counts as bad
        self.cells[0] += int(bad.sum())
        self.cells[1] += bad.numel()
        off = np.abs(np.asarray(kept.center, np.float64) - ref.center).max(-1) / resolution
        self.center += int((~(off < 0.5)).sum())

    def merge(self, other: "Tally") -> None:
        """Add ``other``'s comparisons (another block of vehicles) to this."""
        for a, b in ((self.points, other.points), (self.cells, other.cells)):
            a[0], a[1] = a[0] + b[0], a[1] + b[1]
        self.center += other.center
        self.scans += other.scans
        for pos, c in other.counted.items():
            self.counted[pos] = self.counted.get(pos, np.zeros(3, np.int64)) + c
        self.summaries.update(other.summaries)

    def numbers(self) -> dict:
        share = lambda a: a[0] / a[1] if a[1] else float("nan")
        out = {"point_mismatch": share(self.points), "layer_mismatch": share(self.cells),
               "center_off": self.center}
        if self.summaries:
            out["summary_off"] = int(sum(np.abs(s - self.counted.get(pos, 0)).sum()
                                         for pos, s in self.summaries.items()))
        return out


class _Replay:
    """The reference's replay of ``drive`` for the fleet's ``vehicles``,
    comparing each kept position as it passes it, a stretch at a time."""

    def __init__(self, params, pool, schedule, drive, kept, device, float_dtype, wide_dtype,
                 vehicles, tally):
        idx, poses = schedule.drive_poses(drive)
        self.idx, self.poses = idx[:, vehicles], poses[:, vehicles]
        self.pool, self.kept, self.device, self.tally = pool, kept, device, tally
        self.ref = GroundGridReference(params, self.idx.shape[1], device, float_dtype, wide_dtype)
        self.ref.reset(self.poses[0])
        self.pos = 0

    def until(self, last: int) -> None:
        """Step the reference up to position ``last``, on its own card."""
        pool, ref = self.pool, self.ref
        on_card = (torch.cuda.device(self.device) if self.device.type == "cuda"
                   else contextlib.nullcontext())
        with on_card:
            for pos in range(self.pos, last + 1):
                rows = torch.as_tensor(self.idx[pos], device=pool.points.device)
                counts = [pool.counts[int(i)] for i in self.idx[pos]]
                labels, outlier = ref.step(pool.points[rows].to(self.device),
                                           pool.rings[rows].to(self.device), counts,
                                           self.poses[pos])
                if pos in self.kept:
                    self.tally.add(self.kept[pos], ref, labels, outlier, counts,
                                   ref.g.resolution, pos)
        self.pos = max(self.pos, last + 1)


def replay(params: dict, pool, schedule, drive: int, kept: dict, device,
           float_dtype=torch.float32, wide_dtype=torch.float64, vehicles=slice(None),
           tally: Tally | None = None) -> tuple[dict, int]:
    """Replay ``drive`` of the fleet's ``vehicles`` (a slice: every vehicle,
    or one card's block, whose outputs ``kept`` holds) with the reference
    on ``device`` up to its last kept position and compare every kept
    position, adding to ``tally`` (a fresh one if None); returns (numbers,
    scans compared) of the tally so far."""
    tally = Tally() if tally is None else tally
    _Replay(params, pool, schedule, drive, kept, device, float_dtype, wide_dtype, vehicles,
            tally).until(max(kept))
    return tally.numbers(), tally.scans


def replay_blocks(params: dict, pool, schedule, drive: int, blocks) -> tuple[dict, int]:
    """``replay`` of each (vehicle slice, device, position -> Kept) block of
    the fleet on its own device, the cards at once: each block's first
    position in turn (where the reference captures its CUDA graph, which no
    other thread's work may cross), then the rest of every block, a thread
    a block; returns (numbers, scans compared) over every block."""
    replays = [_Replay(params, pool, schedule, drive, kept, device, torch.float32,
                       torch.float64, vehicles, Tally())
               for vehicles, device, kept in blocks]
    last = max(max(kept) for _, _, kept in blocks)
    for r in replays:
        r.until(0)
    if len(replays) == 1:
        replays[0].until(last)
    else:
        with ThreadPoolExecutor(len(replays)) as threads:
            list(threads.map(lambda r: r.until(last), replays))
    tally = replays[0].tally
    for r in replays[1:]:
        tally.merge(r.tally)
    return tally.numbers(), tally.scans


def compared(limits: dict) -> list:
    """The numbers a cell's check compares: those its limits name."""
    return [k for k in NUMBERS if k in limits]


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number the limits name within its limit (NaN, or a number the
    run did not give, fails)."""
    return all(numbers.get(k, float("nan")) <= limits[k] for k in compared(limits))
