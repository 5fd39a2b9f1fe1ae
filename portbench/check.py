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

The reference (``portbench/reference``) imports nothing of the program and
takes nothing it made: it gets the same raw sensor-frame points, ring
channels and f64 poses the program got, and replays the drive from its
first scan.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.groundgrid import GroundGridReference

# a cell's layers count as different past these: far above the rounding of
# the f32 spiral (~1e-6 m), far below what a missed or extra patch update
# moves (centimetres to metres)
LAYER_TOL_M = 1e-3
LAYER_TOL_CONF = 1e-3

NUMBERS = ("point_mismatch", "layer_mismatch", "center_off")


class Tally:
    def __init__(self):
        self.points = [0, 0]
        self.cells = [0, 0]
        self.center = 0
        self.scans = 0

    def add(self, kept, ref, labels, outlier, counts, resolution):
        """Compare one checked position's kept outputs with the reference's."""
        for v, c in enumerate(counts):
            got_l = torch.as_tensor(kept.labels[v][:c]).to(labels.device)
            got_o = torch.as_tensor(kept.outlier[v][:c]).to(labels.device).bool()
            self.points[0] += int(((got_l != labels[v, :c]) | (got_o != outlier[v, :c])).sum())
            self.points[1] += c
            self.scans += 1
        dg = (kept.ground.to(ref.ground.device).float() - ref.ground.float()).abs()
        dc = (kept.groundpatch.to(ref.ground.device).float() - ref.groundpatch.float()).abs()
        bad = ~((dg <= LAYER_TOL_M) & (dc <= LAYER_TOL_CONF))  # NaN counts as bad
        self.cells[0] += int(bad.sum())
        self.cells[1] += bad.numel()
        off = np.abs(np.asarray(kept.center, np.float64) - ref.center).max(-1) / resolution
        self.center += int((~(off < 0.5)).sum())

    def numbers(self) -> dict:
        share = lambda a: a[0] / a[1] if a[1] else float("nan")
        return {"point_mismatch": share(self.points), "layer_mismatch": share(self.cells),
                "center_off": self.center}


def replay(params: dict, pool, schedule, drive: int, kept: dict, device,
           float_dtype=torch.float32, wide_dtype=torch.float64) -> tuple[dict, int]:
    """Replay ``drive`` with the reference up to its last kept position and
    compare every kept position; returns (numbers, scans compared)."""
    idx, poses = schedule.drive_poses(drive)
    v = schedule.vehicles
    ref = GroundGridReference(params, v, device, float_dtype, wide_dtype)
    ref.reset(poses[0])
    tally = Tally()
    last = max(kept)
    for pos in range(last + 1):
        rows = torch.as_tensor(idx[pos], device=pool.points.device)
        counts = [pool.counts[int(i)] for i in idx[pos]]
        labels, outlier = ref.step(pool.points[rows].to(device), pool.rings[rows].to(device),
                                   counts, poses[pos])
        if pos in kept:
            tally.add(kept[pos], ref, labels, outlier, counts, ref.g.resolution)
    return tally.numbers(), tally.scans


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number within its limit (NaN fails)."""
    return all(numbers[k] <= limits[k] for k in NUMBERS)
