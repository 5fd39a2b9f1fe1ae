"""Sorted scans, prepared on the card before the window.

A loader's work in sorted-scan mode, as the port's host prep does it
(``pipeline.prepare_scan``; the node transforms each scan on the host,
``GroundGridNodelet.cpp:139-184``): each raw sensor-frame scan is moved to
the map frame in f64 and rounded to f32, its padding zeroed, each point
given the flat cell id the step will bin it to against the grid center the
scan carries, and the scan stably sorted by that id into one (5, P) row
block (x, y, z as f32; rings and valid flags as int32 bits). The ids are
the port's own binning (``rasterize.ds_cells`` and ``flat_cells`` on the
constants ``scalars.binning_constants`` ships), as
``pipeline.predict_cells`` runs it, so a prepared scan reaches the step
sorted by the step's own ids.

Here the work runs on the card, a tick's block of vehicles at once, as a
loader that prepares scans ahead of the GPU would hand them over; the same
ops on CPU tensors give the same bits
(``portbench/tests/test_portbench_sorted.py`` holds them to
``prepare_scan``).

Each prepared set carries one planted scan, so that the step's sortedness
check has something to find: at the first position of the drive the check
does not compare, block 0's first vehicle has its last in-map point swapped
with the point after it (out of the map, or padding). The step counts that
scan as a fallback, and its stable sort puts the two points back, so the
scan steps bitwise as prepared. The loop counts the planted scans it steps,
and the check compares the step's count with that.
"""

from __future__ import annotations

import numpy as np
import torch

from groundgrid_torch.core import exactf32
from groundgrid_torch.core import rasterize as rasterlib
from groundgrid_torch.core import scalars as scalarlib
from portbench.roofline import drive_centers

SETS = 2  # prepared drives: drive d steps set d mod SETS, the warm-up drive (-1) set 1


def to_map_frame(raw: torch.Tensor, poses: np.ndarray) -> torch.Tensor:
    """(3, B, P) f32 map-frame x, y, z of (5, B, P) raw rows and (B, 4, 4)
    f64 sensor poses: ``((T[i,0] x + T[i,1] y) + T[i,2] z) + T[i,3]`` in
    f64, rounded to f32 once; padding zeroed."""
    t = torch.as_tensor(np.asarray(poses, np.float64), device=raw.device)
    x, y, z = (raw[i].double() for i in range(3))

    def row(i):
        c = [t[:, i, j, None] for j in range(4)]
        return (((c[0] * x + c[1] * y) + c[2] * z) + c[3]).to(torch.float32)

    xyz = torch.stack([row(0), row(1), row(2)])
    return torch.where(raw[4].view(torch.int32) != 0, xyz, torch.zeros((), device=raw.device))


def cells(cfg, center_hi, center_lo, x, y, valid) -> torch.Tensor:
    """(B, P) int32 flat cell ids of (B, P) f32 map-frame ``x``, ``y``
    against each vehicle's (B, 2) f32 (hi, lo) center: the step's binning,
    ``n * n`` outside the map or where ``valid`` is false."""
    consts = [torch.as_tensor(c, device=x.device)[:, None]
              for c in scalarlib.binning_constants(cfg, center_hi, center_lo)]
    return rasterlib.flat_cells(cfg, *rasterlib.ds_cells(cfg, *consts, x, y), valid)[0]


def prepare_rows(raw: torch.Tensor, poses: np.ndarray, center_hi, center_lo, cfg):
    """One tick's block of scans prepared: ``raw`` (5, B, P) f32 rows of
    sensor-frame scans (x, y, z; rings and valid flags as int32 bits),
    ``poses`` (B, 4, 4) f64 sensor poses, (B, 2) f32 (hi, lo) centers.
    Returns the sorted (5, B, P) rows and the (B, P) int64 order (``sorted
    = raw[..., order]``)."""
    xyz = to_map_frame(raw, poses)
    cell = cells(cfg, center_hi, center_lo, xyz[0], xyz[1], raw[4].view(torch.int32) != 0)
    order = torch.argsort(cell, dim=-1, stable=True)
    out = torch.empty_like(raw)
    out[:3] = torch.gather(xyz, 2, order.expand(3, -1, -1))
    out[3:] = torch.gather(raw[3:], 2, order.expand(2, -1, -1))
    return out, order


def plant(cfg, rows: torch.Tensor, center_hi, center_lo) -> None:
    """Swap, in place, the last in-map point of the prepared (5, P) ``rows``
    with the point after it, out of the map or padding: the scan is then
    unsorted by one pair, and a stable sort of its ids restores it."""
    ids = cells(cfg, center_hi[None], center_lo[None], rows[0][None], rows[1][None],
                rows[4].view(torch.int32)[None] != 0)[0]
    i = int((ids < cfg.cell_count ** 2).sum()) - 1
    if i < 0 or i + 1 >= rows.shape[-1]:
        raise RuntimeError("a planted scan needs an in-map point followed by another point")
    rows[:, [i, i + 1]] = rows[:, [i + 1, i]]


class PreparedDrives:
    """Every scan a sorted fleet steps, prepared before the window.

    ``SETS`` sets (drive d of the window steps set d mod ``SETS``:
    ``traffic.Schedule.drive_poses``), each a drive of the schedule with
    its own seed-drawn offsets, prepared a tick at a time on each card for
    that card's block of vehicles, against each tick's grid center (the
    host recurrence of the sensor positions, ``roofline.drive_centers``;
    the scans carry it). Each set has its planted scan at ``planted_pos``
    (:func:`plant`). The orders are kept at the checked ``positions`` only,
    to map the outputs kept there back to the raw scans' order after the
    window.
    """

    def __init__(self, cfg, schedule, rows, blocks, positions):
        d = schedule.drive_scans
        unchecked = sorted(set(range(d)) - set(positions))
        if not unchecked:
            raise ValueError("a sorted fleet needs a drive position the check does not compare")
        self.planted_pos = unchecked[0]
        self.centers = []  # per set: (D, V, 2) f32 hi and lo
        self.rows = [torch.empty((SETS, d, 5, b.stop - b.start, rows[0].shape[-1]),
                                 dtype=torch.float32, device=dev) for b, dev in blocks]
        self.orders: dict = {}  # (set, position) -> one (B, P) int32 order a block
        for k in range(SETS):
            idx, poses = schedule.drive_poses(k)
            hi, lo = exactf32.f64_to_ds(drive_centers(poses, cfg.resolution))
            self.centers.append((hi, lo))
            for pos in range(d):
                orders = []
                for (b, dev), pool_rows, store in zip(blocks, rows, self.rows):
                    raw = pool_rows[:, torch.as_tensor(idx[pos, b], device=dev)]
                    out, order = prepare_rows(raw, poses[pos, b], hi[pos, b], lo[pos, b], cfg)
                    store[k, pos] = out
                    orders.append(order.to(torch.int32))
                if pos in positions:
                    self.orders[k, pos] = orders
            first = blocks[0][0].start
            plant(cfg, self.rows[0][k, self.planted_pos, :, 0], hi[self.planted_pos, first],
                  lo[self.planted_pos, first])

    def block_rows(self, block: int, drive: int, pos: int) -> torch.Tensor:
        """The (5, B, P) prepared rows of one card's block at a tick."""
        return self.rows[block][drive % SETS, pos]

    def center(self, drive: int, pos: int):
        """The (V, 2) f32 (hi, lo) centers the tick's scans were sorted against."""
        hi, lo = self.centers[drive % SETS]
        return hi[pos], lo[pos]

    def order(self, block: int, drive: int, pos: int) -> torch.Tensor:
        return self.orders[drive % SETS, pos][block]
