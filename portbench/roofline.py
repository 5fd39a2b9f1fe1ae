"""The yardstick's arithmetic: the card's peak and the bytes a kernel's
work needs, counted from the inputs' shapes, each byte once.

The peak is NVIDIA's data sheet for the H100 SXM at its full 700 W; a run
prints the card's own ``power.limit`` beside every share it reports. The
byte counts are those of PERF.md's "Bound ms" column, frozen here so that
no change to the program can move them:

* K3, the spiral (``csrc/spiral.cu``): both layers (ground and confidence,
  f32) of every cell the walk reads (rings 0 .. m, the stencil's outer
  ring included) once, and of every cell it writes (rings 0 .. m-1) once;
* K1, the raster sums (``csrc/raster.cu``): the point buffer's cell ids,
  the seven f32 columns at the points inside the grid, and one f32 output
  per column and cell.
"""

from __future__ import annotations

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3
PEAK_SOURCE = "NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3 at 700 W"
K1_COLUMNS = 7


def k3_bytes(n: int) -> int:
    """Bytes of one grid's spiral at ``n`` cells a side."""
    m = n // 2 - 1
    written = (2 * m - 1) ** 2
    read = (2 * m + 1) ** 2
    return 8 * (read + written)


def k1_bytes(points: int, inside: int, n: int) -> int:
    """Bytes of one scan's raster sums: a ``points`` buffer of which
    ``inside`` points fall in the ``n`` x ``n`` grid."""
    return 4 * points + 4 * K1_COLUMNS * inside + 4 * K1_COLUMNS * n * n


def bound_s(n_bytes: float) -> float:
    return n_bytes / HBM_BYTES_PER_S


def drive_centers(poses: np.ndarray, resolution: float) -> np.ndarray:
    """Each scan's grid center over a drive ((D, V, 4, 4) f64 poses): the
    first pose's position, then grid_map's whole-cell snap of each position,
    half away from zero, in f64."""
    c = poses[0, :, :2, 3].copy()
    out = np.zeros(poses.shape[:2] + (2,))
    for i in range(poses.shape[0]):
        dc = (poses[i, :, :2, 3] - c) / resolution
        c = c + np.sign(dc) * np.floor(np.abs(dc) + 0.5) * resolution
        out[i] = c
    return out


def inside_counts(pool, schedule, ticks, n: int, resolution: float, device) -> int:
    """Points inside the grid, summed over every vehicle's scan at each of
    ``ticks``: the points K1 folds."""
    half = n * resolution / 2.0
    total = 0
    cache = {}
    for t in ticks:
        drive, pos = divmod(int(t), schedule.drive_scans)
        if drive not in cache:
            idx, poses = schedule.drive_poses(drive)
            cache = {drive: (idx, poses, drive_centers(poses, resolution))}
        idx, poses, centers = cache[drive]
        rows = torch.as_tensor(idx[pos], device=device)
        pts = pool.points[rows].to(device=device, dtype=torch.float32)
        t32 = torch.as_tensor(poses[pos].astype(np.float32), device=device)

        def row(i):
            return ((t32[:, i, 0, None] * pts[..., 0] + t32[:, i, 1, None] * pts[..., 1])
                    + t32[:, i, 2, None] * pts[..., 2]) + t32[:, i, 3, None]

        c = torch.as_tensor(centers[pos] + half, device=device)
        i0 = torch.floor((c[:, :1] - row(0).double()) / resolution)
        i1 = torch.floor((c[:, 1:] - row(1).double()) / resolution)
        valid = torch.arange(pts.shape[1], device=device)[None] < torch.as_tensor(
            [pool.counts[int(i)] for i in idx[pos]], device=device)[:, None]
        total += int((valid & (i0 >= 0) & (i0 < n) & (i1 >= 0) & (i1 < n)).sum())
    return total
