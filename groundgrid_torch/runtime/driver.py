"""Streaming driver: plays a LiDAR sequence through the PyTorch step.

The torch counterpart of ``groundgrid_tpu/runtime/driver.py`` for the
sorted-scan path: each record is prepared on the host (map-frame transform,
cell sort against the f64 center tracker), stepped on the device, and its
labels are returned in the input point order, overflow points (beyond
``max_points``) labelled 0. A record with a non-finite pose is dropped (the
reference drops clouds whose transform is missing,
GroundGridNodelet.cpp:124-136), or, with ``config.stale_pose_reuse``, run
with the last good pose.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import transforms as tf
from groundgrid_torch.core.grid import GridState
from groundgrid_torch.pipeline import CenterTracker, Scan, init_state, make_step, prepare_scan

log = logging.getLogger("groundgrid_torch.driver")


@dataclasses.dataclass
class ScanRecord:
    """One sensor-frame scan with its pose (the JAX package's record layout;
    any object with these attributes is accepted)."""

    index: int
    timestamp: float
    points: np.ndarray  # (P, >=3) f32 sensor frame
    labels: np.ndarray  # (P,) int32 semantic ids (ride the ring channel)
    t_map_velo: np.ndarray  # (4, 4) f64 velodyne pose in the map frame


@dataclasses.dataclass
class ScanResult:
    index: int
    timestamp: float
    labels: np.ndarray  # (P,) 49/99 per input point; 0 = dropped
    outlier: np.ndarray  # (P,) bool
    n_points: int
    wall_ms: float


class StreamingDriver:
    """One ego vehicle / one sequence on one device; owns the grid state."""

    def __init__(self, config: GroundGridConfig, device=None):
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.config = config
        self.device = torch.device(device)
        self.step = make_step(config)
        self.state: GridState | None = None
        self._tracker: CenterTracker | None = None
        self._last_pose: np.ndarray | None = None

    def reset(self) -> None:
        self.state = None
        self._tracker = None
        self._last_pose = None

    def make_scan(self, rec) -> tuple[Scan, np.ndarray]:
        """Host prep of one record: ``(scan, order)`` (sorted path)."""
        mv, mb, bm = tf.scan_poses(rec.t_map_velo)
        # f64, as grid_map tracks its center in doubles (GroundGrid.cpp:58)
        pos = np.asarray(rec.t_map_velo, np.float64)[:2, 3]
        if self._tracker is None:
            self._tracker = CenterTracker(self.config, pos)
        center = self._tracker.update(pos)
        return prepare_scan(self.config, rec.points[:, :3], rec.labels, rec.t_map_velo,
                            center, self.device, t_map_base=mb, t_base_map=bm)

    def _check_pose(self, rec):
        if not np.isfinite(rec.t_map_velo).all():
            if self.config.stale_pose_reuse and self._last_pose is not None:
                log.warning("scan %d: non-finite pose; reusing last good transform", rec.index)
                return dataclasses.replace(rec, t_map_velo=self._last_pose)
            log.warning("dropping scan %d: non-finite pose", rec.index)
            return None
        self._last_pose = np.array(rec.t_map_velo, np.float64, copy=True)
        return rec

    def process(self, rec) -> Optional[ScanResult]:
        """Run one scan (odometry update + segmentation), blocking."""
        rec = self._check_pose(rec)
        if rec is None:
            return None
        t0 = time.perf_counter()
        if self.state is None:
            self.state = init_state(self.config, rec.t_map_velo, self.device)
        scan, order = self.make_scan(rec)
        self.state, out = self.step(self.state, scan)
        return self._finalize(rec, out, order, t0)

    def _finalize(self, rec, out, order, t0) -> ScanResult:
        """Fetch the outputs, restore the input point order, pad overflow."""
        n = rec.points.shape[0]

        def fetch(t, dtype):
            a = t.cpu().numpy().astype(dtype)
            u = np.empty_like(a)
            u[order] = a
            if n > u.shape[0]:
                # beyond max_points: never processed, reported as dropped
                u = np.concatenate([u, np.zeros(n - u.shape[0], u.dtype)])
            return u[:n]

        labels = fetch(out.labels, np.int32)
        outlier = fetch(out.outlier, bool)
        ms = (time.perf_counter() - t0) * 1000.0
        return ScanResult(index=rec.index, timestamp=rec.timestamp, labels=labels,
                          outlier=outlier, n_points=n, wall_ms=ms)
