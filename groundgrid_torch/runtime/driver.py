"""Streaming driver: plays a LiDAR sequence through the PyTorch step.

The torch counterpart of ``groundgrid_tpu/runtime/driver.py`` for the
sorted-scan path: each record is prepared on the host (map-frame transform,
cell sort against the f64 center tracker; quantized to the s16 wire format
under ``config.wire_format``), stepped on the device, and its labels are
returned in the input point order, overflow points (beyond ``max_points``)
labelled 0. With ``with_aux`` each result also carries the eleven grid
layers and the map-frame coordinates. A record with a non-finite pose is
dropped (the reference drops clouds whose transform is missing,
GroundGridNodelet.cpp:124-136), or, with ``config.stale_pose_reuse``, run
with the last good pose.

The grid state can be checkpointed at any scan boundary
(``runtime/checkpoint.py``) and installed again with :meth:`restore`, or by
assigning ``driver.state``: the resumed stream reproduces the uninterrupted
one bitwise.
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
from groundgrid_torch.pipeline import (
    CenterTracker,
    init_state,
    make_step,
    prepare_scan,
    prepare_scan_wire,
)

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
    aux: Optional[dict] = None  # (N, N) grid layers by name, with_aux only
    x: Optional[np.ndarray] = None  # (P,) map-frame coordinates, with_aux only
    y: Optional[np.ndarray] = None
    z: Optional[np.ndarray] = None


class StreamingDriver:
    """One ego vehicle / one sequence on one device; owns the grid state.

    ``device`` is required: a CUDA device when none is present raises, and
    nothing falls back to the CPU.
    """

    def __init__(self, config: GroundGridConfig, device, with_aux: bool = False):
        if device is None:
            raise TypeError("StreamingDriver needs an explicit device")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        self.config = config
        self.device = device
        self.with_aux = with_aux
        self.step = make_step(config, with_aux)
        self.state: GridState | None = None
        self._tracker: CenterTracker | None = None
        self._last_pose: np.ndarray | None = None

    def reset(self) -> None:
        self.state = None
        self._tracker = None
        self._last_pose = None

    def restore(self, state: GridState, center64=None) -> None:
        """Install a checkpointed grid state (``runtime/checkpoint.py``).

        Aligns the f64 center tracker with the restored grid center, so the
        resumed stream bins and sorts against the center the uninterrupted
        run would have used. ``center64``: the checkpoint's exact (2,) f64
        tracker center (format v2); without it the tracker resumes from the
        ds pair ``center + center_lo``.
        """
        self.state = state
        if center64 is None:
            center64 = self._state_center64(state)
        self._tracker = CenterTracker(self.config, np.asarray(center64, np.float64))

    @property
    def center64(self) -> Optional[np.ndarray]:
        """The host tracker's exact (2,) f64 center (None before scan 1)."""
        return None if self._tracker is None else self._tracker.center64.copy()

    @staticmethod
    def _state_center64(state: GridState) -> np.ndarray:
        return (np.asarray(state.center_np, np.float64)
                + np.asarray(state.center_lo_np, np.float64))

    def _ensure_tracker(self, pos64: np.ndarray) -> CenterTracker:
        """The f64 center tracker, seeded from the installed state if any.

        The grid center trails odometry by up to half a cell, so a state
        installed without :meth:`restore` seeds the tracker from its own
        center (``center + center_lo``); a tracker seeded from the incoming
        pose would bin the resumed stream against the wrong center. With no
        state, the exact f64 pose seeds it.
        """
        if self._tracker is None:
            seed = pos64 if self.state is None else self._state_center64(self.state)
            self._tracker = CenterTracker(self.config, seed)
        return self._tracker

    def make_scan(self, rec):
        """Host prep of one record: ``(scan, order)``, a ``WireScan`` under
        ``config.wire_format``."""
        mv, mb, bm = tf.scan_poses(rec.t_map_velo)
        # f64, as grid_map tracks its center in doubles (GroundGrid.cpp:58)
        pos = np.asarray(rec.t_map_velo, np.float64)[:2, 3]
        center = self._ensure_tracker(pos).update(pos)
        prep = prepare_scan_wire if self.config.wire_format else prepare_scan
        return prep(self.config, rec.points[:, :3], rec.labels, rec.t_map_velo, center,
                    self.device, t_map_base=mb, t_base_map=bm)

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
            # no state yet: the exact f64 pose seeds the tracker (the ds grid
            # center reconstructs it only to ~2^-48, enough to flip a
            # half-cell snap tie)
            self._ensure_tracker(np.asarray(rec.t_map_velo, np.float64)[:2, 3])
            self.state = init_state(self.config, rec.t_map_velo, self.device)
        scan, order = self.make_scan(rec)
        out = self.step(self.state, scan)
        self.state = out[0]
        return self._finalize(rec, out[1], out[2] if self.with_aux else None, order, t0)

    def _finalize(self, rec, out, aux, order, t0) -> ScanResult:
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
        extra = {}
        if aux is not None:
            # copies: on the CPU a tensor's numpy() shares its memory
            extra = dict(aux={k: v.to("cpu", copy=True).numpy()
                              for k, v in aux._asdict().items()},
                         x=fetch(out.x, np.float32), y=fetch(out.y, np.float32),
                         z=fetch(out.z, np.float32))
        ms = (time.perf_counter() - t0) * 1000.0
        return ScanResult(index=rec.index, timestamp=rec.timestamp, labels=labels,
                          outlier=outlier, n_points=n, wall_ms=ms, **extra)
