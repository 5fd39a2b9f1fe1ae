"""Streaming driver: plays a LiDAR sequence through the PyTorch step.

The torch counterpart of ``groundgrid_tpu/runtime/driver.py``: each record
is prepared on the host, stepped on the device, and its labels are returned
in the input point order, overflow points (beyond ``max_points``) labelled
0. In sorted-scan mode the prep is the map-frame transform and the cell sort
against the f64 center tracker (quantized to the s16 wire format under
``config.wire_format``); in unsorted mode it pads the raw points and ships
the tracker's ds center, and the step transforms on the device. A
:class:`~groundgrid_torch.data.native_loader.PreparedRecord` (sorted host
prep already done by the native loader's threads) is stepped as it comes.
With ``with_aux`` each result also carries the eleven grid layers and the
map-frame coordinates. A record with a non-finite pose is dropped (the
reference drops clouds whose transform is missing,
GroundGridNodelet.cpp:124-136), or, with ``config.stale_pose_reuse``, run
with the last good pose.

:meth:`StreamingDriver.run` can keep ``pipeline_depth`` scans in flight
beyond the one being fetched: results stay in order and bitwise those of the
lock-step run. The grid state can be checkpointed at any scan boundary
(``runtime/checkpoint.py``) and installed again with :meth:`restore`, or by
assigning ``driver.state``: the resumed stream reproduces the uninterrupted
one bitwise.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import transforms as tf
from groundgrid_torch.core.grid import GridState
from groundgrid_torch.data.semantickitti import ScanRecord
from groundgrid_torch.pipeline import (
    CenterTracker,
    init_state,
    make_step,
    pad_scan,
    prepare_scan,
    prepare_scan_wire,
)

__all__ = ["InFlight", "ScanRecord", "ScanResult", "StreamingDriver", "TimingStats"]

log = logging.getLogger("groundgrid_torch.driver")


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


@dataclasses.dataclass
class InFlight:
    """A dispatched scan whose outputs are not fetched yet.

    Holds the step's output tensors, never the grid state: the step updates
    the state object in place, but no output tensor is written after the
    step returns it.
    """

    index: int
    timestamp: float
    n_points: int
    t0: float
    step_out: object  # pipeline.StepOutput (device tensors, step order)
    aux: object  # pipeline.AuxLayers or None
    order: Optional[np.ndarray]  # this scan's host sort permutation (None: unsorted mode)
    rings: torch.Tensor  # the scan's ring channel (ground-truth ids), step order


@dataclasses.dataclass
class TimingStats:
    """Running averages like the reference's logs (GroundGridNodelet.cpp:205).

    ``pipeline_depth`` tags how the per-scan ms was measured: 0 = lock-step
    latency; >= 1 = dispatch-to-fetch latency *including pipeline residency*,
    not comparable to lock-step numbers.
    """

    scans: int = 0
    total_ms: float = 0.0
    avg_ms: float = 0.0
    pipeline_depth: int = 0

    def update(self, ms: float) -> None:
        self.avg_ms = (ms + self.scans * self.avg_ms) / (self.scans + 1)
        self.scans += 1
        self.total_ms += ms

    @property
    def scans_per_sec(self) -> float:
        return 1000.0 / self.avg_ms if self.avg_ms > 0 else 0.0


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
        self.stats = TimingStats()
        self._tracker: CenterTracker | None = None
        self._last_pose: np.ndarray | None = None

    def reset(self) -> None:
        self.state = None
        self.stats = TimingStats()
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

    def reconfigure(self, config: GroundGridConfig) -> None:
        """Swap runtime parameters, keeping the grid state when compatible.

        The counterpart of the reference's dynamic_reconfigure callback
        (GroundGridNodelet.cpp:299-302): the step is rebuilt for ``config``;
        a change of grid geometry or point capacity drops the state, as
        re-creating the map does in the reference.
        """
        keep_state = (self.state is not None
                      and config.cell_count == self.config.cell_count
                      and config.max_points == self.config.max_points)
        self.step = make_step(config, self.with_aux)
        self.config = config
        if not keep_state:
            self.state = None
            self._tracker = None

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
        ``config.wire_format``; ``order`` is None in unsorted mode."""
        mv, mb, bm = tf.scan_poses(rec.t_map_velo)
        # f64, as grid_map tracks its center in doubles (GroundGrid.cpp:58)
        pos = np.asarray(rec.t_map_velo, np.float64)[:2, 3]
        center = self._ensure_tracker(pos).update(pos)
        if not self.config.sorted_scans:
            # the tracker's center rides along in unsorted mode too: the
            # device recurrence snaps from an f32 delta and can misround an
            # exact half-cell step that f64 resolves (grid.index_shift_ds)
            chi, clo = self._tracker.center_ds()
            scan = pad_scan(self.config, rec.points, rec.labels, rec.t_map_velo, self.device,
                            t_map_base=mb, t_base_map=bm)
            return scan._replace(center=chi, center_lo=clo), None
        prep = prepare_scan_wire if self.config.wire_format else prepare_scan
        return prep(self.config, rec.points[:, :3], rec.labels, rec.t_map_velo, center,
                    self.device, t_map_base=mb, t_base_map=bm)

    def _check_pose(self, rec):
        """The record, pose-patched under ``stale_pose_reuse``, or None to
        drop it. A prepared record was binned against its own pose and is
        never patched."""
        if not np.isfinite(rec.t_map_velo).all():
            if (self.config.stale_pose_reuse and self._last_pose is not None
                    and getattr(rec, "scan", None) is None):
                log.warning("scan %d: non-finite pose; reusing last good transform", rec.index)
                return dataclasses.replace(rec, t_map_velo=self._last_pose)
            log.warning("dropping scan %d: non-finite pose", rec.index)
            return None
        self._last_pose = np.array(rec.t_map_velo, np.float64, copy=True)
        return rec

    def process(self, rec) -> Optional[ScanResult]:
        """Run one scan (odometry update + segmentation), blocking.

        ``rec`` is a :class:`ScanRecord` (host prep happens here) or a
        ``PreparedRecord`` from the native loaders. Returns None for a
        dropped scan.
        """
        tok = self.dispatch(rec)
        return None if tok is None else self._finalize(tok)

    def dispatch(self, rec) -> Optional[InFlight]:
        """Check the pose, prepare (unless prepared) and step one scan;
        fetch nothing. None for a dropped scan."""
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
        prepared = getattr(rec, "scan", None)
        if prepared is not None:
            if not self.config.sorted_scans:
                raise ValueError("a PreparedRecord is cell-sorted: it needs a sorted-scan config")
            scan, order, n = prepared, rec.order, rec.n_points
            # the tracker adopts the center the loader binned against, so a
            # checkpoint taken now carries the stream's exact f64 center
            self._tracker = CenterTracker(self.config, rec.center64)
        else:
            (scan, order), n = self.make_scan(rec), rec.points.shape[0]
        out = self.step(self.state, scan)
        self.state = out[0]
        return InFlight(index=rec.index, timestamp=rec.timestamp, n_points=n, t0=t0,
                         step_out=out[1], aux=out[2] if self.with_aux else None,
                         order=order, rings=scan.rings)

    def _finalize(self, tok: InFlight) -> ScanResult:
        """Fetch a dispatched scan's outputs, restore the input point order,
        pad overflow."""
        n, order = tok.n_points, tok.order

        def fetch(t, dtype):
            a = t.cpu().numpy().astype(dtype)
            if order is None:
                u = a
            else:
                u = np.empty_like(a)
                u[order] = a
            if n > u.shape[0]:
                # beyond max_points: never processed, reported as dropped
                u = np.concatenate([u, np.zeros(n - u.shape[0], u.dtype)])
            return u[:n]

        out = tok.step_out
        labels = fetch(out.labels, np.int32)
        outlier = fetch(out.outlier, bool)
        extra = {}
        if tok.aux is not None:
            # copies: on the CPU a tensor's numpy() shares its memory
            extra = dict(aux={k: v.to("cpu", copy=True).numpy()
                              for k, v in tok.aux._asdict().items()},
                         x=fetch(out.x, np.float32), y=fetch(out.y, np.float32),
                         z=fetch(out.z, np.float32))
        ms = (time.perf_counter() - tok.t0) * 1000.0
        self.stats.update(ms)
        return ScanResult(index=tok.index, timestamp=tok.timestamp, labels=labels,
                          outlier=outlier, n_points=n, wall_ms=ms, **extra)

    def run(self, records: Iterable, callback: Optional[Callable[[ScanResult], None]] = None,
            pipeline_depth: int = 0) -> Iterator[ScanResult]:
        """Stream records through the step; yields one result per kept scan.

        ``pipeline_depth``: scans dispatched beyond the one being fetched.
        0 is lock-step (each scan's fetch completes before the next
        dispatch). With depth >= 1 the next scans' host prep and dispatch
        run before the fetch; the step reads the device twice per scan
        (sortedness check, march candidate count), so the overlap is bounded
        by those reads. Results arrive in order, bitwise those of depth 0;
        ``wall_ms`` then includes pipeline residency.
        """
        if pipeline_depth > 0:
            self.stats.pipeline_depth = pipeline_depth
        queue: collections.deque[InFlight] = collections.deque()
        for rec in records:
            tok = self.dispatch(rec)
            if tok is None:
                continue
            queue.append(tok)
            while len(queue) > pipeline_depth:
                result = self._finalize(queue.popleft())
                if callback is not None:
                    callback(result)
                yield result
        while queue:
            result = self._finalize(queue.popleft())
            if callback is not None:
                callback(result)
            yield result
