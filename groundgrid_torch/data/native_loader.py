"""ctypes binding of the native threaded scan loader (``native/loader.cpp``).

The torch counterpart of ``groundgrid_tpu/data/native_loader.py``, over the
same C++ library. Its worker threads read SemanticKITTI scans ahead of the
consumer and, for the sorted-scan step, do all of the host prep: label
unpack, map-frame transform, cell binning against the host-tracked f64
center and the stable cell sort (``prep_scan``), or the s16 wire
quantization (``prep_scan_wire``), bitwise the port's ``prepare_scan`` /
``prepare_scan_wire``.

The library is built by ``make -C native`` into ``native/build/`` at first
use. Without a C++ toolchain every loader falls back to the NumPy reader and
prep (``.native`` is then false); that is host code, never the device.

Each prepared scan is written by the library straight into a fresh host
buffer (pinned for a CUDA device) and reaches ``device`` in one copy, like
``pipeline._to_device``; no staging buffer is reused while a copy from it
may be in flight.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
from typing import Iterator, Optional

import numpy as np
import torch

from groundgrid_torch.core import transforms as tf
from groundgrid_torch.core.exactf32 import f64_to_ds
from groundgrid_torch.data.semantickitti import ScanRecord, SemanticKITTI
from groundgrid_torch.pipeline import (
    CenterTracker,
    Scan,
    WireScan,
    prepare_scan,
    prepare_scan_wire,
    wire_scales,
)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libggloader.so")

_lib: Optional[ctypes.CDLL] = None

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i16p = ctypes.POINTER(ctypes.c_int16)
_f64p = ctypes.POINTER(ctypes.c_double)


def _build_library() -> bool:
    """``make -C native`` into a private target, renamed into place.

    The rename is atomic, so a concurrent build or load elsewhere never sees
    a half-written library.
    """
    if not os.path.exists(os.path.join(_NATIVE_DIR, "Makefile")):
        return False
    tmp = os.path.join("build", f"libggloader.so.{os.getpid()}.tmp")
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, "-s", f"TARGET={tmp}"], check=True,
                       capture_output=True, timeout=300)
        os.replace(os.path.join(_NATIVE_DIR, tmp), _LIB_PATH)
        return True
    except (subprocess.SubprocessError, OSError):
        return False


def load_library(auto_build: bool = True) -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native loader; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH) and not (auto_build and _build_library()):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.gg_loader_create.restype = ctypes.c_void_p
    lib.gg_loader_create.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
                                     ctypes.c_int32, ctypes.c_int32]
    lib.gg_loader_next.restype = ctypes.c_int64
    lib.gg_loader_next.argtypes = [ctypes.c_void_p, _f32p, _i32p, _i32p]
    lib.gg_loader_seek.restype = None
    lib.gg_loader_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.gg_loader_destroy.restype = None
    lib.gg_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.gg_loader_create_sorted.restype = ctypes.c_void_p
    lib.gg_loader_create_sorted.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        _f64p, _f64p, ctypes.c_double, ctypes.c_double, ctypes.c_int32,
    ]
    lib.gg_loader_next_sorted.restype = ctypes.c_int64
    lib.gg_loader_next_sorted.argtypes = [ctypes.c_void_p, _f32p, _f32p, _f32p, _i32p, _i32p,
                                          _i32p]
    lib.gg_loader_create_wire.restype = ctypes.c_void_p
    lib.gg_loader_create_wire.argtypes = (lib.gg_loader_create_sorted.argtypes
                                          + [ctypes.c_double, ctypes.c_double])  # s_xy, s_z
    lib.gg_loader_next_wire.restype = ctypes.c_int64
    lib.gg_loader_next_wire.argtypes = [ctypes.c_void_p, _i16p, _i16p, _i16p, _i16p, _i32p,
                                        _i32p]
    _lib = lib
    return lib


def _ptr(t: torch.Tensor, ctype):
    return ctypes.cast(t.data_ptr(), ctypes.POINTER(ctype))


def _host_buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    """A fresh host buffer, pinned when it is bound for a CUDA device."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


class _NativeLoader:
    """Handle lifetime and seeking shared by the loaders."""

    _handle = None
    _lib = None

    @property
    def native(self) -> bool:
        return self._handle is not None

    def seek(self, index: int) -> None:
        if self._handle is not None:
            self._lib.gg_loader_seek(self._handle, index)
        self._fallback_start = index

    def _next(self, fn, *buffers) -> Optional[tuple[int, int]]:
        """``(index, count)`` of the next scan written into ``buffers``, or
        None at the end of the sequence."""
        count = ctypes.c_int32(0)
        idx = fn(self._handle, *buffers, ctypes.byref(count))
        if idx < 0:
            if idx == -2:
                raise IOError("native loader failed to read a scan")
            return None
        return int(idx), int(count.value)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.gg_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: the library may be gone
            pass


class PrefetchingLoader(_NativeLoader):
    """Iterate a SemanticKITTI sequence with native threaded read-ahead.

    Yields :class:`ScanRecord` like ``SemanticKITTI.iter_scans``, truncated
    to ``cap`` points (poses and times come from the Python reader; the file
    reads and label unpacking run in C++).
    """

    def __init__(self, dataset: SemanticKITTI, cap: int = 150_000, n_threads: int = 4,
                 queue_depth: int = 8):
        self.ds = dataset
        self.cap = cap
        self._lib = load_library()
        if self._lib is not None:
            self._handle = ctypes.c_void_p(self._lib.gg_loader_create(
                self.ds.root.encode(), len(self.ds), cap, n_threads, queue_depth))
        self._pts = np.empty((cap, 4), np.float32)
        self._lab = np.empty((cap,), np.int32)
        self._fallback_start = 0

    def __iter__(self) -> Iterator[ScanRecord]:
        if self._handle is None:
            for idx in range(self._fallback_start, len(self.ds)):
                rec = self.ds.read_scan(idx)
                yield dataclasses.replace(rec, points=rec.points[: self.cap],
                                          labels=rec.labels[: self.cap])
            return
        while (got := self._next(self._lib.gg_loader_next,
                                 self._pts.ctypes.data_as(_f32p),
                                 self._lab.ctypes.data_as(_i32p))) is not None:
            idx, c = got
            yield ScanRecord(index=idx, timestamp=float(self.ds.times[idx]),
                             points=self._pts[:c].copy(), labels=self._lab[:c].copy(),
                             t_map_velo=self.ds.poses[idx])


@dataclasses.dataclass
class PreparedRecord:
    """A host-prepared, device-resident sorted scan.

    ``scan`` is a pipeline :class:`~groundgrid_torch.pipeline.Scan` (or
    :class:`~groundgrid_torch.pipeline.WireScan`) on the loader's device,
    sorted by predicted flat cell id against the host-tracked center.
    ``order`` is the applied permutation (``sorted = original[order]``);
    ``labels`` are the ground-truth ids in the original order; ``center64``
    is the exact (2,) f64 grid center the scan was binned against.
    """

    index: int
    timestamp: float
    scan: object
    order: np.ndarray
    n_points: int
    labels: np.ndarray
    t_map_velo: np.ndarray
    center64: np.ndarray


class _PrepLoader(_NativeLoader):
    """The sorted and wire loaders' shared setup.

    The f64 center track over the sequence from ``start`` is computed up
    front (poses are known), so out-of-order workers can bin any scan. It is
    the track a driver starting at ``start`` keeps: seeded at ``center64``
    (a resumed stream's checkpointed center) or else at the pose of scan
    ``start``; the loader begins at ``start``.
    """

    def __init__(self, dataset: SemanticKITTI, config, device, start: int, center64):
        if device is None:
            raise TypeError(f"{type(self).__name__} needs an explicit device")
        self.device = torch.device(device)
        self.ds = dataset
        self.config = config
        self.cap = config.max_points
        n = len(dataset)
        self._poses = np.ascontiguousarray(
            np.stack([np.asarray(dataset.poses[i], np.float64) for i in range(n)])
            if n else np.zeros((0, 4, 4), np.float64))
        centers64 = np.zeros((n, 2), np.float64)  # scans before ``start`` are never read
        if start < n:
            tracker = CenterTracker(config, self._poses[start, :2, 3] if center64 is None
                                    else center64)
            for i in range(start, n):
                centers64[i] = tracker.update(self._poses[i, :2, 3])
        self._centers64 = np.ascontiguousarray(centers64)
        self._chi, self._clo = f64_to_ds(centers64)
        self._start = start
        self._fallback_start = start

    def _open(self, create, n_threads: int, queue_depth: int, *extra) -> None:
        """Start the library's workers on this track, positioned at ``start``."""
        cfg = self.config
        self._lib = load_library()
        if self._lib is None or len(self.ds) == 0:
            return
        self._handle = ctypes.c_void_p(getattr(self._lib, create)(
            self.ds.root.encode(), len(self.ds), self.cap, n_threads, queue_depth,
            self._poses.ctypes.data_as(_f64p), self._centers64.ctypes.data_as(_f64p),
            ctypes.c_double(cfg.resolution), ctypes.c_double(cfg.half_length),
            cfg.cell_count, *extra))
        if self._start:
            self._lib.gg_loader_seek(self._handle, self._start)

    def seek(self, index: int) -> None:
        if index < self._start:
            raise ValueError(f"scan {index} precedes the loader's center track, which "
                             f"starts at scan {self._start}")
        super().seek(index)

    def _fallback(self, prep) -> Iterator[PreparedRecord]:
        for idx in range(self._fallback_start, len(self.ds)):
            rec = self.ds.read_scan(idx)
            scan, order = prep(self.config, rec.points[:, :3], rec.labels, rec.t_map_velo,
                               self._centers64[idx], self.device)
            yield PreparedRecord(index=idx, timestamp=rec.timestamp, scan=scan, order=order,
                                 n_points=rec.points.shape[0], labels=rec.labels,
                                 t_map_velo=self._poses[idx], center64=self._centers64[idx])

    def _record(self, idx: int, c: int, scan, order: np.ndarray,
                sorted_labels: np.ndarray) -> PreparedRecord:
        # the library reads at most ``cap`` points; the file size gives the
        # scan's own count, whose overflow points the driver labels 0 (their
        # ids, never read, are 0 here: no scorer counts a point labelled 0)
        n = os.path.getsize(os.path.join(self.ds.velodyne_dir, f"{idx:06d}.bin")) // 16
        restored = np.zeros((max(n, self.cap),), np.int32)
        restored[order] = sorted_labels
        restored[c:] = 0
        return PreparedRecord(index=idx, timestamp=float(self.ds.times[idx]), scan=scan,
                              order=order, n_points=n, labels=restored[:n],
                              t_map_velo=self._poses[idx], center64=self._centers64[idx])

    def _poses_of(self, idx: int) -> dict:
        mv, mb, bm = tf.scan_poses(self._poses[idx])
        return dict(t_map_velo=mv, t_map_base=mb, t_base_map=bm,
                    center=self._chi[idx], center_lo=self._clo[idx])


class SortedPrefetchingLoader(_PrepLoader):
    """Native threaded loader yielding fully prepared sorted scans
    (:class:`PreparedRecord` with a :class:`Scan` on ``device``) from scan
    ``start`` on, bitwise the port's ``prepare_scan``."""

    def __init__(self, dataset: SemanticKITTI, config, device, start: int = 0,
                 center64=None, n_threads: int = 4, queue_depth: int = 8):
        super().__init__(dataset, config, device, start, center64)
        self._open("gg_loader_create_sorted", n_threads, queue_depth)

    def __iter__(self) -> Iterator[PreparedRecord]:
        if self._handle is None:
            yield from self._fallback(prepare_scan)
            return
        cap = self.cap
        while True:
            # x, y, z as f32 and labels, valid as i32 bits: prepare_scan's
            # layout, in a fresh buffer: the copy below may still be reading
            # it when the next scan is written
            buf = _host_buffer((5, cap), torch.float32, self.device)
            ints = buf[3:].view(torch.int32)
            order_t = torch.empty((cap,), dtype=torch.int32)
            got = self._next(self._lib.gg_loader_next_sorted,
                             _ptr(buf[0], ctypes.c_float), _ptr(buf[1], ctypes.c_float),
                             _ptr(buf[2], ctypes.c_float), _ptr(ints[0], ctypes.c_int32),
                             _ptr(order_t, ctypes.c_int32))
            if got is None:
                return
            idx, count = got
            c = min(count, cap)
            order = order_t.numpy()
            ints[1] = torch.from_numpy((order < c).astype(np.int32))
            sorted_labels = ints[0].numpy().copy()
            dev = buf.to(self.device, non_blocking=True)
            scan = Scan(px=dev[0], py=dev[1], pz=dev[2], rings=dev[3].view(torch.int32),
                        valid=dev[4].view(torch.int32), **self._poses_of(idx))
            yield self._record(idx, c, scan, order, sorted_labels)


class WirePrefetchingLoader(_PrepLoader):
    """Native threaded loader yielding s16 wire-prepared scans
    (:class:`PreparedRecord` with a :class:`WireScan` on ``device``) from
    scan ``start`` on, bitwise the port's ``prepare_scan_wire``; consume
    with a ``config.wire_format`` step."""

    def __init__(self, dataset: SemanticKITTI, config, device, start: int = 0,
                 center64=None, n_threads: int = 4, queue_depth: int = 8):
        if not getattr(config, "wire_format", False):
            raise ValueError("WirePrefetchingLoader needs config.wire_format")
        super().__init__(dataset, config, device, start, center64)
        sxy, sz = wire_scales(config)
        self._open("gg_loader_create_wire", n_threads, queue_depth,
                   ctypes.c_double(float(sxy)), ctypes.c_double(float(sz)))

    def __iter__(self) -> Iterator[PreparedRecord]:
        if self._handle is None:
            yield from self._fallback(prepare_scan_wire)
            return
        cap = self.cap
        while True:
            # qx, qy, qz, labels: prepare_scan_wire's (4, P) int16 layout, in
            # a fresh buffer as above
            buf = _host_buffer((4, cap), torch.int16, self.device)
            order_t = torch.empty((cap,), dtype=torch.int32)
            got = self._next(self._lib.gg_loader_next_wire,
                             *(_ptr(buf[k], ctypes.c_int16) for k in range(4)),
                             _ptr(order_t, ctypes.c_int32))
            if got is None:
                return
            idx, count = got
            c = min(count, cap)
            sorted_labels = buf[3].numpy().astype(np.int32)
            dev = buf.to(self.device, non_blocking=True)
            scan = WireScan(qx=dev[0], qy=dev[1], qz=dev[2], rings=dev[3], count=c,
                            **self._poses_of(idx))
            yield self._record(idx, c, scan, order_t.numpy(), sorted_labels)
