"""SemanticKITTI sequence reader (and writer, for fixtures/benchmarks).

A copy of ``groundgrid_tpu/data/semantickitti.py`` (the port cannot import
the JAX package), held to it both ways by ``tests/test_torch_shared.py``:
either package reads what the other writes, bitwise.

ROS-free replacement for ``scripts/kitti_data_publisher.py``: reads
``velodyne/*.bin`` (float32 x4), ``labels/*.label`` (uint32; semantic id in
the low 16 bits, :156-161), ``poses.txt`` conjugated with the camera->velodyne
calibration (``pose' = Tr^-1 P Tr``, :164-180) and ``times.txt``. The
simulated /clock + lock-step NextCloud service collapse into plain Python
iteration: pulling the next record *is* the step, so evaluation is
deterministic by construction (SURVEY.md section 3.4).

Player semantics preserved: ``start``/``end`` seconds and ``seek``
(kitti_data_publisher.py:50-59, 236-261) map to the ``start``/``end``
arguments and slicing on timestamps.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np

from groundgrid_torch.core import transforms as tf


@dataclasses.dataclass
class ScanRecord:
    """One sensor-frame scan with its pose (any object with these attributes
    is accepted by the driver)."""

    index: int
    timestamp: float
    points: np.ndarray  # (P, 4) f32: x, y, z, remission (sensor frame)
    labels: np.ndarray  # (P,) int32 semantic ids (0 if no label file)
    t_map_velo: np.ndarray  # (4, 4) f64 velodyne pose in map frame


class SemanticKITTI:
    """One sequence of a SemanticKITTI-layout dataset directory."""

    def __init__(self, directory: str, sequence: str | int = 0):
        seq = f"{int(sequence):02d}" if not isinstance(sequence, str) else sequence
        self.sequence = seq
        self.root = os.path.join(directory, "sequences", seq)
        if not os.path.isdir(self.root):
            raise FileNotFoundError(f"no such sequence directory: {self.root}")
        self.velodyne_dir = os.path.join(self.root, "velodyne")
        self.labels_dir = os.path.join(self.root, "labels")
        self.times = np.loadtxt(os.path.join(self.root, "times.txt"), dtype=np.float64).reshape(-1)
        self.poses = self._load_poses()
        self.n_scans = min(len(self.times), len(self.poses))

    def _load_poses(self) -> np.ndarray:
        """poses.txt rows are 3x4 camera-frame poses; conjugate with Tr.

        Uses the sequence's own ``calib.txt`` Tr row when present, else the
        seq-00-10 constant the reference hardcodes
        (kitti_data_publisher.py:168).
        """
        raw = np.loadtxt(os.path.join(self.root, "poses.txt"), dtype=np.float64)
        raw = raw.reshape(-1, 3, 4)
        calib_path = os.path.join(self.root, "calib.txt")
        Tr = None
        if os.path.exists(calib_path):
            with open(calib_path) as f:
                for line in f:
                    if line.startswith("Tr"):
                        vals = np.fromstring(line.split(":", 1)[1], sep=" ")
                        Tr = np.vstack([vals.reshape(3, 4), [0, 0, 0, 1]])
        out = np.empty((raw.shape[0], 4, 4), dtype=np.float64)
        for k in range(raw.shape[0]):
            if Tr is None:
                out[k] = tf.kitti_pose_to_map(raw[k])
            else:
                P = np.vstack([raw[k], [0, 0, 0, 1]])
                out[k] = np.linalg.inv(Tr) @ P @ Tr
        return out

    def read_scan(self, idx: int) -> ScanRecord:
        binpath = os.path.join(self.velodyne_dir, f"{idx:06d}.bin")
        scan = np.fromfile(binpath, dtype=np.float32).reshape(-1, 4)
        labelpath = os.path.join(self.labels_dir, f"{idx:06d}.label")
        if os.path.exists(labelpath):
            lab = np.fromfile(labelpath, dtype=np.uint32).reshape(-1)
            lab = (lab & 0xFFFF).astype(np.int32)  # semantic id, low half (:160)
            if lab.shape[0] != scan.shape[0]:
                raise ValueError(
                    f"label/scan length mismatch at {idx}: {lab.shape[0]} vs {scan.shape[0]}"
                )
        else:
            lab = np.zeros(scan.shape[0], dtype=np.int32)
        return ScanRecord(
            index=idx,
            timestamp=float(self.times[idx]),
            points=scan,
            labels=lab,
            t_map_velo=self.poses[idx],
        )

    def __len__(self) -> int:
        return self.n_scans

    def iter_scans(self, start: float = 0.0, end: float = float("inf")) -> Iterator[ScanRecord]:
        """Yield scans with timestamps in [start, end] (player start/end)."""
        for idx in range(self.n_scans):
            t = float(self.times[idx])
            if t < start:
                continue
            if t > end:
                return
            yield self.read_scan(idx)

    def seek_index(self, second: float) -> int:
        """First scan index at/after ``second`` (player seek, :255-261)."""
        return int(np.searchsorted(self.times[: self.n_scans], second, side="left"))


def write_sequence(
    directory: str,
    sequence: str | int,
    scans,  # iterable of (points_velo (P,>=3), labels (P,), t_map_velo (4,4))
    dt: float = 0.1,
    tr: np.ndarray | None = None,
) -> str:
    """Write scans in SemanticKITTI layout (fixture/benchmark generator).

    Poses are stored camera-frame (``P = Tr pose' Tr^-1``) so a round trip
    through the reader's conjugation reproduces the input pose.
    """
    seq = f"{int(sequence):02d}" if not isinstance(sequence, str) else sequence
    root = os.path.join(directory, "sequences", seq)
    os.makedirs(os.path.join(root, "velodyne"), exist_ok=True)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    Tr = tf.KITTI_TR if tr is None else tr

    times, poses = [], []
    for k, (pts, lab, T) in enumerate(scans):
        pts = np.asarray(pts, dtype=np.float32)
        if pts.shape[1] == 3:
            pts = np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], axis=1)
        pts.tofile(os.path.join(root, "velodyne", f"{k:06d}.bin"))
        np.asarray(lab, dtype=np.uint32).tofile(os.path.join(root, "labels", f"{k:06d}.label"))
        times.append(k * dt)
        P_cam = Tr @ np.asarray(T, dtype=np.float64) @ np.linalg.inv(Tr)
        poses.append(P_cam[:3].reshape(-1))

    np.savetxt(os.path.join(root, "times.txt"), np.array(times), fmt="%.6e")
    np.savetxt(os.path.join(root, "poses.txt"), np.array(poses), fmt="%.12e")
    with open(os.path.join(root, "calib.txt"), "w") as f:
        f.write("Tr: " + " ".join(f"{v:.12e}" for v in Tr[:3].reshape(-1)) + "\n")
    return root
