"""Rigid-transform helpers: host NumPy forms and the device transform.

A copy of the host pieces of ``groundgrid_tpu/core/transforms.py``: in
sorted-scan mode the points are transformed to the map frame on the host
(``pipeline.prepare_scan``); the SemanticKITTI reader conjugates its
camera-frame poses with ``KITTI_TR``. In unsorted mode the step transforms
on the device (:func:`transform_points_soa`).

Conventions: ``T_a_b`` maps points from frame ``b`` to frame ``a``
(``p_a = T_a_b @ p_b``); points are ``(N, 3)`` arrays.
"""

from __future__ import annotations

import numpy as np


def transform_points(T, points):
    """Apply a 4x4 rigid transform to an (N, 3) point batch.

    Nine multiply-adds per point in the same order as the JAX package, so
    both produce the same float64 (and then float32) coordinates.
    """
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    out_x = T[0, 0] * x + T[0, 1] * y + T[0, 2] * z + T[0, 3]
    out_y = T[1, 0] * x + T[1, 1] * y + T[1, 2] * z + T[1, 3]
    out_z = T[2, 0] * x + T[2, 1] * y + T[2, 2] * z + T[2, 3]
    return np.stack([out_x, out_y, out_z], axis=-1)


def transform_points_soa(T, x, y, z):
    """Rigid transform of three (P,) f32 tensors (or NumPy arrays) by the
    (4, 4) f32 ``T``.

    The JAX package's ``transform_points_soa`` in its order of operations,
    ``((T00*x + T01*y) + T02*z) + T03``, each product and sum rounded as its
    own f32 op (eager PyTorch and NumPy fuse none); the matrix entries enter
    as the f32 values they are.
    """
    t = np.asarray(T, np.float32)

    def row(i):
        return ((float(t[i, 0]) * x + float(t[i, 1]) * y) + float(t[i, 2]) * z) + float(t[i, 3])

    return row(0), row(1), row(2)


def invert_rigid(T):
    """Invert a rigid 4x4 transform: [R|t]^-1 = [R^T | -R^T t]."""
    R = T[:3, :3]
    t = T[:3, 3]
    Rt = R.T
    out = np.eye(4, dtype=T.dtype)
    out[:3, :3] = Rt
    out[:3, 3] = -Rt @ t
    return out


def translation(x: float, y: float, z: float, dtype=np.float64) -> np.ndarray:
    """Pure-translation 4x4 (host-side helper for static extrinsics)."""
    T = np.eye(4, dtype=dtype)
    T[:3, 3] = (x, y, z)
    return T


# Static extrinsic from the reference launch files
# (launch/KITTIPlayback.launch:13-17): base_link sits at ground level 1.95 m
# ahead of the sensor.
T_KITTIBASE_BASE = translation(1.95, 0.0, -1.73)

# KITTI odometry camera->velodyne calibration ``Tr`` of sequences 00-10, the
# constant the reference player hardcodes (kitti_data_publisher.py:168).
KITTI_TR = np.array(
    [
        [4.276802385584e-04, -9.999672484946e-01, -8.084491683471e-03, -1.198459927713e-02],
        [-7.210626507497e-03, 8.081198471645e-03, -9.999413164504e-01, -5.403984729748e-02],
        [9.999738645903e-01, 4.859485810390e-04, -7.206933692422e-03, -2.921968648686e-01],
        [0.0, 0.0, 0.0, 1.0],
    ],
    dtype=np.float64,
)


def kitti_pose_to_map(pose_3x4: np.ndarray) -> np.ndarray:
    """Conjugate a KITTI camera-frame pose into the velodyne/map frame:
    ``pose' = Tr^-1 @ P @ Tr`` (kitti_data_publisher.py:164-180)."""
    P = np.vstack([np.asarray(pose_3x4, dtype=np.float64).reshape(3, 4), [0, 0, 0, 1]])
    return np.linalg.inv(KITTI_TR) @ P @ KITTI_TR


def scan_poses(T_map_velo: np.ndarray):
    """Per-scan pose set: ``(T_map_velo, T_map_base, T_base_map)`` in f32.

    * ``T_map_velo`` -- cloud->map transform; its translation is the sensor
      origin (GroundGridNodelet.cpp:139-146).
    * ``T_map_base`` -- base_link pose in map; its z seeds the spiral
      (GroundSegmentation.cpp:406-411).
    * ``T_base_map`` -- map->base_link, for re-initializing freshly exposed
      grid cells to the base plane (GroundGrid.cpp:121-133).
    """
    T_map_velo = np.asarray(T_map_velo, dtype=np.float64)
    T_map_base = T_map_velo @ T_KITTIBASE_BASE
    T_base_map = invert_rigid(T_map_base)
    return (
        T_map_velo.astype(np.float32),
        T_map_base.astype(np.float32),
        T_base_map.astype(np.float32),
    )
