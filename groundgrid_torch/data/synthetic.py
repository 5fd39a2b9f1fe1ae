"""Synthetic Velodyne-style scene generator (host NumPy).

A copy of ``groundgrid_tpu/data/synthetic.py``: ``Scene``, ``make_scene``,
``terrain_z``, ``vehicle_pose``, ``render_scan``, ``synthetic_sequence`` and
the adversarial world of the accuracy harness (``make_adversarial_scene``,
``vehicle_pose_6dof``, ``adversarial_sequence``); and of the random
detect-stage layers of ``tests/test_pallas_detect.py`` (:func:`detect_layers`). It is carried here because importing
``groundgrid_tpu`` imports JAX; ``tests/test_torch_shared.py`` holds the
copy's output bitwise to the original's.

The simulated sensor mimics an HDL-64E: 64 beams between +2 and -24.8 deg
elevation, uniform azimuth sweep. The world is a gently rolling terrain (sum
of long-wavelength sinusoids) plus axis-aligned boxes (cars, buildings,
vegetation blobs), labelled with SemanticKITTI ids.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# SemanticKITTI label ids (cfg/semantic-kitti-all.yaml)
ROAD, TERRAIN, CAR, BUILDING, VEGETATION = 40, 72, 10, 50, 70

SENSOR_HEIGHT = 1.73  # m above ground (KITTI velodyne mount)


@dataclasses.dataclass
class Scene:
    terrain_amp: np.ndarray  # (K,)
    terrain_freq: np.ndarray  # (K, 2)
    terrain_phase: np.ndarray  # (K,)
    boxes: np.ndarray  # (B, 6|8): cx, cy, sx, sy, sz, label[, z_off, porosity]
    road_halfwidth: float = 6.0
    # adversarial extensions (defaults keep legacy scenes bit-identical)
    grade: tuple = (0.0, 0.0)  # linear terrain slope dz/dx, dz/dy
    reflection_rate: float = 0.0  # fraction of ground returns mirrored below
    reflection_depth: tuple = (0.5, 3.0)  # mirror depth range [m]


def make_scene(seed: int = 0, n_boxes: int = 24, extent: float = 120.0) -> Scene:
    rng = np.random.default_rng(seed)
    k = 3
    amp = rng.uniform(0.1, 0.4, size=k)
    freq = rng.uniform(2 * np.pi / 200.0, 2 * np.pi / 60.0, size=(k, 2))
    phase = rng.uniform(0, 2 * np.pi, size=k)

    boxes = []
    labels = [CAR, BUILDING, VEGETATION]
    for i in range(n_boxes):
        label = labels[i % len(labels)]
        cx = rng.uniform(5.0, extent)
        side = rng.choice([-1.0, 1.0])
        if label == CAR:
            cy = side * rng.uniform(2.0, 5.0)
            sx, sy, sz = rng.uniform(3.5, 5.0), rng.uniform(1.6, 2.0), rng.uniform(1.4, 1.8)
        elif label == BUILDING:
            cy = side * rng.uniform(12.0, 30.0)
            sx, sy, sz = rng.uniform(8.0, 20.0), rng.uniform(6.0, 15.0), rng.uniform(4.0, 10.0)
        else:  # vegetation blob
            cy = side * rng.uniform(7.0, 20.0)
            sx = sy = rng.uniform(1.5, 4.0)
            sz = rng.uniform(2.0, 6.0)
        boxes.append((cx, cy, sx, sy, sz, float(label)))
    return Scene(
        terrain_amp=amp, terrain_freq=freq, terrain_phase=phase,
        boxes=np.array(boxes, dtype=np.float64),
    )


def terrain_z(scene: Scene, x, y):
    x = np.asarray(x, dtype=np.float64)
    z = np.zeros_like(x)
    for a, (fx, fy), p in zip(scene.terrain_amp, scene.terrain_freq, scene.terrain_phase):
        z = z + a * np.sin(fx * x + p) * np.cos(fy * y)
    gx, gy = scene.grade
    if gx or gy:
        z = z + gx * x + gy * np.asarray(y, dtype=np.float64)
    return z


def vehicle_pose(scene: Scene, scan_idx: int, step_m: float = 1.0) -> np.ndarray:
    """4x4 velodyne pose in map frame for scan ``scan_idx`` along a +x path."""
    x = scan_idx * step_m
    y = 1.5 * np.sin(0.02 * x)
    yaw = np.arctan2(1.5 * 0.02 * np.cos(0.02 * x), 1.0)
    z = terrain_z(scene, x, y) + SENSOR_HEIGHT
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = (x, y, z)
    return T


def render_scan(
    scene: Scene,
    t_map_velo: np.ndarray,
    n_beams: int = 64,
    n_azimuth: int = 1800,
    max_range: float = 75.0,
    noise: float = 0.01,
    seed: int = 0,
):
    """Ray-cast one scan. Returns (points_velo (P,3) f32, labels (P,) i32).

    Points are expressed in the sensor (velodyne) frame like a KITTI .bin.
    """
    rng = np.random.default_rng(seed)
    T = np.asarray(t_map_velo, dtype=np.float64)
    o = T[:3, 3]
    R = T[:3, :3]

    elev = np.deg2rad(np.linspace(2.0, -24.8, n_beams))
    azim = np.linspace(0, 2 * np.pi, n_azimuth, endpoint=False)
    ce, se = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(azim), np.sin(azim)
    # (n_beams, n_azimuth, 3) directions in sensor frame
    d_sensor = np.stack(
        [ce[:, None] * ca[None, :], ce[:, None] * sa[None, :],
         np.broadcast_to(se[:, None], (n_beams, n_azimuth))], axis=-1,
    ).reshape(-1, 3)
    d = d_sensor @ R.T  # map frame

    n_rays = d.shape[0]
    t_hit = np.full(n_rays, np.inf)
    lbl = np.zeros(n_rays, dtype=np.int32)

    # terrain intersection by fixed-point iteration (gentle slopes)
    down = d[:, 2] < -1e-3
    t = np.full(n_rays, np.inf)
    tz = terrain_z(scene, o[0], o[1])
    t_est = np.where(down, (tz - o[2]) / np.where(down, d[:, 2], -1.0), np.inf)
    for _ in range(3):
        px = o[0] + t_est * d[:, 0]
        py = o[1] + t_est * d[:, 1]
        with np.errstate(invalid="ignore"):
            t_est = np.where(down, (terrain_z(scene, px, py) - o[2]) / d[:, 2], np.inf)
    ok = down & (t_est > 0) & (t_est < max_range)
    t = np.where(ok, t_est, np.inf)
    ground_y = o[1] + t * d[:, 1]
    with np.errstate(invalid="ignore"):
        ground_lbl = np.where(np.abs(ground_y - o[1]) < scene.road_halfwidth, ROAD, TERRAIN)
    t_hit = t
    lbl = np.where(np.isfinite(t), ground_lbl, 0).astype(np.int32)

    # box intersections (slab method); boxes sit on the terrain unless a
    # z_off column lifts them (bridge decks / overhangs). A porosity column
    # in (0, 1] lets a fraction of rays pass through (vegetation canopies).
    for box in scene.boxes:
        cx, cy, sx, sy, sz, blabel = box[:6]
        z_off = box[6] if len(box) > 6 else 0.0
        porosity = box[7] if len(box) > 7 else 0.0
        z0 = terrain_z(scene, cx, cy) + z_off
        lo = np.array([cx - sx / 2, cy - sy / 2, z0])
        hi = np.array([cx + sx / 2, cy + sy / 2, z0 + sz])
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (lo[None, :] - o[None, :]) / d
            t2 = (hi[None, :] - o[None, :]) / d
        tmin = np.nanmax(np.minimum(t1, t2), axis=1)
        tmax = np.nanmin(np.maximum(t1, t2), axis=1)
        hit = (tmax >= tmin) & (tmax > 0) & (tmin < max_range) & (tmin > 0.5)
        if porosity > 0.0:
            hit &= rng.random(n_rays) >= porosity
        closer = hit & (tmin < t_hit)
        t_hit = np.where(closer, tmin, t_hit)
        lbl = np.where(closer, np.int32(blabel), lbl)

    # mirror-reflection artifacts: a fraction of *ground* returns re-emitted
    # below the surface (puddle/window multipath). These are the below-ground
    # outliers the reference's occlusion ray-march exists to catch
    # (GroundSegmentation.cpp:242-275); SemanticKITTI labels such points 1
    # ("outlier"), which the evaluator counts in totals but in neither the
    # ground nor the non-ground headline set.
    refl_extra = None
    if scene.reflection_rate > 0.0:
        is_ground_hit = np.isfinite(t_hit) & np.isin(lbl, (ROAD, TERRAIN))
        pick = is_ground_hit & (rng.random(n_rays) < scene.reflection_rate)
        if pick.any():
            depth = rng.uniform(*scene.reflection_depth, int(pick.sum()))
            p = o[None, :] + t_hit[pick, None] * d[pick]
            p = p.copy()
            p[:, 2] -= 2.0 * depth  # mirrored below the surface
            refl_extra = (p, np.full(len(p), 1, dtype=np.int32))

    keep = np.isfinite(t_hit)
    t_final = t_hit[keep] + rng.normal(0, noise, keep.sum())
    pts_map = o[None, :] + t_final[:, None] * d[keep]
    out_lbl = lbl[keep]
    if refl_extra is not None:
        pts_map = np.concatenate([pts_map, refl_extra[0]], axis=0)
        out_lbl = np.concatenate([out_lbl, refl_extra[1]])
    pts_velo = (pts_map - o[None, :]) @ R  # R^-1 = R^T applied from the right
    return pts_velo.astype(np.float32), out_lbl


FENCE, OTHER_STRUCTURE, OUTLIER = 51, 52, 1


def make_adversarial_scene(seed: int = 0, extent: float = 160.0) -> Scene:
    """Adversarial test world (VERDICT r2 'What's weak' #2).

    Contents the benign :func:`make_scene` lacks, each targeting a specific
    reference code path:
      * steep linear grade + large short-wave terrain -> pitched/rolled poses
        and damage-fill base-plane math with non-identity rotations
        (GroundGrid.cpp:121-133)
      * retaining walls (thin tall fences beside the road) -> near-vertical
        surfaces adjacent to ground cells (variance/stencil stress,
        GroundSegmentation.cpp:343-395)
      * bridge decks / overhangs above the road -> elevated structure over
        valid ground (tolerance/classification stress)
      * porous vegetation canopies -> mixed-cell variance
      * mirror reflections below the surface -> the occlusion ray-march's
        raison d'etre (GroundSegmentation.cpp:242-275)
    """
    rng = np.random.default_rng(seed)
    k = 4
    amp = rng.uniform(0.3, 0.9, size=k)
    freq = rng.uniform(2 * np.pi / 160.0, 2 * np.pi / 35.0, size=(k, 2))
    phase = rng.uniform(0, 2 * np.pi, size=k)
    grade = (rng.uniform(0.04, 0.09) * rng.choice([-1.0, 1.0]),
             rng.uniform(0.01, 0.04) * rng.choice([-1.0, 1.0]))

    boxes = []
    # retaining walls: 0.4 m thick, 2-4 m tall, 20-60 m long, near the road
    for _ in range(4):
        cx = rng.uniform(10.0, extent)
        side = rng.choice([-1.0, 1.0])
        cy = side * rng.uniform(6.5, 9.0)
        boxes.append((cx, cy, rng.uniform(20.0, 60.0), 0.4,
                      rng.uniform(2.0, 4.0), float(FENCE), 0.0, 0.0))
    # bridge decks: wide slabs 4.5-6 m above the terrain spanning the road
    for _ in range(2):
        cx = rng.uniform(25.0, extent)
        boxes.append((cx, 0.0, rng.uniform(6.0, 10.0), 44.0, 0.6,
                      float(OTHER_STRUCTURE), rng.uniform(4.5, 6.0), 0.0))
    # dense porous vegetation
    for _ in range(12):
        cx = rng.uniform(5.0, extent)
        cy = rng.choice([-1.0, 1.0]) * rng.uniform(6.5, 22.0)
        s = rng.uniform(2.0, 6.0)
        boxes.append((cx, cy, s, s, rng.uniform(2.5, 7.0), float(VEGETATION),
                      0.0, 0.55))
    # cars and buildings as in the benign scene
    for _ in range(8):
        cx = rng.uniform(5.0, extent)
        side = rng.choice([-1.0, 1.0])
        boxes.append((cx, side * rng.uniform(2.0, 5.0), rng.uniform(3.5, 5.0),
                      rng.uniform(1.6, 2.0), rng.uniform(1.4, 1.8),
                      float(CAR), 0.0, 0.0))
    for _ in range(4):
        cx = rng.uniform(10.0, extent)
        side = rng.choice([-1.0, 1.0])
        boxes.append((cx, side * rng.uniform(12.0, 30.0),
                      rng.uniform(8.0, 20.0), rng.uniform(6.0, 15.0),
                      rng.uniform(4.0, 10.0), float(BUILDING), 0.0, 0.0))
    return Scene(
        terrain_amp=amp, terrain_freq=freq, terrain_phase=phase,
        boxes=np.array(boxes, dtype=np.float64),
        grade=grade, reflection_rate=0.004,
    )


def vehicle_pose_6dof(scene: Scene, scan_idx: int, step_m: float = 1.0) -> np.ndarray:
    """Full 6-DoF velodyne pose: yaw from the path, pitch/roll from terrain.

    The benign :func:`vehicle_pose` is yaw-only; real odometry (and the
    damage-fill base-plane transform it feeds, GroundGrid.cpp:121-133) has
    pitch and roll whenever the road does. R = Rz(yaw) @ Ry(pitch) @ Rx(roll)
    with pitch/roll from the numerical terrain gradient at the vehicle.
    """
    x = scan_idx * step_m
    y = 2.5 * np.sin(0.015 * x)
    dydx = 2.5 * 0.015 * np.cos(0.015 * x)
    yaw = np.arctan2(dydx, 1.0)

    eps = 0.5
    dzdx = (terrain_z(scene, x + eps, y) - terrain_z(scene, x - eps, y)) / (2 * eps)
    dzdy = (terrain_z(scene, x, y + eps) - terrain_z(scene, x, y - eps)) / (2 * eps)
    # slope along/across the heading direction
    c, s = np.cos(yaw), np.sin(yaw)
    slope_fwd = dzdx * c + dzdy * s
    slope_lat = -dzdx * s + dzdy * c
    pitch = -np.arctan(slope_fwd)  # nose up on rising grade (Ry convention)
    roll = np.arctan(slope_lat)

    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    T = np.eye(4)
    T[:3, :3] = Rz @ Ry @ Rx
    T[:3, 3] = (x, y, terrain_z(scene, x, y) + SENSOR_HEIGHT)
    return T


def adversarial_sequence(
    n_scans: int,
    seed: int = 0,
    n_beams: int = 64,
    n_azimuth: int = 1800,
    step_m: float = 1.0,
):
    """Yield (points_velo, labels, t_map_velo) over the adversarial world."""
    scene = make_adversarial_scene(seed)
    for k in range(n_scans):
        T = vehicle_pose_6dof(scene, k, step_m)
        pts, lbl = render_scan(scene, T, n_beams=n_beams, n_azimuth=n_azimuth,
                               seed=seed + 1000 + k)
        yield pts, lbl, T


def synthetic_sequence(
    n_scans: int,
    seed: int = 0,
    n_beams: int = 64,
    n_azimuth: int = 1800,
    step_m: float = 1.0,
):
    """Yield (points_velo, labels, t_map_velo) for a driving sequence."""
    scene = make_scene(seed)
    for k in range(n_scans):
        T = vehicle_pose(scene, k, step_m)
        pts, lbl = render_scan(scene, T, n_beams=n_beams, n_azimuth=n_azimuth, seed=seed + k)
        yield pts, lbl, T


def detect_layers(n: int, seed: int):
    """Plausible detect-stage inputs on an (n, n) grid, float32 NumPy.

    ``(points, variance, min_gh, ground, conf)``: sparse integer counts and
    the rasterizer's empty-cell conventions (variance 0, min_gh FLT_MAX), as
    ``_random_inputs`` of ``tests/test_pallas_detect.py`` makes them.
    """
    flt_max = np.float32(np.finfo(np.float32).max)
    rng = np.random.default_rng(seed)
    points = rng.poisson(1.2, (n, n)).astype(np.float32)
    points[rng.random((n, n)) < 0.4] = 0.0
    occupied = points > 0
    variance = np.where(occupied, rng.gamma(2.0, 0.05, (n, n)), 0.0).astype(np.float32)
    min_gh = np.where(occupied, rng.normal(-1.6, 0.4, (n, n)), flt_max).astype(np.float32)
    ground = rng.normal(-1.7, 0.3, (n, n)).astype(np.float32)
    conf = rng.random((n, n)).astype(np.float32)
    return points, variance, min_gh, ground, conf


def detect_seam_layers(n: int, seed: int):
    """Detect-stage inputs that reach the ladder's seams, float32 NumPy:
    :func:`detect_layers` with dense points, cut into five column bands.

    0. min_gh >= 0 with +0.0 and -0.0 among it, ground 1, high variance:
       the local-min branch takes a signed zero (which zero a min keeps).
    1. min_gh and ground -0.0, low variance: the main update on a window
       sum of -0.0 (a chain started at 0 would give +0.0).
    2. As band 0 with NaN in min_gh and points and FLT_MAX in min_gh under
       nonzero points: NaN windows keep the cell, inf sums.
    3. Ties: variance 0 on stripes of 6 rows (``max_var > 0`` at 0: the
       windows inside a stripe sum no variance), confidence 0.5 on a third
       of the cells (``groundpatch > 0.5`` at 0.5), ground the 3x3 or 5x5
       minimum of min_gh (``localmin < ground`` at equality), points 1 so
       that window counts meet the skip thresholds.
    4. Low variance: the main update.
    """
    points, variance, min_gh, ground, conf = detect_layers(n, seed)
    rng = np.random.default_rng(seed + 1000)
    points = points * np.float32(10.0)
    bands = np.minimum(np.arange(n) * 5 // n, 4)[None, :].repeat(n, 0)
    occupied = points > 0
    signed = np.abs(min_gh)
    zeros = occupied & (rng.random((n, n)) < 0.4)
    signed[zeros] = np.where(rng.random(int(zeros.sum())) < 0.5, 0.0, -0.0)
    for band in (0, 2):
        at = bands == band
        min_gh[at], ground[at] = signed[at], 1.0
        variance[at] *= np.float32(10.0)
    at = bands == 1
    min_gh[at], ground[at] = -0.0, -0.0
    variance[(bands == 1) | (bands == 4)] *= np.float32(0.01)
    at = bands == 2
    min_gh[at & (rng.random((n, n)) < 0.05)] = np.nan
    points[at & (rng.random((n, n)) < 0.02)] = np.nan
    min_gh[at & occupied & (rng.random((n, n)) < 0.05)] = np.finfo(np.float32).max
    at = bands == 3
    points[at & occupied] = 1.0
    variance[at & (np.arange(n)[:, None] // 6 % 2 == 0)] = 0.0
    conf[at & (rng.random((n, n)) < 0.33)] = 0.5
    pad = np.pad(min_gh, 2, constant_values=np.inf)

    def window_min(size):
        r = size // 2
        return np.min([pad[2 - r + i:2 - r + i + n, 2 - r + j:2 - r + j + n]
                       for i in range(size) for j in range(size)], axis=0)

    win = np.where(rng.random((n, n)) < 0.5, window_min(3), window_min(5))
    take = at & np.isfinite(win)
    ground[take] = win[take]
    return points, variance, min_gh, ground, conf
