"""Synthetic HDL-64E scans, rendered on the device from a seed.

A plain PyTorch rewrite of the repository's NumPy scene generator
(``make_scene``, ``vehicle_pose``, ``render_scan``): a gently rolling
terrain (three long-wavelength sinusoids), axis-aligned boxes (cars,
buildings, vegetation blobs) beside a road along +x, and a spinning sensor
whose rays are cast against both. The NumPy renderer costs about a second
a scan on one core; this one renders a whole pool of consecutive scans in
a few large device calls, so a run's traffic is made in its set-up.

Everything random comes from one ``--seed``: the scene's parameters from a
host ``torch.Generator``, the range noise from one on the device. The same
seed gives the same pool on the same device. A traffic file whose ``scene``
names a ``seed`` of its own fixes the scene (a map every run drives): the
run's seed then draws only the range noise, so every run's scans hold the
same cells, boxes and points per cell, and the seed does not change the
work.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# SemanticKITTI label ids; the ring channel carries them, as the port's
# readers do
ROAD, TERRAIN, CAR, BUILDING, VEGETATION = 40, 72, 10, 50, 70

# sensor mount height above the terrain (KITTI's velodyne)
SENSOR_HEIGHT = 1.73


@dataclasses.dataclass
class Scene:
    amp: torch.Tensor  # (K,) f64
    freq: torch.Tensor  # (K, 2) f64
    phase: torch.Tensor  # (K,) f64
    boxes: torch.Tensor  # (NB, 6) f64: cx, cy, sx, sy, sz, label
    road_halfwidth: float


@dataclasses.dataclass
class Pool:
    """Consecutive scans along the scene's path, padded to ``max_points``.

    points: (S, P, 3) f32 sensor frame; rings: (S, P) i32; counts: (S,)
    host ints; poses: (S, 4, 4) f64 host sensor poses in the scene frame.
    """

    points: torch.Tensor
    rings: torch.Tensor
    counts: list
    poses: np.ndarray


def make_scene(params: dict, seed: int) -> Scene:
    """The scene of ``params`` (``n_boxes``, ``extent``, ``road_halfwidth``)
    drawn from ``seed``."""
    g = torch.Generator().manual_seed(seed)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape or (1,), generator=g, dtype=torch.float64)

    k = 3
    amp = uniform(0.1, 0.4, k)
    freq = uniform(2 * math.pi / 200.0, 2 * math.pi / 60.0, k, 2)
    phase = uniform(0.0, 2 * math.pi, k)
    boxes = []
    kinds = (CAR, BUILDING, VEGETATION)
    for i in range(int(params["n_boxes"])):
        label = kinds[i % 3]
        cx = float(uniform(5.0, float(params["extent"])))
        side = 1.0 if float(uniform(0.0, 1.0)) < 0.5 else -1.0
        if label == CAR:
            cy = side * float(uniform(2.0, 5.0))
            sx, sy, sz = (float(uniform(3.5, 5.0)), float(uniform(1.6, 2.0)),
                          float(uniform(1.4, 1.8)))
        elif label == BUILDING:
            cy = side * float(uniform(12.0, 30.0))
            sx, sy, sz = (float(uniform(8.0, 20.0)), float(uniform(6.0, 15.0)),
                          float(uniform(4.0, 10.0)))
        else:
            cy = side * float(uniform(7.0, 20.0))
            sx = sy = float(uniform(1.5, 4.0))
            sz = float(uniform(2.0, 6.0))
        boxes.append((cx, cy, sx, sy, sz, float(label)))
    return Scene(amp, freq, phase, torch.tensor(boxes, dtype=torch.float64).reshape(-1, 6),
                 float(params["road_halfwidth"]))


def terrain_z(scene: Scene, x, y):
    """Terrain height at (x, y): f64 tensors or floats on any device."""
    x = torch.as_tensor(x, dtype=torch.float64)
    y = torch.as_tensor(y, dtype=torch.float64, device=x.device)
    z = torch.zeros_like(x)
    amp, freq, phase = (t.to(x.device) for t in (scene.amp, scene.freq, scene.phase))
    for i in range(amp.shape[0]):
        z = z + amp[i] * torch.sin(freq[i, 0] * x + phase[i]) * torch.cos(freq[i, 1] * y)
    return z


def vehicle_pose(scene: Scene, x: float) -> np.ndarray:
    """4x4 f64 sensor pose at ``x`` metres along the scene's +x path."""
    y = 1.5 * math.sin(0.02 * x)
    yaw = math.atan2(1.5 * 0.02 * math.cos(0.02 * x), 1.0)
    z = float(terrain_z(scene, x, y)) + SENSOR_HEIGHT
    c, s = math.cos(yaw), math.sin(yaw)
    t = np.eye(4)
    t[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
    t[:3, 3] = (x, y, z)
    return t


def _ray_directions(sensor: dict, device) -> torch.Tensor:
    elev = torch.deg2rad(torch.linspace(float(sensor["elevation_max_deg"]),
                                        float(sensor["elevation_min_deg"]),
                                        int(sensor["beams"]), dtype=torch.float64))
    n_az = int(sensor["azimuths"])
    azim = torch.arange(n_az, dtype=torch.float64) * (2 * math.pi / n_az)
    ce, se = torch.cos(elev), torch.sin(elev)
    ca, sa = torch.cos(azim), torch.sin(azim)
    d = torch.stack([ce[:, None] * ca[None, :], ce[:, None] * sa[None, :],
                     se[:, None].expand(-1, n_az)], dim=-1)
    return d.reshape(-1, 3).to(device)


def _render(scene: Scene, sensor: dict, poses: torch.Tensor, d_sensor, noise_gen):
    """Cast every ray of the scans at ``poses`` ((S, 4, 4) f64 on the
    device): (S, R) hit ranges (inf: no return) and labels, and the map-frame
    directions."""
    rot, org = poses[:, :3, :3], poses[:, :3, 3]
    d = torch.einsum("rj,sij->sri", d_sensor, rot)  # (S, R, 3) map frame
    ox, oy, oz = (org[:, i:i + 1] for i in range(3))
    max_range = float(sensor["max_range_m"])
    down = d[..., 2] < -1e-3
    tz = terrain_z(scene, ox, oy)
    dz = torch.where(down, d[..., 2], torch.full_like(d[..., 2], -1.0))
    t_est = torch.where(down, (tz - oz) / dz, torch.full_like(dz, math.inf))
    for _ in range(3):
        px = ox + t_est * d[..., 0]
        py = oy + t_est * d[..., 1]
        t_est = torch.where(down, (terrain_z(scene, px, py) - oz) / dz,
                            torch.full_like(dz, math.inf))
    ok = down & (t_est > 0) & (t_est < max_range)
    t_hit = torch.where(ok, t_est, torch.full_like(t_est, math.inf))
    ground_y = oy + t_hit * d[..., 1]
    lbl = torch.where((ground_y - oy).abs() < scene.road_halfwidth, ROAD, TERRAIN)
    lbl = torch.where(torch.isfinite(t_hit), lbl, 0).to(torch.int32)
    boxes = scene.boxes.to(d.device)
    for b in range(boxes.shape[0]):
        cx, cy, sx, sy, sz, blabel = (float(v) for v in boxes[b])
        z0 = float(terrain_z(scene, cx, cy))
        lo = torch.tensor([cx - sx / 2, cy - sy / 2, z0], dtype=torch.float64, device=d.device)
        hi = torch.tensor([cx + sx / 2, cy + sy / 2, z0 + sz], dtype=torch.float64,
                          device=d.device)
        t1 = (lo - org[:, None, :]) / d
        t2 = (hi - org[:, None, :]) / d
        tmin = torch.nan_to_num(torch.minimum(t1, t2), nan=-math.inf).amax(-1)
        tmax = torch.nan_to_num(torch.maximum(t1, t2), nan=math.inf).amin(-1)
        hit = (tmax >= tmin) & (tmax > 0) & (tmin < max_range) & (tmin > 0.5)
        closer = hit & (tmin < t_hit)
        t_hit = torch.where(closer, tmin, t_hit)
        lbl = torch.where(closer, int(blabel), lbl)
    noise = torch.randn(t_hit.shape, generator=noise_gen, dtype=torch.float64,
                        device=d.device) * float(sensor["range_noise_m"])
    return t_hit, lbl, d, noise


def render_pool(sensor: dict, scene_params: dict, pool: int, step_m: float, max_points: int,
                seed: int, device, chunk: int = 8) -> Pool:
    """``pool`` consecutive scans ``step_m`` apart along the path of the
    scene drawn from ``scene_params["seed"]`` where it is given, else from
    ``seed``, rendered on ``device`` ``chunk`` scans at a time with range
    noise drawn from ``seed``, each padded to ``max_points`` (a scan's
    points beyond it are cut)."""
    device = torch.device(device)
    scene = make_scene(scene_params, int(scene_params.get("seed", seed)))
    poses = np.stack([vehicle_pose(scene, i * step_m) for i in range(pool)])
    d_sensor = _ray_directions(sensor, device)
    noise_gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    points = torch.zeros((pool, max_points, 3), dtype=torch.float32, device=device)
    rings = torch.zeros((pool, max_points), dtype=torch.int32, device=device)
    counts = []
    for s0 in range(0, pool, chunk):
        pz = torch.from_numpy(poses[s0:s0 + chunk]).to(device)
        t_hit, lbl, d, noise = _render(scene, sensor, pz, d_sensor, noise_gen)
        keep = torch.isfinite(t_hit)
        # sensor frame: the hit's map offset from the origin rotated back,
        # which is the map direction rotated back (the sensor ray) times range
        rng = torch.where(keep, t_hit + noise, torch.zeros_like(t_hit))
        pts_sensor = (d_sensor[None] * rng[..., None]).to(torch.float32)
        for i in range(pts_sensor.shape[0]):
            idx = torch.nonzero(keep[i]).squeeze(1)[:max_points]
            n = int(idx.numel())
            points[s0 + i, :n] = pts_sensor[i, idx]
            rings[s0 + i, :n] = lbl[i, idx]
            counts.append(n)
    return Pool(points=points, rings=rings, counts=counts, poses=poses)
