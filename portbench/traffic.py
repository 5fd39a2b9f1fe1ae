"""Drives over a pool of scans: the one generator every traffic file feeds.

A traffic file (``portbench/traffic/<name>.json``) gives the parameters;
this module turns them and ``--seed`` into what each vehicle scans at each
tick. A vehicle drives over the pool of consecutive scans
(:func:`scenes.render_pool`) in a forward and reverse cycle, so its poses
stay continuous: at tick ``t`` vehicle ``v`` is at pool index
``pingpong((phase_step * v + t) mod 2S)``. Every ``drive_scans`` ticks
all vehicles start fresh drives together: each drive is a fresh grid, and
each (vehicle, drive) has its own map-frame rigid offset drawn from the
seed (a yaw in [0, 2 pi) and a translation), so every drive bins, moves
and interpolates differently over the same sensor-frame points.

A schedule of ``sets`` K (the sorted-scan fleet, whose scans are prepared
before the window: ``prepare.SETS``) has K distinct drives: drive d, the
warm-up drive (-1) among them, steps drive d mod K's pool indices and
offsets, so the warm-up steps the last of the K.
"""

from __future__ import annotations

import numpy as np

# key of the warm-up drive's offsets, apart from the window's drives 0, 1, ...
WARMUP_DRIVE = -1


def _seed_key(seed: int) -> int:
    return int(seed) % (1 << 63)


class Schedule:
    """Where each vehicle is, and at which pose, at each tick."""

    def __init__(self, traffic: dict, seed: int, pool_poses: np.ndarray):
        self.vehicles = int(traffic["vehicles"])
        self.phase_step = int(traffic.get("phase_step", 0))
        self.drive_scans = int(traffic["drive_scans"])
        self.pool = pool_poses.shape[0]
        self.pool_poses = np.asarray(pool_poses, np.float64)
        self.offset = traffic["offset"]
        self.sets = 0  # K distinct drives, drive d stepping drive d mod K; 0: every drive its own
        self.seed = _seed_key(seed)

    def pool_index(self, vehicle: int, tick: int) -> int:
        u = (self.phase_step * vehicle + tick) % (2 * self.pool)
        return u if u < self.pool else 2 * self.pool - 1 - u

    def indices(self, tick: int) -> list[int]:
        return [self.pool_index(v, tick) for v in range(self.vehicles)]

    def offsets(self, drive: int) -> np.ndarray:
        """(V, 4, 4) f64 map-frame offsets of every vehicle's drive ``drive``."""
        out = np.zeros((self.vehicles, 4, 4))
        lo_xy, hi_xy = self.offset["xy_m"]
        lo_z, hi_z = self.offset["z_m"]
        for v in range(self.vehicles):
            rng = np.random.default_rng([self.seed, v, drive - WARMUP_DRIVE])
            yaw = rng.uniform(0.0, 2 * np.pi)
            c, s = np.cos(yaw), np.sin(yaw)
            out[v] = [[c, -s, 0, rng.uniform(lo_xy, hi_xy)], [s, c, 0, rng.uniform(lo_xy, hi_xy)],
                      [0, 0, 1, rng.uniform(lo_z, hi_z)], [0, 0, 0, 1]]
        return out

    def drive_poses(self, drive: int) -> tuple[np.ndarray, np.ndarray]:
        """Every vehicle's pool indices and f64 sensor poses over drive
        ``drive``: (D, V) ints and (D, V, 4, 4), one row a tick; with
        ``sets`` K, those of drive ``drive mod K``."""
        if self.sets:
            drive = drive % self.sets
        d = self.drive_scans
        ticks = drive * d + np.arange(d) if drive >= 0 else np.arange(d)
        idx = np.array([self.indices(int(t)) for t in ticks])
        poses = self.offsets(drive)[None] @ self.pool_poses[idx]
        return idx, poses


def check_positions(traffic: dict, seed: int) -> list[int]:
    """The positions in a drive whose outputs a run compares, drawn from the
    seed: ``check.positions`` of them, the drive's last always among them."""
    d = int(traffic["drive_scans"])
    k = int(traffic["check"]["positions"])
    rng = np.random.default_rng([_seed_key(seed), 0xC4EC])
    rest = rng.choice(d - 1, size=min(k - 1, d - 1), replace=False)
    return sorted({int(r) for r in rest} | {d - 1})
