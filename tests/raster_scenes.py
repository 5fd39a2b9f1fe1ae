"""Raster-stage inputs that put the finish on its seams.

Shared by ``test_torch_raster_stage.py`` (the plain K9 / K10 against the
route they replace, and against the JAX package) and ``test_torch_cuda.py``
(the kernels against their plain versions on the card). Imports neither
JAX nor ``groundgrid_tpu``.

:func:`seam_points` places points at chosen cells of a small grid (each
point at its cell's centre, binned by the port's own ``bin_points``) so
that the layers meet: cells with one accepted point, cells whose accepted
points share one pd, cells whose pds differ by an ulp or two (some of them
leave a negative residue, clamped to 2^-80), all-ignored and all-outlier
cells (the min layer's sentinel), all-negative z (the max layer's FLT_MIN
reset), -0.0 and +0.0 z, and points off the map or invalid (the overflow
id N^2); the other points go to the other cells.
"""

from __future__ import annotations

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import rasterize as rasterlib
from groundgrid_torch.core import scalars, transforms

# a small grid (80^2) with the ring rule in reach
SEAM_CONFIG = dict(dimension=40.0, resolution=0.5, max_points=8192, ray_steps=40,
                   max_outlier_candidates=512, max_ring=60)


def seam_poses(rng):
    """``(center, t_map_velo, t_base_map)`` of a sensor near the grid's
    centre on a tilted base plane, so the plane shift differs from cell to
    cell."""
    center = rng.normal(0.0, 0.2, 2).astype(np.float32)
    t_base_map = transforms.translation(0.05, -0.1, -1.6)
    t_base_map[2, :2] = rng.normal(0.0, 0.02, 2)
    return center, transforms.translation(*(center + rng.normal(0, 0.5, 2)), 1.7), t_base_map


def seam_packed(config: GroundGridConfig, poses) -> np.ndarray:
    """The scan scalars of :func:`seam_poses`' ``poses``."""
    center, t_map_velo, t_base_map = poses
    return scalars.pack(config, center, np.zeros(2, np.float32), (0, 0), t_map_velo,
                        np.eye(4), t_base_map)


def seam_points(config: GroundGridConfig, packed: np.ndarray, rng, p: int):
    """``(x, y, z, rings, valid, outlier)`` NumPy arrays of ``p`` points,
    shuffled, against the scan scalars ``packed`` (see the module
    docstring)."""
    n, res = config.cell_count, np.float64(np.float32(config.resolution))
    s = scalars.view(torch.from_numpy(packed))
    sh = (np.float64(s.sh0) + np.float64(s.sl0), np.float64(s.sh1) + np.float64(s.sl1))
    cells = rng.permutation(n * n)
    xs, ys, zs, rings, outlier = [], [], [], [], []

    def put(cell, z, ring=0, out=False):
        i, j = divmod(int(cell), n)
        xs.append(sh[0] - (i + 0.5) * res)
        ys.append(sh[1] - (j + 0.5) * res)
        zs.append(z)
        rings.append(ring)
        outlier.append(out)

    groups = iter(np.array_split(cells[:1200], 12))
    for c in next(groups):  # one accepted point
        put(c, rng.uniform(-3.0, 2.0))
    for c in next(groups):  # identical pd
        z = np.float32(rng.uniform(-3.0, 2.0))
        for _ in range(rng.integers(2, 6)):
            put(c, z)
    for c in np.concatenate([next(groups), next(groups), next(groups)]):  # an ulp or two
        # terrain heights, 0.05-7.4 m either side of the map's zero
        z = np.float32(rng.choice([-1.0, 1.0]) * np.exp(rng.uniform(-3.0, 2.0)))
        for k in range(rng.integers(2, 4)):
            put(c, np.nextafter(z, np.float32(np.inf)) if k == 1 else z)
    for c in next(groups):  # all ignored: raw > 0, no accepted point
        for _ in range(rng.integers(1, 4)):
            put(c, rng.uniform(-3.0, 2.0), ring=config.max_ring + 1)
    for c in next(groups):  # all outliers
        for _ in range(rng.integers(1, 4)):
            put(c, rng.uniform(-3.0, 2.0), out=True)
    for c in next(groups):  # all-negative z: the max layer's reset wins
        for _ in range(rng.integers(1, 5)):
            put(c, rng.uniform(-3.0, -0.01))
    for c in next(groups):  # signed zeros
        for _ in range(rng.integers(1, 4)):
            put(c, rng.choice([-0.0, 0.0]))
    for c in next(groups):  # mixed: accepted, ignored and outlier points in one cell
        for _ in range(rng.integers(2, 6)):
            put(c, rng.uniform(-3.0, 2.0), ring=rng.choice([0, config.max_ring + 1]),
                out=bool(rng.random() < 0.3))
    k = p - len(xs)
    if k < 0:
        raise ValueError(f"{p} points hold fewer than the seams' {len(xs)}")
    for c in rng.choice(cells[1200:], k - k // 10):  # random, away from the seams
        put(c, rng.uniform(-3.0, 2.0), ring=rng.integers(0, 70), out=bool(rng.random() < 0.05))
    half = np.float64(config.half_length)
    for _ in range(k // 10):  # off the map
        xs.append(rng.choice([-1.0, 1.0]) * rng.uniform(1.01, 1.5) * half)
        ys.append(rng.uniform(-1.5, 1.5) * half)
        zs.append(rng.uniform(-3.0, 2.0))
        rings.append(0)
        outlier.append(False)
    perm = rng.permutation(p)
    valid = rng.random(p) < 0.98
    arrays = (np.asarray(xs, np.float32), np.asarray(ys, np.float32),
              np.asarray(zs, np.float32), np.asarray(rings, np.int32), valid,
              np.asarray(outlier, bool))
    return tuple(a[perm] for a in arrays)


def seam_inputs(seeds=(0,), p: int = 6144, device="cpu", sort: bool = False,
                config: GroundGridConfig | None = None):
    """``(config, s, binning, z, outlier)`` of one seam scene a seed: (P,)
    tensors for one seed, (B, P) rows (each its own scan scalars) for more.
    With ``sort`` each row's points come sorted by cell id (stable).
    ``config`` defaults to :data:`SEAM_CONFIG`."""
    config = GroundGridConfig(**SEAM_CONFIG) if config is None else config
    rows, packs = [], []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        packed = seam_packed(config, seam_poses(rng))
        x, y, z, rings, valid, outlier = seam_points(config, packed, rng, p)
        if sort:
            b = rasterlib.bin_points(config, scalars.view(torch.from_numpy(packed)),
                                     *(torch.from_numpy(a) for a in (x, y, rings, valid)))
            order = np.argsort(b.cell.numpy(), kind="stable")
            x, y, z, rings, valid, outlier = (a[order] for a in (x, y, z, rings, valid,
                                                                 outlier))
        rows.append((x, y, z, rings, valid, outlier))
        packs.append(packed)
    batch = len(seeds) > 1
    x, y, z, rings, valid, outlier = (
        torch.from_numpy(np.stack(a) if batch else a[0]).to(device) for a in zip(*rows))
    s = scalars.view(torch.from_numpy(np.stack(packs) if batch else packs[0]).to(device))
    binning = rasterlib.bin_points(config, s, x, y, rings, valid)
    return config, s, binning, z, outlier
