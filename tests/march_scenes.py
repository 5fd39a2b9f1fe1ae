"""Scenes for the occlusion march's tests, made with NumPy from a seed.

:func:`edge_scene` puts the marchable rays' last samples on rows and
columns 1, 2, 3 and n - 2 of the grid, where ``occlusion_key_table``'s
low-side clamp acts (rows and columns 1 and 2 read the block sum centred
on 3), and makes every decision of a cell's occlusion key there matter: the
interior never occludes (its ground lies below every sample), the border
band's ground straddles the samples' heights, and its confidences are
dyadic fractions (exact sums, many 3x3 blocks summing to exactly
``min_outlier_detection_ground_confidence``) or exactly ``float32(0.01)``
(the cell test's edge). ``tests/test_torch_march_redesign.py`` shows that
the scene's outliers change when the clamp, the block test or the cell
test change; ``tests/test_torch_cuda.py`` holds K6 and K7 to their plain
versions on it. Neither JAX nor ``groundgrid_tpu`` is imported here.
"""

from typing import NamedTuple

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import scalars, transforms
from groundgrid_torch.ops import binning

EDGE = dict(dimension=40.0, resolution=0.5, max_points=4096, ray_steps=40,
            max_outlier_candidates=4096)  # 80^2 cells
BAND = 5  # cells from the border whose ground can occlude


class Scene(NamedTuple):
    x: np.ndarray  # (P,) f32 points
    y: np.ndarray
    z: np.ndarray
    rings: np.ndarray  # (P,) i32
    valid: np.ndarray  # (P,) bool
    origin: np.ndarray  # (3,) f32 sensor position
    packed: np.ndarray  # (SIZE,) f32 scan scalars (grid center 0)
    ground: np.ndarray  # (n, n) f32, the moved layers
    conf: np.ndarray


def edge_scene(cfg: GroundGridConfig, seed: int) -> Scene:
    """One vehicle's scene: ``cfg.max_points`` points, each in a cell 0-4
    or n-5..n-1 from the border on one axis (both, in the corners, for an
    eighth) and anywhere on the other, below the terrain; a sensor near
    the centre; the (n, n) layers described above."""
    rng = np.random.default_rng(seed)
    n, p, res = cfg.cell_count, cfg.max_points, np.float32(cfg.resolution)
    half = np.float32(cfg.half_length)
    near = np.concatenate([np.arange(BAND), np.arange(n - BAND, n)])
    cells = rng.integers(0, n, (2, p))
    axis = rng.integers(0, 2, p)
    cells[axis, np.arange(p)] = rng.choice(near, p)
    corner = rng.random(p) < 0.125
    cells[:, corner] = rng.choice(near, (2, int(corner.sum())))
    frac = rng.uniform(0.05, 0.95, (2, p))
    x, y = (half - (cells + frac) * res).astype(np.float32)  # cell = floor((half - x) / res)
    z = rng.uniform(-4.0, -1.4, p).astype(np.float32)
    rings = np.zeros(p, np.int32)
    valid = rng.random(p) < 0.97
    origin = np.float32([*rng.uniform(-0.4, 0.4, 2), 1.7])
    packed = scalars.pack(cfg, np.zeros(2, np.float32), np.zeros(2, np.float32), (0, 0),
                          transforms.translation(*origin, np.float32), np.eye(4), np.eye(4))
    ground = np.full((n, n), -6.0, np.float32)
    border = np.ones((n, n), bool)
    border[BAND:n - BAND, BAND:n - BAND] = False
    ground[border] = rng.normal(-2.0, 1.2, int(border.sum())).astype(np.float32)
    levels = np.float32([0.0, 0.125, 0.25, 0.375, 0.01])
    conf = levels[rng.choice(5, (n, n), p=[0.2, 0.25, 0.25, 0.15, 0.15])]
    return Scene(x, y, z, rings, valid, origin, packed, ground, conf)


# the ground word K6 would read past a grid's last cell: the next grid's
# first word, or the word after the buffer (a guard-free read turns the
# overflow points' candidacy: z < -1000.2 is false, z < 0 - 0.2 true)
PAST_GRID = -1000.0


def fold_inputs(cfg: GroundGridConfig, seeds, device="cpu"):
    """K6's inputs on the edge scenes of ``seeds`` (one vehicle, or a (B,
    ...) batch) with the seams of its ground read, on ``device``: ``(s,
    binning, x, y, z, ground, overflow)``. ``ground`` is the moved ground
    with -0.0 at the cells of every 5th point and NaN at every 11th (the
    NaN word turns a candidate away: z < NaN is false); each grid's first
    word and the word past the last grid are ``PAST_GRID`` (``ground`` is a
    view of a buffer one word longer). The points ``overflow`` marks (every
    7th) are made in-map and unignored with the overflow id n^2, which
    reads 0. The binning is ``bin_points_plain``'s otherwise."""
    scenes = [edge_scene(cfg, seed) for seed in seeds]
    n, p = cfg.cell_count, cfg.max_points
    buf = np.zeros(len(seeds) * n * n + 1, np.float32)
    ground = buf[:-1].reshape(len(seeds), n, n)
    ground[:] = np.stack([sc.ground for sc in scenes])
    idx = np.arange(p)
    for g, sc in zip(ground, scenes):
        i0 = np.floor((np.float32(cfg.half_length) - sc.x) / np.float32(cfg.resolution))
        i1 = np.floor((np.float32(cfg.half_length) - sc.y) / np.float32(cfg.resolution))
        inside = (i0 >= 0) & (i0 < n) & (i1 >= 0) & (i1 < n)
        for every, word in ((5, -0.0), (11, np.nan)):
            pick = inside & (idx % every == 0)
            g[i0[pick].astype(int), i1[pick].astype(int)] = word
    ground[:, 0, 0] = PAST_GRID
    buf[-1] = PAST_GRID
    shape = (len(seeds),) if len(seeds) > 1 else ()

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).reshape(*shape, *a.shape[1:])).to(device)

    packed, x, y, z, rings, valid = (t(np.stack([getattr(sc, f) for sc in scenes]))
                                     for f in ("packed", "x", "y", "z", "rings", "valid"))
    s = scalars.view(packed)
    b = binning.bin_points_plain(cfg, s, x, y, rings, valid)
    ov = t(np.tile(idx % 7 == 3, (len(seeds), 1)))
    b = b._replace(cell=torch.where(ov, torch.full_like(b.cell, n * n), b.cell),
                   inmap=b.inmap | ov, ignored=b.ignored & ~ov)
    grids = torch.from_numpy(buf).to(device)[:-1].view(*shape, n, n)
    return s, b, x, y, z, grids, ov
