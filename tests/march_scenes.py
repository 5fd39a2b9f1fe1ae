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

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import scalars, transforms

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
