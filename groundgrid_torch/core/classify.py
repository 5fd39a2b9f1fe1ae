"""Per-point ground/non-ground classification (PyTorch).

The torch counterpart of ``groundgrid_tpu/core/classify.py``, the final loop
of ``GroundSegmentation::filter_cloud`` (``GroundSegmentation.cpp:146-189``):
a distance/variance-adaptive height tolerance per point.

Labels: 99 non-ground, 49 ground, 0 for points the reference drops from its
output (out-of-map points and the within-3-cells-of-max-border quirk,
:167-168).
"""

from __future__ import annotations

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core.rasterize import Binning

LABEL_GROUND = 49
LABEL_NONGROUND = 99
LABEL_DROPPED = 0


def classify(config: GroundGridConfig, binning: Binning, z, outlier, gh, var):
    """(P,) int32 labels.

    ``gh``/``var``: per-point ``ground[cell]`` and ``variance[cell]`` (K2).
    tolerance = max(min((5*min_dist_factor*dist)/var * h_thr, h_thr), h_obs);
    non-ground iff ground + tolerance < z (cpp:170-173). var == 0 gives the
    h_thr clamp and 0/0 NaN a "ground" verdict, as in C++. Outliers are
    force-labelled ground and bypass the border drop (cpp:184-189).
    """
    n = config.cell_count
    considered = binning.inmap & ~outlier
    if config.border_drop:
        considered = considered & (binning.gi0 + 3 < n) & (binning.gi1 + 3 < n)

    dist = torch.sqrt(binning.sqdist)
    min_dist_fac = float(np.float32(config.minimum_distance_factor * 5))
    h_thr = float(np.float32(config.miminum_point_height_threshold))
    h_obs = float(np.float32(config.minimum_point_height_obstacle_threshold))

    tol = torch.clamp_min(torch.clamp_max((min_dist_fac * dist) / var * h_thr, h_thr), h_obs)
    nonground = tol + gh < z

    labels = torch.where(
        nonground, torch.full_like(binning.cell, LABEL_NONGROUND),
        torch.full_like(binning.cell, LABEL_GROUND),
    )
    labels = torch.where(considered, labels, torch.full_like(labels, LABEL_DROPPED))
    return torch.where(outlier, torch.full_like(labels, LABEL_GROUND), labels)
