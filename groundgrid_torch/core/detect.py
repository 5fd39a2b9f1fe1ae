"""Ground-patch detection: whole-grid stencil update (PyTorch).

The torch counterpart of ``groundgrid_tpu/core/detect.py``, the replacement
of ``GroundSegmentation::detect_ground_patches`` /
``detect_ground_patch<3|5>`` (``GroundSegmentation.cpp:314-395``). Each cell
writes only itself and reads neighbour blocks of layers this stage never
writes, so the sweep is a set of windowed reductions plus selects.

The 3x3 and 5x5 box sums and min-pools are fixed-order shifted-slice adds
and mins with SAME-style padding (zeros for sums, +inf for minima). Not
``F.conv2d``: on CUDA it goes through cuDNN in TF32 by default.

Divisions by constants go through ``exactf32.div_const``: a CUDA division
by a host scalar would multiply by the rounded reciprocal, an ulp off the
reference's quotient.

Layers may carry leading vehicle axes, ``(..., N, N)`` (the fleet's
batched step): the windows run over the last two axes and the tables
broadcast, so each grid is bitwise its own sweep.

The distance-derived tables depend only on the config and are built once on
the host (:func:`make_tables`), as the reference precomputes its
``expectedPoints`` table (``GroundSegmentation.cpp:37-48``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core.exactf32 import div_const
from groundgrid_torch.golden import expected_points_table


class DetectTables(NamedTuple):
    """Static per-cell tables, as tensors on the step's device."""

    use3: torch.Tensor  # bool: 3x3 patch (inside patch_size_change_distance)
    var_thr_sq: torch.Tensor  # clamped squared variance threshold
    skip_thr: torch.Tensor  # early-skip point count threshold
    interior: torch.Tensor  # bool: cells the reference iterates ([2, N-2)^2)
    min_expected_s: torch.Tensor  # expected * S * threshold
    # (N, N, 4) int32, the five tables as one 16-byte record a cell (K8's one
    # load): var_thr_sq, skip_thr and min_expected_s as f32 bits, then
    # use3 | interior << 1 (RECORD_USE3, RECORD_INTERIOR)
    records: torch.Tensor


RECORD_USE3, RECORD_INTERIOR = 1, 2


def make_tables(config: GroundGridConfig, device) -> DetectTables:
    """Host float64 tables (the JAX package's ``make_tables``), then f32."""
    n = config.cell_count
    res = config.resolution
    ii, jj = np.meshgrid(np.arange(n, dtype=np.float64), np.arange(n, dtype=np.float64),
                         indexing="ij")
    sqdist = ((ii - n / 2.0) ** 2 + (jj - n / 2.0) ** 2) * res * res
    use3 = sqdist <= config.patch_size_change_distance ** 2
    s = np.where(use3, 3.0, 5.0)
    expected = expected_points_table(config).astype(np.float64)
    thr = config.ground_patch_detection_minimum_point_count_threshold
    skip_thr = np.maximum(np.floor(thr * s * expected), 3.0)  # cpp:364
    var_thr_sq = np.minimum(  # cpp:369
        np.maximum(sqdist * config.distance_factor ** 2, config.minimum_distance_factor ** 2),
        (config.minimum_distance_factor * 10) ** 2,
    )
    interior = np.zeros((n, n), dtype=bool)
    interior[2:n - 2, 2:n - 2] = True
    min_expected_s = expected * s * thr  # branch gate (cpp:382), sans groundDiff

    def dev(a, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a.astype(dtype))).to(device)

    words = [a.astype(np.float32).view(np.int32) for a in (var_thr_sq, skip_thr, min_expected_s)]
    flags = use3 * RECORD_USE3 | interior * RECORD_INTERIOR
    return DetectTables(
        use3=dev(use3, bool), var_thr_sq=dev(var_thr_sq), skip_thr=dev(skip_thr),
        interior=dev(interior, bool), min_expected_s=dev(min_expected_s),
        records=dev(np.stack(words + [flags.astype(np.int32)], axis=-1), np.int32),
    )


def _window(x, size: int, pad_value: float, combine):
    """SAME window reduction over the last two axes, offsets combined in
    row-major order."""
    n0, n1 = x.shape[-2:]
    r = size // 2
    p = torch.nn.functional.pad(x, (r, r, r, r), value=pad_value)
    out = None
    for di in range(size):
        for dj in range(size):
            v = p[..., di:di + n0, dj:dj + n1]
            out = v if out is None else combine(out, v)
    return out


def _box(x, size):
    return _window(x, size, 0.0, torch.add)


def _minpool(x, size):
    return _window(x, size, float("inf"), torch.minimum)


def detect_ground_patches(config: GroundGridConfig, tables: DetectTables, points, variance,
                          min_ground_height, ground, groundpatch):
    """One detection sweep; returns new (ground, groundpatch).

    Formulas of GroundSegmentation.cpp:343-395; 3x3 vs 5x5 per cell by the
    patch_size_change_distance rule (:330-338).
    """
    return _update(config, tables, points, variance, min_ground_height, ground, groundpatch, 0)


# ghost rows a row block's stencil inputs carry on each side (the 5x5 window)
HALO = 2


def row_tables(tables: DetectTables, rows: slice) -> DetectTables:
    """The tables of a block of grid rows."""
    return DetectTables(*(t[rows] for t in tables))


def detect_block(config: GroundGridConfig, tables: DetectTables, points_h, variance_h,
                 min_ground_height_h, ground, groundpatch):
    """:func:`detect_ground_patches` on one block of grid rows, the port of
    the JAX package's ``parallel/spatial.py _detect_block``.

    The stencil inputs carry ``HALO`` ghost rows above and below the block
    (``(rows + 2 HALO, N)``); ``tables`` (:func:`row_tables`), ``ground`` and
    ``groundpatch`` are the block's own rows. The windows reduce over the
    halo'd block, offsets in the whole grid's row-major order, and are then
    cropped: with the neighbours' rows as halo, the block is bitwise the
    whole grid's sweep on those rows. At the grid's top and bottom the JAX
    step fills the halo with zeros, for the minimum too (+inf pads the
    whole grid's); only rows 0-1 and N-2..N-1 read them, and those lie
    outside ``tables.interior``, so no output changes.
    """
    return _update(config, tables, points_h, variance_h, min_ground_height_h, ground,
                   groundpatch, HALO)


def _update(config, tables, points_h, variance_h, min_gh_h, ground, groundpatch, halo):
    cfg = config
    rows = slice(halo, points_h.shape[-2] - halo)
    pv = points_h * variance_h
    pm = points_h * min_gh_h  # empty cells: 0 * FLT_MAX == 0

    def box(x, size):
        return _box(x, size)[..., rows, :]

    def minpool(x, size):
        return _minpool(x, size)[..., rows, :]

    use3 = tables.use3
    psum = torch.where(use3, box(points_h, 3), box(points_h, 5))
    pvsum = torch.where(use3, box(pv, 3), box(pv, 5))
    pmsum = torch.where(use3, box(pm, 3), box(pm, 5))
    localmin = torch.where(use3, minpool(min_gh_h, 3), minpool(min_gh_h, 5))
    points, variance = points_h[..., rows, :], variance_h[..., rows, :]

    process = tables.interior & (psum >= tables.skip_thr)
    safe = torch.clamp_min(psum, 1.0)
    max_var = torch.where(
        points >= float(np.float32(cfg.point_count_cell_variance_threshold)),
        variance, pvsum / safe,
    )
    groundlevel = pmsum / safe

    ground_diff = torch.clamp_min((groundlevel - ground) * (2.0 * groundpatch), 1.0)
    guard = (groundpatch > 0.5) & (
        groundlevel >= ground + float(np.float32(cfg.outlier_tolerance))
    )
    ocpcf = float(np.float32(cfg.occupied_cells_point_count_factor))
    branch1 = (
        (tables.var_thr_sq > max_var * max_var)
        & (max_var > 0)
        & (psum > ground_diff * tables.min_expected_s)
    )
    new_c = torch.clamp_max(div_const(psum, ocpcf), 1.0)
    h1 = (groundlevel * new_c + groundpatch * ground * 2.0) / (new_c + groundpatch * 2.0)
    c1 = torch.clamp_max(div_const(div_const(psum, ocpcf * 2.0) + groundpatch, 2.0), 1.0)

    branch2 = localmin < ground
    take1 = process & ~guard & branch1
    take2 = process & ~guard & ~branch1 & branch2

    new_ground = torch.where(take1, h1, torch.where(take2, localmin, ground))
    new_conf = torch.where(
        take1, c1,
        torch.where(take2, torch.clamp_max(groundpatch + 0.1, 0.5), groundpatch),
    )
    return new_ground, new_conf
