"""Configuration of the PyTorch / CUDA GroundGrid engine.

A copy of ``groundgrid_tpu.config.GroundGridConfig``: the same field names,
defaults and derived geometry, so a config written for one package means the
same thing to the other (``tests/test_torch_shared.py`` holds the copy to the
original). It is carried here rather than imported because importing anything
under ``groundgrid_tpu`` imports JAX, which the port never needs.

The parameter set mirrors the reference's dynamic_reconfigure file
(``cfg/GroundGrid.cfg:8-21``), the grid geometry
(``include/groundgrid/GroundGrid.h:70-71``) and the algorithm constants
(``include/groundgrid/GroundSegmentation.h:68-70``).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class GroundGridConfig:
    """Runtime-tunable parameters. Names & defaults match ``cfg/GroundGrid.cfg``.

    The reference typo ``miminum_point_height_threshold`` is kept on purpose
    (``cfg/GroundGrid.cfg:13``) so configs written against the reference map
    over 1:1.
    """

    # --- segmentation parameters (cfg/GroundGrid.cfg:8-21) ---
    point_count_cell_variance_threshold: int = 10
    max_ring: int = 1024
    # unused by the reference algorithm as well; kept for config parity
    groundpatch_detection_minimum_threshold: float = 0.01
    distance_factor: float = 0.0001
    minimum_distance_factor: float = 0.0005
    miminum_point_height_threshold: float = 0.3  # sic, reference typo
    minimum_point_height_obstacle_threshold: float = 0.1
    outlier_tolerance: float = 0.1
    ground_patch_detection_minimum_point_count_threshold: float = 0.25
    patch_size_change_distance: float = 20.0
    occupied_cells_decrease_factor: float = 5.0
    occupied_cells_point_count_factor: float = 20.0
    min_outlier_detection_ground_confidence: float = 1.25
    # no-op (kept for parity with cfg/GroundGrid.cfg:21)
    thread_count: int = 8

    # --- grid geometry (include/groundgrid/GroundGrid.h:70-71) ---
    dimension: float = 120.0  # metres (square grid side length)
    resolution: float = 0.33  # metres per cell

    # --- sensor constants (include/groundgrid/GroundSegmentation.h:68-70) ---
    vertical_point_ang_dist: float = 0.00174532925 * 2
    min_dist_squared: float = 12.0  # metres^2; closer points are "ignored"

    # --- pipeline shape parameters (no reference equivalent) ---
    # fixed-size point buffer; scans are padded/masked to this size
    max_points: int = 131072
    # bound of the outlier occlusion ray-march (GroundSegmentation.cpp:258):
    # whole-metre steps from step 3, capped by the grid half-diagonal
    ray_steps: int = 96
    # bound on the below-ground candidates marched per scan; on overflow the
    # shortest-budget candidates are shed (core/outliers.py)
    max_outlier_candidates: int = 8192
    # candidate width of a march chunk (the JAX package's tier base width)
    march_chunk: int = 1024
    # reproduce the reference's "drop points within 3 cells of the max-index
    # border" quirk (GroundSegmentation.cpp:167-168)
    border_drop: bool = True
    # hand-written CUDA kernels: None = on for tensors on a CUDA device,
    # False = the plain PyTorch versions on every device. The name is the
    # JAX package's, where it switched the Pallas kernels.
    use_pallas: bool | None = None
    # sorted-scan mode: the host transforms points to the map frame and
    # sorts them by flat cell id against the host-tracked grid center
    sorted_scans: bool = False
    # verify sortedness on the device (and sort there if the host order was
    # wrong); False trusts the host's order and skips the check's host read
    sorted_fallback_check: bool = True
    # quantized s16 wire format: 8 bytes per point (pipeline.WireScan)
    wire_format: bool = False
    # fused detect stencil, K4 (ops/detect.py) instead of core/detect.py
    fused_detect: bool = False
    # degraded mode for a scan whose pose is missing/non-finite: False drops
    # the scan (GroundGridNodelet.cpp:133-136); True reuses the last good pose
    stale_pose_reuse: bool = False

    @property
    def cell_count(self) -> int:
        """Grid cells per side; grid_map rounds (GridMap::setGeometry)."""
        return int(round(self.dimension / self.resolution))

    @property
    def half_length(self) -> float:
        """Half the *actual* grid side length (= cells * resolution / 2)."""
        return self.cell_count * self.resolution / 2.0

    @property
    def center_cell(self) -> int:
        """Spiral-interpolation center index (GroundSegmentation.cpp:403)."""
        return self.cell_count // 2 - 1

    def validate(self) -> "GroundGridConfig":
        if self.cell_count < 8:
            raise ValueError(f"grid too small: {self.cell_count} cells/side")
        if self.max_points <= 0:
            raise ValueError("max_points must be positive")
        if not math.isfinite(self.resolution) or self.resolution <= 0:
            raise ValueError("resolution must be positive")
        if self.wire_format and not self.sorted_scans:
            raise ValueError(
                "wire_format requires sorted_scans (the s16 wire prep "
                "pre-sorts by the dequantized coordinates' cell ids)"
            )
        return self


DEFAULT_CONFIG = GroundGridConfig()
