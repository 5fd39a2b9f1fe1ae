"""Sequential NumPy golden implementation of the GroundGrid algorithm.

A copy of ``groundgrid_tpu/golden.py`` on the port's config, held to the
original bitwise by ``tests/test_torch_shared.py`` (importing the original
would import JAX). It is the *test oracle* for the pipeline: a deliberately
slow, single-threaded, per-point/per-cell transliteration of the algorithm's math,
written directly from the published formulas (see SURVEY.md section 2.1 and
the paper, RA-L 2024, DOI 10.1109/LRA.2023.3333233). The reference C++ is
racy across threads (unsynchronized accumulator writes,
``GroundSegmentation.cpp:200-310``); this golden picks the canonical
deterministic order (points in index order, cells row-major, spiral exactly
as specified), which is also what the JAX pipeline reproduces.

Not performance code. The pipeline imports only :func:`expected_points_table`
(``core/detect.py``'s detection tables).

Formula provenance (file:line in the reference implementation):
  * expected point density table     GroundSegmentation.cpp:37-48
  * rasterization accumulators       GroundSegmentation.cpp:282-309
  * outlier occlusion ray-march      GroundSegmentation.cpp:242-275
  * variance map                     GroundSegmentation.cpp:323
  * ground patch detection           GroundSegmentation.cpp:343-395
  * spiral interpolation             GroundSegmentation.cpp:398-465
  * point classification             GroundSegmentation.cpp:146-189
  * grid move / damage re-init       GroundGrid.cpp:83-147
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from groundgrid_torch.config import GroundGridConfig

FLT_MAX = np.float32(np.finfo(np.float32).max)
FLT_MIN = np.float32(np.finfo(np.float32).tiny)  # C++ FLT_MIN = smallest normal

LABEL_GROUND = 49
LABEL_NONGROUND = 99
LABEL_DROPPED = 0  # point absent from the reference's output cloud


def expected_points_table(config: GroundGridConfig) -> np.ndarray:
    """Per-cell expected point count per laser (GroundSegmentation.cpp:37-48).

    expected(i, j) = atan(1 / dist_cells) / verticalPointAngDist with
    dist_cells = hypot(i - N/2, j - N/2). The center cell divides by zero ->
    atan(inf) = pi/2, matching C++ float semantics.
    """
    n = config.cell_count
    ii, jj = np.meshgrid(np.arange(n, dtype=np.float64), np.arange(n, dtype=np.float64), indexing="ij")
    dist = np.hypot(ii - n / 2.0, jj - n / 2.0)
    with np.errstate(divide="ignore"):
        table = np.arctan(1.0 / dist) / config.vertical_point_ang_dist
    return table.astype(np.float32)


@dataclasses.dataclass
class GoldenState:
    """Persistent layers + center (mirrors GridState)."""

    ground: np.ndarray
    groundpatch: np.ndarray
    center: np.ndarray  # (2,) float64


class GoldenGroundGrid:
    """Stateful sequential engine; one instance per LiDAR sequence."""

    def __init__(self, config: GroundGridConfig):
        self.config = config
        self.expected = expected_points_table(config)
        self.state: GoldenState | None = None
        self.scratch: dict[str, np.ndarray] = {}
        # stage snapshots + per-point bookkeeping, for stage-level tests
        self.snapshots: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        self.last_outliers: list[int] = []
        self.last_ignored: list[int] = []
        # MEASUREMENT-HARNESS control, never set by parity tests: when > 0,
        # the per-scan variance map is nudged by +-N float32 ulps (random
        # sign per cell, deterministic seed) before detection. Any two valid
        # float32 roundings of the same real-arithmetic variance (sequential
        # Welford vs a parallel two-pass sum, or two summation orders)
        # differ by exactly this noise class, and detect thresholds it
        # (GroundSegmentation.cpp:369-382), so golden-vs-perturbed-golden
        # metric deltas measure the algorithm's intrinsic rounding-tie
        # sensitivity -- the envelope the accuracy benchmark compares the
        # pipeline delta against (eval/accuracy.py chaos control).
        self.chaos_variance_ulps: int = 0
        self._chaos_rng = np.random.default_rng(0xC4A05)

    # ------------------------------------------------------------------ grid
    def _index(self, xy: np.ndarray) -> np.ndarray:
        """Position -> cell index, grid_map convention (index 0 at max pos)."""
        c = self.config
        rel = (self.state.center + c.half_length) - np.asarray(xy, dtype=np.float64)
        return np.floor(rel / c.resolution).astype(np.int64)

    def _cell_position(self, i: int, j: int) -> tuple[float, float]:
        c = self.config
        x = self.state.center[0] + c.half_length - (i + 0.5) * c.resolution
        y = self.state.center[1] + c.half_length - (j + 0.5) * c.resolution
        return x, y

    def update_odom(self, T_map_velo: np.ndarray, T_base_map: np.ndarray) -> None:
        """GroundGrid::update (GroundGrid.cpp:83-147): init or move the grid."""
        c = self.config
        n = c.cell_count
        pos = np.asarray(T_map_velo, dtype=np.float64)[:2, 3]
        z = float(T_map_velo[2, 3])

        if self.state is None:  # initGroundGrid (GroundGrid.cpp:50-80)
            self.state = GoldenState(
                ground=np.full((n, n), np.float32(z), dtype=np.float32),
                groundpatch=np.full((n, n), np.float32(1e-7), dtype=np.float32),
                center=pos.copy(),
            )
            return

        st = self.state
        dc = (pos - st.center) / c.resolution
        # half-away-from-zero (grid_map getIndexShiftFromPositionShift:
        # int(x + 0.5*sign(x))), NOT np.round's half-to-even (AUDIT.md #1)
        k = (np.sign(dc) * np.floor(np.abs(dc) + 0.5)).astype(np.int64)
        st.center = st.center + k.astype(np.float64) * c.resolution
        if k[0] == 0 and k[1] == 0:
            return  # no damage; early return (GroundGrid.cpp:136-137)

        st.ground = np.roll(st.ground, shift=(k[0], k[1]), axis=(0, 1))
        st.groundpatch = np.roll(st.groundpatch, shift=(k[0], k[1]), axis=(0, 1))

        idx = np.arange(n)
        m0 = (idx < k[0]) if k[0] >= 0 else (idx >= n + k[0])
        m1 = (idx < k[1]) if k[1] >= 0 else (idx >= n + k[1])
        if abs(k[0]) >= n:
            m0 = np.ones(n, bool)
        if abs(k[1]) >= n:
            m1 = np.ones(n, bool)
        exposed = m0[:, None] | m1[None, :]

        Tb = np.asarray(T_base_map, dtype=np.float64)
        eis, ejs = np.nonzero(exposed)
        for i, j in zip(eis, ejs):
            x, y = self._cell_position(i, j)
            z_base = Tb[2, 0] * x + Tb[2, 1] * y + Tb[2, 3]
            st.ground[i, j] = np.float32(-z_base)
            st.groundpatch[i, j] = 0.0

    # -------------------------------------------------------------- pipeline
    def filter_cloud(
        self,
        points_map: np.ndarray,
        rings: np.ndarray,
        origin: np.ndarray,
        T_map_base: np.ndarray,
    ) -> np.ndarray:
        """Full per-scan pipeline; returns per-point int labels (49/99/0)."""
        cfg = self.config
        st = self.state
        n = cfg.cell_count
        pts = np.asarray(points_map, dtype=np.float32)
        origin = np.asarray(origin, dtype=np.float32)
        P = pts.shape[0]

        # scratch layers (GroundSegmentation.cpp:61-75)
        z32 = lambda: np.zeros((n, n), dtype=np.float32)
        ground_candidates = z32()
        plane_dist = z32()
        m2 = z32()
        mean_variance = z32()
        points_raw = z32()
        points = z32()
        min_gh = np.full((n, n), FLT_MAX, dtype=np.float32)
        max_gh = np.full((n, n), FLT_MIN, dtype=np.float32)  # +tiny, sic (:73)

        point_index: list[tuple[int, tuple[int, int]]] = []
        ignored: list[tuple[int, tuple[int, int]]] = []
        outliers: list[int] = []

        # ---- stage 1: rasterize + outlier test (GroundSegmentation.cpp:200-311)
        min_conf = np.float32(cfg.min_outlier_detection_ground_confidence)
        tol_out = np.float32(cfg.outlier_tolerance)
        for i in range(P):
            x, y, z = (np.float32(v) for v in pts[i])
            sqdist = (x - origin[0]) ** 2 + (y - origin[1]) ** 2
            gi = self._index((x, y))
            if not (0 <= gi[0] < n and 0 <= gi[1] < n):
                continue
            g0, g1 = int(gi[0]), int(gi[1])
            points_raw[g0, g1] += 1.0

            if rings[i] > cfg.max_ring or sqdist < cfg.min_dist_squared:
                ignored.append((i, (g0, g1)))
                continue

            # outlier occlusion ray-march (:242-275)
            skip = False
            if z < st.ground[g0, g1] - 0.2:
                vec = np.array([x, y, z], np.float32) - origin
                length = np.float32(np.sqrt(np.sum(vec.astype(np.float64) ** 2)))
                vec = vec / length
                step = 3
                while step * step < length * length and vec[2] < -0.01:
                    ipos = (origin[0] + step * vec[0], origin[1] + step * vec[1])
                    ii = self._index(ipos)
                    i0, i1 = int(ii[0]), int(ii[1])
                    if i0 <= 0 or i1 <= 0 or i0 >= n - 1 or i1 >= n - 1:
                        step += 1
                        continue
                    r0, c0 = max(i0 - 1, 2), max(i1 - 1, 2)
                    block_sum = st.groundpatch[r0 : r0 + 3, c0 : c0 + 3].sum(dtype=np.float32)
                    if (
                        block_sum > min_conf
                        and st.groundpatch[i0, i1] > 0.01
                        and st.ground[i0, i1] >= step * vec[2] + origin[2] + tol_out
                    ):
                        outliers.append(i)
                        skip = True
                        break
                    step += 1
            if skip:
                continue

            # accumulators (:282-309); single canonical order (see module doc)
            cnt = points[g0, g1]
            pd = z - origin[2]
            ground_candidates[g0, g1] = (z + cnt * ground_candidates[g0, g1]) / (cnt + 1.0)
            if mean_variance[g0, g1] == 0.0:
                mean_variance[g0, g1] = pd
            if not math.isnan(pd):
                delta = pd - mean_variance[g0, g1]
                mean_variance[g0, g1] += delta / (cnt + 1)
                plane_dist[g0, g1] = (pd + cnt * plane_dist[g0, g1]) / (cnt + 1.0)
                m2[g0, g1] += delta * (pd - mean_variance[g0, g1])
            max_gh[g0, g1] = max(max_gh[g0, g1], z)
            min_gh[g0, g1] = min(min_gh[g0, g1], z - np.float32(0.0001))
            points[g0, g1] = cnt + 1.0
            point_index.append((i, (g0, g1)))

        self.snapshots["pre_detect"] = (st.ground.copy(), st.groundpatch.copy())
        self.last_outliers = list(outliers)
        self.last_ignored = [i for i, _ in ignored]

        # ---- stage 2: variance + patch detection (GroundSegmentation.cpp:314-395)
        variance = m2 / (points + FLT_MIN)
        if self.chaos_variance_ulps:  # harness control only (see __init__)
            # only nonzero variances: exact zeros (empty / single-point
            # cells) are exactly zero under ANY valid rounding, so nudging
            # them would spuriously flip the maxVar > 0 test
            direction = np.where(
                self._chaos_rng.random(variance.shape) < 0.5,
                np.float32(-np.inf), np.float32(np.inf),
            )
            nudged = variance
            for _ in range(self.chaos_variance_ulps):
                nudged = np.nextafter(nudged, direction, dtype=np.float32)
            variance = np.where(variance > 0, nudged, variance)
        # stage-1 accumulator snapshot for stage-level divergence attribution
        # (scratch["points"] later gains the classify increments, so the
        # detect-stage inputs are only recoverable here)
        self.snapshots["detect_inputs"] = (
            points.copy(), variance.copy(), min_gh.copy()
        )
        self._detect_ground_patches(points, variance, min_gh)
        self.snapshots["post_detect"] = (st.ground.copy(), st.groundpatch.copy())

        # ---- stage 3: spiral interpolation (:398-465)
        self._spiral_interpolation(np.asarray(T_map_base, dtype=np.float64))
        self.snapshots["post_spiral"] = (st.ground.copy(), st.groundpatch.copy())

        # ---- stage 4+5: classification (:146-189)
        labels = np.full(P, LABEL_DROPPED, dtype=np.int32)
        points[:] = 0.0
        min_dist_fac = np.float32(cfg.minimum_distance_factor * 5)
        h_thr = np.float32(cfg.miminum_point_height_threshold)
        h_obs = np.float32(cfg.minimum_point_height_obstacle_threshold)
        for i, (g0, g1) in point_index + ignored:
            # border drop quirk (:167-168); optional in this engine
            # (config.border_drop), so the oracle must honor the flag too
            if cfg.border_drop and (n <= g0 + 3 or n <= g1 + 3):
                continue
            x, y, z = (np.float32(v) for v in pts[i])
            groundheight = st.ground[g0, g1]
            var = variance[g0, g1]
            dist = np.float32(np.hypot(np.float64(x - origin[0]), np.float64(y - origin[1])))
            with np.errstate(divide="ignore", invalid="ignore"):
                tol = np.float32(
                    max(min((min_dist_fac * dist) / var * h_thr, h_thr), h_obs)
                )
            if tol + groundheight < z:
                labels[i] = LABEL_NONGROUND
                points[g0, g1] += 1.0
            else:
                labels[i] = LABEL_GROUND
        for i in outliers:
            labels[i] = LABEL_GROUND

        self.scratch = {
            "points": points,
            "pointsRaw": points_raw,
            "groundCandidates": ground_candidates,
            "planeDist": plane_dist,
            "m2": m2,
            "meanVariance": mean_variance,
            "minGroundHeight": min_gh,
            "maxGroundHeight": max_gh,
            "variance": variance,
        }
        return labels

    # ---------------------------------------------------------------- detect
    def _detect_ground_patches(self, points, variance, min_gh):
        """Per-cell stencil update (GroundSegmentation.cpp:314-395).

        Order-free: each cell writes only itself and reads neighbor blocks of
        layers not written in this stage, so a plain double loop is exact.
        """
        cfg = self.config
        st = self.state
        n = cfg.cell_count
        res = cfg.resolution
        thr = cfg.ground_patch_detection_minimum_point_count_threshold
        psd2 = cfg.patch_size_change_distance**2
        df2 = cfg.distance_factor**2
        mdf2 = cfg.minimum_distance_factor**2
        mdf10_2 = (cfg.minimum_distance_factor * 10) ** 2
        ocpcf = cfg.occupied_cells_point_count_factor
        pccvt = cfg.point_count_cell_variance_threshold
        out_tol = cfg.outlier_tolerance

        ground = st.ground
        conf = st.groundpatch

        for i in range(2, n - 2):
            for j in range(2, n - 2):
                sqdist = ((i - n / 2.0) ** 2 + (j - n / 2.0) ** 2) * res * res
                S = 3 if sqdist <= psd2 else 5
                c = S // 2
                pb = points[i - c : i + c + 1, j - c : j + c + 1]
                psum = pb.sum(dtype=np.float32)
                expected = self.expected[i, j]

                # early skip of (almost) empty areas (:364)
                if psum < max(math.floor(thr * S * expected), 3.0):
                    continue

                var_thr_sq = np.float32(min(max(sqdist * df2, mdf2), mdf10_2))
                vb = variance[i - c : i + c + 1, j - c : j + c + 1]
                mb = min_gh[i - c : i + c + 1, j - c : j + c + 1]
                var_center = vb[c, c]
                localmin = mb.min()
                max_var = (
                    var_center
                    if pb[c, c] >= pccvt
                    else np.float32((pb * vb).sum(dtype=np.float32) / psum)
                )
                groundlevel = np.float32((pb * mb).sum(dtype=np.float32) / psum)
                old_h = ground[i, j]
                old_c = conf[i, j]
                ground_diff = np.float32(max((groundlevel - old_h) * (2.0 * old_c), 1.0))

                # never move a high-confidence estimate upward (:379-380)
                if old_c > 0.5 and groundlevel >= old_h + out_tol:
                    continue

                if (
                    var_thr_sq > max_var * max_var
                    and max_var > 0
                    and psum > (ground_diff * expected * S) * thr
                ):
                    new_c = np.float32(min(psum / ocpcf, 1.0))
                    ground[i, j] = (groundlevel * new_c + old_c * old_h * 2) / (new_c + old_c * 2)
                    conf[i, j] = np.float32(min((psum / (ocpcf * 2.0) + old_c) / 2.0, 1.0))
                elif localmin < old_h:
                    ground[i, j] = localmin
                    conf[i, j] = np.float32(min(old_c + 0.1, 0.5))

    # ----------------------------------------------------------------- spiral
    def _spiral_interpolation(self, T_map_base: np.ndarray):
        """Concentric-rectangle sweep, center outward (:398-465).

        Order matters: outer rings read already-updated inner rings; the ring
        corners (i, i) and (2c-i, 2c-i) are visited twice per ring, exactly as
        the reference's four side-walks produce.
        """
        cfg = self.config
        st = self.state
        c_idx = cfg.center_cell

        st.groundpatch[c_idx, c_idx] = 1.0
        st.ground[c_idx, c_idx] = np.float32(T_map_base[2, 3])  # base z in map

        for i in range(c_idx - 1, 0, -1):
            side_len = (c_idx - i) * 2
            rect = i
            # top row then left column (:421-428)
            for side in range(2):
                for pos in range(rect, rect + side_len):
                    x = pos if side % 2 else rect
                    y = rect if side % 2 else pos
                    self._interpolate_cell(x, y)
            # bottom row then right column, descending, inclusive (:431-439)
            rect2 = rect + side_len
            for side in range(2):
                for pos in range(rect2, rect2 - side_len - 1, -1):
                    x = pos if side % 2 else rect2
                    y = rect2 if side % 2 else pos
                    self._interpolate_cell(x, y)

    def _interpolate_cell(self, x: int, y: int):
        """Confidence-weighted 3x3 blend + confidence decay (:445-465)."""
        cfg = self.config
        st = self.state
        c_idx = cfg.center_cell
        gvl = st.groundpatch
        ggl = st.ground

        block_c = gvl[x - 1 : x + 2, y - 1 : y + 2]
        block_h = ggl[x - 1 : x + 2, y - 1 : y + 2]
        s = block_c.sum(dtype=np.float32) + FLT_MIN
        avg = np.float32((block_c * block_h).sum(dtype=np.float32) / s)

        occ = gvl[x, y]
        ggl[x, y] = (1.0 - occ) * avg + occ * ggl[x, y]
        if ((x - c_idx) ** 2 + (y - c_idx) ** 2) * cfg.resolution**2 > cfg.min_dist_squared:
            gvl[x, y] = np.float32(max(occ - occ / cfg.occupied_cells_decrease_factor, 0.001))
