"""A plain PyTorch GroundGrid: the benchmark's reference.

Written from the published algorithm (GroundGrid, RA-L 2024, DOI
10.1109/LRA.2023.3333233) and the reference C++ node's order of operations,
the formulas cited by file and line of dcmlr/groundgrid below, with the
node's canonical deterministic order (points in index order, cells row-major,
the spiral as the node walks it). It imports nothing of the system under
test: it takes raw sensor-frame points, ring channels and f64 poses, keeps
its own grid state, and computes every layer again.

Vectorized, so that it can replay a drive after a benchmark window:

* per point: binning in f64 (grid_map's ``getIndexFromPosition``), the
  occlusion ray-march as a (candidates x steps) lattice;
* per cell: the raster accumulators as sums (the node's running means and
  Welford updates, up to rounding), the patch detection on every cell at
  once (it is order-free: a cell writes only itself);
* the spiral ring by ring (each ring reads the one inside it final): the
  four side-walks of a ring are affine recurrences in the height of the
  walk's predecessor, solved at once in f64 as lower-triangular products,
  and the few reads of cells that another side-walk of the same ring wrote
  first are resolved by iterating the solve as deep as those reads chain.

It batches B independent grids (a leading axis on every tensor). Floats
default to f32 with f64 where the node computes in doubles (binning, the
cell-center plane) and where a reduction's order would otherwise matter;
``float_dtype``/``wide_dtype`` lower them for the benchmark's control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LABEL_GROUND, LABEL_NONGROUND, LABEL_DROPPED = 49, 99, 0
FLT_MIN = float(np.finfo(np.float32).tiny)

# base_link sits 1.95 m ahead of the sensor and 1.73 m below it
# (launch/KITTIPlayback.launch:13-17)
T_SENSOR_BASE = np.array([[1, 0, 0, 1.95], [0, 1, 0, 0], [0, 0, 1, -1.73], [0, 0, 0, 1]],
                         dtype=np.float64)

# a 3x3 block's offsets, row-major; index 4 is the cell itself
BLOCK = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]


class Geometry:
    """The grid geometry and parameters of a configuration's dict (the
    names of ``cfg/GroundGrid.cfg`` and ``GroundGrid.h``)."""

    def __init__(self, p: dict):
        self.p = p
        self.resolution = float(p["resolution"])
        self.n = int(round(float(p["dimension"]) / self.resolution))
        self.half = self.n * self.resolution / 2.0
        self.m = self.n // 2 - 1  # the spiral's center cell


def scan_poses(t_map_velo: np.ndarray):
    """(T_map_velo, T_map_base, T_base_map) as f32, from an f64 pose."""
    t = np.asarray(t_map_velo, np.float64)
    mb = t @ T_SENSOR_BASE
    r, tr = mb[:3, :3], mb[:3, 3]
    bm = np.eye(4)
    bm[:3, :3] = r.T
    bm[:3, 3] = -r.T @ tr
    return t.astype(np.float32), mb.astype(np.float32), bm.astype(np.float32)


def expected_points(g: Geometry) -> np.ndarray:
    """Expected points per laser and cell (GroundSegmentation.cpp:37-48)."""
    i = np.arange(g.n, dtype=np.float64)
    dist = np.hypot(i[:, None] - g.n / 2.0, i[None, :] - g.n / 2.0)
    with np.errstate(divide="ignore"):
        return (np.arctan(1.0 / dist) / float(g.p["vertical_point_ang_dist"])).astype(np.float32)


class RingPlan:
    """The spiral's walk of one ring, as index arrays.

    The node walks ring ``d`` (rows and columns ``m-d .. m+d``) in four
    side-walks (GroundSegmentation.cpp:421-439): the top row ascending, the
    left column ascending, the bottom row descending and the right column
    descending, the last two one cell longer, so two corners are visited
    twice. Each visit blends its 3x3 block (:445-465). For every visit and
    block cell this plan says which earlier visit of this ring wrote the
    cell last (-1: none, the value from before the ring), whether that is
    the walk's predecessor, and how often the cell's confidence decayed in
    this ring before the read. The walks are padded to one width; a padding
    visit reads the center and writes nothing.
    """

    # the solves a ring needs: reads of a cell that another side-walk of the
    # ring wrote first chain at most three deep (the left column reads the
    # top row's first visits, the bottom row's last ones the left column's
    # last, the right column the bottom row's first and the top row's
    # last), and each solve settles one more link
    # (``tests/test_portbench_reference.py`` counts the chains)
    ITERATIONS = 4

    def __init__(self, g: Geometry, d: int, scratch: np.ndarray):
        n, m = g.n, g.m
        lo, hi = m - d, m + d
        w = 2 * d + 1
        ar = np.arange(2 * d)
        desc = np.arange(w)
        walks = [(lo + 0 * ar, lo + ar), (lo + ar, lo + 0 * ar),
                 (hi + 0 * desc, hi - desc), (hi - desc, hi + 0 * desc)]
        v = 4 * w
        xs = np.full(v, m, np.int64)
        ys = np.full(v, m, np.int64)
        real = np.zeros(v, bool)
        step = np.zeros(v, np.int64)  # position within its side-walk
        for s, (wx, wy) in enumerate(walks):
            xs[s * w:s * w + len(wx)] = wx
            ys[s * w:s * w + len(wy)] = wy
            real[s * w:s * w + len(wx)] = True
            step[s * w:s * w + w] = np.arange(w)
        cell = xs * n + ys
        t = np.arange(v)
        first, last = scratch[0], scratch[1]
        first[cell[real]] = v
        last[cell[real]] = -1
        np.minimum.at(first, cell[real], t[real])
        np.maximum.at(last, cell[real], t[real])
        offs = np.array([dx * n + dy for dx, dy in BLOCK])
        read = cell[:, None] + offs[None, :]
        on_ring = (np.maximum(np.abs(read // n - m), np.abs(read % n - m)) == d)
        f = np.where(on_ring, first[read], -1)
        l_ = np.where(on_ring, last[read], -1)
        tt = t[:, None]
        writer = np.where((l_ >= 0) & (l_ < tt), l_, np.where((f >= 0) & (f < tt), f, -1))
        seen = ((f >= 0) & (f < tt)).astype(np.int64) + ((l_ > f) & (l_ < tt)).astype(np.int64)
        pred = (writer == tt - 1) & (step[:, None] > 0) & real[:, None]
        writer[~real] = -1
        seen[~real] = 0
        cells_r = np.unique(cell[real])
        final_visit = last[cells_r].copy()
        final_count = 1 + (last[cells_r] > first[cells_r]).astype(np.int64)
        first[cell[real]] = 0
        last[cell[real]] = 0
        res2 = g.resolution ** 2
        min_d2 = float(g.p["min_dist_squared"])

        def decays(c):
            return (((c // n) - m) ** 2 + ((c % n) - m) ** 2) * res2 > min_d2

        self.width, self.real, self.read = w, real, read
        self.writer, self.pred, self.seen = writer, pred, seen
        self.read_decays = decays(read)
        self.final_cells, self.final_visit, self.final_count = cells_r, final_visit, final_count
        self.final_decays = decays(cells_r)
        self.cross = bool(((writer >= 0) & ~pred).any())

    def to(self, device) -> dict:
        """The plan as device tensors, with the masks the ring's solve takes
        precomputed."""
        t = lambda a: torch.as_tensor(a, device=device)
        w = self.width
        k = np.arange(w)
        return {
            "read": t(self.read), "read_decays": t(self.read_decays),
            "seen0": t(self.seen == 0), "seen1": t(self.seen == 1),
            "pred": t(self.pred), "not_pred": t(~self.pred), "real": t(self.real),
            "cross": t((self.writer >= 0) & ~self.pred), "writer": t(np.maximum(self.writer, 0)),
            "below": t(k[:, None] > k[None, :]),
            "final_cells": t(self.final_cells), "final_visit": t(self.final_visit),
            "final_twice": t(self.final_count == 2), "final_decays": t(self.final_decays),
            "width": w, "has_cross": self.cross,
        }


class GroundGridReference:
    """B independent grids stepped by the plain algorithm.

    :meth:`reset` creates each grid at its first pose (GroundGrid.cpp:50-80);
    :meth:`step` runs one scan per grid and returns per-point labels (49
    ground, 99 non-ground, 0 dropped) and outlier flags. ``ground``,
    ``groundpatch`` ((B, N, N)) and ``center`` ((B, 2) f64, host) are the
    state after the last step.
    """

    def __init__(self, params: dict, batch: int, device, float_dtype=torch.float32,
                 wide_dtype=torch.float64):
        self.g = Geometry(params)
        self.p = params
        self.batch = batch
        self.device = torch.device(device)
        self.ft, self.wt = float_dtype, wide_dtype
        self.expected = torch.from_numpy(expected_points(self.g)).to(self.device, self.ft)
        self._plans = None
        self._graph = self._static = None
        self.ground = self.groundpatch = None
        self.center = None

    # ---------------------------------------------------------------- state
    def reset(self, poses: np.ndarray) -> None:
        """Fresh grids: ground at each pose's z, confidence 1e-7, centered on
        the pose (initGroundGrid, GroundGrid.cpp:50-80)."""
        poses = np.asarray(poses, np.float64).reshape(self.batch, 4, 4)
        n = self.g.n
        z = torch.tensor(poses[:, 2, 3].astype(np.float32), device=self.device)
        self.ground = z.to(self.ft)[:, None, None].expand(-1, n, n).contiguous()
        self.groundpatch = torch.full((self.batch, n, n), 1e-7, dtype=self.ft,
                                      device=self.device)
        self.center = self._keep_center(poses[:, :2, 3])

    def _keep_center(self, c: np.ndarray) -> np.ndarray:
        """The f64 center (grid_map tracks it in doubles), held in the wide
        dtype: exact for f64, rounded for the control's lower precision."""
        return torch.as_tensor(c).to(self.wt).double().numpy().copy()

    def _move(self, poses: np.ndarray, bm: np.ndarray) -> None:
        """GroundGrid::update (GroundGrid.cpp:83-147): whole-cell shift
        snapped half away from zero, exposed cells on the base plane."""
        g, n, dev = self.g, self.g.n, self.device
        dc = (poses[:, :2, 3] - self.center) / g.resolution
        k = (np.sign(dc) * np.floor(np.abs(dc) + 0.5)).astype(np.int64)
        self.center = self._keep_center(self.center + k.astype(np.float64) * g.resolution)
        if not k.any():
            return
        idx = torch.arange(n, device=dev)
        kt = torch.as_tensor(k, device=dev)
        i0 = torch.remainder(idx[None] - kt[:, :1], n)
        i1 = torch.remainder(idx[None] - kt[:, 1:], n)
        b = torch.arange(self.batch, device=dev)[:, None, None]
        ground = self.ground[b, i0[:, :, None], i1[:, None, :]]
        patch = self.groundpatch[b, i0[:, :, None], i1[:, None, :]]

        def axis(kk):
            kk = kk[:, None]
            return torch.where(kk >= 0, idx[None] < kk, idx[None] >= n + kk) | (kk.abs() >= n)

        exposed = axis(kt[:, 0])[:, :, None] | axis(kt[:, 1])[:, None, :]
        wt = self.wt
        off = g.half - (torch.arange(n, device=dev, dtype=wt) + 0.5) * g.resolution
        cx = torch.as_tensor(self.center[:, 0], device=dev, dtype=wt)[:, None, None]
        cy = torch.as_tensor(self.center[:, 1], device=dev, dtype=wt)[:, None, None]
        px, py = cx + off[None, :, None], cy + off[None, None, :]
        tb = torch.as_tensor(bm.astype(np.float64), device=dev, dtype=wt)
        z_base = (tb[:, 2, 0, None, None] * px + tb[:, 2, 1, None, None] * py) \
            + tb[:, 2, 3, None, None]
        self.ground = torch.where(exposed, (-z_base).to(self.ft), ground)
        self.groundpatch = torch.where(exposed, torch.zeros_like(patch), patch)

    def _cells(self, x, y):
        """(row, column) cell indices of map positions, grid_map's
        convention (index 0 at the max position): f64 floor."""
        wt = self.wt
        c = torch.as_tensor(self.center + self.g.half, device=self.device, dtype=wt)
        i0 = torch.floor((c[:, :1] - x.to(wt)) / self.g.resolution).long()
        i1 = torch.floor((c[:, 1:] - y.to(wt)) / self.g.resolution).long()
        return i0, i1

    # ----------------------------------------------------------------- step
    def step(self, points: torch.Tensor, rings: torch.Tensor, counts, poses: np.ndarray):
        """One scan per grid: ``points`` (B, P, 3) f32 sensor frame, ``rings``
        (B, P) i32, ``counts`` real points per row, ``poses`` (B, 4, 4) f64.
        Returns ``(labels (B, P) i32, outlier (B, P) bool)``."""
        p, g, n, dev, ft = self.p, self.g, self.g.n, self.device, self.ft
        poses = np.asarray(poses, np.float64).reshape(self.batch, 4, 4)
        sets = [scan_poses(t) for t in poses]
        mv = np.stack([s[0] for s in sets])
        mb = np.stack([s[1] for s in sets])
        bm = np.stack([s[2] for s in sets])
        self._move(poses, bm)
        b_, pn = points.shape[:2]
        valid = torch.arange(pn, device=dev)[None] < torch.as_tensor(
            np.asarray(counts), device=dev)[:, None]
        # to the map frame, each product and sum its own f32 op
        T = torch.as_tensor(mv, device=dev).to(ft)
        px, py, pz = (points[..., i].to(ft) for i in range(3))

        def row(i):
            return ((T[:, i, 0, None] * px + T[:, i, 1, None] * py)
                    + T[:, i, 2, None] * pz) + T[:, i, 3, None]

        x, y, z = row(0), row(1), row(2)
        ox, oy, oz = (T[:, i, 3, None] for i in range(3))
        i0, i1 = self._cells(x, y)
        inmap = valid & (i0 >= 0) & (i0 < n) & (i1 >= 0) & (i1 < n)
        i0c, i1c = i0.clamp(0, n - 1), i1.clamp(0, n - 1)
        flat = i0c * n + i1c
        sqdist = (x - ox) ** 2 + (y - oy) ** 2
        ignored = inmap & ((rings > int(p["max_ring"])) | (sqdist < float(p["min_dist_squared"])))
        work = inmap & ~ignored

        ground_f = self.ground.reshape(b_, -1)
        patch_f = self.groundpatch.reshape(b_, -1)
        g_at = torch.gather(ground_f, 1, flat)
        cand = work & (z < g_at - 0.2)
        outlier = torch.zeros_like(cand)
        if bool(cand.any()):
            outlier = self._march(cand, x, y, z, ox, oy, oz, ground_f, patch_f)
        accept = work & ~outlier

        # --- rasterize (GroundSegmentation.cpp:282-309) ---
        wt = self.wt
        n2 = n * n
        seg = (torch.arange(b_, device=dev)[:, None] * n2 + flat)[accept]
        pd = (z - oz)[accept].to(wt)
        cnt = torch.zeros(b_ * n2, dtype=wt, device=dev).index_add_(
            0, seg, torch.ones_like(pd))
        tot = torch.zeros_like(cnt).index_add_(0, seg, pd)
        mean = tot / cnt.clamp(min=1)
        m2 = torch.zeros_like(cnt).index_add_(0, seg, (pd - mean[seg]) ** 2)
        zmin = torch.full((b_ * n2,), torch.finfo(ft).max, dtype=ft, device=dev).scatter_reduce_(
            0, seg, z[accept] - np.float32(0.0001), "amin")
        count = cnt.to(ft).reshape(b_, n, n)
        variance = m2.to(ft).reshape(b_, n, n) / (count + FLT_MIN)
        min_gh = zmin.reshape(b_, n, n)

        self._detect(count, variance, min_gh)
        base_z = torch.as_tensor(mb[:, 2, 3], device=dev).to(ft)
        self._spiral(base_z)

        # --- classify (GroundSegmentation.cpp:146-189) ---
        gh = torch.gather(self.ground.reshape(b_, -1), 1, flat)
        var = torch.gather(variance.reshape(b_, -1), 1, flat)
        dist = torch.hypot((x - ox).to(wt), (y - oy).to(wt)).to(ft)
        h_thr = torch.tensor(np.float32(p["miminum_point_height_threshold"]), dtype=ft,
                             device=dev)
        h_obs = torch.tensor(np.float32(p["minimum_point_height_obstacle_threshold"]),
                             dtype=ft, device=dev)
        fac = torch.tensor(np.float32(float(p["minimum_distance_factor"]) * 5), dtype=ft,
                           device=dev)
        tol = (fac * dist) / var * h_thr
        tol = torch.where(h_thr < tol, h_thr, tol)  # Python's min and max: NaN stays
        tol = torch.where(h_obs > tol, h_obs, tol)
        labels = torch.where(tol + gh < z, LABEL_NONGROUND, LABEL_GROUND)
        if p.get("border_drop", True):
            labels = torch.where((n <= i0 + 3) | (n <= i1 + 3), LABEL_DROPPED, labels)
        labels = torch.where(outlier, LABEL_GROUND, labels)
        labels = torch.where(inmap, labels, LABEL_DROPPED).to(torch.int32)
        return labels, outlier

    # ---------------------------------------------------------------- march
    def _march(self, cand, x, y, z, ox, oy, oz, ground_f, patch_f):
        """The occlusion ray-march (GroundSegmentation.cpp:242-275): whole-
        metre steps from 3 along the ray from the sensor, an outlier at the
        first step whose cell holds a confident terrain above the ray.

        The configuration bounds the march: a point marches where its ray
        points down (``vz < -0.01``), at most ``max_outlier_candidates`` of
        them a scan, and on overflow the shortest rays are shed, ranked by
        the squared length's f32 bits cut to their top 15 of the
        order-preserving 32 (ties: the higher point index first) in a buffer
        of up to 2^17 points, else by the exact squared length (ties: the
        lower index first); steps stop below ``ray_steps``. Candidates march
        in chunks of ``MARCH_CELLS`` lattice points."""
        ft, wt = self.ft, self.wt
        bi, pi = torch.nonzero(cand, as_tuple=True)
        vx, vy, vz = x[bi, pi] - ox[bi, 0], y[bi, pi] - oy[bi, 0], z[bi, pi] - oz[bi, 0]
        length = torch.sqrt(vx.to(wt) ** 2 + vy.to(wt) ** 2 + vz.to(wt) ** 2).to(ft)
        down = vz / length < -0.01
        budget = torch.zeros(cand.shape, dtype=torch.float32, device=cand.device)
        budget[bi, pi] = torch.where(down, length * length, 0.0).float()
        keep = self._cap(budget)
        sel = keep[bi, pi]
        bi, pi, vx, vy, vz, length = bi[sel], pi[sel], vx[sel], vy[sel], vz[sel], length[sel]
        out = torch.zeros_like(cand)
        chunk = max(1, self.MARCH_CELLS // int(self.p["ray_steps"]))
        for k in range(0, bi.numel(), chunk):
            c = slice(k, k + chunk)
            out[bi[c], pi[c]] = self._march_rays(bi[c], vx[c], vy[c], vz[c], length[c],
                                                 ox[bi[c], 0], oy[bi[c], 0], oz[bi[c], 0],
                                                 ground_f, patch_f)
        return out

    def _cap(self, budget):
        """(B, P) bool: the points that march, of (B, P) f32 budgets (the
        squared ray length of a downward candidate, 0 elsewhere)."""
        cap = int(self.p["max_outlier_candidates"])
        marchable = budget > 0
        p = budget.shape[1]
        if cap >= p or int(marchable.sum(1).max()) <= cap:
            return marchable
        idx = torch.arange(p, device=budget.device)
        bits = budget.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        if p <= 1 << 17:
            key = ((bits | 0x80000000) & ~((1 << 17) - 1)) | idx
        else:
            key = (bits << 32) | (0xFFFFFFFF - idx)
        kth = torch.topk(key, cap, dim=1).values[:, -1:]
        over = marchable.sum(1, keepdim=True) > cap
        return torch.where(over, key >= kth, marchable)

    MARCH_CELLS = 1 << 24

    def _march_rays(self, bi, vx, vy, vz, length, ox, oy, oz, ground_f, patch_f):
        n, dev, ft, wt = self.g.n, self.device, self.ft, self.wt
        vx, vy, vz = vx / length, vy / length, vz / length
        top = min(int(math.ceil(float(length.max()))) + 1, int(self.p["ray_steps"]))
        s = torch.arange(3, max(top, 4), device=dev)[None, :]
        live = (s * s).to(wt) < (length * length).to(wt)[:, None]
        sf = s.to(ft)
        qx = ox[:, None] + sf * vx[:, None]
        qy = oy[:, None] + sf * vy[:, None]
        c = torch.as_tensor(self.center + self.g.half, device=dev, dtype=wt)
        j0 = torch.floor((c[bi, :1] - qx.to(wt)) / self.g.resolution).long()
        j1 = torch.floor((c[bi, 1:] - qy.to(wt)) / self.g.resolution).long()
        inside = (j0 > 0) & (j1 > 0) & (j0 < n - 1) & (j1 < n - 1)
        j0c, j1c = j0.clamp(1, n - 2), j1.clamp(1, n - 2)
        r0, c0 = (j0c - 1).clamp(min=2), (j1c - 1).clamp(min=2)
        base = bi[:, None] * (n * n)
        flat_patch = patch_f.reshape(-1)
        block = torch.zeros_like(qx)
        for dr in range(3):
            for dc in range(3):
                block = block + flat_patch[base + (r0 + dr) * n + (c0 + dc)]
        at = base + j0c * n + j1c
        conf = flat_patch[at]
        hgt = ground_f.reshape(-1)[at]
        tol = torch.tensor(np.float32(self.p["outlier_tolerance"]), dtype=ft, device=dev)
        min_conf = torch.tensor(np.float32(self.p["min_outlier_detection_ground_confidence"]),
                                dtype=ft, device=dev)
        hit = (block > min_conf) & (conf > 0.01) & (hgt >= (sf * vz[:, None] + oz[:, None]) + tol)
        return (live & inside & hit).any(1)

    # --------------------------------------------------------------- detect
    def _detect(self, points, variance, min_gh):
        """Ground patch detection (GroundSegmentation.cpp:314-395) on every
        cell of rows and columns 2 .. N-3 at once."""
        p, g, n, ft, dev = self.p, self.g, self.g.n, self.ft, self.device
        wt = self.wt
        idx = torch.arange(n, device=dev, dtype=wt)
        sqdist = ((idx[:, None] - n / 2.0) ** 2 + (idx[None, :] - n / 2.0) ** 2) \
            * g.resolution * g.resolution
        small = sqdist <= float(p["patch_size_change_distance"]) ** 2
        df2 = float(p["distance_factor"]) ** 2
        mdf2 = float(p["minimum_distance_factor"]) ** 2
        mdf10_2 = (float(p["minimum_distance_factor"]) * 10) ** 2
        var_thr_sq = torch.clamp(torch.clamp(sqdist * df2, min=mdf2), max=mdf10_2).to(ft)
        thr = float(p["ground_patch_detection_minimum_point_count_threshold"])
        ocpcf = float(p["occupied_cells_point_count_factor"])
        pccvt = float(p["point_count_cell_variance_threshold"])
        out_tol = float(p["outlier_tolerance"])

        def windows(a, fill):
            pad = torch.nn.functional.pad(a, (2, 2, 2, 2), value=fill)
            return pad.unfold(1, 5, 1).unfold(2, 5, 1)  # (B, N, N, 5, 5)

        pw, vw = windows(points, 0.0), windows(variance, 0.0)
        mw = windows(min_gh, torch.finfo(ft).max)
        inner = (slice(None),) * 3 + (slice(1, 4), slice(1, 4))

        def both(fn):
            return torch.where(small, fn(*(w[inner] for w in (pw, vw, mw))), fn(pw, vw, mw))

        psum = both(lambda a, b, c: a.sum((-2, -1)))
        pvsum = both(lambda a, b, c: (a * b).sum((-2, -1)))
        pmsum = both(lambda a, b, c: (a * c).sum((-2, -1)))
        localmin = both(lambda a, b, c: c.amin((-2, -1)))
        S = torch.where(small, 3.0, 5.0)
        expected = self.expected
        floor_thr = torch.floor(torch.where(small, expected * (thr * 3), expected * (thr * 5)))
        skip = psum < torch.clamp(floor_thr, min=3.0)
        max_var = torch.where(points >= pccvt, variance, pvsum / psum)
        groundlevel = pmsum / psum
        old_h, old_c = self.ground, self.groundpatch
        gd = (groundlevel - old_h) * (2.0 * old_c)
        gd = torch.where(1.0 > gd, torch.ones_like(gd), gd)
        keep_high = (old_c > 0.5) & (groundlevel >= old_h + out_tol)
        flat_ok = (var_thr_sq > max_var * max_var) & (max_var > 0) \
            & (psum > ((gd * expected) * S.to(ft)) * thr)
        new_c = psum / ocpcf
        new_c = torch.where(1.0 < new_c, torch.ones_like(new_c), new_c)
        g_patch = (groundlevel * new_c + (old_c * old_h) * 2) / (new_c + old_c * 2)
        c_patch = (psum / (ocpcf * 2.0) + old_c) / 2.0
        c_patch = torch.where(1.0 < c_patch, torch.ones_like(c_patch), c_patch)
        c_min = old_c + 0.1
        c_min = torch.where(0.5 < c_min, torch.full_like(c_min, 0.5), c_min)
        lower = localmin < old_h
        rows = torch.zeros(n, dtype=torch.bool, device=dev)
        rows[2:n - 2] = True
        live = rows[:, None] & rows[None, :] & ~skip & ~keep_high
        ground = torch.where(live & flat_ok, g_patch,
                             torch.where(live & lower, localmin, old_h))
        patch = torch.where(live & flat_ok, c_patch, torch.where(live & lower, c_min, old_c))
        self.ground, self.groundpatch = ground.contiguous(), patch.contiguous()

    # --------------------------------------------------------------- spiral
    def plans(self) -> list:
        if self._plans is None:
            scratch = np.zeros((2, self.g.n * self.g.n), np.int64)
            self._plans = [RingPlan(self.g, d, scratch).to(self.device)
                           for d in range(1, self.g.m)]
        return self._plans

    def _decay(self, c, where):
        """Confidence after a visit: ``max(c - c / factor, 0.001)`` where the
        cell lies beyond ``min_dist_squared`` from the center (:459-463)."""
        f = float(self.p["occupied_cells_decrease_factor"])
        return torch.where(where, torch.clamp_min(c - c / f, 0.001), c)

    def _spiral(self, base_z):
        """Spiral interpolation (GroundSegmentation.cpp:398-465): the center
        seeded with the base height at confidence 1, then rings 1 .. m-1. On
        a card the sweep's ops (tens a ring) are captured once as a CUDA
        graph and replayed, which keeps the check's replay of a drive short."""
        n, b_ = self.g.n, self.batch
        H = self.ground.reshape(b_, -1).clone()
        C = self.groundpatch.reshape(b_, -1).clone()
        if self.device.type != "cuda":
            self._sweep(H, C, base_z)
        else:
            if self._graph is None:
                self._static = (H.clone(), C.clone(), base_z.clone())
                self._sweep(*self._static)  # the eager warm-up builds the plans
                torch.cuda.synchronize(self.device)
                graph = torch.cuda.CUDAGraph()
                # captured on a stream of this grid's own card (the default
                # capture stream is made once, on whichever card came first)
                with torch.cuda.graph(graph, stream=torch.cuda.Stream(self.device)):
                    self._sweep(*self._static)
                self._graph = graph
            sh, sc, sb = self._static
            sh.copy_(H)
            sc.copy_(C)
            sb.copy_(base_z)
            self._graph.replay()
            H, C = sh.clone(), sc.clone()
        self.ground = H.reshape(b_, n, n)
        self.groundpatch = C.reshape(b_, n, n)

    def _sweep(self, H, C, base_z):
        m, n = self.g.m, self.g.n
        H[:, m * n + m] = base_z
        C[:, m * n + m] = 1.0
        for plan in self.plans():
            self._ring(H, C, plan)

    def _ring(self, H, C, plan):
        """One ring's visits, every side-walk at once: a visit's height is
        ``a + b h(predecessor)``, ``b`` from confidences alone (known before
        the ring: a confidence decays at each visit, whatever the heights),
        ``a`` from the block's other cells as they stand at the visit."""
        wt, ft = self.wt, self.ft
        b_ = H.shape[0]
        w = plan["width"]
        read = plan["read"]  # (V, 9)
        c_pre = C[:, read]  # (B, V, 9), before the ring
        once = self._decay(c_pre, plan["read_decays"])
        twice = self._decay(once, plan["read_decays"])
        cw = torch.where(plan["seen0"], c_pre, torch.where(plan["seen1"], once, twice)).to(wt)
        occ = cw[..., 4]
        alpha = torch.where(plan["real"], (1.0 - occ) / (cw.sum(-1) + FLT_MIN), 0.0)
        b = alpha * (cw * plan["pred"]).sum(-1)  # (B, V)
        # per side-walk: E[k, j] = b[j+1] ... b[k] below the diagonal, 1 on it
        bw = b.reshape(b_, 4, w, 1)
        E = torch.tril(torch.cumprod(torch.where(plan["below"], bw, 1.0), dim=-2))
        own = torch.where(plan["real"], occ, 0.0)
        cwn = cw * plan["not_pred"]
        hr = H[:, read].to(wt)
        h_pre, writer, cross = hr, plan["writer"], plan["cross"]
        for i in range(RingPlan.ITERATIONS if plan["has_cross"] else 1):
            if i:
                hr = torch.where(cross, h[:, writer], h_pre)
            a = alpha * (cwn * hr).sum(-1) + own * hr[..., 4]
            h = (E @ a.reshape(b_, 4, w, 1)).reshape(b_, -1)
        cells = plan["final_cells"]
        c_pre = C[:, cells]
        c1 = self._decay(c_pre, plan["final_decays"])
        H[:, cells] = h[:, plan["final_visit"]].to(ft)
        C[:, cells] = torch.where(plan["final_twice"], self._decay(c1, plan["final_decays"]), c1)
