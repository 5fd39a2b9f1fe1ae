"""The per-scan segmentation step, in PyTorch.

The torch counterpart of ``groundgrid_tpu/pipeline.py``. In sorted-scan mode
(``config.sorted_scans``, the flagship path) the host transforms each scan to
the map frame and sorts it by flat cell id against the host-tracked grid
center (:func:`prepare_scan`); the device step then runs, in the reference's
stage order (``GroundSegmentation.cpp:50-197``, ``GroundGrid.cpp:83-147``):

    move -> bin -> K2 (old ground) -> march -> K1 raster -> detect
         -> K3 spiral -> K2 (ground, variance) -> classify

Unsorted mode (``sorted_scans=False``, the config default) takes raw
sensor-frame scans (:func:`pad_scan`): the step transforms them on the
device, bins against the shipped center (or, without one, the device center
recurrence ``grid.index_shift_ds``), and orders the raster's inputs by a
stable device sort of the cell ids before K1. Where the JAX package's
unsorted step scatters (``rasterize``), the port sorts: no float atomics,
so it stays deterministic. Per-point outputs come back in the scan's own
order.

PyTorch idiom: plain functions on tensors, eager. Entry points that
allocate take an explicit ``device``. The step updates the ``GridState`` it
is given in place and returns it (the JAX step donated the state's buffers,
``pipeline.py:325`` of the JAX package); the spiral kernel writes into the
detect stage's fresh layers. Per scan the step reads the device twice in
sorted mode (the sortedness check and the march's candidate count) and once
in unsorted mode (the count).

Kernels: with ``config.use_pallas`` None or True, K1-K4 go through their
wrappers (``groundgrid_torch/ops``), which launch the CUDA kernels for CUDA
tensors and take the plain versions for CPU tensors; False takes the plain
versions on every device. ``config.fused_detect`` runs detection through
K4 instead of ``core/detect.py``.

Options, as in the JAX package: ``with_aux`` also returns all eleven
published grid layers (:class:`AuxLayers`; the non-ground count is a second
K1 launch), and ``config.wire_format`` takes the 8-byte-per-point s16
:class:`WireScan` (:func:`prepare_scan_wire`), dequantized on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import classify as classifylib
from groundgrid_torch.core import detect as detectlib
from groundgrid_torch.core import exactf32
from groundgrid_torch.core import grid as gridlib
from groundgrid_torch.core import outliers as outlierlib
from groundgrid_torch.core import rasterize as rasterlib
from groundgrid_torch.core import transforms as tf
from groundgrid_torch.core.grid import GridState
from groundgrid_torch.ops import detect as detectops
from groundgrid_torch.ops import lookup as lookuplib
from groundgrid_torch.ops import raster as rasterops
from groundgrid_torch.ops import spiral as spiralops


class Scan(NamedTuple):
    """One padded scan on the step's device.

    px/py/pz: (P,) f32 coordinates: map frame and cell-sorted in sorted-scan
        mode (:func:`prepare_scan`), sensor frame in unsorted mode
        (:func:`pad_scan`).
    rings:    (P,) i32 ring channel (the SemanticKITTI label rides here).
    valid:    (P,) i32 padding mask (1 = real point).
    t_map_velo, t_map_base, t_base_map: (4, 4) f32 NumPy poses (host).
    center, center_lo: (2,) f32 NumPy ds image of the host-tracked f64 grid
        center the points are binned against; sorted mode requires it. None
        (unsorted mode only) derives it on the device
        (``grid.index_shift_ds``).
    """

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    rings: torch.Tensor
    valid: torch.Tensor
    t_map_velo: np.ndarray
    t_map_base: np.ndarray
    t_base_map: np.ndarray
    center: np.ndarray | None = None
    center_lo: np.ndarray | None = None


class StepOutput(NamedTuple):
    """Per-scan results, (P,) in the scan's own point order.

    labels: int32 49 ground / 99 non-ground / 0 dropped; outlier: int32 0/1;
    x/y/z: f32 map-frame coordinates.
    """

    labels: torch.Tensor
    outlier: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class AuxLayers(NamedTuple):
    """All published grid layers, (N, N) f32 (reference layer set, SURVEY.md 2.3)."""

    points: torch.Tensor  # non-ground count after classification
    points_raw: torch.Tensor
    ground: torch.Tensor
    groundpatch: torch.Tensor
    ground_candidates: torch.Tensor
    plane_dist: torch.Tensor
    mean_variance: torch.Tensor
    m2: torch.Tensor
    min_ground_height: torch.Tensor
    max_ground_height: torch.Tensor
    variance: torch.Tensor


def _validate(config: GroundGridConfig) -> None:
    config.validate()
    need = int(math.ceil(config.half_length * math.sqrt(2.0))) + 8
    if config.ray_steps < need:
        raise ValueError(
            f"config.ray_steps={config.ray_steps} too small for a "
            f"{config.dimension}m grid; need >= {need}"
        )


class Step:
    """``step(state, scan) -> (state, StepOutput[, AuxLayers])`` for one config.

    ``scan`` is a :class:`Scan`, or a :class:`WireScan` under
    ``config.wire_format``. In sorted mode ``fallbacks`` counts scans whose
    device cell ids were not sorted (a host/device binning divergence);
    those are sorted on the device, by a stable sort of the ids, before K1.
    With ``config.sorted_fallback_check`` false the step trusts the host's
    order, as the JAX step does: no sortedness read, no fallback. Unsorted
    mode takes that stable sort on every scan, and counts no fallback.
    ``marchable`` is the last scan's count of marchable outlier candidates,
    before the ``max_outlier_candidates`` cap.
    """

    def __init__(self, config: GroundGridConfig, with_aux: bool = False):
        self.config = config
        self.with_aux = with_aux
        self.fallbacks = 0
        self.marchable = 0
        self._tables: dict[torch.device, detectlib.DetectTables] = {}
        if config.use_pallas is False:
            self._reduce = rasterops.raster_reduce_plain
            self._lookup = lookuplib.lookup_plain
            self._spiral = spiralops.spiral_interpolation_plain
            fused = detectops.detect_fused_plain
        else:
            self._reduce = rasterops.raster_reduce
            self._lookup = lookuplib.lookup
            self._spiral = spiralops.spiral_interpolation
            fused = detectops.detect_fused
        self._detect = fused if config.fused_detect else detectlib.detect_ground_patches

    def tables(self, device) -> detectlib.DetectTables:
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = detectlib.make_tables(self.config, device)
        return self._tables[device]

    def __call__(self, state: GridState, scan):
        cfg = self.config
        n2 = cfg.cell_count ** 2
        if cfg.wire_format:
            scan = dequantize_scan(cfg, scan)
        if cfg.sorted_scans:
            if scan.center is None:
                raise ValueError("a sorted scan carries the center it was sorted against")
            x, y, z = scan.px, scan.py, scan.pz
        else:
            # --- transform to the map frame (GroundGridNodelet.cpp:139-184) ---
            x, y, z = tf.transform_points_soa(scan.t_map_velo, scan.px, scan.py, scan.pz)
        origin = np.asarray(scan.t_map_velo, np.float32)[:3, 3]

        # --- grid relocation (GroundGrid.cpp:83-147) ---
        moved = gridlib.move(cfg, state, scan.t_base_map, scan.center, scan.center_lo,
                             new_position=origin[:2])
        center, center_lo = moved.center_np, moved.center_lo_np

        # --- f64-faithful binning ---
        binning = rasterlib.bin_points(cfg, center, center_lo, x, y, scan.rings,
                                       scan.valid > 0, origin)

        # --- outlier ray-march against the previous terrain (cpp:242-275) ---
        (old_h,) = self._lookup(binning.cell, [moved.ground], n2)
        outlier, self.marchable = outlierlib.detect_outliers(
            cfg, center, center_lo, moved.ground, moved.groundpatch, binning, x, y, z,
            origin, old_h, self._lookup,
        )

        # --- rasterize (cpp:200-311) ---
        accept = binning.inmap & ~binning.ignored & ~outlier
        rb, rz, racc = binning, z, accept
        cell = binning.cell
        order = None
        if not cfg.sorted_scans:
            order = torch.argsort(cell, stable=True)
        elif (cfg.sorted_fallback_check and cell.shape[0] > 1
                and not bool((cell[1:] >= cell[:-1]).all())):
            self.fallbacks += 1
            order = torch.argsort(cell, stable=True)
        if order is not None:
            rb, rz, racc = binning.permute(order), z[order], accept[order]
        raster = rasterlib.rasterize_sorted(cfg, rb, rz, origin, racc, center,
                                            scan.t_base_map, self._reduce,
                                            with_max=self.with_aux)

        # --- ground patch detection (cpp:314-395) ---
        ground, groundpatch = self._detect(
            cfg, self.tables(z.device), raster.points, raster.variance,
            raster.min_ground_height, moved.ground, moved.groundpatch,
        )

        # --- spiral interpolation (cpp:398-465) ---
        base_z = float(np.asarray(scan.t_map_base, np.float32)[2, 3])
        ground, groundpatch = self._spiral(cfg, ground, groundpatch, base_z)

        # --- classification (cpp:146-189) ---
        gh, var = self._lookup(binning.cell, [ground, raster.variance], n2)
        labels = classifylib.classify(cfg, binning, z, outlier, gh, var)

        state.ground, state.groundpatch = ground, groundpatch
        state.center, state.center_lo = moved.center, moved.center_lo
        out = StepOutput(labels=labels, outlier=outlier.to(torch.int32), x=x, y=y, z=z)
        if not self.with_aux:
            return state, out

        # non-ground count per cell (cpp:176): a K1 sum over the raster's
        # (sorted) cells, the JAX step's count kernel
        ng = (labels == classifylib.LABEL_NONGROUND).to(torch.float32)
        (counts,) = self._reduce(rb.cell, [ng if order is None else ng[order]], ["sum"], n2)
        aux = AuxLayers(
            points=counts.reshape(ground.shape), points_raw=raster.points_raw,
            ground=ground, groundpatch=groundpatch,
            ground_candidates=raster.ground_candidates, plane_dist=raster.plane_dist,
            mean_variance=raster.mean_variance, m2=raster.m2,
            min_ground_height=raster.min_ground_height,
            max_ground_height=raster.max_ground_height, variance=raster.variance,
        )
        return state, out, aux


def make_step_fn(config: GroundGridConfig, with_aux: bool = False) -> Step:
    """Build the per-scan step for ``config`` (raises for invalid configs)."""
    _validate(config)
    return Step(config, with_aux)


def make_step(config: GroundGridConfig, with_aux: bool = False) -> Step:
    """The per-scan step; PyTorch runs eagerly, so this is :func:`make_step_fn`.

    With ``config.wire_format`` the step takes a :class:`WireScan`.
    """
    return make_step_fn(config, with_aux)


def make_wire_step(config: GroundGridConfig, with_aux: bool = False) -> Step:
    """The per-scan step consuming :class:`WireScan` (sorted-scan mode);
    ``make_step`` with ``config.wire_format=True``."""
    if not config.sorted_scans:
        raise ValueError("the wire format requires config.sorted_scans")
    return make_step(dataclasses.replace(config, wire_format=True), with_aux)


def init_state(config: GroundGridConfig, t_map_velo, device) -> GridState:
    """First-odometry grid creation (GroundGrid::initGroundGrid).

    ground := odom z, groundpatch := 1e-7, centered on the sensor xy; the
    f64 pose seeds the ds center exactly (grid_map stores doubles).
    """
    t64 = np.asarray(t_map_velo, np.float64)
    return gridlib.create(config, t64[:2, 3], np.float32(t64[2, 3]), device)


class CenterTracker:
    """Host-side replica of the grid-center recurrence, in float64.

    The host must know the grid center before dispatch (to bin and sort the
    points by the ids the device will compute). The recurrence is grid_map's
    double math: half-away-from-zero whole-cell snap of the f64 position
    delta, then ``center += k * resolution`` in f64.
    """

    def __init__(self, config: GroundGridConfig, center_xy):
        self._res = np.float64(config.resolution)
        self.center64 = np.asarray(center_xy, np.float64).copy()

    @property
    def center(self) -> np.ndarray:
        return self.center64.astype(np.float32)

    def center_ds(self):
        """(hi, lo) f32 ds image of the f64 center."""
        return exactf32.f64_to_ds(self.center64)

    def update(self, position_xy) -> np.ndarray:
        """Advance to the cell-snapped ``position_xy``; returns the f64 center."""
        dc = (np.asarray(position_xy, np.float64) - self.center64) / self._res
        k = gridlib._snap_cells(dc)
        self.center64 = self.center64 + k * self._res
        return self.center64


def pad_scan(config: GroundGridConfig, points, rings, t_map_velo, device, t_map_base=None,
             t_base_map=None) -> Scan:
    """Host helper for unsorted mode: pad a raw sensor-frame scan to
    ``max_points`` and ship it to ``device`` in one copy.

    Points beyond ``max_points`` are dropped (the driver labels them 0). The
    scan carries no center: the step derives it with the device recurrence
    unless the caller sets one (``scan._replace(center=..., center_lo=...)``,
    as the driver does with its f64 tracker's).
    """
    p = np.asarray(points, dtype=np.float32)
    r = np.asarray(rings, dtype=np.int32)
    cap = config.max_points
    count = min(p.shape[0], cap)
    t_map_velo = np.asarray(t_map_velo, dtype=np.float64)
    if t_map_base is None or t_base_map is None:
        _, t_map_base, t_base_map = tf.scan_poses(t_map_velo)
    # one (5, P) 32-bit buffer: x, y, z as f32, rings and valid as i32 bits
    buf = np.zeros((5, cap), np.float32)
    buf[:3, :count] = p[:count, :3].T
    buf[3:].view(np.int32)[0, :count] = r[:count]
    buf[3:].view(np.int32)[1, :count] = 1
    dev = _to_device(buf, device)
    return Scan(
        px=dev[0], py=dev[1], pz=dev[2],
        rings=dev[3].view(torch.int32), valid=dev[4].view(torch.int32),
        t_map_velo=t_map_velo.astype(np.float32),
        t_map_base=np.asarray(t_map_base, np.float32),
        t_base_map=np.asarray(t_base_map, np.float32),
    )


def _center_ds(center, center_lo=None):
    """A host center as an f32 (hi, lo) pair: f64 splits exactly; an f32 hi
    takes the given (or a zero) tail."""
    c = np.asarray(center)
    if c.dtype == np.float64 and center_lo is None:
        return exactf32.f64_to_ds(c)
    hi = c.astype(np.float32)
    lo = np.zeros_like(hi) if center_lo is None else np.asarray(center_lo, np.float32)
    return hi, lo


def predict_cells(config: GroundGridConfig, center, x, y, valid, center_lo=None) -> np.ndarray:
    """Host replica of the device binning: (P,) int32 flat cell ids.

    Runs the port's own :func:`rasterize.faithful_cells` on CPU tensors, the
    op sequence the device step runs, so host and device ids agree bitwise.
    """
    ch, cl = _center_ds(center, center_lo)
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    yt = torch.from_numpy(np.ascontiguousarray(y, np.float32))
    gi0, gi1 = rasterlib.faithful_cells(config, ch, cl, xt, yt)
    cell, _ = rasterlib.flat_cells(config, gi0, gi1,
                                   torch.from_numpy(np.asarray(valid).astype(bool)))
    return cell.numpy()


def _to_device(buf: np.ndarray, device) -> torch.Tensor:
    """One host -> device copy of ``buf``, from pinned memory for CUDA."""
    host = torch.from_numpy(buf)
    device = torch.device(device)
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def prepare_scan(config: GroundGridConfig, points, rings, t_map_velo, center, device,
                 t_map_base=None, t_base_map=None):
    """Host-side scan preparation for the sorted-scan step.

    Transforms the sensor-frame points to the map frame (f64, then f32),
    pads to ``max_points``, sorts by the predicted flat cell id (stable)
    against ``center`` (preferably the (2,) f64 tracker value) and ships the
    per-point arrays to ``device`` in ONE copy from pinned memory. Returns
    ``(scan, order)``: ``sorted = arr[order]``.
    """
    p = np.asarray(points, dtype=np.float64)
    r = np.asarray(rings, dtype=np.int32)
    cap = config.max_points
    count = min(p.shape[0], cap)
    t_map_velo = np.asarray(t_map_velo, dtype=np.float64)
    if t_map_base is None or t_base_map is None:
        _, t_map_base, t_base_map = tf.scan_poses(t_map_velo)

    xyz = np.zeros((cap, 3), dtype=np.float32)
    xyz[:count] = tf.transform_points(t_map_velo, p[:count, :3]).astype(np.float32)
    msk = np.zeros((cap,), dtype=np.int32)
    msk[:count] = 1
    rng = np.zeros((cap,), dtype=np.int32)
    rng[:count] = r[:count]

    ch, cl = _center_ds(center)
    cells = predict_cells(config, ch, xyz[:, 0], xyz[:, 1], msk, center_lo=cl)
    order = np.argsort(cells, kind="stable")

    # one (5, P) 32-bit buffer: x, y, z as f32, rings and valid as i32 bits
    buf = np.empty((5, cap), np.float32)
    buf[:3] = xyz[order].T
    buf[3:].view(np.int32)[0] = rng[order]
    buf[3:].view(np.int32)[1] = msk[order]
    dev = _to_device(buf, device)
    scan = Scan(
        px=dev[0], py=dev[1], pz=dev[2],
        rings=dev[3].view(torch.int32), valid=dev[4].view(torch.int32),
        t_map_velo=t_map_velo.astype(np.float32),
        t_map_base=np.asarray(t_map_base, np.float32),
        t_base_map=np.asarray(t_base_map, np.float32),
        center=np.asarray(ch, np.float32), center_lo=np.asarray(cl, np.float32),
    )
    return scan, order


def wire_scales(config: GroundGridConfig) -> tuple[np.float32, np.float32]:
    """Per-axis s16 wire quantization steps ``(s_xy, s_z)``, powers of two.

    A copy of the JAX package's ``wire_scales`` (held to it bitwise by
    ``tests/test_torch_shared.py``). ``s_xy`` is the smallest power-of-two
    step whose +/-32767-step span covers the grid half-span plus a 2 m guard
    (a clamped point is still outside the map); ``s_z`` is one power finer,
    coarsened until the z span reaches +/-16 m (a clamped z would be a wrong
    height inside the map). Default geometry: 2**-9 m xy, 2**-10 m z.
    """
    need = float(config.half_length) + 2.0
    k = 0
    while 32767.0 * 2.0 ** -(k + 1) >= need:
        k += 1
    kz = k + 1
    while 32767.0 * 2.0 ** -kz < 16.0:
        kz -= 1
    return np.float32(2.0 ** -k), np.float32(2.0 ** -kz)


class WireScan(NamedTuple):
    """One scan in the 8-byte-per-point s16 wire format, cell-sorted.

    qx/qy: (P,) int16 on the step's device, ``(x - center) / s_xy``; qz:
    ``(z - sensor z) / s_z``; rings: (P,) int16. ``count`` is the valid
    prefix length (padding sorts behind every real point). The poses and the
    center pair are host NumPy f32, as in :class:`Scan`.
    """

    qx: torch.Tensor
    qy: torch.Tensor
    qz: torch.Tensor
    rings: torch.Tensor
    count: int
    t_map_velo: np.ndarray
    t_map_base: np.ndarray
    t_base_map: np.ndarray
    center: np.ndarray
    center_lo: np.ndarray


def dequantize_scan(config: GroundGridConfig, w: WireScan) -> Scan:
    """WireScan -> Scan on the device: ``q * s + ref`` in f32.

    The steps are powers of two, so ``q * s`` is exact and only the add
    rounds: bitwise the host's dequantized coordinates that the scan was
    sorted by (eager PyTorch keeps the product and the add two ops).
    """
    sxy, sz = wire_scales(config)
    dev = w.qx.device
    x = w.qx.to(torch.float32) * float(sxy) + float(w.center[0])
    y = w.qy.to(torch.float32) * float(sxy) + float(w.center[1])
    z = w.qz.to(torch.float32) * float(sz) + float(np.float32(w.t_map_velo[2, 3]))
    valid = (torch.arange(w.qx.shape[0], dtype=torch.int32, device=dev) < w.count)
    return Scan(px=x, py=y, pz=z, rings=w.rings.to(torch.int32), valid=valid.to(torch.int32),
                t_map_velo=w.t_map_velo, t_map_base=w.t_map_base, t_base_map=w.t_base_map,
                center=w.center, center_lo=w.center_lo)


def prepare_scan_wire(config: GroundGridConfig, points, rings, t_map_velo, center, device,
                      t_map_base=None, t_base_map=None):
    """Host prep for the s16 wire format; returns ``(WireScan, order)``.

    Quantizes the map-frame points against the grid center (x, y) and the
    sensor height (z), bins and stably sorts the *dequantized* f32
    coordinates (what the device will see, so the device-side sortedness
    holds), and ships one (4, P) int16 buffer in one pinned copy. The NumPy
    steps are the JAX package's ``prepare_scan_wire``, bitwise.
    """
    p = np.asarray(points, dtype=np.float64)
    r = np.asarray(rings, dtype=np.int32)
    count = min(p.shape[0], config.max_points)
    cap = config.max_points

    t_map_velo = np.asarray(t_map_velo, dtype=np.float64)
    if t_map_base is None or t_base_map is None:
        _, t_map_base, t_base_map = tf.scan_poses(t_map_velo)
    ch, cl = _center_ds(center)
    origin_z = np.float32(t_map_velo[2, 3].astype(np.float32))

    xyz = np.zeros((cap, 3), dtype=np.float32)
    xyz[:count] = tf.transform_points(t_map_velo, p[:count, :3]).astype(np.float32)
    refs = np.array([ch[0], ch[1], origin_z], np.float32)
    sxy, sz = wire_scales(config)
    scales = np.array([sxy, sxy, sz], np.float32)
    # power-of-two steps: the 1/s multiply is exact; np.rint rounds half to even
    q = np.clip(
        np.rint((xyz - refs[None, :]) * (np.float32(1.0) / scales)[None, :]),
        -32768, 32767,
    ).astype(np.int16)
    q[count:] = 0  # padding quantizes to garbage offsets; zero keeps dequant tame
    dq = q.astype(np.float32) * scales[None, :] + refs[None, :]

    msk = np.zeros((cap,), dtype=np.int32)
    msk[:count] = 1
    cells = predict_cells(config, ch, dq[:, 0], dq[:, 1], msk, center_lo=cl)
    # padding sorts behind every real point: the stable sort keeps real
    # out-of-map points, which share the overflow bin, ahead of it
    order = np.argsort(cells, kind="stable")
    rng = np.zeros((cap,), dtype=np.int16)
    rng[:count] = r[:count].astype(np.int16)

    buf = np.empty((4, cap), np.int16)
    buf[:3] = q[order].T
    buf[3] = rng[order]
    dev = _to_device(buf, device)
    wire = WireScan(
        qx=dev[0], qy=dev[1], qz=dev[2], rings=dev[3], count=int(count),
        t_map_velo=t_map_velo.astype(np.float32),
        t_map_base=np.asarray(t_map_base, np.float32),
        t_base_map=np.asarray(t_base_map, np.float32),
        center=np.asarray(ch, np.float32), center_lo=np.asarray(cl, np.float32),
    )
    return wire, order
