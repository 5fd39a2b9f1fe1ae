"""The per-scan segmentation step, in PyTorch.

The torch counterpart of ``groundgrid_tpu/pipeline.py`` for its flagship
sorted-scan path: the host transforms each scan to the map frame and sorts
it by flat cell id against the host-tracked grid center
(:func:`prepare_scan`); the device step then runs, in the reference's stage
order (``GroundSegmentation.cpp:50-197``, ``GroundGrid.cpp:83-147``):

    move -> bin -> K2 (old ground) -> march -> K1 raster -> detect
         -> K3 spiral -> K2 (ground, variance) -> classify

PyTorch idiom: plain functions on tensors, eager. Entry points that
allocate take an explicit ``device``. The step updates the ``GridState`` it
is given in place and returns it (the JAX step donated the state's buffers,
``pipeline.py:325`` of the JAX package); the spiral kernel writes into the
detect stage's fresh layers. Per scan the step reads the device twice: the
sortedness check and the march's candidate count.

Kernels: with ``config.use_pallas`` None or True, K1/K2/K3 go through their
wrappers (``groundgrid_torch/ops``), which launch the CUDA kernels for CUDA
tensors and take the plain versions for CPU tensors; False takes the plain
versions on every device.

Configurations outside this slice raise ``NotImplementedError``: unsorted
scans, the wire format, aux layers and the fused detect stencil (see
ROADMAP.md).
"""

from __future__ import annotations

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
from groundgrid_torch.ops import lookup as lookuplib
from groundgrid_torch.ops import raster as rasterops
from groundgrid_torch.ops import spiral as spiralops


class Scan(NamedTuple):
    """One host-prepared, cell-sorted scan.

    px/py/pz: (P,) f32 map-frame coordinates on the step's device.
    rings:    (P,) i32 ring channel (the SemanticKITTI label rides here).
    valid:    (P,) i32 padding mask (1 = real point).
    t_map_velo, t_map_base, t_base_map: (4, 4) f32 NumPy poses (host).
    center, center_lo: (2,) f32 NumPy ds image of the host-tracked f64 grid
        center the points were sorted against.
    """

    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    rings: torch.Tensor
    valid: torch.Tensor
    t_map_velo: np.ndarray
    t_map_base: np.ndarray
    t_base_map: np.ndarray
    center: np.ndarray
    center_lo: np.ndarray


class StepOutput(NamedTuple):
    """Per-scan results, (P,) in the scan's (sorted) point order.

    labels: int32 49 ground / 99 non-ground / 0 dropped; outlier: int32 0/1;
    x/y/z: f32 map-frame coordinates.
    """

    labels: torch.Tensor
    outlier: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def _validate(config: GroundGridConfig, with_aux: bool) -> None:
    config.validate()
    todo = [name for name, on in (
        ("sorted_scans=False", not config.sorted_scans),
        ("wire_format", config.wire_format),
        ("fused_detect", config.fused_detect),
        ("with_aux", with_aux),
    ) if on]
    if todo:
        raise NotImplementedError(
            f"groundgrid_torch runs the sorted-scan main path only; not ported yet: "
            f"{', '.join(todo)} (see ROADMAP.md, Queue 1)"
        )
    if config.max_points > 1 << outlierlib.IDX_BITS:
        raise NotImplementedError(
            f"max_points > {1 << outlierlib.IDX_BITS} (the outlier selection key's index "
            "bits) is not ported yet (see ROADMAP.md)"
        )
    need = int(math.ceil(config.half_length * math.sqrt(2.0))) + 8
    if config.ray_steps < need:
        raise ValueError(
            f"config.ray_steps={config.ray_steps} too small for a "
            f"{config.dimension}m grid; need >= {need}"
        )


class Step:
    """``step(state, scan) -> (state, StepOutput)`` for one config.

    ``fallbacks`` counts scans whose device cell ids were not sorted (a
    host/device binning divergence); those are sorted on the device, by a
    stable sort of the ids, before K1.
    """

    def __init__(self, config: GroundGridConfig):
        self.config = config
        self.fallbacks = 0
        self._tables: dict[torch.device, detectlib.DetectTables] = {}
        if config.use_pallas is False:
            self._reduce = rasterops.raster_reduce_plain
            self._lookup = lookuplib.lookup_plain
            self._spiral = spiralops.spiral_interpolation_plain
        else:
            self._reduce = rasterops.raster_reduce
            self._lookup = lookuplib.lookup
            self._spiral = spiralops.spiral_interpolation

    def tables(self, device) -> detectlib.DetectTables:
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = detectlib.make_tables(self.config, device)
        return self._tables[device]

    def __call__(self, state: GridState, scan: Scan):
        cfg = self.config
        n2 = cfg.cell_count ** 2
        x, y, z = scan.px, scan.py, scan.pz
        origin = np.asarray(scan.t_map_velo, np.float32)[:3, 3]

        # --- grid relocation (GroundGrid.cpp:83-147) ---
        moved = gridlib.move(cfg, state, scan.t_base_map, scan.center, scan.center_lo)
        center, center_lo = moved.center_np, moved.center_lo_np

        # --- f64-faithful binning ---
        binning = rasterlib.bin_points(cfg, center, center_lo, x, y, scan.rings,
                                       scan.valid > 0, origin)

        # --- outlier ray-march against the previous terrain (cpp:242-275) ---
        (old_h,) = self._lookup(binning.cell, [moved.ground], n2)
        outlier = outlierlib.detect_outliers(
            cfg, center, center_lo, moved.ground, moved.groundpatch, binning, x, y, z,
            origin, old_h, self._lookup,
        )

        # --- rasterize (cpp:200-311) ---
        accept = binning.inmap & ~binning.ignored & ~outlier
        rb, rz, racc = binning, z, accept
        cell = binning.cell
        if cell.shape[0] > 1 and not bool((cell[1:] >= cell[:-1]).all()):
            self.fallbacks += 1
            order = torch.argsort(cell, stable=True)
            rb, rz, racc = binning.permute(order), z[order], accept[order]
        raster = rasterlib.rasterize_sorted(cfg, rb, rz, origin, racc, center,
                                            scan.t_base_map, self._reduce)

        # --- ground patch detection (cpp:314-395) ---
        ground, groundpatch = detectlib.detect_ground_patches(
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
        return state, StepOutput(labels=labels, outlier=outlier.to(torch.int32), x=x, y=y, z=z)


def make_step_fn(config: GroundGridConfig, with_aux: bool = False) -> Step:
    """Build the per-scan step for ``config`` (raises for unported modes)."""
    _validate(config, with_aux)
    return Step(config)


def make_step(config: GroundGridConfig, with_aux: bool = False) -> Step:
    """The per-scan step; PyTorch runs eagerly, so this is :func:`make_step_fn`."""
    return make_step_fn(config, with_aux)


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
    host = torch.from_numpy(buf)
    device = torch.device(device)
    if device.type == "cuda":
        dev = host.pin_memory().to(device, non_blocking=True)
    else:
        dev = host.to(device)
    scan = Scan(
        px=dev[0], py=dev[1], pz=dev[2],
        rings=dev[3].view(torch.int32), valid=dev[4].view(torch.int32),
        t_map_velo=t_map_velo.astype(np.float32),
        t_map_base=np.asarray(t_map_base, np.float32),
        t_base_map=np.asarray(t_base_map, np.float32),
        center=np.asarray(ch, np.float32), center_lo=np.asarray(cl, np.float32),
    )
    return scan, order
