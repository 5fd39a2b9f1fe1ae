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

PyTorch idiom: plain functions on tensors. Entry points that allocate take
an explicit ``device``. The host derives every per-scan value (the poses,
the grid center, the move's shift, a wire scan's count) and ships them in
one small tensor, the scan scalars (``core/scalars.py``); the device body
(:meth:`Step.body`) reads nothing back to the host (the march runs a fixed
candidate buffer, the sortedness check counts on the device) and runs the
same ops for every scan. :func:`make_step` therefore captures it as one
CUDA graph and replays it per scan (:class:`CapturedStep`, the port's
``jax.jit``, ``pipeline.py:325`` of the JAX package), on fixed buffers that
each scan updates in place (the JAX step donated the state's buffers);
:func:`make_step_fn` is the eager step, the reference it is held against.

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

from groundgrid_torch.capture import Graph
from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import classify as classifylib
from groundgrid_torch.core import detect as detectlib
from groundgrid_torch.core import exactf32
from groundgrid_torch.core import grid as gridlib
from groundgrid_torch.core import outliers as outlierlib
from groundgrid_torch.core import rasterize as rasterlib
from groundgrid_torch.core import scalars as scalarlib
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
    """``step(state, scan) -> (state, StepOutput[, AuxLayers])`` for one config,
    run eagerly: the unjitted step of the JAX package
    (``groundgrid_tpu/pipeline.py:126``), and the reference the captured
    step (:class:`CapturedStep`) is held against.

    ``scan`` is a :class:`Scan`, or a :class:`WireScan` under
    ``config.wire_format``. The host derives every per-scan value from the
    state's center and the scan (:meth:`scalars`: the move's shift, the new
    center, the poses, a wire scan's count) and ships them in one pinned
    copy; the device body (:meth:`body`) reads them as the scan scalars
    (``core/scalars.py``). In sorted mode ``fallbacks`` counts scans whose
    device cell ids were not sorted (a host/device binning divergence).
    With the check on, every scan's raster inputs take a stable sort of the
    ids before K1; of sorted ids it is the identity, so a sorted scan reaches
    K1 bitwise as it came, and no host read picks between the two (the JAX
    step's ``lax.cond``, ``pipeline.py:204-214`` there). With
    ``config.sorted_fallback_check`` false the step trusts the host's order,
    as the JAX step does: no check, no fallback, no sort. Unsorted mode
    takes that stable sort on every scan, and counts no fallback. ``marchable``
    is the last scan's count of marchable outlier candidates, before the
    ``max_outlier_candidates`` cap. Both counts stay on the device until
    read: reading one waits for the step.
    """

    def __init__(self, config: GroundGridConfig, with_aux: bool = False):
        self.config = config
        self.with_aux = with_aux
        self._fallbacks: dict[torch.device, torch.Tensor] = {}  # a counter per device
        self._marchable: torch.Tensor | None = None
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

    @property
    def fallbacks(self) -> int:
        return sum(int(count) for count in self._fallbacks.values())

    @property
    def marchable(self) -> int:
        return 0 if self._marchable is None else int(self._marchable)

    def tables(self, device) -> detectlib.DetectTables:
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = detectlib.make_tables(self.config, device)
        return self._tables[device]

    def install(self, state: GridState) -> GridState:
        """The state to step from: the eager step steps any state as it is."""
        return state

    def scalars(self, center, center_lo, scan):
        """Host: the scan scalars and new center of ``scan`` (:func:`scan_scalars`)."""
        return scan_scalars(self.config, center, center_lo, scan)

    def __call__(self, state: GridState, scan):
        packed, center, center_lo = self.scalars(state.center_np, state.center_lo_np, scan)
        return self.run(state, scan, to_device(packed, state.ground.device), center, center_lo)

    def run(self, state: GridState, scan, scalars: torch.Tensor, center, center_lo):
        """Step ``state`` in place with the shipped scan scalars (a tensor on
        the state's device) and the host center they were made with."""
        ground, groundpatch, out, aux = self.body(state.ground, state.groundpatch,
                                                  scan_tensors(scan), scalars)
        state.ground, state.groundpatch = ground, groundpatch
        state.center, state.center_lo = gridlib.host_pair(center), gridlib.host_pair(center_lo)
        return (state, out) if aux is None else (state, out, aux)

    def body(self, ground, groundpatch, points, scalars):
        """The device step: ``(ground, groundpatch, StepOutput, AuxLayers or
        None)`` from the layers, the scan's point tensors
        (:func:`scan_tensors`) and the scan scalars, all on one device. Its
        ops depend on the config and shapes alone and it reads nothing back,
        so one capture serves every scan. The inputs are not modified."""
        cfg = self.config
        n2 = cfg.cell_count ** 2
        s = scalarlib.view(scalars)
        if cfg.wire_format:
            x, y, z, rings, valid = dequantize(cfg, *points, s)
        else:
            x, y, z, rings, valid = points
            if not cfg.sorted_scans:
                # --- transform to the map frame (GroundGridNodelet.cpp:139-184) ---
                x, y, z = tf.transform_points_soa(s.velo, x, y, z)

        # --- grid relocation (GroundGrid.cpp:83-147) ---
        moved_g, moved_c = gridlib.move(cfg, ground, groundpatch, s)

        # --- f64-faithful binning ---
        binning = rasterlib.bin_points(cfg, s, x, y, rings, valid > 0)

        # --- outlier ray-march against the previous terrain (cpp:242-275) ---
        (old_h,) = self._lookup(binning.cell, [moved_g], n2)
        outlier, self._marchable = outlierlib.detect_outliers(
            cfg, s, moved_g, moved_c, binning, x, y, z, old_h, self._lookup,
        )

        # --- rasterize (cpp:200-311) ---
        accept = binning.inmap & ~binning.ignored & ~outlier
        rb, rz, racc = binning, z, accept
        cell = binning.cell
        order = None
        if not cfg.sorted_scans or cfg.sorted_fallback_check:
            order = torch.argsort(cell, stable=True)
        if cfg.sorted_scans and cfg.sorted_fallback_check:
            if cell.device not in self._fallbacks:
                self._fallbacks[cell.device] = torch.zeros((), dtype=torch.int64,
                                                           device=cell.device)
            self._fallbacks[cell.device] += (cell[1:] < cell[:-1]).any()
        if order is not None:
            rb, rz, racc = binning.permute(order), z[order], accept[order]
        raster = rasterlib.rasterize_sorted(cfg, rb, rz, racc, s, self._reduce,
                                            with_max=self.with_aux)

        # --- ground patch detection (cpp:314-395) ---
        ground, groundpatch = self._detect(
            cfg, self.tables(z.device), raster.points, raster.variance,
            raster.min_ground_height, moved_g, moved_c,
        )

        # --- spiral interpolation (cpp:398-465) ---
        ground, groundpatch = self._spiral(cfg, ground, groundpatch, s.base_z)

        # --- classification (cpp:146-189) ---
        gh, var = self._lookup(binning.cell, [ground, raster.variance], n2)
        labels = classifylib.classify(cfg, binning, z, outlier, gh, var)

        out = StepOutput(labels=labels, outlier=outlier.to(torch.int32), x=x, y=y, z=z)
        if not self.with_aux:
            return ground, groundpatch, out, None

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
        return ground, groundpatch, out, aux


def scan_scalars(config: GroundGridConfig, center, center_lo, scan):
    """Host: ``(packed, new_center, new_center_lo)`` for ``scan`` from the
    grid's host center pair: the (``scalars.SIZE``,) f32 scan scalars and the
    f32 (hi, lo) center after the move. The shift comes from the scan's
    center (:func:`~groundgrid_torch.core.grid.shift_cells`), or, for an
    unsorted scan without one, from the host center recurrence
    (:func:`~groundgrid_torch.core.grid.index_shift_ds`)."""
    if scan.center is None:
        if config.sorted_scans:
            raise ValueError("a sorted scan carries the center it was sorted against")
        origin = np.asarray(scan.t_map_velo, np.float32)[:3, 3]
        k, new_center, new_lo = gridlib.index_shift_ds(config, center, center_lo, origin[:2])
        new_center, new_lo = new_center.numpy(), new_lo.numpy()
    else:
        k = gridlib.shift_cells(config, center, scan.center)
        new_center = np.asarray(scan.center, np.float32)
        new_lo = (np.zeros((2,), np.float32) if scan.center_lo is None
                  else np.asarray(scan.center_lo, np.float32))
    count = scan.count if config.wire_format else 0
    packed = scalarlib.pack(config, new_center, new_lo, k, scan.t_map_velo, scan.t_map_base,
                            scan.t_base_map, count)
    return packed, new_center, new_lo


def scan_tensors(scan) -> tuple:
    """The device tensors of a scan, in the body's order: ``(px, py, pz,
    rings, valid)`` of a :class:`Scan`, ``(qx, qy, qz, rings)`` of a
    :class:`WireScan`."""
    if isinstance(scan, WireScan):
        return scan.qx, scan.qy, scan.qz, scan.rings
    return scan.px, scan.py, scan.pz, scan.rings, scan.valid


class CapturedStep:
    """The per-scan step as one CUDA graph: each scan is one replay.

    The port's ``jax.jit`` (``groundgrid_tpu/pipeline.py:325``). It holds
    fixed ("static") buffers: the two state layers, the scan's point
    buffer (the (5, P) f32 rows of a :class:`Scan`, or the (4, P) int16 rows
    of a :class:`WireScan`), the scan scalars and the outputs. A call copies
    its inputs into them (a state's layers only when they are not the
    static ones: :meth:`install`), replays, and returns *clones* of the
    outputs, so a scan still in flight (``run(pipeline_depth=2)``) is not
    overwritten by the next replay; the state it returns holds the static
    layers and the new host center.

    The first call runs the eager body (:meth:`Step.body`) on the real scan,
    which advances the state and does the lazy set-up (the detect tables,
    the fallback counter, the kernel build, the kernels' shared-memory
    attributes); then the body is captured (``capture.Graph``, the protocol
    the spatial step shares) and replayed from the next scan on. A capture
    that fails raises: there is
    no eager fallback. The capture's launches are taken off the launch
    counters and added back on each replay (``ops.add_launches``).

    On the CPU the same protocol runs the eager body where the card would
    replay, so the aliasing rules hold on every device. A scan without a
    center raises: its host center recurrence belongs to the eager
    :func:`make_step_fn`. ``capture_seconds`` and ``pool_bytes`` (the
    memory the capture reserved for its private pool) are None until the
    capture.
    """

    def __init__(self, config: GroundGridConfig, with_aux: bool = False):
        self.config = config
        self.with_aux = with_aux
        self.eager = Step(config, with_aux)
        self._layers: tuple | None = None  # static (ground, groundpatch)
        self._points: tuple | None = None  # static point rows, body order
        self._scalars: torch.Tensor | None = None
        self._graph: Graph | None = None  # its outputs: StepOutput, then AuxLayers

    @property
    def fallbacks(self) -> int:
        return self.eager.fallbacks

    @property
    def marchable(self) -> int:
        return self.eager.marchable

    @property
    def captured(self) -> bool:
        return self._graph is not None and self._graph.graph is not None

    @property
    def capture_seconds(self) -> float | None:
        return None if self._graph is None else self._graph.seconds

    @property
    def pool_bytes(self) -> int | None:
        return None if self._graph is None else self._graph.pool_bytes

    def install(self, state: GridState) -> GridState:
        """A state on the static layers (allocated from the first state):
        ``state``'s layers copied in unless they are the static ones, its
        center kept; ``state`` itself is left as it was."""
        if self._layers is None:
            self._layers = (torch.empty_like(state.ground, memory_format=torch.contiguous_format),
                            torch.empty_like(state.groundpatch,
                                             memory_format=torch.contiguous_format))
        for dst, src in zip(self._layers, (state.ground, state.groundpatch)):
            if src is not dst:
                dst.copy_(src)
        return GridState(*self._layers, center=state.center, center_lo=state.center_lo)

    def scalars(self, center, center_lo, scan):
        """Host: the scan scalars and new center of ``scan`` (:meth:`Step.scalars`)."""
        if scan.center is None:
            raise ValueError("the captured step takes scans with their center (the drivers "
                             "ship one); step center-less scans with make_step_fn")
        return self.eager.scalars(center, center_lo, scan)

    def __call__(self, state: GridState, scan):
        packed, center, center_lo = self.scalars(state.center_np, state.center_lo_np, scan)
        host = torch.from_numpy(packed)
        if state.ground.device.type == "cuda":
            host = host.pin_memory()  # a fresh buffer: no queued copy reads it again
        return self.run(state, scan, host, center, center_lo)

    def run(self, state: GridState, scan, scalars: torch.Tensor, center, center_lo):
        """Step ``state`` with the scan scalars (on the state's device, or in
        pinned host memory) and the host center they were made with."""
        state = self.install(state)
        points = scan_tensors(scan)
        if self._points is None:
            self._allocate(points, scalars, state.ground.device)
        for dst, src in zip(self._points, points):
            dst.copy_(src)
        self._scalars.copy_(scalars, non_blocking=True)
        if self._graph is None:
            result = [t.clone() for t in self._body()]
            self._first(result)
        else:
            self._graph.replay(self._body)
            result = [t.clone() for t in self._graph.outputs]
        state.center, state.center_lo = gridlib.host_pair(center), gridlib.host_pair(center_lo)
        out = StepOutput(*result[:len(StepOutput._fields)])
        if not self.with_aux:
            return state, out
        return state, out, AuxLayers(*result[len(StepOutput._fields):])

    def _allocate(self, points, scalars, device) -> None:
        """The static point rows (one buffer, 32-bit rows viewed as their
        dtypes) and scan scalars."""
        wire = points[0].dtype == torch.int16
        rows = torch.empty((len(points), points[0].shape[0]),
                           dtype=torch.int16 if wire else torch.float32, device=device)
        self._points = tuple(row.view(p.dtype) for row, p in zip(rows.unbind(0), points))
        self._scalars = torch.empty(scalars.shape, dtype=scalars.dtype, device=device)

    def _body(self) -> list:
        """The eager body on the static buffers; the new layers land in the
        static layers. Returns the outputs as one flat list."""
        g, c = self._layers
        ground, groundpatch, out, aux = self.eager.body(g, c, self._points, self._scalars)
        g.copy_(ground)
        c.copy_(groundpatch)
        return list(out) + ([] if aux is None else list(aux))

    def _first(self, result: list) -> None:
        """After the first (eager) call: capture the body on the card, or keep
        the outputs' buffers on the CPU (``capture.Graph``)."""
        graph = Graph(self._layers[0].device)
        marchable = self.eager._marchable
        graph.capture(self._body, result)
        if graph.graph is not None:
            # the capture's marchable holds nothing until the first replay
            self.eager._marchable.copy_(marchable)
        self._graph = graph


def make_step_fn(config: GroundGridConfig, with_aux: bool = False) -> Step:
    """The eager per-scan step for ``config`` (raises for invalid configs):
    the JAX package's unjitted step."""
    _validate(config)
    return Step(config, with_aux)


def make_step(config: GroundGridConfig, with_aux: bool = False):
    """The per-scan step, captured (:class:`CapturedStep`), the counterpart of
    the JAX package's ``jax.jit``; with ``config.use_pallas`` False the
    eager :func:`make_step_fn`, whose plain K3 is a Python ring loop.

    With ``config.wire_format`` the step takes a :class:`WireScan`.
    """
    _validate(config)
    if config.use_pallas is False:
        return Step(config, with_aux)
    return CapturedStep(config, with_aux)


def make_wire_step(config: GroundGridConfig, with_aux: bool = False):
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
    dev = to_device(buf, device)
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

    Runs the port's own :func:`rasterize.ds_cells` on CPU tensors with the
    binning constants the step ships (``scalars.binning_constants``), the op
    sequence the device step runs, so host and device ids agree bitwise.
    """
    ch, cl = _center_ds(center, center_lo)
    xt = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    yt = torch.from_numpy(np.ascontiguousarray(y, np.float32))
    gi0, gi1 = rasterlib.ds_cells(config, *scalarlib.binning_constants(config, ch, cl), xt, yt)
    cell, _ = rasterlib.flat_cells(config, gi0, gi1,
                                   torch.from_numpy(np.asarray(valid).astype(bool)))
    return cell.numpy()


def to_device(buf: np.ndarray, device) -> torch.Tensor:
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
    dev = to_device(buf, device)
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


def dequantize(config: GroundGridConfig, qx, qy, qz, rings, s):
    """A wire scan's rows -> ``(x, y, z, rings, valid)`` on the device:
    ``q * step + ref`` in f32, the refs the scan scalars' center (``s.cx``,
    ``s.cy``) and sensor height (``s.oz``), ``valid`` from its device
    ``count``.

    The steps are powers of two, so ``q * step`` is exact and only the add
    rounds: bitwise the host's dequantized coordinates that the scan was
    sorted by (eager PyTorch keeps the product and the add two ops).
    """
    sxy, sz = wire_scales(config)
    x = qx.to(torch.float32) * float(sxy) + s.cx
    y = qy.to(torch.float32) * float(sxy) + s.cy
    z = qz.to(torch.float32) * float(sz) + s.oz
    valid = torch.arange(qx.shape[0], dtype=torch.int32, device=qx.device) < s.count
    return x, y, z, rings.to(torch.int32), valid.to(torch.int32)


def dequantize_scan(config: GroundGridConfig, w: WireScan) -> Scan:
    """WireScan -> Scan on the device (:func:`dequantize`, its scan scalars
    shipped from the wire scan's own host fields)."""
    packed = scalarlib.pack(config, w.center, w.center_lo, (0, 0), w.t_map_velo, w.t_map_base,
                            w.t_base_map, w.count)
    x, y, z, rings, valid = dequantize(config, *scan_tensors(w),
                                       scalarlib.view(to_device(packed, w.qx.device)))
    return Scan(px=x, py=y, pz=z, rings=rings, valid=valid, t_map_velo=w.t_map_velo,
                t_map_base=w.t_map_base, t_base_map=w.t_base_map, center=w.center,
                center_lo=w.center_lo)


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
    dev = to_device(buf, device)
    wire = WireScan(
        qx=dev[0], qy=dev[1], qz=dev[2], rings=dev[3], count=int(count),
        t_map_velo=t_map_velo.astype(np.float32),
        t_map_base=np.asarray(t_map_base, np.float32),
        t_base_map=np.asarray(t_base_map, np.float32),
        center=np.asarray(ch, np.float32), center_lo=np.asarray(cl, np.float32),
    )
    return wire, order
