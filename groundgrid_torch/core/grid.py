"""Ego-centric moving grid state (PyTorch).

The torch counterpart of ``groundgrid_tpu/core/grid.py``, itself the
replacement for grid_map's circular buffer (``src/GroundGrid.cpp:50-147``):
the grid is two dense (N, N) layers, relocation is a whole-cell gather
(bitwise ``torch.roll``) plus a re-initialization of the freshly exposed
cells.

Only ``ground``, ``groundpatch`` and the grid center survive from scan to
scan (every other layer is reset at the top of each scan,
``GroundSegmentation.cpp:61-75``).

The center lives on the host. ``center``/``center_lo`` are (2,) float32 CPU
tensors whatever the device of the layers: the host derives every scalar
the step needs from them (the ds binning constants, the shift, the base
plane) and ships those in the scan scalars (``core/scalars.py``), so the
step reads no geometry back from the device. Index convention as
grid_map: index 0 is the **max**-position corner,
``idx = floor((center + half - pos) / res)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import exactf32
from groundgrid_torch.core import scalars as scalarlib


@dataclasses.dataclass
class GridState:
    """Recurrent scene state.

    Attributes:
      ground:      (N, N) f32 terrain height estimate [m, map frame].
      groundpatch: (N, N) f32 ground confidence in [0, 1].
      center:      (2,) f32 CPU tensor, grid center [m, map frame].
      center_lo:   (2,) f32 CPU tensor, ds tail of the f64 grid center.
    """

    ground: torch.Tensor
    groundpatch: torch.Tensor
    center: torch.Tensor
    center_lo: torch.Tensor

    @property
    def center_np(self) -> np.ndarray:
        return self.center.numpy()

    @property
    def center_lo_np(self) -> np.ndarray:
        return self.center_lo.numpy()


def host_pair(v) -> torch.Tensor:
    """A (2,) f32 CPU tensor of its own from a host pair (array or tensor);
    (B, 2) from a batch of pairs."""
    if isinstance(v, torch.Tensor):
        v = v.numpy()
    a = np.array(v, dtype=np.float32)
    return torch.from_numpy(a.reshape(2) if a.ndim <= 1 else a.reshape(-1, 2))


def create(config: GroundGridConfig, center_xy, center_z, device) -> GridState:
    """Initial grid, equivalent to ``GroundGrid::initGroundGrid``.

    ground := odom z everywhere, groundpatch := 1e-7 (GroundGrid.cpp:71-75).
    A float64 ``center_xy`` seeds the ds center exactly; f32 seeds a zero
    tail.
    """
    n = config.cell_count
    lo = np.zeros((2,), np.float32)
    center_xy = np.asarray(center_xy)
    if center_xy.dtype == np.float64:
        hi, lo = exactf32.f64_to_ds(center_xy)
        center_xy = hi
    ground = torch.full((n, n), float(np.float32(center_z)), dtype=torch.float32,
                        device=device)
    groundpatch = torch.full((n, n), float(np.float32(1e-7)), dtype=torch.float32,
                             device=device)
    return GridState(ground=ground, groundpatch=groundpatch,
                     center=host_pair(center_xy), center_lo=host_pair(lo))


def state_from_numpy(ground, groundpatch, center, center_lo, device) -> GridState:
    """Build the port's state from NumPy layers, e.g. a JAX ``GridState``
    fetched with ``np.asarray`` or an ``.npz`` checkpoint."""
    def layer(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    lo = np.zeros((2,), np.float32) if center_lo is None else center_lo
    return GridState(ground=layer(ground), groundpatch=layer(groundpatch),
                     center=host_pair(center), center_lo=host_pair(lo))


def state_to_numpy(state: GridState):
    """``(ground, groundpatch, center, center_lo)`` as float32 NumPy arrays
    of their own: the captured step overwrites its layers in place, and on
    the CPU ``numpy()`` would share their memory."""
    return (
        state.ground.detach().to("cpu", copy=True).numpy(),
        state.groundpatch.detach().to("cpu", copy=True).numpy(),
        state.center.numpy().copy(),
        state.center_lo.numpy().copy(),
    )


def _snap_cells(x):
    """Round positions-in-cells to whole cells, half AWAY from zero.

    grid_map's ``getIndexShiftFromPositionShift`` computes
    ``static_cast<int>(x + 0.5*sign(x))``; ``torch.round`` and ``np.round``
    round half to even (AUDIT.md #1). Works on NumPy arrays and tensors.
    """
    if isinstance(x, torch.Tensor):
        return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)
    return np.sign(x) * np.floor(np.abs(x) + np.asarray(0.5, x.dtype))


def shift_cells(config: GroundGridConfig, old_center, new_center):
    """Whole-cell roll shift between two host f32 centers (as Python ints).

    The centers differ by exact cell multiples, so the f32 delta snaps
    robustly (``grid.py:177-178`` of the JAX package). Of (B, 2) batches of
    centers, one pass over the batch: a (B, 2) int32 array, clamped to
    ``[-n, n]`` as ``scalars.pack`` clamps a shift (:func:`_host_cells`).
    """
    res = np.float32(config.resolution)
    d = (np.asarray(new_center, np.float32) - np.asarray(old_center, np.float32)) / res
    return _host_cells(config, _snap_cells(d.astype(np.float32)))


def _host_cells(config: GroundGridConfig, k):
    """Snapped whole-cell shifts on the host: of a (2,) pair Python ints;
    of a (B, 2) batch an int32 array clamped to ``[-n, n]`` (a shift of
    ``|k| >= n`` exposes every cell whatever its size, and so fits int32)."""
    if k.ndim == 1:
        return int(k[0]), int(k[1])
    n = config.cell_count
    return np.clip(np.asarray(k), -n, n).astype(np.int32)


def roll_cells(x: torch.Tensor, k0, k1) -> torch.Tensor:
    """``torch.roll(x, (k0, k1), (-2, -1))`` as one gather with device indices
    ``(arange(n) - k) mod n`` per axis: data moves only, so bitwise the roll,
    and the shift may be a 0-dim device tensor (the scan scalars). Of a
    (B, N, N) batch with (B, 1) shifts, each grid rolls by its own: the
    indices are (B, N) rows."""
    n0, n1 = x.shape[-2:]
    i0 = torch.remainder(torch.arange(n0, device=x.device) - k0, n0)
    i1 = torch.remainder(torch.arange(n1, device=x.device) - k1, n1)
    if x.dim() == 2:
        return x[i0[:, None], i1[None, :]]
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return x[b, i0[:, :, None], i1[:, None, :]]


def exposed_mask(n: int, k0, k1, device) -> torch.Tensor:
    """(N, N) bool mask of cells newly exposed by a roll of (k0, k1), 0-dim
    int tensors on ``device``; (B, N, N) for (B, 1) shifts.

    +k exposes indices [0, k); -k exposes [N-k, N); |k| >= N wipes the grid.
    """
    idx = torch.arange(n, device=device)

    def axis_mask(kk):
        return torch.where(kk >= 0, idx < kk, idx >= n + kk) | (torch.abs(kk) >= n)

    return axis_mask(k0)[..., :, None] | axis_mask(k1)[..., None, :]


def cell_positions(config: GroundGridConfig, cx, cy, device):
    """Map-frame (x, y) of every cell center: (N, 1) and (1, N) tensors
    that broadcast to the grid.

    pos = center + half - (idx + 0.5) * res (axis 0 <-> x, axis 1 <-> y);
    ``cx``, ``cy``: the f32 center, 0-dim tensors on ``device``; (B, 1)
    columns give (B, N, 1) and (B, 1, N).
    """
    n = config.cell_count
    res = float(np.float32(config.resolution))
    half = float(np.float32(config.half_length))
    coord = half - (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * res
    return scalarlib.grid(cx) + coord[:, None], scalarlib.grid(cy) + coord[None, :]


def index_shift_ds(config: GroundGridConfig, center, center_lo, new_position):
    """The device center recurrence: the whole-cell shift towards
    ``new_position`` and the ds center ``center += k * resolution``.

    The JAX package's ``index_shift_ds`` (``grid.py:111-140``), op for op on
    host f32: ``k`` snaps the f32 position delta half away from zero, then
    ``k`` times the ds image of the f64 resolution is added to the (hi, lo)
    center, mirroring grid_map's double recurrence to ~2^-47. ``center``,
    ``center_lo`` (None = zero tail) and ``new_position``: (2,) f32 values.

    Caveat: an odometry step of exactly half a cell, a tie grid_map decides
    in f64, can snap the other way once |position| is large enough that f32
    loses the tie. The drivers therefore track the center in f64 on the host
    (``pipeline.CenterTracker``) and ship it in ``Scan.center``; this
    recurrence serves scans without a center (``pipeline.pad_scan``), on
    the eager step.
    Returns ``(k, new_center, new_center_lo)``: (k0, k1) ints and two (2,)
    f32 CPU tensors; of (B, 2) batches, the shifts as :func:`shift_cells`
    gives a batch's and (B, 2) tensors.
    """
    res = np.float32(config.resolution)
    c = host_pair(center)
    lo = torch.zeros_like(c) if center_lo is None else host_pair(center_lo)
    delta = host_pair(new_position) - c
    # through int32, as the JAX package's k: a snapped -0.0 becomes +0.0
    kf = _snap_cells(delta / torch.tensor(res)).to(torch.int32).to(torch.float32)
    rh, rl, _ = exactf32.res_ds(config.resolution)
    rhh, rhl = exactf32.split(rh)
    rlh, rll = exactf32.split(rl)
    p1h, p1l = exactf32.two_prod_int_const(kf, rh, rhh, rhl)
    p2h, p2l = exactf32.two_prod_int_const(kf, rl, rlh, rll)
    nh, nl = exactf32.ds_add(c, lo, p1h, p1l)
    nh, nl = exactf32.ds_add(nh, nl, p2h, p2l)
    return _host_cells(config, kf.numpy()), nh, nl


def move(config: GroundGridConfig, ground, groundpatch, s):
    """Relocate the grid (``GroundGrid::update``); returns new (ground,
    groundpatch), the inputs untouched.

    ``s``: the scan scalars (``core/scalars.py``) holding the whole-cell
    shift ``k0, k1``, the new f32 center ``cx, cy`` and ``t_base_map`` row 2.
    The host derives the shift from its own centers (:func:`shift_cells`, or
    :func:`index_shift_ds` for a scan without one) and ships it, so the move
    reads nothing back. Content shifts by whole cells (:func:`roll_cells`);
    freshly exposed cells are re-initialized to the base_link plane height
    ``ground := -z_base(cell)``, ``groundpatch := 0`` (GroundGrid.cpp:121-133).
    Layers of (B, N, N) with batched scan scalars move each grid by its
    own vehicle's shift and plane.
    The move always runs: a zero shift exposes no cell and leaves the
    layers bitwise as they were (GroundGrid.cpp:136-137), where the JAX
    ``move`` rolls by its traced ``k`` (``grid.py:180-181`` there).
    """
    n = config.cell_count
    dev = ground.device
    ground = roll_cells(ground, s.k0, s.k1)
    groundpatch = roll_cells(groundpatch, s.k0, s.k1)
    exposed = exposed_mask(n, s.k0, s.k1, dev)
    px, py = cell_positions(config, s.cx, s.cy, dev)
    b20, b21, b23 = (scalarlib.grid(v) for v in (s.b20, s.b21, s.b23))
    z_base = (b20 * px + b21 * py) + b23
    ground = torch.where(exposed, -z_base, ground)
    groundpatch = torch.where(exposed, torch.zeros_like(groundpatch), groundpatch)
    return ground, groundpatch
