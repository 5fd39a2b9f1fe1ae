"""Ego-centric moving grid state (PyTorch).

The torch counterpart of ``groundgrid_tpu/core/grid.py``, itself the
replacement for grid_map's circular buffer (``src/GroundGrid.cpp:50-147``):
the grid is two dense (N, N) layers, relocation is a ``torch.roll`` plus a
re-initialization of the freshly exposed cells.

Only ``ground``, ``groundpatch`` and the grid center survive from scan to
scan (every other layer is reset at the top of each scan,
``GroundSegmentation.cpp:61-75``).

The center lives on the host. ``center``/``center_lo`` are (2,) float32 CPU
tensors whatever the device of the layers: every consumer needs them as
scalars (the ds binning constants, the roll shift, the base plane), so
keeping them host-side makes the whole step free of device-to-host syncs for
geometry. Index convention as grid_map: index 0 is the **max**-position
corner, ``idx = floor((center + half - pos) / res)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import exactf32


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


def _host_pair(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        v = v.numpy()
    return torch.from_numpy(np.array(v, dtype=np.float32).reshape(2))


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
                     center=_host_pair(center_xy), center_lo=_host_pair(lo))


def state_from_numpy(ground, groundpatch, center, center_lo, device) -> GridState:
    """Build the port's state from NumPy layers, e.g. a JAX ``GridState``
    fetched with ``np.asarray`` or an ``.npz`` checkpoint."""
    def layer(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    lo = np.zeros((2,), np.float32) if center_lo is None else center_lo
    return GridState(ground=layer(ground), groundpatch=layer(groundpatch),
                     center=_host_pair(center), center_lo=_host_pair(lo))


def state_to_numpy(state: GridState):
    """``(ground, groundpatch, center, center_lo)`` as float32 NumPy arrays."""
    return (
        state.ground.detach().cpu().numpy(),
        state.groundpatch.detach().cpu().numpy(),
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


def shift_cells(config: GroundGridConfig, old_center, new_center) -> tuple[int, int]:
    """Whole-cell roll shift between two host f32 centers (as Python ints).

    The centers differ by exact cell multiples, so the f32 delta snaps
    robustly (``grid.py:177-178`` of the JAX package).
    """
    res = np.float32(config.resolution)
    d = (np.asarray(new_center, np.float32) - np.asarray(old_center, np.float32)) / res
    k = _snap_cells(d.astype(np.float32))
    return int(k[0]), int(k[1])


def exposed_mask(n: int, k, device) -> torch.Tensor:
    """(N, N) bool mask of cells newly exposed by a roll of (k0, k1).

    +k exposes indices [0, k); -k exposes [N-k, N); |k| >= N wipes the grid.
    """
    idx = torch.arange(n, device=device)

    def axis_mask(kk: int):
        if abs(kk) >= n:
            return torch.ones(n, dtype=torch.bool, device=device)
        return idx < kk if kk >= 0 else idx >= n + kk

    return axis_mask(k[0])[:, None] | axis_mask(k[1])[None, :]


def cell_positions(config: GroundGridConfig, center, device):
    """Map-frame (x, y) of every cell center as two (N, N) tensors.

    pos = center + half - (idx + 0.5) * res (axis 0 <-> x, axis 1 <-> y).
    """
    n = config.cell_count
    res = float(np.float32(config.resolution))
    half = float(np.float32(config.half_length))
    coord = half - (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * res
    c = np.asarray(center, np.float32)
    px = (float(c[0]) + coord[:, None]).expand(n, n)
    py = (float(c[1]) + coord[None, :]).expand(n, n)
    return px, py


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
    (``pipeline.CenterTracker``) and ship it in ``Scan.center``, which
    :func:`move` prefers; this recurrence serves scans without a center
    (``pipeline.pad_scan``).
    Returns ``(k, new_center, new_center_lo)``: (k0, k1) ints and two (2,)
    f32 CPU tensors.
    """
    res = np.float32(config.resolution)
    c = _host_pair(center)
    lo = torch.zeros(2, dtype=torch.float32) if center_lo is None else _host_pair(center_lo)
    delta = _host_pair(new_position) - c
    # through int32, as the JAX package's k: a snapped -0.0 becomes +0.0
    kf = _snap_cells(delta / torch.tensor(res)).to(torch.int32).to(torch.float32)
    rh, rl, _ = exactf32.res_ds(config.resolution)
    rhh, rhl = exactf32.split(rh)
    rlh, rll = exactf32.split(rl)
    p1h, p1l = exactf32.two_prod_int_const(kf, rh, rhh, rhl)
    p2h, p2l = exactf32.two_prod_int_const(kf, rl, rlh, rll)
    nh, nl = exactf32.ds_add(c, lo, p1h, p1l)
    nh, nl = exactf32.ds_add(nh, nl, p2h, p2l)
    return (int(kf[0]), int(kf[1])), nh, nl


def move(config: GroundGridConfig, state: GridState, t_base_map, new_center=None,
         new_center_lo=None, new_position=None) -> GridState:
    """Relocate the grid (``GroundGrid::update``).

    To the host-tracked ``new_center`` / ``new_center_lo`` when given; with
    ``new_center`` None, to the center :func:`index_shift_ds` derives from
    the sensor's (2,) f32 ``new_position``, as the JAX ``move`` does
    (``grid.py:170-173``). Content shifts by whole cells (``torch.roll``
    with host ints); freshly exposed cells are re-initialized to the
    base_link plane height ``ground := -z_base(cell)``, ``groundpatch := 0``
    (GroundGrid.cpp:121-133). No movement leaves the layers untouched
    (GroundGrid.cpp:136-137). Returns a new state; the input layers are not
    modified.
    """
    n = config.cell_count
    if new_center is None:
        k, new_center, new_center_lo = index_shift_ds(config, state.center, state.center_lo,
                                                      new_position)
    else:
        k = shift_cells(config, state.center_np, new_center)
        if new_center_lo is None:
            new_center_lo = np.zeros((2,), np.float32)
    ground, groundpatch = state.ground, state.groundpatch
    if k != (0, 0):
        dev = ground.device
        ground = torch.roll(ground, shifts=k, dims=(0, 1))
        groundpatch = torch.roll(groundpatch, shifts=k, dims=(0, 1))
        exposed = exposed_mask(n, k, dev)
        px, py = cell_positions(config, new_center, dev)
        t = np.asarray(t_base_map, np.float32)
        z_base = (float(t[2, 0]) * px + float(t[2, 1]) * py) + float(t[2, 3])
        ground = torch.where(exposed, -z_base, ground)
        groundpatch = torch.where(exposed, torch.zeros_like(groundpatch), groundpatch)
    return GridState(ground=ground, groundpatch=groundpatch,
                     center=_host_pair(new_center), center_lo=_host_pair(new_center_lo))
