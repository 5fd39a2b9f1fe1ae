"""The scan scalars: every per-scan value the step takes, in one small tensor.

The JAX step takes its poses and grid center as traced arrays (``Scan``
fields, ``groundgrid_tpu/pipeline.py:41-61``) and the move's shift as a
traced ``k`` (``groundgrid_tpu/core/grid.py:180-181``), so one compiled
program serves every scan. The port's counterpart: the host computes each
per-scan scalar in NumPy f32, exactly as the step once did from its host
floats (the ds image of the center plus the half length, ``c + half``, the
sensor origin, the base plane, the whole-cell shift), and ships all of them
in one (``SIZE``,) float32 tensor, the integers as int32 bits. The step reads
each as a 0-dim view on the device (:func:`view`), so a CUDA graph captured
on one scan replays on any other.

A batch of vehicles (the fleet's batched step, ``pipeline.Step.body`` on a
leading vehicle axis) ships a ``(B, SIZE)`` tensor, one row a vehicle:
:func:`view` then gives ``(B, 1)`` columns, which broadcast against the
``(B, P)`` point tensors, and :func:`grid` turns a view into the form that
broadcasts against ``(..., N, N)`` layers. The single step is the batch's
body without the vehicle axis.

A device op ``t - s.ox`` rounds as ``t - float(v)`` did: both are one IEEE
f32 operation on the same two f32 values (no per-scan scalar divides).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import exactf32


class ScanScalars(NamedTuple):
    """Named views of the scan scalars: 0-dim tensors on the step's device
    (:func:`view`), or any scalars that combine with f32 tensors in one
    IEEE operation."""

    ox: object  # sensor origin, map frame (t_map_velo[:3, 3] as f32)
    oy: object
    oz: object
    base_z: object  # base_link height (t_map_base[2, 3]): K3's center seed, (B,) batched
    sh0: object  # ds image (hi, lo) of center + half length, axis 0: the binning
    sl0: object
    sh1: object  # the same, axis 1
    sl1: object
    cxh: object  # f32 center + half length per axis: the plane shift
    cyh: object
    cx: object  # f32 grid center (hi): exposed cells' base plane, wire dequantization
    cy: object
    b20: object  # t_base_map row 2: the base plane
    b21: object
    b23: object
    velo: object  # (3, 4) t_map_velo rows 0-2 ((B, 3, 4)): unsorted mode's device transform
    k0: object  # int32 whole-cell shift of the move, per axis
    k1: object
    count: object  # int32 valid prefix of a wire scan (0 otherwise)


N_FLOATS = 15  # ox .. b23
VELO = slice(N_FLOATS, N_FLOATS + 12)
K0, K1, COUNT = N_FLOATS + 12, N_FLOATS + 13, N_FLOATS + 14
SIZE = N_FLOATS + 15


def binning_constants(config: GroundGridConfig, center, center_lo):
    """Host: ``(sh0, sl0, sh1, sl1)`` np.float32, the ds image of
    ``center + half_length`` per axis (``center_lo`` None = zero tail). Of
    (B, 2) centers each is a (B,) array, the same f32 operations a vehicle."""
    hh, hl = exactf32.f64_to_ds(np.float64(config.half_length))
    c = np.asarray(center, np.float32)
    cl = np.zeros_like(c) if center_lo is None else np.asarray(center_lo, np.float32)
    (c0, c1), (l0, l1) = c.T, cl.T  # scalars of a pair, (B,) columns of a batch
    sh0, sl0 = exactf32.ds_add(c0, l0, np.float32(hh), np.float32(hl))
    sh1, sl1 = exactf32.ds_add(c1, l1, np.float32(hh), np.float32(hl))
    return sh0, sl0, sh1, sl1


def pack(config: GroundGridConfig, center, center_lo, k, t_map_velo, t_map_base, t_base_map,
         count=0) -> np.ndarray:
    """Host: the (``SIZE``,) float32 scan scalars of one scan.

    ``center`` / ``center_lo``: the grid center after the move, an f32
    (hi, lo) pair; ``k``: the move's whole-cell shift (ints), clamped to
    ``[-n, n]``, since a shift of ``|k| >= n`` exposes every cell whatever
    its size; the poses as the scan carries them.

    Of a batch of vehicles, one pass over it: (B, 2) centers and shifts,
    (B, 4, 4) poses and a (B,) or a shared ``count`` give the (B, ``SIZE``)
    rows, each bitwise its vehicle's single call (elementwise f32
    operations; no Python float meets an f32 array).
    """
    n = config.cell_count
    c = np.asarray(center, np.float32)
    half = np.float32(config.half_length)
    velo = np.asarray(t_map_velo, np.float32)
    tb = np.asarray(t_base_map, np.float32)
    out = np.empty((*c.shape[:-1], SIZE), np.float32)
    cols = out.T  # a field a row: (SIZE,) of one scan, (SIZE, B) of a batch
    cx, cy = c.T
    cols[:N_FLOATS] = (
        *velo[..., :3, 3].T, np.asarray(t_map_base, np.float32)[..., 2, 3],
        *binning_constants(config, c, center_lo),
        cx + half, cy + half, cx, cy, tb[..., 2, 0], tb[..., 2, 1], tb[..., 2, 3],
    )
    cols[VELO] = velo[..., :3, :].reshape(*velo.shape[:-2], 12).T
    ints = cols.view(np.int32)
    # through f64, exact for every int32 and every shift an f32 delta snaps to
    ints[K0:K1 + 1] = np.clip(np.asarray(k, np.float64), -n, n).astype(np.int32).T
    ints[COUNT] = count
    return out


def view(t: torch.Tensor) -> ScanScalars:
    """Named views of packed scan scalars: of a (``SIZE``,) tensor 0-dim
    views (``velo`` a (3, 4) view); of a (B, ``SIZE``) batch (B, 1) columns,
    ``base_z`` (B,) (K3's per-grid seeds) and ``velo`` (B, 3, 4)."""
    i = t.view(torch.int32)
    if t.dim() == 1:
        return ScanScalars(*t[:N_FLOATS].unbind(0), velo=t[VELO].view(3, 4), k0=i[K0],
                           k1=i[K1], count=i[COUNT])
    cols = t[:, :N_FLOATS].unsqueeze(-1).unbind(1)
    return ScanScalars(*cols[:3], t[:, 3], *cols[4:], velo=t[:, VELO].view(-1, 3, 4),
                       k0=i[:, K0:K0 + 1], k1=i[:, K1:K1 + 1], count=i[:, COUNT:COUNT + 1])


# the fields a kernel reads from device memory, at their offsets in a row
# (k0 and k1 as int32 bits)
KERNEL_FIELDS = {"ox": 0, "oy": 1, "oz": 2, "sh0": 4, "sl0": 5, "sh1": 6, "sl1": 7, "cxh": 8,
                 "cyh": 9, "cx": 10, "cy": 11, "b20": 12, "b21": 13, "b23": 14, "k0": K0,
                 "k1": K1}


def device_rows(s: ScanScalars, points: torch.Tensor) -> tuple[int, int]:
    """For a kernel that reads the scan scalars where they lie (a captured
    graph then replays on any scan): the address of the first row's ``ox``
    and the row stride in floats, of :func:`view`'s views of a (``SIZE``,)
    tensor for (P,) ``points``, or of a (B, ``SIZE``) batch for (B, P).
    Raises unless :data:`KERNEL_FIELDS` lie at their offsets, as float32
    on the points' device."""
    ox = s.ox
    if not (isinstance(ox, torch.Tensor) and ox.dtype == torch.float32
            and ox.device == points.device):
        raise ValueError("the scan scalars must be float32 views on the points' device")
    shape = () if points.dim() == 1 else (points.shape[0], 1)
    if tuple(ox.shape) != shape:
        raise ValueError(f"scan scalars of shape {tuple(ox.shape)} for points of shape "
                         f"{tuple(points.shape)}")
    stride = ox.stride(0) if shape else 0
    base = ox.data_ptr()
    for name, offset in KERNEL_FIELDS.items():
        v = getattr(s, name)
        if (tuple(v.shape) != shape or v.data_ptr() != base + 4 * offset
                or (shape and v.stride(0) != stride)):
            raise ValueError(f"scan scalar {name}: not at offset {offset} of a packed row of "
                             f"the points' batch (shape {tuple(v.shape)})")
    return base, stride


def grid(v):
    """A scan scalar's view in the form that broadcasts against ``(..., N,
    N)`` layers: a 0-dim view as (1,), a (B, 1) column as (B, 1, 1); a host
    scalar as it is."""
    return v[..., None] if isinstance(v, torch.Tensor) else v


def host(config: GroundGridConfig, center, center_lo, t_map_velo, t_map_base=None,
         t_base_map=None, k=(0, 0), count: int = 0) -> ScanScalars:
    """The scan scalars as views of a CPU tensor: the host prep's and the
    tests' form. Missing poses follow ``t_map_velo`` (``transforms.scan_poses``)."""
    from groundgrid_torch.core import transforms as tf

    if t_map_base is None or t_base_map is None:
        _, t_map_base, t_base_map = tf.scan_poses(np.asarray(t_map_velo, np.float64))
    return view(torch.from_numpy(pack(config, center, center_lo, k, t_map_velo, t_map_base,
                                      t_base_map, count)))
