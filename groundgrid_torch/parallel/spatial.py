"""Spatial grid sharding: one grid split row-wise over a mesh.

The torch counterpart of ``groundgrid_tpu/parallel/spatial.py``. The fleet
axis (``parallel/sharding.py``) scales the number of vehicles; this module
splits *one grid* for configurations a device cannot hold or chew through,
e.g. the 0.1 m / 120 m stress geometry (1200^2 cells, BASELINE.json config
4) pushed to larger extents. The (N, N) layers are cut into S blocks of N/S
rows, one per shard (:func:`spatial_sharding`), and a scan's points into S
contiguous chunks (:func:`shard_scan`).

A mesh is one of two kinds:

  * :class:`LocalMesh`, a device list run in this process, shard s on
    ``devices[s]`` (repeats allowed: ``["cpu"] * 8`` mirrors the JAX tests'
    8 virtual CPU devices, ``["cuda:0"] * 8`` runs 8 shards on one card).
    Its collectives are copies between the shards' devices, folded in shard
    order;
  * :class:`GroupMesh`, this process's one shard of the default
    ``torch.distributed`` group (``parallel/multihost.py init_multihost``:
    gloo on the CPU, NCCL on cards), shard = rank. Its collectives are
    ``all_gather``, ``all_reduce`` and ``broadcast`` on the shard's device.

Both run the same per-shard code and fold what they gather in shard order,
so every rank of a group is bitwise the local mesh with the same S.

Exactness: the sharded detect (:func:`make_sharded_detect`, and the step's
detect) is bitwise the single-grid ``detect_ground_patches``: the windows
add their offsets in the whole grid's row-major order (``core/detect.py``).
The step's raster folds the shards' K1 columns in shard order, which
reassociates the sums of the few cells whose points straddle two chunks, so
it is held to the single-grid step within the JAX spatial step's bounds,
not bitwise.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.core import classify as classifylib
from groundgrid_torch.core import detect as detectlib
from groundgrid_torch.core import grid as gridlib
from groundgrid_torch.core import outliers as outlierlib
from groundgrid_torch.core import rasterize as rasterlib
from groundgrid_torch.core import scalars as scalarlib
from groundgrid_torch.core import transforms as tf
from groundgrid_torch.core.detect import HALO
from groundgrid_torch.ops import lookup as lookuplib
from groundgrid_torch.ops import raster as rasterops
from groundgrid_torch.ops import spiral as spiralops
from groundgrid_torch.parallel.sharding import _place, make_mesh
from groundgrid_torch.parallel.spiral_shard import banded_spiral
from groundgrid_torch.pipeline import Scan, _validate, scan_scalars, to_device


class LocalMesh:
    """S shards in this process, shard s on ``devices[s]``.

    ``shards`` lists the shard indices this process runs (all of them) and
    ``devices`` their devices, in the same order. Collectives take one
    value per local shard and return one per local shard.
    """

    def __init__(self, devices: Sequence):
        self.devices = make_mesh(devices)
        self.size = len(self.devices)
        self.shards = list(range(self.size))

    def all_gather(self, values):
        """Every shard's value, in shard order, on each shard's device (a
        value already there is shared, not copied: read only)."""
        return [[v.to(dev) for v in values] for dev in self.devices]

    def all_reduce_sum(self, values):
        """The sum over the shards, added in shard order; a fresh tensor per
        shard."""
        total = values[0]
        for v in values[1:]:
            total = total + v.to(total.device)
        return [total.to(dev, copy=True) for dev in self.devices]

    def relay(self, value, src: int, shape):
        """Shard ``src``'s ``value``, delivered to shard ``src + 1``."""
        return value.to(self.devices[src + 1], copy=True)


class GroupMesh:
    """This process's shard of the default ``torch.distributed`` group,
    shard = rank, on ``device`` (a card under NCCL, the CPU under gloo)."""

    def __init__(self, device):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("GroupMesh needs an initialized torch.distributed group "
                               "(parallel.multihost.init_multihost)")
        self.devices = make_mesh([device])
        self.size = dist.get_world_size()
        self.shards = [dist.get_rank()]

    def all_gather(self, values):
        (v,) = values
        out = [torch.empty_like(v) for _ in range(self.size)]
        dist.all_gather(out, v.contiguous())
        return [out]

    def all_reduce_sum(self, values):
        (v,) = values
        v = v.clone()
        dist.all_reduce(v)
        return [v]

    def relay(self, value, src: int, shape):
        buf = value if dist.get_rank() == src else torch.empty(
            shape, dtype=torch.float32, device=self.devices[0])
        dist.broadcast(buf, src)
        return buf


def as_mesh(mesh):
    """A :class:`LocalMesh` of a device list; a mesh as it is."""
    return mesh if isinstance(mesh, (LocalMesh, GroupMesh)) else LocalMesh(mesh)


def _rows(n: int, size: int, s: int) -> slice:
    if n % size:
        raise ValueError(f"grid rows {n} not divisible by {size} shards")
    r = n // size
    return slice(s * r, (s + 1) * r)


def spatial_sharding(mesh, n: int) -> list[tuple[slice, torch.device]]:
    """Each local shard's block of an (N, N) layer: (rows, device), as
    ``fleet_sharding`` gives vehicle blocks. ``ValueError`` where S does
    not divide N."""
    mesh = as_mesh(mesh)
    return [(_rows(n, mesh.size, s), dev) for s, dev in zip(mesh.shards, mesh.devices)]


def split_rows(full, mesh) -> list:
    """The local shards' row blocks of an (N, N) layer, each on its device."""
    return [_place(full[rows].contiguous(), dev)
            for rows, dev in spatial_sharding(mesh, full.shape[0])]


def gather_rows(blocks, mesh, device=None):
    """The (N, N) layer from every shard's row block (an ``all_gather`` on a
    group), on ``device`` (default: the first local shard's)."""
    mesh = as_mesh(mesh)
    full = torch.cat(mesh.all_gather(list(blocks))[0])
    return full if device is None else full.to(device)


def shard_scan(scan: Scan, mesh) -> list:
    """The local shards' chunks of a padded scan: the point arrays in S
    contiguous chunks, each on its shard's device; the poses and the center
    stay host values. ``ValueError`` where S does not divide the points."""
    mesh = as_mesh(mesh)
    p = scan.px.shape[0]
    if p % mesh.size:
        raise ValueError(f"max_points {p} not divisible by {mesh.size} shards")
    k = p // mesh.size
    fields = ("px", "py", "pz", "rings", "valid")
    return [scan._replace(**{f: _place(getattr(scan, f)[s * k:(s + 1) * k], dev) for f in fields})
            for s, dev in zip(mesh.shards, mesh.devices)]


def blocks_from_numpy(ground, groundpatch, center, center_lo, mesh):
    """A grid state as NumPy arrays (a JAX ``GridState`` through
    ``np.asarray``, a checkpoint) split into the local shards' row blocks:
    ``(g_blocks, c_blocks, (center, center_lo))``, the center pair as the
    port's host (2,) f32 tensors."""
    state = gridlib.state_from_numpy(ground, groundpatch, center, center_lo, "cpu")
    return (split_rows(state.ground, mesh), split_rows(state.groundpatch, mesh),
            (state.center, state.center_lo))


def blocks_to_numpy(g_blocks, c_blocks, center, mesh):
    """The inverse of :func:`blocks_from_numpy`: ``(ground, groundpatch,
    center, center_lo)`` as float32 NumPy arrays (rows gathered over a
    group)."""
    ground = gather_rows(g_blocks, mesh, "cpu").numpy()
    groundpatch = gather_rows(c_blocks, mesh, "cpu").numpy()
    return ground, groundpatch, center[0].numpy().copy(), center[1].numpy().copy()


def exchange_halo(blocks, mesh) -> list:
    """Each local row block with ``HALO`` ghost rows from its grid
    neighbours above and below, ``(rows + 2 HALO, N)``; zeros at the grid's
    top and bottom edges (no wraparound), as the JAX ``_exchange_halo``.
    One ``all_gather`` of every block's edge rows."""
    mesh = as_mesh(mesh)
    edges = [torch.cat([b[:HALO], b[-HALO:]]) for b in blocks]
    out = []
    for s, b, got in zip(mesh.shards, blocks, mesh.all_gather(edges)):
        zeros = torch.zeros((HALO, b.shape[1]), dtype=b.dtype, device=b.device)
        above = got[s - 1][HALO:] if s > 0 else zeros
        below = got[s + 1][:HALO] if s < mesh.size - 1 else zeros
        out.append(torch.cat([above, b, below]))
    return out


class _ShardTables:
    """The detect tables per device, and each shard's rows of them."""

    def __init__(self, config: GroundGridConfig, size: int):
        self.config, self.size = config, size
        self._full: dict = {}

    def rows(self, s: int, device) -> detectlib.DetectTables:
        device = torch.device(device)
        if device not in self._full:
            self._full[device] = detectlib.make_tables(self.config, device)
        return detectlib.row_tables(self._full[device],
                                    _rows(self.config.cell_count, self.size, s))


def make_sharded_detect(config: GroundGridConfig, mesh):
    """A row-sharded drop-in for ``detect_ground_patches``: ``f(points,
    variance, min_gh, ground, groundpatch) -> (ground', groundpatch')`` over
    lists of the local shards' row blocks. The stencil inputs exchange
    their halos (:func:`exchange_halo`); bitwise the single-grid sweep.
    ``ValueError`` where S does not divide N."""
    mesh = as_mesh(mesh)
    _rows(config.cell_count, mesh.size, 0)
    tables = _ShardTables(config, mesh.size)

    def f(points, variance, min_gh, ground, groundpatch):
        halos = [exchange_halo(x, mesh) for x in (points, variance, min_gh)]
        out = [detectlib.detect_block(config, tables.rows(s, g.device), p, v, m, g, c)
               for s, p, v, m, g, c in zip(mesh.shards, *halos, ground, groundpatch)]
        return [g for g, _ in out], [c for _, c in out]

    return f


class SpatialOutput(NamedTuple):
    """One spatial step's results, lists over the local shards."""

    ground: list  # (N/S, N) f32 row blocks
    groundpatch: list
    center: tuple  # (center, center_lo): (2,) f32 host tensors
    labels: list  # (P/S,) int32, each shard's points in input order
    outlier: list  # (P/S,) int32


class SpatialStep:
    """``step(g_blocks, c_blocks, center, scan_blocks) -> SpatialOutput``.

    Per local shard, as the JAX spatial step's ``local_step``: gather the
    rows into full layers, ``grid.move`` them (replicated), bin, K2 and
    march its own points (its own ``max_outlier_candidates`` buffer), its
    seven K1 columns (:func:`~groundgrid_torch.core.rasterize.
    raster_partials`); the columns of every shard folded in shard order
    (:func:`~groundgrid_torch.core.rasterize.finish_partials`); detect on
    its rows, halo'd from those layers (:func:`~groundgrid_torch.core.
    detect.detect_block`); the rows gathered; the spiral, a full K3 launch
    per shard (``"replicated"``) or the band relay (``"banded"``,
    ``parallel/spiral_shard.py``); K2 and classify on its own points.

    ``center`` is the host pair ``(center, center_lo)``: with
    ``with_scan_center`` the scans' centers are the new ones (sorted scans
    need it), else the device recurrence's (``grid.index_shift_ds``). Kernel
    launches per scan: K1 x S, K2 x 3 S, K3 x S (one per non-empty band
    when banded). The step reads nothing back to the host; ``fallbacks``
    counts the shards' unsorted chunks of sorted scans (a host read).
    """

    def __init__(self, config: GroundGridConfig, mesh, spiral_mode: str = "replicated",
                 with_scan_center: bool = False):
        _validate(config)
        self.config, self.mesh = config, as_mesh(mesh)
        size = self.mesh.size
        _rows(config.cell_count, size, 0)
        if config.max_points % size:
            raise ValueError(f"max_points {config.max_points} not divisible by {size} shards")
        if spiral_mode not in ("replicated", "banded"):
            raise ValueError(f"spiral_mode {spiral_mode!r}: 'replicated' or 'banded'")
        if config.sorted_scans and not with_scan_center:
            raise ValueError("sorted scans carry the center they were sorted against: "
                             "with_scan_center=True")
        if config.wire_format:
            raise ValueError("the spatial step takes Scan, not the wire format")
        self.with_scan_center = with_scan_center
        plain = config.use_pallas is False
        self._reduce = rasterops.raster_reduce_plain if plain else rasterops.raster_reduce
        self._lookup = lookuplib.lookup_plain if plain else lookuplib.lookup
        self._spiral = (spiralops.spiral_interpolation_plain if plain
                        else spiralops.spiral_interpolation)
        self._banded = None
        if spiral_mode == "banded":
            rings = (spiralops.spiral_interpolation_rings_plain if plain
                     else spiralops.spiral_interpolation_rings)
            self._banded = banded_spiral(config, self.mesh, lambda *a: rings(*a, False))
        self._tables = _ShardTables(config, size)
        self._fallbacks: dict = {}

    @property
    def fallbacks(self) -> int:
        return sum(int(v) for v in self._fallbacks.values())

    def __call__(self, g_blocks, c_blocks, center, scan_blocks) -> SpatialOutput:
        cfg, mesh = self.config, self.mesh
        n, n2 = cfg.cell_count, cfg.cell_count ** 2
        local = list(zip(mesh.shards, mesh.devices))
        if not len(g_blocks) == len(c_blocks) == len(scan_blocks) == len(local):
            raise ValueError(f"need one block and one scan chunk per local shard ({len(local)})")
        scan0 = scan_blocks[0]
        if self.with_scan_center and scan0.center is None:
            raise ValueError("with_scan_center: the scans carry no center")
        if not self.with_scan_center:
            scan0 = scan0._replace(center=None, center_lo=None)
        packed, new_center, new_lo = scan_scalars(cfg, center[0].numpy(), center[1].numpy(),
                                                  scan0)
        on_device: dict = {}  # the scan scalars, shipped once per device

        grounds = [torch.cat(x) for x in mesh.all_gather(list(g_blocks))]
        patches = [torch.cat(x) for x in mesh.all_gather(list(c_blocks))]
        shards, parts = [], []
        for (s, dev), g, c, scan in zip(local, grounds, patches, scan_blocks):
            if dev not in on_device:
                on_device[dev] = scalarlib.view(to_device(packed, dev))
            sc = on_device[dev]
            moved = gridlib.move(cfg, g, c, sc)
            if cfg.sorted_scans:
                x, y, z = scan.px, scan.py, scan.pz
            else:
                x, y, z = tf.transform_points_soa(sc.velo, scan.px, scan.py, scan.pz)
            binning = rasterlib.bin_points(cfg, sc, x, y, scan.rings, scan.valid > 0)
            (old_h,) = self._lookup(binning.cell, [moved[0]], n2)
            outlier, _ = outlierlib.detect_outliers(cfg, sc, *moved, binning, x, y, z, old_h,
                                                    self._lookup)
            accept = binning.inmap & ~binning.ignored & ~outlier
            rb, rz, racc = binning, z, accept
            if not cfg.sorted_scans or cfg.sorted_fallback_check:
                order = torch.argsort(binning.cell, stable=True)
                rb, rz, racc = binning.permute(order), z[order], accept[order]
            if cfg.sorted_scans and cfg.sorted_fallback_check:
                if dev not in self._fallbacks:
                    self._fallbacks[dev] = torch.zeros((), dtype=torch.int64, device=dev)
                self._fallbacks[dev] += (binning.cell[1:] < binning.cell[:-1]).any()
            cols = rasterlib.raster_partials(cfg, rb, rz, racc, sc, self._reduce)
            parts.append(torch.stack(list(cols)))
            shards.append((moved, binning, z, outlier))

        dets = []
        for (s, dev), gathered, (moved, *_) in zip(local, mesh.all_gather(parts), shards):
            raster = rasterlib.finish_partials(cfg, [p.unbind(0) for p in gathered],
                                               on_device[dev])
            rows = _rows(n, mesh.size, s)

            def halo(full):
                return torch.nn.functional.pad(full, (0, 0, HALO, HALO))[
                    rows.start:rows.stop + 2 * HALO]

            dets.append((raster, detectlib.detect_block(
                cfg, self._tables.rows(s, dev), halo(raster.points), halo(raster.variance),
                halo(raster.min_ground_height), moved[0][rows], moved[1][rows])))

        grounds = [torch.cat(x) for x in mesh.all_gather([g for _, (g, _) in dets])]
        patches = [torch.cat(x) for x in mesh.all_gather([c for _, (_, c) in dets])]
        if self._banded is not None:
            grounds, patches = self._banded(grounds, patches, on_device[local[0][1]].base_z)
        else:
            for (_, dev), g, c in zip(local, grounds, patches):
                self._spiral(cfg, g, c, on_device[dev].base_z)

        g_out, c_out, labels, outliers = [], [], [], []
        for (s, _), g, c, (raster, _), (moved, binning, z, outlier) in zip(
                local, grounds, patches, dets, shards):
            gh, var = self._lookup(binning.cell, [g, raster.variance], n2)
            labels.append(classifylib.classify(cfg, binning, z, outlier, gh, var))
            outliers.append(outlier.to(torch.int32))
            rows = _rows(n, mesh.size, s)
            g_out.append(g[rows].clone())
            c_out.append(c[rows].clone())
        return SpatialOutput(g_out, c_out, (gridlib.host_pair(new_center),
                                            gridlib.host_pair(new_lo)), labels, outliers)


def make_spatial_step(config: GroundGridConfig, mesh, spiral_mode: str = "replicated",
                      with_scan_center: bool = False) -> SpatialStep:
    """The per-scan step with one grid split row-wise over ``mesh`` (a device
    list, a :class:`LocalMesh` or a :class:`GroupMesh`): a
    :class:`SpatialStep`. ``ValueError`` where the mesh's S does not divide
    the grid's rows or ``max_points``."""
    return SpatialStep(config, mesh, spiral_mode, with_scan_center)
