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
so every rank of a group is bitwise the local mesh with the same S. The
per-shard code is a generator that yields at each collective
(``parallel/collectives.py``), the counterpart of the JAX ``shard_map``
body.

Captured: :func:`make_spatial_step` and :func:`make_sharded_detect` return
the captured step and detect (:class:`CapturedSpatialStep`,
:class:`CapturedDetect`), the counterparts of the JAX package's ``jax.jit``
over ``shard_map``, bitwise the eager :class:`SpatialStep` and
:class:`ShardedDetect`. Where every local shard is on one device
(``["cuda:0"] * S``) the collectives are copies on that device and the whole
step is one CUDA graph (``"inside"``). Elsewhere (a mesh across cards, a
``GroupMesh`` rank) each device captures one graph per segment between two
collectives, and the collectives run between the replays (``"between"``):
a copy to another card waits on that card's stream, which a capture on one
stream cannot hold, and NCCL calls captured inside a rank's graph were not
faster beyond the spread (PERF.md). :func:`default_collectives` makes that
choice from the mesh; there is no other.

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
from groundgrid_torch.parallel.collectives import CapturedShards, Gather, drive
from groundgrid_torch.parallel.sharding import _place, make_mesh
from groundgrid_torch.parallel.spiral_shard import BandRelay
from groundgrid_torch.pipeline import Scan, _validate, scan_scalars, scan_tensors, to_device


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


def _edges(block):
    """A row block's ``HALO`` top and bottom rows, stacked."""
    return torch.cat([block[:HALO], block[-HALO:]])


def _halo(s: int, size: int, block, edges):
    """Shard ``s``'s block with its neighbours' edge rows from ``edges``
    (every shard's :func:`_edges`); zeros at the grid's top and bottom."""
    zeros = torch.zeros((HALO, block.shape[1]), dtype=block.dtype, device=block.device)
    above = edges[s - 1][HALO:] if s > 0 else zeros
    below = edges[s + 1][:HALO] if s < size - 1 else zeros
    return torch.cat([above, block, below])


def exchange_halo(blocks, mesh) -> list:
    """Each local row block with ``HALO`` ghost rows from its grid
    neighbours above and below, ``(rows + 2 HALO, N)``; zeros at the grid's
    top and bottom edges (no wraparound), as the JAX ``_exchange_halo``.
    One ``all_gather`` of every block's edge rows."""
    mesh = as_mesh(mesh)
    got = mesh.all_gather([_edges(b) for b in blocks])
    return [_halo(s, mesh.size, b, e) for s, b, e in zip(mesh.shards, blocks, got)]


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


def default_collectives(mesh) -> str:
    """``"inside"`` the capture where every shard is on one device of this
    process (a ``LocalMesh``), else ``"between"`` the graphs
    (``parallel/collectives.py``)."""
    mesh = as_mesh(mesh)
    return "inside" if isinstance(mesh, LocalMesh) and len(set(mesh.devices)) == 1 else "between"


def _one_kind(mesh) -> None:
    if len({d.type for d in mesh.devices}) > 1:
        raise ValueError(f"a captured mesh runs on one kind of device, not {mesh.devices}")


def _static_blocks(held, blocks):
    """Static copies of ``blocks`` (allocated like them at first use), with
    ``blocks`` copied in unless they are the static ones."""
    if held is None:
        held = [torch.empty_like(b, memory_format=torch.contiguous_format) for b in blocks]
    for dst, src in zip(held, blocks, strict=True):
        if src is not dst:
            dst.copy_(src)
    return held


class ShardedDetect:
    """``f(points, variance, min_gh, ground, groundpatch) -> (ground',
    groundpatch')`` over lists of the local shards' row blocks, eagerly:
    each shard's :meth:`body` exchanges its stencil inputs' halos
    (:func:`exchange_halo`) and runs ``detect_block``; bitwise the
    single-grid sweep."""

    def __init__(self, config: GroundGridConfig, mesh):
        self.config, self.mesh = config, as_mesh(mesh)
        _rows(config.cell_count, self.mesh.size, 0)
        self._tables = _ShardTables(config, self.mesh.size)

    def body(self, s, device, points, variance, min_gh, ground, groundpatch):
        """Shard ``s``'s body (``parallel/collectives.py``)."""
        inputs = (points, variance, min_gh)
        got = yield Gather(tuple(_edges(x) for x in inputs))
        halos = [_halo(s, self.mesh.size, x, e) for x, e in zip(inputs, got)]
        return detectlib.detect_block(self.config, self._tables.rows(s, device), *halos, ground,
                                      groundpatch)

    def bodies(self, blocks) -> list:
        return [self.body(s, dev, *b) for s, dev, *b in zip(self.mesh.shards, self.mesh.devices,
                                                             *blocks)]

    def __call__(self, points, variance, min_gh, ground, groundpatch):
        out = drive(self.mesh, self.bodies((points, variance, min_gh, ground, groundpatch)))
        return [g for g, _ in out], [c for _, c in out]


class CapturedDetect:
    """:class:`ShardedDetect` captured (``parallel/collectives.py``), the
    counterpart of the jitted JAX sharded detect: the five inputs' blocks
    are copied into static blocks, the bodies replay, and the outputs come
    back as clones."""

    def __init__(self, config: GroundGridConfig, mesh):
        self.eager = ShardedDetect(config, mesh)
        self.mesh = self.eager.mesh
        _one_kind(self.mesh)
        self._shards = CapturedShards(self.mesh, default_collectives(self.mesh))
        self._inputs: list | None = None  # static blocks, per input

    @property
    def captured(self) -> bool:
        return self._shards.captured

    def __call__(self, *blocks):
        held = self._inputs or [None] * len(blocks)
        self._inputs = [_static_blocks(h, b) for h, b in zip(held, blocks, strict=True)]
        out = self._shards(lambda: self.eager.bodies(self._inputs))
        return [g.clone() for g, _ in out], [c.clone() for _, c in out]


def make_sharded_detect(config: GroundGridConfig, mesh):
    """A row-sharded drop-in for ``detect_ground_patches``: ``f(points,
    variance, min_gh, ground, groundpatch) -> (ground', groundpatch')`` over
    lists of the local shards' row blocks; the stencil inputs exchange
    their halos (:func:`exchange_halo`); bitwise the single-grid sweep.
    Captured (:class:`CapturedDetect`, its collectives placed by
    :func:`default_collectives`); :class:`ShardedDetect` is the eager one.
    ``ValueError`` where S does not divide N."""
    return CapturedDetect(config, mesh)


class SpatialOutput(NamedTuple):
    """One spatial step's results, lists over the local shards."""

    ground: list  # (N/S, N) f32 row blocks
    groundpatch: list
    center: tuple  # (center, center_lo): (2,) f32 host tensors
    labels: list  # (P/S,) int32, each shard's points in input order
    outlier: list  # (P/S,) int32


class SpatialStep:
    """``step(g_blocks, c_blocks, center, scan_blocks) -> SpatialOutput``,
    run eagerly: the reference the captured step
    (:class:`CapturedSpatialStep`) is held against.

    Per local shard, as the JAX spatial step's ``local_step`` (its
    :meth:`body`): gather the rows into full layers, ``grid.move`` them
    (replicated), bin, K2 and march its own points (its own
    ``max_outlier_candidates`` buffer), its seven K1 columns
    (:func:`~groundgrid_torch.core.rasterize.raster_partials`); the columns
    of every shard folded in shard order
    (:func:`~groundgrid_torch.core.rasterize.finish_partials`); detect on
    its rows, halo'd from those layers (:func:`~groundgrid_torch.core.
    detect.detect_block`); the rows gathered; the spiral, a full K3 launch
    per shard (``"replicated"``) or the band relay (``"banded"``,
    ``parallel/spiral_shard.py``); K2 and classify on its own points.

    ``center`` is the host pair ``(center, center_lo)``: with
    ``with_scan_center`` the scans' centers are the new ones (sorted scans
    need it), else the host center recurrence's (``grid.index_shift_ds``).
    The host packs every per-scan value into the scan scalars, shipped once
    per device. Kernel launches per scan: K1 x S, K2 x 3 S, K3 x S (one per
    non-empty band when banded). The step reads nothing back to the host;
    ``fallbacks`` counts the shards' unsorted chunks of sorted scans (a
    host read).
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
        self._band = None
        if spiral_mode == "banded":
            rings = (spiralops.spiral_interpolation_rings_plain if plain
                     else spiralops.spiral_interpolation_rings)
            self._band = BandRelay(config, size, lambda *a: rings(*a, False))
        self._tables = _ShardTables(config, size)
        self._fallbacks: dict = {}

    @property
    def fallbacks(self) -> int:
        return sum(int(v) for v in self._fallbacks.values())

    def scalars(self, center, scan_blocks):
        """Host: the scan scalars and the new center pair (``pipeline.
        scan_scalars``) of the scan whose chunks are ``scan_blocks``."""
        if len(scan_blocks) != len(self.mesh.shards):
            raise ValueError(f"need one scan chunk per local shard ({len(self.mesh.shards)})")
        scan0 = scan_blocks[0]
        if self.with_scan_center and scan0.center is None:
            raise ValueError("with_scan_center: the scans carry no center")
        if not self.with_scan_center:
            scan0 = scan0._replace(center=None, center_lo=None)
        return scan_scalars(self.config, center[0].numpy(), center[1].numpy(), scan0)

    def body(self, s, dev, g_block, c_block, points, sc, write_blocks: bool = False):
        """Shard ``s``'s step on ``dev`` (``parallel/collectives.py``), from its
        row blocks, its chunk's point tensors (``pipeline.scan_tensors``) and
        the scan scalars' views on ``dev``. Returns its new row blocks (clones,
        or with ``write_blocks`` ``g_block`` and ``c_block`` rewritten), labels
        and outlier flags."""
        cfg, size = self.config, self.mesh.size
        n, n2 = cfg.cell_count, cfg.cell_count ** 2
        rows = _rows(n, size, s)
        grounds, patches = yield Gather((g_block, c_block))
        moved = gridlib.move(cfg, torch.cat(grounds), torch.cat(patches), sc)
        x, y, z, rings, valid = points
        if not cfg.sorted_scans:
            x, y, z = tf.transform_points_soa(sc.velo, x, y, z)
        binning = rasterlib.bin_points(cfg, sc, x, y, rings, valid > 0)
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

        (gathered,) = yield Gather((torch.stack(list(cols)),))
        raster = rasterlib.finish_partials(cfg, [p.unbind(0) for p in gathered], sc)

        def halo(full):
            return torch.nn.functional.pad(full, (0, 0, HALO, HALO))[
                rows.start:rows.stop + 2 * HALO]

        det = detectlib.detect_block(
            cfg, self._tables.rows(s, dev), halo(raster.points), halo(raster.variance),
            halo(raster.min_ground_height), moved[0][rows], moved[1][rows])
        grounds, patches = yield Gather(det)
        g, c = torch.cat(grounds), torch.cat(patches)
        if self._band is not None:
            g, c = yield from self._band.shard(s, g, c, sc.base_z)
        else:
            self._spiral(cfg, g, c, sc.base_z)

        gh, var = self._lookup(binning.cell, [g, raster.variance], n2)
        labels = classifylib.classify(cfg, binning, z, outlier, gh, var)
        if write_blocks:
            g_block.copy_(g[rows])
            c_block.copy_(c[rows])
            g_rows, c_rows = g_block, c_block
        else:
            g_rows, c_rows = g[rows].clone(), c[rows].clone()
        return g_rows, c_rows, labels, outlier.to(torch.int32)

    def bodies(self, g_blocks, c_blocks, points, scalars, write_blocks: bool = False) -> list:
        """Every local shard's :meth:`body`; ``scalars`` maps each device to
        the scan scalars' views there."""
        if not len(g_blocks) == len(c_blocks) == len(points) == len(self.mesh.shards):
            raise ValueError(f"need one block and one scan chunk per local shard "
                             f"({len(self.mesh.shards)})")
        return [self.body(s, dev, g, c, p, scalars[dev], write_blocks)
                for s, dev, g, c, p in zip(self.mesh.shards, self.mesh.devices, g_blocks,
                                           c_blocks, points)]

    def __call__(self, g_blocks, c_blocks, center, scan_blocks) -> SpatialOutput:
        packed, new_center, new_lo = self.scalars(center, scan_blocks)
        scalars = {dev: scalarlib.view(to_device(packed, dev))
                   for dev in dict.fromkeys(self.mesh.devices)}
        out = drive(self.mesh, self.bodies(g_blocks, c_blocks,
                                           [scan_tensors(scan) for scan in scan_blocks], scalars))
        g_out, c_out, labels, outliers = (list(x) for x in zip(*out))
        return SpatialOutput(g_out, c_out, (gridlib.host_pair(new_center),
                                            gridlib.host_pair(new_lo)), labels, outliers)


class CapturedSpatialStep:
    """The spatial step captured, the counterpart of the JAX spatial step's
    ``jax.jit`` over ``shard_map``: the eager :class:`SpatialStep`'s bodies
    run under ``parallel/collectives.py``'s :class:`~groundgrid_torch.
    parallel.collectives.CapturedShards` (placed by
    :func:`default_collectives`: one graph a scan on a one-device mesh).

    Static buffers, as ``pipeline.CapturedStep`` holds: each local shard's
    two row blocks (a state's blocks are copied in unless they are the
    static ones: :meth:`install`) and its (5, P/S) point rows, the scan
    scalars per device (filled from pinned host memory), and the outputs.
    A call copies its inputs in, replays, and returns the static blocks
    (the new layers, written in place) with the new host center pair, and
    *clones* of the labels and outlier flags. The first call runs the
    bodies eagerly (the lazy set-up: detect tables, band masks, the
    fallback counter, the kernels' build, NCCL's communicators); the
    capture follows it; a capture that fails raises, and nothing falls back
    to the eager step. On the CPU the bodies run where the card replays.
    Only scans with their center (``with_scan_center``): the host center
    recurrence belongs to the eager step.
    """

    def __init__(self, config: GroundGridConfig, mesh, spiral_mode: str = "replicated"):
        self.eager = SpatialStep(config, mesh, spiral_mode, with_scan_center=True)
        self.config, self.mesh = config, self.eager.mesh
        _one_kind(self.mesh)
        self._shards = CapturedShards(self.mesh, default_collectives(self.mesh))
        self._blocks: tuple | None = None  # static (ground, groundpatch) row blocks
        self._points: list | None = None  # static point rows per local shard, body order
        self._scalars: dict | None = None  # static scan scalars per device

    @property
    def fallbacks(self) -> int:
        return self.eager.fallbacks

    @property
    def collectives(self) -> str:
        """``"inside"`` the one graph or ``"between"`` the segments."""
        return self._shards.collectives

    @property
    def captured(self) -> bool:
        return self._shards.captured

    @property
    def capture_seconds(self) -> float | None:
        return self._shards.capture_seconds

    @property
    def pool_bytes(self) -> int | None:
        return self._shards.pool_bytes

    def install(self, g_blocks, c_blocks) -> tuple[list, list]:
        """The static row blocks (allocated from the first state's), with
        ``g_blocks`` and ``c_blocks`` copied in unless they are the static
        ones."""
        held = self._blocks or (None, None)
        self._blocks = (_static_blocks(held[0], g_blocks), _static_blocks(held[1], c_blocks))
        return self._blocks

    def _allocate(self, points) -> None:
        """The static point rows (one 32-bit buffer per shard, its rows
        viewed as their dtypes) and scan scalars per device."""
        self._points = []
        for p in points:
            rows = torch.empty((len(p), p[0].shape[0]), dtype=torch.float32, device=p[0].device)
            self._points.append(tuple(r.view(t.dtype) for r, t in zip(rows.unbind(0), p)))
        self._scalars = {dev: torch.empty((scalarlib.SIZE,), dtype=torch.float32, device=dev)
                         for dev in dict.fromkeys(self.mesh.devices)}

    def __call__(self, g_blocks, c_blocks, center, scan_blocks) -> SpatialOutput:
        if scan_blocks and scan_blocks[0].center is None:
            raise ValueError("the captured spatial step takes scans with their center; step "
                             "center-less scans with SpatialStep")
        packed, new_center, new_lo = self.eager.scalars(center, scan_blocks)
        g_static, c_static = self.install(g_blocks, c_blocks)
        points = [scan_tensors(scan) for scan in scan_blocks]
        if self._points is None:
            self._allocate(points)
        for dst, src in zip(self._points, points, strict=True):
            for d, t in zip(dst, src, strict=True):
                d.copy_(t)
        host = torch.from_numpy(packed)
        if any(dev.type == "cuda" for dev in self._scalars):
            host = host.pin_memory()  # a fresh buffer: no queued copy reads it again
        for buf in self._scalars.values():
            buf.copy_(host, non_blocking=True)
        views = {dev: scalarlib.view(buf) for dev, buf in self._scalars.items()}
        out = self._shards(lambda: self.eager.bodies(g_static, c_static, self._points, views,
                                                     write_blocks=True))
        return SpatialOutput(list(g_static), list(c_static),
                             (gridlib.host_pair(new_center), gridlib.host_pair(new_lo)),
                             [o[2].clone() for o in out], [o[3].clone() for o in out])


def make_spatial_step(config: GroundGridConfig, mesh, spiral_mode: str = "replicated",
                      with_scan_center: bool = False):
    """The per-scan step with one grid split row-wise over ``mesh`` (a device
    list, a :class:`LocalMesh` or a :class:`GroupMesh`): captured
    (:class:`CapturedSpatialStep`, the counterpart of the JAX spatial step's
    ``jax.jit``); the eager :class:`SpatialStep`, the reference, with
    ``with_scan_center=False`` (its host center recurrence belongs to the
    eager step) and with ``config.use_pallas`` False (whose plain K3 is a
    Python ring loop). ``ValueError`` where the mesh's S does not divide
    the grid's rows or ``max_points``."""
    if not with_scan_center or config.use_pallas is False:
        return SpatialStep(config, mesh, spiral_mode, with_scan_center)
    return CapturedSpatialStep(config, mesh, spiral_mode)
