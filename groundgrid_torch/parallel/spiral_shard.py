"""Sharded spiral interpolation: the exact annular-band relay over a mesh.

The torch counterpart of ``groundgrid_tpu/parallel/spiral_shard.py``. The
spiral sweep (``GroundSegmentation.cpp:398-465``) is the one sequential
stage: ring D's blend reads ring D-1's *final* values, so the inner -> outer
chain cannot be reordered. What can be split exactly is the work: the
walked rings are cut into S contiguous annular bands (:func:`ring_bands`),
one per shard; shard s walks its band only, after it receives band s-1's
outermost ring (:func:`pack_ring`, the (8, N) rows and columns of that ring
in both layers).

Each band is one ring-range launch of K3
(``ops/spiral.py spiral_interpolation_rings``; its plain version on the
CPU), which walks the band as the whole sweep walks it: the relay is
bitwise one full launch on one device. The JAX relay runs the XLA ring scan
instead (its ``_band_scan``); here the plain sweep takes over a second a
scan at 364^2 on the card, so K3 is the spiral off the CPU in every mode.

The relay is sequential: shard s cannot start before shard s-1 is done, so
the wall time is the sweep's plus S-1 hand-offs. What it splits is the
sweep's work per shard, not its latency.
"""

from __future__ import annotations

import numpy as np
import torch

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.ops import spiral as spiralops
from groundgrid_torch.parallel.collectives import Relay, Sum, drive


def ring_bands(config: GroundGridConfig, n_shards: int) -> list[np.ndarray]:
    """Partition the walked rings (row indices center-1 .. 1, inner -> outer)
    into ``n_shards`` contiguous descending bands (some may be empty on tiny
    grids, at the end). A copy of the JAX package's function."""
    c_idx = config.center_cell
    rings = np.arange(c_idx - 1, 0, -1, dtype=np.int32)
    return [np.asarray(b, np.int32) for b in np.array_split(rings, n_shards)]


def band_ranges(config: GroundGridConfig, n_shards: int) -> list[tuple[int, int]]:
    """Each band of :func:`ring_bands` as the ring radii ``(d_first,
    d_last)`` it walks (radius D = center - row); an empty band is
    ``(d, d - 1)``."""
    out, d = [], 1
    for band in ring_bands(config, n_shards):
        out.append((d, d + len(band) - 1))
        d += len(band)
    return out


def pack_ring(ground, groundpatch, i: int, n2c: int):
    """(8, N) bundle of ring row ``i``'s rows and columns from both layers:
    rows i and 2c - i, columns i and 2c - i (``n2c`` = 2c)."""
    j = n2c - i
    g, c = ground, groundpatch
    return torch.stack([g[i], g[j], g[:, i], g[:, j], c[i], c[j], c[:, i], c[:, j]])


def unpack_ring(ground, groundpatch, pkg, i: int, n2c: int):
    """Write a :func:`pack_ring` bundle back, in place, in the JAX order."""
    j = n2c - i
    ground[i], ground[j] = pkg[0], pkg[1]
    ground[:, i], ground[:, j] = pkg[2], pkg[3]
    groundpatch[i], groundpatch[j] = pkg[4], pkg[5]
    groundpatch[:, i], groundpatch[:, j] = pkg[6], pkg[7]
    return ground, groundpatch


def _ring_ids(n: int, c_idx: int, device) -> torch.Tensor:
    """(N, N) int32 ``min(x, y, 2c - x, 2c - y)``: the row index of each
    cell's ring (center - D), negative past the last row of the walk."""
    idx = torch.arange(n, dtype=torch.int32, device=device)
    ii, jj = idx[:, None], idx[None, :]
    return torch.minimum(torch.minimum(ii, jj), torch.minimum(2 * c_idx - ii, 2 * c_idx - jj))


class BandRelay:
    """The banded sweep's per-shard body over ``size`` shards.

    :meth:`shard` is shard ``s``'s body (a generator, ``parallel/
    collectives.py``) on its full copies of both layers, all equal on entry;
    ``base_z``, the center's seed, is a 0-dim float32 tensor on the layers'
    device (K3 reads it there). Every shard seeds the center; shard s walks
    its band on its copy (``rings_fn``, by default
    :func:`spiral_interpolation_rings <groundgrid_torch.ops.spiral.
    spiral_interpolation_rings>`) after it receives band s-1's boundary ring
    (a :class:`~groundgrid_torch.parallel.collectives.Relay`: a copy on a
    local mesh, a ``broadcast`` from rank s on a group). The disjoint annuli
    are then recombined as the JAX relay does: the sum over the shards of
    each shard's own cells (zeros elsewhere; a
    :class:`~groundgrid_torch.parallel.collectives.Sum`, one ``all_reduce``
    on a group), and the pre-sweep values outside the walked cells. The
    masked sum is exact in any order, but -0.0 comes back as +0.0 where S >
    1, as in JAX. Returns a fresh pair.
    """

    def __init__(self, config: GroundGridConfig, size: int, rings_fn=None):
        self.config, self.size = config, size
        self.rings_fn = spiralops.spiral_interpolation_rings if rings_fn is None else rings_fn
        self.ranges = band_ranges(config, size)
        self._masks: dict = {}  # per device: (walked, mine per shard)

    def masks(self, device):
        """(walked, mine per shard) on ``device``, built at first use."""
        if device not in self._masks:
            c_idx = self.config.center_cell
            rid = _ring_ids(self.config.cell_count, c_idx, device)
            walked = (rid >= 1) & (rid <= c_idx - 1)  # not the center (ring c_idx)
            mine = [walked & (rid >= c_idx - d1) & (rid <= c_idx - d0) for d0, d1 in self.ranges]
            self._masks[device] = (walked, mine)
        return self._masks[device]

    def shard(self, s: int, ground, groundpatch, base_z):
        cfg = self.config
        c_idx, n = cfg.center_cell, cfg.cell_count
        n2c = 2 * c_idx
        ground[c_idx, c_idx].copy_(base_z)  # on the device: no host value, no sync
        groundpatch[c_idx, c_idx].fill_(1.0)
        pre = ground.clone(), groundpatch.clone()
        for b, (d0, d1) in enumerate(self.ranges):
            if b == s and d0 <= d1:
                self.rings_fn(cfg, ground, groundpatch, base_z, d0, d1)
            if b < self.size - 1 and d0 <= d1:
                i_b = c_idx - d1  # the band's outermost ring
                pkg = pack_ring(ground, groundpatch, i_b, n2c) if b == s else None
                got = yield Relay(pkg, b, (8, n))
                if s == b + 1:
                    unpack_ring(ground, groundpatch, got, i_b, n2c)
        walked, mine = self.masks(ground.device)
        total = yield Sum(torch.stack([torch.where(mine[s], ground, 0.0),
                                       torch.where(mine[s], groundpatch, 0.0)]))
        return torch.where(walked, total[0], pre[0]), torch.where(walked, total[1], pre[1])


def banded_spiral(config: GroundGridConfig, mesh, rings_fn=None):
    """Build the banded sweep over ``mesh``'s shards.

    ``mesh``: a ``parallel.spatial`` mesh (:class:`~groundgrid_torch.parallel.
    spatial.LocalMesh` or :class:`~groundgrid_torch.parallel.spatial.
    GroupMesh`). Returns ``f(grounds, patches, base_z) -> (grounds,
    patches)``, one full (N, N) copy of each layer per local shard, all
    equal on entry, each shard running :meth:`BandRelay.shard` (``base_z`` a
    0-dim float32 tensor, copied to each shard's device). Returns a fresh
    pair per local shard.
    """
    relay = BandRelay(config, mesh.size, rings_fn)

    def f(grounds, patches, base_z):
        out = drive(mesh, [relay.shard(s, g, c, base_z.to(g.device))
                           for s, g, c in zip(mesh.shards, grounds, patches)])
        return [g for g, _ in out], [c for _, c in out]

    return f
