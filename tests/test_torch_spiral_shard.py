"""The port's banded spiral relay (``parallel/spiral_shard.py``) and K3's
ring range (``ops/spiral.py spiral_interpolation_rings``) on the CPU.

The bands of ``ring_bands`` equal the JAX function's; the plain ring-range
walks of the bands, run in order, are bitwise the full plain sweep; the
relay over ``["cpu"] * S`` is bitwise the port's full sweep and agrees with
the JAX relay under ``shard_map`` on the 8-device CPU mesh within the
port's plain-vs-XLA spiral bound (heights atol 2e-5 / rtol 1e-5,
confidence bitwise; ``tests/test_torch_kernels_cpu.py``). At 1200^2 the
relay is held to the port's full sweep only; the JAX relay there takes ~26
s on this mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from groundgrid_tpu.config import GroundGridConfig as JConfig
from groundgrid_tpu.parallel.spiral_shard import banded_spiral as j_banded_spiral
from groundgrid_tpu.parallel.spiral_shard import ring_bands as j_ring_bands

from groundgrid_torch.config import GroundGridConfig
from groundgrid_torch.ops import spiral
from groundgrid_torch.parallel.spatial import LocalMesh
from groundgrid_torch.parallel.spiral_shard import (band_ranges, banded_spiral, pack_ring,
                                                    ring_bands, unpack_ring)

torch.set_num_threads(1)

# tests/test_spiral_shard.py's geometry: 40 m at 0.5 m, n = 80
KW = dict(dimension=40.0, resolution=0.5, max_points=4096, ray_steps=64)


def _layers(n, seed):
    """tests/test_spiral_shard.py's random layers: zeros and 1e-7s sprinkled
    into the confidence."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, n)).astype(np.float32)
    c = rng.uniform(0.0, 1.0, size=(n, n)).astype(np.float32)
    c[rng.random((n, n)) < 0.1] = 0.0
    c[rng.random((n, n)) < 0.1] = 1e-7
    return g, c


@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
@pytest.mark.parametrize("kw", [dict(dimension=12.0, resolution=0.5), dict(KW),
                                dict(dimension=120.0, resolution=0.1)], ids=["n24", "n80", "n1200"])
def test_ring_bands_equal_jax(kw, n_shards):
    """The port's copy equals the JAX function; its ring ranges cover 1 ..
    center-1 in order, empties last."""
    cfg, jcfg = GroundGridConfig(**kw), JConfig(**kw)
    got, want = ring_bands(cfg, n_shards), j_ring_bands(jcfg, n_shards)
    assert len(got) == len(want) == n_shards
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    ranges = band_ranges(cfg, n_shards)
    c = cfg.center_cell
    assert [list(range(d0, d1 + 1)) for d0, d1 in ranges] == [list(c - b) for b in got]


@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_plain_bands_in_order_are_the_full_sweep(n_shards):
    """Plain ring-range walks of the bands, in order on the same layers, are
    bitwise the full plain sweep (the first band seeds the center)."""
    cfg = GroundGridConfig(**KW)
    g, c = _layers(cfg.cell_count, 3)
    want = spiral.spiral_interpolation_plain(cfg, torch.from_numpy(g.copy()),
                                             torch.from_numpy(c.copy()), 1.25)
    tg, tc = torch.from_numpy(g.copy()), torch.from_numpy(c.copy())
    for k, (d0, d1) in enumerate(band_ranges(cfg, n_shards)):
        out = spiral.spiral_interpolation_rings(cfg, tg, tc, 1.25, d0, d1, seed_center=k == 0)
        assert out[0] is tg and out[1] is tc  # in place
    assert torch.equal(tg, want[0]) and torch.equal(tc, want[1])


def test_ring_range_rejects_bad_ranges():
    cfg = GroundGridConfig(**KW)
    m = cfg.center_cell
    g, c = torch.zeros(80, 80), torch.zeros(80, 80)
    for d0, d1, seed in ((0, 3, False), (5, 2, False), (1, m, False), (2, 5, True)):
        with pytest.raises(ValueError):
            spiral.spiral_interpolation_rings(cfg, g, c, 0.0, d0, d1, seed)
    # an empty range walks nothing; from ring 1 it may still seed the center
    spiral.spiral_interpolation_rings(cfg, g, c, 0.5, 4, 3)
    assert not g.any()
    spiral.spiral_interpolation_rings(cfg, g, c, 0.5, 1, 0, True)
    assert float(g[m, m]) == 0.5 and float(c[m, m]) == 1.0 and int((g != 0).sum()) == 1


def test_pack_unpack_ring_round_trip():
    cfg = GroundGridConfig(**KW)
    n, c2 = cfg.cell_count, 2 * cfg.center_cell
    g, c = (torch.from_numpy(a) for a in _layers(n, 5))
    pkg = pack_ring(g, c, 20, c2)
    assert pkg.shape == (8, n)
    g2, c2_ = torch.zeros(n, n), torch.zeros(n, n)
    unpack_ring(g2, c2_, pkg, 20, c2)
    for a, b in ((g2, g), (c2_, c)):
        for idx in ((20,), (c2 - 20,), (slice(None), 20), (slice(None), c2 - 20)):
            assert torch.equal(a[idx], b[idx])
    assert int((g2 != 0).sum()) <= 4 * n


def _jax_banded(jcfg, n_shards, g, c, base_z):
    mesh = Mesh(np.array(jax.devices()[:n_shards]), ("space",))
    f = j_banded_spiral(jcfg, "space", n_shards)
    sharded = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(P(), P(), P()),
                                    out_specs=(P(), P()), check_vma=False))
    out = sharded(jnp.asarray(g), jnp.asarray(c), jnp.asarray(base_z, jnp.float32))
    return [np.asarray(a) for a in out]


@pytest.mark.parametrize("kw,n_shards,base_z", [
    (KW, 2, 1.25), (KW, 8, 1.25),
    (dict(resolution=0.1, max_points=4096, ray_steps=128), 8, -0.4),
], ids=["n80-S2", "n80-S8", "n1200-S8"])
def test_banded_spiral_on_cpu_mesh(kw, n_shards, base_z):
    """The relay on ``["cpu"] * S``: every shard's result is bitwise the
    port's full sweep; at n = 80 also within the plain-vs-XLA bound of the
    JAX relay (at 1200^2 that takes ~26 s here: the card's phase 2 holds
    K3's bands against one launch there)."""
    cfg, jcfg = GroundGridConfig(**kw), JConfig(**kw)
    g, c = _layers(cfg.cell_count, 3 if cfg.cell_count == 80 else 11)
    want = spiral.spiral_interpolation(cfg, torch.from_numpy(g.copy()),
                                       torch.from_numpy(c.copy()), base_z)
    mesh = LocalMesh(["cpu"] * n_shards)
    f = banded_spiral(cfg, mesh)
    grounds, patches = f([torch.from_numpy(g.copy()) for _ in range(n_shards)],
                         [torch.from_numpy(c.copy()) for _ in range(n_shards)],
                         torch.tensor(base_z, dtype=torch.float32))
    assert len(grounds) == len(patches) == n_shards
    for tg, tc in zip(grounds, patches):
        assert torch.equal(tg, want[0]) and torch.equal(tc, want[1])
    if cfg.cell_count > 80:
        return
    jg, jc = _jax_banded(jcfg, n_shards, g, c, base_z)
    np.testing.assert_allclose(grounds[0].numpy(), jg, atol=2e-5, rtol=1e-5)
    np.testing.assert_array_equal(patches[0].numpy(), jc)
