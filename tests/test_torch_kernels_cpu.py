"""The plain versions of the port's three kernels against the JAX package's
Pallas kernels (interpret mode) and references, on the CPU.

On CPU tensors each wrapper takes its plain PyTorch version, which is also
what ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the CUDA kernels
to on the card. Bounds are the JAX package's own kernel tests':
K1 sums rtol/atol 1e-5 with exact columns and extrema bitwise
(``tests/test_pallas_raster.py``), K2 bitwise (``tests/test_pallas_lookup.py``),
K3 heights atol 2e-5 / rtol 1e-5 with confidence bitwise
(``tests/test_pallas_spiral.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groundgrid_tpu.config import GroundGridConfig as JConfig
from groundgrid_tpu.core import interpolate as jinterp
from groundgrid_tpu.core import rasterize as jraster
from groundgrid_tpu.ops.pallas_lookup import sorted_lookup
from groundgrid_tpu.ops.pallas_raster import raster_sums
from groundgrid_tpu.ops.pallas_spiral import spiral_interpolation_pallas

from groundgrid_torch.config import GroundGridConfig as TConfig
from groundgrid_torch.ops import lookup, raster, spiral

# the test workers share the CPU: torch's intra-op thread pools would
# oversubscribe it and stall on the many small ops of the plain versions
torch.set_num_threads(1)

N2 = 96 * 96


def _t(a):
    return torch.from_numpy(np.array(a))


def _sequential_sums(cell, vals, n2):
    """np.add.at accumulates in f32 in point order: the kernel's order."""
    sums = np.zeros((len(vals), n2 + 1), np.float32)
    for k, v in enumerate(vals):
        np.add.at(sums[k], cell, v)
    return sums[:, :n2]


def _cells(kind, rng, p=4096, n2=N2):
    if kind == "random":
        return np.sort(rng.integers(0, n2 + 1, p)).astype(np.int32)
    if kind == "one_cell":
        return np.full(p, 4711 % n2, np.int32)
    if kind == "overflow":
        return np.full(p, n2, np.int32)
    if kind == "straddle":
        return np.sort((1024 * rng.integers(0, max(n2 // 1024, 1), p)
                        + rng.integers(-2, 3, p)).clip(0, n2)).astype(np.int32)
    if kind == "long_runs":  # runs of 1 to 2,024 points on random cells, ascending
        lengths = np.array([1, 2, 5, 40, 300, 700, 1024, p - 2072])
        cells = np.sort(rng.choice(n2, lengths.size, replace=False))
        return np.repeat(cells, rng.permutation(lengths)).astype(np.int32)
    raise KeyError(kind)


RASTER_KINDS = ["random", "one_cell", "overflow", "straddle", "long_runs"]


@pytest.mark.parametrize("kind", RASTER_KINDS)
def test_raster_plain_vs_pallas(kind):
    rng = np.random.default_rng(RASTER_KINDS.index(kind))
    cell = _cells(kind, rng)
    p = cell.shape[0]
    ind = [rng.integers(0, 2, p).astype(np.float32) for _ in range(2)]
    vals = [rng.standard_normal(p).astype(np.float32) for _ in range(3)]
    accept = ind[1] > 0
    z = rng.normal(-1.7, 0.5, p).astype(np.float32)
    zmin_col = np.where(accept, z, np.float32(2.0 ** 126))
    zmax_col = np.where(accept, z, -np.float32(2.0 ** 126))
    cols = ind + vals + [zmin_col, zmax_col]
    ops = ["sum"] * 5 + ["min", "max"]
    got = [c.numpy() for c in raster.raster_reduce(_t(cell), [_t(c) for c in cols], ops, N2)]

    want = raster_sums(jnp.asarray(cell), [jnp.asarray(c) for c in ind + vals],
                       [True, True, False, False, False], N2, interpret=True)
    for j in range(5):
        if j < 2:
            np.testing.assert_array_equal(got[j], np.asarray(want[j]), err_msg=f"column {j}")
        else:
            np.testing.assert_allclose(got[j], np.asarray(want[j]), rtol=1e-5, atol=1e-5,
                                       err_msg=f"column {j}")
    # same summation order as the kernel: bitwise the sequential sums
    np.testing.assert_array_equal(np.stack(got[:5]), _sequential_sums(cell, cols[:5], N2))

    # extrema: the JAX path's run-end scan through the Pallas kernel
    for j, combine in ((5, jnp.minimum), (6, jnp.maximum)):
        ends = jraster.seg_end_reduce(jnp.asarray(cell), jnp.asarray(cols[j]), combine)
        (ext,) = raster_sums(jnp.asarray(cell), [ends], [False], N2, interpret=True)
        np.testing.assert_array_equal(got[j], np.asarray(ext), err_msg=f"column {j}")


@pytest.mark.parametrize("p,n", [(1000, 7), (77, 5), (3000, 31)])
def test_raster_plain_any_length_tiny_grids(p, n):
    """No padding multiple, n < 32 grids: bitwise the sequential reference."""
    rng = np.random.default_rng(p)
    n2 = n * n
    cell = np.sort(rng.integers(0, n2 + 1, p)).astype(np.int32)
    v = rng.standard_normal(p).astype(np.float32)
    got = raster.raster_reduce(_t(cell), [_t(v), _t(v), _t(v)], ["sum", "min", "max"], n2)
    np.testing.assert_array_equal(got[0].numpy(), _sequential_sums(cell, [v], n2)[0])
    for out, fn in ((got[1], np.min), (got[2], np.max)):
        want = np.array([fn(v[cell == c]) if (cell == c).any() else 0.0 for c in range(n2)],
                        np.float32)
        np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("kind", ["random", "one_cell", "overflow", "straddle", "unsorted"])
def test_lookup_plain_vs_pallas(kind):
    rng = np.random.default_rng(7)
    if kind == "unsorted":
        cell = rng.permutation(_cells("random", rng))
    else:
        cell = _cells(kind, rng)
    tab_a = rng.standard_normal(N2).astype(np.float32)
    tab_b = rng.standard_normal((96, 96)).astype(np.float32)
    got = lookup.lookup(_t(cell), [_t(tab_a), _t(tab_b)], N2)
    want = sorted_lookup(jnp.asarray(cell), [jnp.asarray(tab_a), jnp.asarray(tab_b)], N2,
                         interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32), np.asarray(w).view(np.int32))


def test_lookup_plain_copies_key_bits():
    """Any 32-bit pattern passes through (the occlusion keys are u32 in f32)."""
    rng = np.random.default_rng(8)
    words = rng.integers(0, 1 << 32, N2, dtype=np.uint64).astype(np.uint32)
    cell = rng.integers(0, N2 + 1, 5000).astype(np.int32)
    (got,) = lookup.lookup(_t(cell), [_t(words.view(np.float32))], N2)
    want = np.concatenate([words, np.zeros(1, np.uint32)])[cell]
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def _spiral_inputs(n, seed):
    rng = np.random.default_rng(seed)
    ground = rng.normal(0, 0.5, (n, n)).astype(np.float32)
    conf = np.zeros((n, n), np.float32)
    mask = rng.random((n, n)) < 0.4
    conf[mask] = rng.uniform(0.0, 1.0, mask.sum()).astype(np.float32)
    return ground, conf


@pytest.mark.parametrize("kw,seed", [
    ({"dimension": 40.0, "resolution": 0.5}, 0),
    ({"dimension": 40.0, "resolution": 0.5}, 1),
    ({"dimension": 70.0, "resolution": 0.5, "ray_steps": 104}, 7),  # multi-tier (n=140)
    ({"dimension": 12.0, "resolution": 0.5, "ray_steps": 24}, 3),  # n = 24 < 32
])
def test_spiral_plain_vs_pallas_and_xla(kw, seed):
    jcfg, tcfg = JConfig(max_points=16384, **kw), TConfig(max_points=16384, **kw)
    ground, conf = _spiral_inputs(jcfg.cell_count, seed)
    tg, tc = _t(ground), _t(conf)
    g, c = spiral.spiral_interpolation(tcfg, tg, tc, 0.37)
    assert g is tg and c is tc  # in place, as the JAX step donated the layers
    g_x, c_x = jinterp.spiral_interpolation(jcfg, jnp.asarray(ground), jnp.asarray(conf), 0.37)
    refs = [(g_x, c_x)]
    if jcfg.cell_count >= 32:
        refs.append(spiral_interpolation_pallas(jcfg, jnp.asarray(ground), jnp.asarray(conf),
                                                0.37, interpret=True))
    for g_r, c_r in refs:
        np.testing.assert_allclose(g.numpy(), np.asarray(g_r), atol=2e-5, rtol=1e-5)
        np.testing.assert_array_equal(c.numpy(), np.asarray(c_r))
