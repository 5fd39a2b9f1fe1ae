"""K12's function, the grid move (``ops/move.py``), against the JAX package
on the CPU.

On the CPU ``ops.move.move`` takes its plain version, ``core/grid.py
move``: the layers rolled by the whole-cell shift in the scan scalars and
the exposed cells reset to the base plane (``ground = -z_base``,
``groundpatch = 0``). It is held bitwise to the JAX package's eager
``groundgrid_tpu/core/grid.py move`` given the new centre, on inputs made
with numpy from a seed: shifts of 0, +-1, +-37, +-(n - 1), +-n and beyond,
mixed signs, NaN and -0.0 in the layers, a flat base plane whose height is
+0.0 (exposed ground -0.0), and a batch of three grids with different
shifts, each row bitwise its own JAX move. The kernel itself runs only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2), held
bitwise to the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groundgrid_tpu.config import GroundGridConfig as JConfig
from groundgrid_tpu.core import grid as jgrid

from groundgrid_torch.config import GroundGridConfig as TConfig
from groundgrid_torch.core import grid as tgrid
from groundgrid_torch.core import scalars as tscalars
from groundgrid_torch.ops import move

torch.set_num_threads(1)

GEOMETRIES = [(40.0, 0.5), (120.0, 0.33)]  # 80^2 and the default 364^2


def shifts(n):
    return [(0, 0), (1, 0), (0, -1), (-1, 1), (37, -37), (-37, 5), (n - 1, 0), (0, 1 - n),
            (n, 2), (-n, -n), (n + 9, -3), (-500, 700)]


def layers(rng, n):
    """Random ground and confidence with NaN (a quiet one and one with a
    payload) and -0.0 words, which the roll must move bit for bit."""
    g = rng.normal(-1.7, 0.4, (n, n)).astype(np.float32)
    c = rng.uniform(0.0, 1.0, (n, n)).astype(np.float32)
    g[0, :3] = np.nan
    g.view(np.int32)[n // 2, n // 3] = 0x7FC01234
    g[1, 1] = -0.0
    c[2, n - 1] = -0.0
    c[n - 1, 0] = np.nan
    return g, c


def base_map(rng, flat=False):
    """``t_base_map``: a tilted plane, or a flat one at height 0 (its
    ``z_base`` is +0.0 on every cell, so an exposed cell's ground is -0.0)."""
    tb = np.eye(4, dtype=np.float32)
    if not flat:
        tb[2, 0], tb[2, 1], tb[2, 3] = rng.normal(0, 0.02, 2).astype(np.float32).tolist() + [
            np.float32(rng.normal(-1.7, 0.2))]
    else:
        tb[2, 3] = 0.0
    return tb


def jax_move(jcfg, g, c, center, new_center, tb):
    with jax.disable_jit():
        state = jgrid.GridState(jnp.asarray(g), jnp.asarray(c), jnp.asarray(center),
                                jnp.zeros(2, jnp.float32))
        out = jgrid.move(jcfg, state, None, jnp.asarray(tb), new_center=jnp.asarray(new_center),
                         new_center_lo=jnp.zeros(2, jnp.float32))
    return np.asarray(out.ground), np.asarray(out.groundpatch)


def scan_scalars(tcfg, center, new_center, tb):
    k = tgrid.shift_cells(tcfg, center, new_center)
    return tscalars.pack(tcfg, new_center, None, k, np.eye(4), np.eye(4), tb), k


def same_bits(a, b) -> bool:
    return np.array_equal(np.asarray(a).view(np.int32), np.asarray(b).view(np.int32))


@pytest.mark.parametrize("flat", [False, True], ids=["tilted", "flat"])
@pytest.mark.parametrize("dimension,resolution", GEOMETRIES)
def test_move_matches_jax(dimension, resolution, flat):
    """Every shift of :func:`shifts` from a random centre: ground and
    groundpatch bitwise the JAX package's eager move."""
    kw = dict(dimension=dimension, resolution=resolution)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    n = tcfg.cell_count
    rng = np.random.default_rng(n + flat)
    res = np.float32(resolution)
    for k in shifts(n):
        g, c = layers(rng, n)
        tb = base_map(rng, flat)
        center = (rng.normal(0, 40, 2) / res).round().astype(np.float32) * res
        new_center = (center + np.float32(k) * res).astype(np.float32)
        packed, got_k = scan_scalars(tcfg, center, new_center, tb)
        assert got_k == k
        s = tscalars.view(torch.from_numpy(packed))
        got = move.move(tcfg, torch.from_numpy(g), torch.from_numpy(c), s)
        want = jax_move(jcfg, g, c, center, new_center, tb)
        for name, a, b in zip(("ground", "groundpatch"), got, want):
            assert same_bits(a.numpy(), b), (k, name)
        if flat and k != (0, 0):
            exposed = tgrid.exposed_mask(n, torch.tensor(k[0]), torch.tensor(k[1]), "cpu")
            assert (got[0][exposed].view(torch.int32) == np.int32(-2 ** 31)).all()  # -0.0


@pytest.mark.parametrize("dimension,resolution", GEOMETRIES)
def test_move_batch_rows_match_jax(dimension, resolution):
    """Three grids with their own shifts (mixed signs, none, a wipe), centres
    and planes in one call: each row bitwise its own JAX move and its own
    single call; the inputs untouched."""
    kw = dict(dimension=dimension, resolution=resolution)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    n = tcfg.cell_count
    rng = np.random.default_rng(7)
    res = np.float32(resolution)
    rows = []
    for k in ((3, -2), (0, 0), (-n, n + 4)):
        g, c = layers(rng, n)
        tb = base_map(rng)
        center = (rng.normal(0, 40, 2) / res).round().astype(np.float32) * res
        new_center = (center + np.float32(k) * res).astype(np.float32)
        packed, _ = scan_scalars(tcfg, center, new_center, tb)
        rows.append((g, c, center, new_center, tb, packed))
    g = torch.from_numpy(np.stack([r[0] for r in rows]))
    c = torch.from_numpy(np.stack([r[1] for r in rows]))
    g0, c0 = g.clone(), c.clone()
    sb = tscalars.view(torch.from_numpy(np.stack([r[5] for r in rows])))
    got = move.move(tcfg, g, c, sb)
    assert same_bits(g.numpy(), g0.numpy()) and same_bits(c.numpy(), c0.numpy())
    for v, (gv, cv, center, new_center, tb, packed) in enumerate(rows):
        want = jax_move(jcfg, gv, cv, center, new_center, tb)
        one = move.move(tcfg, g[v], c[v], tscalars.view(torch.from_numpy(packed)))
        for a, b, o in zip(got, want, one):
            assert same_bits(a[v].numpy(), b) and same_bits(a[v].numpy(), o.numpy()), v


@pytest.mark.parametrize("k1", range(-6, 7))
def test_move_every_column_offset_matches_jax(k1):
    """At the default 364^2 grid (n % 4 == 0: the card's kernel takes four
    cells a thread, the rolled row's two runs read by the column offset
    k1 mod 4) every column shift of -6 .. 6 with a row shift: ground and
    groundpatch bitwise the JAX package's eager move."""
    jcfg, tcfg = JConfig(), TConfig()
    n = tcfg.cell_count
    rng = np.random.default_rng(100 + k1)
    res = np.float32(tcfg.resolution)
    g, c = layers(rng, n)
    tb = base_map(rng)
    center = (rng.normal(0, 40, 2) / res).round().astype(np.float32) * res
    k = (3, k1)
    new_center = (center + np.float32(k) * res).astype(np.float32)
    packed, got_k = scan_scalars(tcfg, center, new_center, tb)
    assert got_k == k
    got = move.move(tcfg, torch.from_numpy(g), torch.from_numpy(c),
                    tscalars.view(torch.from_numpy(packed)))
    want = jax_move(jcfg, g, c, center, new_center, tb)
    for name, a, b in zip(("ground", "groundpatch"), got, want):
        assert same_bits(a.numpy(), b), name
