"""Candidate selection of the occlusion march above 2^17 points.

Up to 2^17 points the JAX package selects candidates by a packed key, the
truncated budget over the point index (equal keys: the higher index first);
above, by ``lax.top_k`` over the exact budgets (equal budgets: the lower
index first). The port keeps both orders with unique int64 keys. Here more
candidates fire than ``max_outlier_candidates`` holds, and the cut falls
inside a group of identical points (equal budgets) spread over the whole
index range: the outlier set must be bitwise the JAX package's, at the
ceiling itself and on both sides of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groundgrid_tpu.config import GroundGridConfig as JConfig
from groundgrid_tpu.core import outliers as joutliers
from groundgrid_tpu.core import rasterize as jraster

from groundgrid_torch.config import GroundGridConfig as TConfig
from groundgrid_torch.core import outliers as toutliers
from groundgrid_torch.core import rasterize as traster
from groundgrid_torch.ops import lookup

torch.set_num_threads(1)

K_MAX = 450
N_LONG, N_TIED, N_SHORT, N_ABOVE = 300, 300, 200, 5000


def _scene(p_total, seed=0):
    """(x, y, z, valid) with 300 long rays, 300 identical rays (the cut falls
    among them) and 200 short ones below a flat confident terrain at z = 0,
    5000 points above it, the rest padding; positions shuffled over [0, P)."""
    rng = np.random.default_rng(seed)

    def ring(n, r0, r1, z):
        ang, r = rng.uniform(0, 2 * np.pi, n), rng.uniform(r0, r1, n)
        return np.stack([r * np.cos(ang), r * np.sin(ang), np.full(n, z)], 1)

    pts = np.concatenate([
        ring(N_LONG, 12.0, 17.0, -2.0),
        np.tile([[10.0, 3.0, -2.5]], (N_TIED, 1)),
        ring(N_SHORT, 5.0, 7.0, -1.0),
        ring(N_ABOVE, 4.0, 18.0, 0.5),
    ]).astype(np.float32)
    slots = rng.permutation(p_total)[: pts.shape[0]]
    xyz = np.zeros((3, p_total), np.float32)
    xyz[:, slots] = pts.T
    valid = np.zeros(p_total, bool)
    valid[slots] = True
    tied = np.sort(slots[N_LONG:N_LONG + N_TIED])
    return xyz, valid, tied


@pytest.mark.parametrize("p_total", [1 << 17, (1 << 17) + 640, 1 << 18])
def test_march_selection_bitwise(p_total):
    kw = dict(dimension=40.0, resolution=0.5, max_points=p_total, ray_steps=40,
              max_outlier_candidates=K_MAX)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    n = jcfg.cell_count
    (x, y, z), valid, tied = _scene(p_total)
    rings = np.zeros(p_total, np.int32)
    center, lo = np.zeros(2, np.float32), np.zeros(2, np.float32)
    origin = np.float32([0.0, 0.0, 1.7])
    ground = np.zeros((n, n), np.float32)
    conf = np.ones((n, n), np.float32)
    with jax.disable_jit():
        jb = jraster.bin_points(jcfg, jnp.asarray(center), jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(z), jnp.asarray(rings), jnp.asarray(valid),
                                jnp.asarray(origin), center_lo=jnp.asarray(lo))
        want = np.asarray(joutliers.detect_outliers(
            jcfg, jnp.asarray(center), jnp.asarray(ground), jnp.asarray(conf), jb,
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), jnp.asarray(origin),
            center_lo=jnp.asarray(lo)))
    t = [torch.from_numpy(a) for a in (x, y, z)]
    tb = traster.bin_points(tcfg, center, lo, t[0], t[1], torch.from_numpy(rings),
                            torch.from_numpy(valid), origin)
    (old_h,) = lookup.lookup(tb.cell, [torch.from_numpy(ground)], n * n)
    got, marchable = toutliers.detect_outliers(tcfg, center, lo, torch.from_numpy(ground),
                                               torch.from_numpy(conf), tb, *t, origin, old_h,
                                               lookup.lookup)
    np.testing.assert_array_equal(got.numpy(), want)
    assert marchable == N_LONG + N_TIED + N_SHORT > K_MAX
    # the long rays fire and the short ones are shed; the cut splits the tie
    fired = want[tied]
    assert int(want.sum()) == K_MAX and 0 < fired.sum() < N_TIED
    keep = K_MAX - N_LONG
    if p_total > 1 << toutliers.IDX_BITS:  # lax.top_k: the lowest indices
        assert fired[:keep].all() and not fired[keep:].any()
    else:  # the packed key: the highest indices
        assert fired[-keep:].all() and not fired[:-keep].any()


def test_selection_key_orders():
    """Both keys are unique and rank a larger budget first; equal budgets by
    index the JAX package's way on each side of the ceiling."""
    for p_total in (1 << 17, (1 << 17) + 1):
        budget = torch.zeros(p_total)
        budget[[5, 7, p_total - 1]] = 4.0
        budget[9] = 9.0
        key = toutliers.selection_key(budget)
        assert torch.unique(key).numel() == p_total
        top = torch.topk(key, 3).indices.tolist()
        assert top[0] == 9
        assert top[1:] == ([p_total - 1, 7] if p_total == 1 << 17 else [5, 7])
