"""K11's function, the march's candidate selection (``ops/select.py``),
against the JAX package on the CPU.

On the CPU ``select_candidates`` takes its plain version,
``select_candidates_plain``: the stable partition of the point indices by
selection (every marchable point while there are at most ``k_max``, else
the ``k_max`` largest keys), cut at ``k_max``, and the marchable count.
Its marchable members must be those of the JAX package's own selection,
recomputed here as ``groundgrid_tpu/core/outliers.py:228-248`` builds it
(the packed u32 key's ``lax.sort`` up to 2^17 points, ``lax.top_k`` of the
budgets above), under the cap, at it and over it, on both key forms, with
tied budgets, and row by row on a batch; ``detect_outliers`` through the
select wrapper must give the JAX package's outlier set bitwise. Inputs are
made with numpy from a seed. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2), held bitwise
to the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from groundgrid_tpu.config import GroundGridConfig as JConfig
from groundgrid_tpu.core import outliers as joutliers
from groundgrid_tpu.core import rasterize as jraster

from groundgrid_torch.config import GroundGridConfig as TConfig
from groundgrid_torch.core import outliers as toutliers
from groundgrid_torch.core import rasterize as traster
from groundgrid_torch.core import scalars as tscalars
from groundgrid_torch.core import transforms as ttf
from groundgrid_torch.ops import march, select

from test_torch_outliers_topk import N_LONG, N_SHORT, N_TIED, _scene

torch.set_num_threads(1)


def jax_selection(budget: np.ndarray, k_max: int) -> np.ndarray:
    """The JAX package's candidate buffer over one row of budgets, as
    ``groundgrid_tpu/core/outliers.py:228-248`` builds it: the packed key's
    sort and slice up to 2^17 points, ``lax.top_k`` of the budgets above."""
    p_total = budget.shape[0]
    b = jnp.asarray(budget)
    idx_mask = np.uint32((1 << 17) - 1)
    trunc = joutliers._mono_u32(b) & ~idx_mask
    if p_total <= joutliers.U32_SORT_MAX_POINTS:
        key = trunc | jnp.arange(p_total, dtype=jnp.uint32)
        nk_sorted = lax.sort(~key, is_stable=False)
        key_sorted = ~lax.slice_in_dim(nk_sorted, 0, k_max)
        pidx = (key_sorted & idx_mask).astype(jnp.int32)
    else:
        _, pidx = lax.top_k(b, k_max)
    return np.asarray(pidx)


def marchable_members(pidx: np.ndarray, budget: np.ndarray) -> set:
    return {int(i) for i in pidx if budget[i] > 0}


def budgets(rng, p_total: int, n_pos: int, ties: bool) -> np.ndarray:
    """A row of ``p_total`` budgets, ``n_pos`` of them positive (squared ray
    lengths of 0.2 to 20 m) at random slots; with ``ties`` rounded to a few
    values, so that the cap falls inside groups of equal budgets."""
    out = np.zeros(p_total, np.float32)
    slots = rng.choice(p_total, n_pos, replace=False)
    v = rng.uniform(0.04, 400.0, n_pos).astype(np.float32)
    if ties:
        v = (np.round(v / 40.0) * 40.0 + 0.5).astype(np.float32)
    out[slots] = v
    return out


CASES = [  # (points, marchable, k_max): under the cap, at it, over it
    (4097, 300, 700), (4097, 700, 700), (4097, 1500, 700),
    (1 << 17, 726, 8192), (1 << 17, 8192, 8192), (1 << 17, 9000, 8192),
    ((1 << 17) + 640, 5000, 3000),
    (1 << 18, 2000, 8192), (1 << 18, 8192, 8192), (1 << 18, 12000, 8192),
]


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "tied"])
@pytest.mark.parametrize("p_total,n_pos,k_max", CASES)
def test_plain_select_marchable_members_match_jax(p_total, n_pos, k_max, ties):
    """The marchable members of the plain selection are the JAX package's,
    and the marchable count is the row's count of positive budgets."""
    budget = budgets(np.random.default_rng(p_total + n_pos), p_total, n_pos, ties)
    b = torch.from_numpy(budget)
    pidx, n_marchable = select.select_candidates(b, toutliers.selection_key(b), k_max)
    assert pidx.shape == (k_max,) and pidx.dtype == torch.int64
    assert int(n_marchable) == n_pos
    got = marchable_members(pidx.numpy(), budget)
    assert got == marchable_members(jax_selection(budget, k_max), budget)
    assert len(got) == min(n_pos, k_max)


@pytest.mark.parametrize("p_total,n_pos,k_max", [(77, 20, 40), (77, 60, 40), (5000, 900, 700),
                                                 ((1 << 17) + 5, 3000, 1000), (33, 0, 33)])
def test_plain_select_is_the_stable_partition(p_total, n_pos, k_max):
    """The plain selection's indices are the stable partition that K11 is
    held to bitwise, built here in numpy: the selected points (the
    marchable ones, or past the cap the top ``k_max`` keys) in point order,
    then the others in point order, cut at ``k_max``."""
    budget = budgets(np.random.default_rng(p_total), p_total, n_pos, True)
    b = torch.from_numpy(budget)
    key = toutliers.selection_key(b)
    pidx, _ = select.select_candidates_plain(b, key, k_max)
    if n_pos <= k_max:
        sel = budget > 0
    else:
        sel = np.zeros(p_total, bool)
        sel[np.argsort(-key.numpy(), kind="stable")[:k_max]] = True
    want = np.concatenate([np.flatnonzero(sel), np.flatnonzero(~sel)])[:k_max]
    np.testing.assert_array_equal(pidx.numpy(), want)


@pytest.mark.parametrize("p_total", [4097, 1 << 17, 1 << 18])
def test_plain_select_batch_rows_match_single_calls(p_total):
    """Three rows, one under the cap, one at it, one over it: each row of
    the batched call bitwise its single call."""
    rng = np.random.default_rng(3)
    k_max = 700
    rows = np.stack([budgets(rng, p_total, n, True) for n in (300, 700, 1500)])
    b = torch.from_numpy(rows)
    pidx, n_marchable = select.select_candidates(b, toutliers.selection_key(b), k_max)
    assert pidx.shape == (3, k_max) and n_marchable.tolist() == [300, 700, 1500]
    for v in range(3):
        one = select.select_candidates(b[v], toutliers.selection_key(b[v]), k_max)
        assert torch.equal(pidx[v], one[0]) and torch.equal(n_marchable[v], one[1])


@pytest.mark.parametrize("cap", [450, N_LONG + N_TIED + N_SHORT, 2000],
                         ids=["over", "at", "under"])
@pytest.mark.parametrize("p_total", [1 << 17, (1 << 17) + 640, 1 << 18])
def test_detect_outliers_through_select_matches_jax(p_total, cap):
    """``detect_outliers`` with ``select_fn`` the K11 wrapper on
    ``test_torch_outliers_topk.py``'s scene (800 marchable candidates, the
    cut inside a group of equal budgets), the cap over, at and under the
    marchable count: the outlier set bitwise the JAX package's eager one."""
    kw = dict(dimension=40.0, resolution=0.5, max_points=p_total, ray_steps=40,
              max_outlier_candidates=cap)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    n = jcfg.cell_count
    (x, y, z), valid, _ = _scene(p_total)
    rings = np.zeros(p_total, np.int32)
    center = lo = np.zeros(2, np.float32)
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
    s = tscalars.host(tcfg, center, lo, ttf.translation(*origin, np.float32))
    tb = traster.bin_points(tcfg, s, t[0], t[1], torch.from_numpy(rings),
                            torch.from_numpy(valid))
    got, marchable = toutliers.detect_outliers(tcfg, s, torch.from_numpy(ground),
                                               torch.from_numpy(conf), tb, *t,
                                               march.march_budget, select.select_candidates,
                                               march.march)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(marchable) == N_LONG + N_TIED + N_SHORT
    marchable = int(marchable)
    fired = int(want.sum())
    assert fired == cap if cap < marchable else fired >= N_LONG + N_TIED


@pytest.mark.parametrize("p_total,n_pos,k_max", [c for c in CASES if c[1] > c[2]])
def test_storm_marchable_count_and_flags_match_jax(p_total, n_pos, k_max):
    """On the storms past the cap: the marchable count is the number of
    marchable members of the JAX package's candidate buffer with no cap
    (every positive budget), an int64; and the plain march of the selected
    candidates writes K6's plain flags, all False before it, as bool."""
    budget = budgets(np.random.default_rng(p_total + n_pos), p_total, n_pos, True)
    b = torch.from_numpy(budget)
    pidx, n_marchable = select.select_candidates(b, toutliers.selection_key(b), k_max)
    assert n_marchable.dtype == torch.int64
    assert int(n_marchable) == len(marchable_members(jax_selection(budget, p_total), budget))
    assert bool((b[pidx] > 0).all())  # past the cap every candidate is marchable
    cfg = TConfig(dimension=40.0, resolution=0.5, max_points=p_total, ray_steps=8)
    n = cfg.cell_count
    s = tscalars.host(cfg, np.zeros(2, np.float32), np.zeros(2, np.float32),
                      ttf.translation(0.0, 0.0, 1.7, np.float32))
    flags = torch.zeros(p_total, dtype=torch.bool)
    dirs = torch.zeros((3, p_total))
    dirs[2] = -1.0  # straight down: no step leaves the origin's cell
    layer = torch.zeros((n, n))
    got = march.march(cfg, s, layer, layer, pidx, b, dirs, n_marchable, flags)
    assert got is flags and got.dtype == torch.bool
