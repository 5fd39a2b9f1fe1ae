"""The port's double-single float32 arithmetic is bitwise the JAX package's.

Every function of ``groundgrid_torch.core.exactf32`` gets the same
numpy-seeded inputs as its ``groundgrid_tpu.core.exactf32`` counterpart
(jitted, as the JAX pipeline runs it) and must return the same bits. The
inputs mix random magnitudes with values a hair around decision boundaries
(division midpoints, exact squares, cell edges).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groundgrid_tpu.core import exactf32 as jef
from groundgrid_torch.core import exactf32 as tef

# the test workers share the CPU: torch's intra-op thread pools would
# oversubscribe it and stall on the many small ops of the plain versions
torch.set_num_threads(1)

N = 20_000


def _f32(rng, lo=-300.0, hi=300.0, n=N):
    return rng.uniform(lo, hi, size=n).astype(np.float32)


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g.view(np.int32) if g.dtype == np.float32 else g,
                                      w.view(np.int32) if w.dtype == np.float32 else w)


def _inputs(name, rng):
    a, b = _f32(rng), _f32(rng, -1e-3, 1e-3)
    if name in ("two_sum", "ds_add_f32_small"):
        return a, b
    if name in ("two_prod", "split"):
        return a, _f32(rng)
    if name == "ds_add":
        hi1, lo1 = jef.two_sum(_f32(rng), _f32(rng, -1e-4, 1e-4))
        hi2, lo2 = jef.two_sum(-np.asarray(hi1) + _f32(rng, -1e-3, 1e-3), _f32(rng, -1e-4, 1e-4))
        return tuple(np.asarray(v, np.float32) for v in (hi1, lo1, hi2, lo2))
    if name == "div_rn":
        q = np.float32(1.5) + np.arange(N // 4, dtype=np.float32) * np.float32(1e-4)
        d = np.abs(_f32(rng, 1.0, 100.0, N // 4))
        near = [(q.astype(np.float64) + 2.0 ** -25 * k) * d.astype(np.float64)
                for k in (-1, 0, 1)]
        num = np.concatenate([_f32(rng, n=N // 4)] + [x.astype(np.float32) for x in near])
        return num, np.concatenate([np.abs(_f32(rng, 0.5, 200.0, N // 4))] + [d] * 3)
    if name == "sqrt_rn_ds":
        x, y, z = _f32(rng, lo=0.1, hi=170.0), _f32(rng, lo=0.1, hi=170.0), _f32(rng, lo=0, hi=80)
        sh, sl = jef.sumsq3_ds(x, y, z)
        sh, sl = np.asarray(sh), np.asarray(sl)
        sq = np.arange(64, dtype=np.float32)
        return np.concatenate([sh, sq * sq]), np.concatenate([sl, np.zeros(64, np.float32)])
    if name == "sumsq3_ds":
        return _f32(rng), _f32(rng), _f32(rng, lo=-80, hi=80)
    if name == "ds_sign":
        h = np.concatenate([_f32(rng, -1, 1, 1000), np.zeros(1000, np.float32)])
        l = np.concatenate([np.zeros(1000, np.float32), _f32(rng, -1e-20, 1e-20, 1000)])
        return h, l
    raise KeyError(name)


CASES = {
    "two_sum": (tef.two_sum, jef.two_sum),
    "split": (lambda a, b: tef.split(a), lambda a, b: jef.split(a)),
    "two_prod": (tef.two_prod, jef.two_prod),
    "ds_add": (tef.ds_add, jef.ds_add),
    "ds_add_f32_small": (lambda a, b: tef.ds_add_f32(a, -b, b),
                         lambda a, b: jef.ds_add_f32(a, -b, b)),
    "div_rn": (tef.div_rn, jef.div_rn),
    "sqrt_rn_ds": (tef.sqrt_rn_ds, jef.sqrt_rn_ds),
    "sumsq3_ds": (tef.sumsq3_ds, jef.sumsq3_ds),
    "ds_sign": (lambda h, l: (tef.ds_lt0(h, l), tef.ds_ge0(h, l)),
                lambda h, l: (jef.ds_lt0(h, l), jef.ds_ge0(h, l))),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_elementwise_bitwise(name, jit):
    rng = np.random.default_rng(sorted(CASES).index(name))
    args = _inputs(name, rng)
    t_fn, j_fn = CASES[name]
    got = t_fn(*(torch.from_numpy(a) for a in args))
    want = (jax.jit(j_fn) if jit else j_fn)(*(jnp.asarray(a) for a in args))
    if jit and name == "sumsq3_ds":
        # XLA's fused form rounds the ds tail differently (eager JAX and
        # numpy agree with the port); the head and the value every caller
        # takes from the pair, the correctly rounded root, are bitwise
        _same(got[0], want[0])
        _same(tef.sqrt_rn_ds(*got), jax.jit(jef.sqrt_rn_ds)(*want))
        return
    _same(got, want)


def test_two_prod_int_const_bitwise():
    rng = np.random.default_rng(1)
    m = rng.integers(-(1 << 21) + 1, 1 << 21, size=N).astype(np.float32)
    for c in (np.float32(0.33), np.float32(-1.3113022e-08), np.float32(0.1)):
        ch, cl = jef.split(c, xp=np)
        tch, tcl = tef.split(c)
        assert (tch, tcl) == (ch, cl)
        got = tef.two_prod_int_const(torch.from_numpy(m), c, tch, tcl)
        want = jax.jit(lambda mm: jef.two_prod_int_const(mm, c, ch, cl))(m)
        _same(got, want)


@pytest.mark.parametrize("resolution", [0.33, 0.5, 0.1])
def test_ds_bin_bitwise(resolution):
    rng = np.random.default_rng(2)
    center = np.array([1234.5678901, -9876.54321])
    half = 60.06
    sh, sl = tef.center_edge_ds(center, half)
    jsh, jsl = jef.center_edge_ds(center, half)
    _same((sh, sl), (jsh, jsl))
    consts = tef.res_ds(resolution)
    assert consts == jef.res_ds(resolution)
    x = center[0] + rng.uniform(-70, 70, N)
    # points a hair around cell edges (the decision the ds form exists for)
    edges = center[0] + half - resolution * rng.integers(0, 400, 2000)
    x = np.concatenate([x, edges, np.nextafter(edges, -np.inf), np.nextafter(edges, np.inf)])
    x = x.astype(np.float32)
    got = tef.ds_bin(sh[0], sl[0], torch.from_numpy(x), *consts)
    want = jax.jit(lambda xx: jef.ds_bin(jnp.float32(sh[0]), jnp.float32(sl[0]), xx,
                                         *jef.res_ds(resolution)))(x)
    _same(got, want)
    _same(got, jef.ds_bin(sh[0], sl[0], x, *jef.res_ds(resolution), xp=np))


def test_f64_to_ds_bitwise():
    x = np.random.default_rng(3).uniform(-5e4, 5e4, size=N)
    _same(tef.f64_to_ds(x), jef.f64_to_ds(x))
