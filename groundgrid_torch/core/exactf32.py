"""Error-free float32 transforms: the bitwise-parity substrate, in PyTorch.

The torch counterpart of ``groundgrid_tpu/core/exactf32.py``. The reference
bins points and marches rays through double-precision math; the port, like
the JAX package, evaluates those few *discontinuous* decisions in
double-single ("ds") float32 arithmetic so they agree with the f64 semantics
bitwise outside a ~1e-12 m band, while all smooth math stays plain f32.

One implementation serves CPU and CUDA tensors alike: every step is a single
IEEE-rounded f32 add, subtract, multiply, divide, square root or floor, and
eager PyTorch runs each op as its own kernel, so the host prep (CPU tensors)
and the device step (CUDA tensors) produce the same bits. That is the
sorted-scan invariant. The JAX package's ``barrier`` existed only against
XLA's FMA contraction and has no counterpart here. Never write these paths
with ``addcmul``, ``lerp``, ``alpha=`` forms or ``torch.compile``: each may
fuse a multiply and an add.

Scalar constants are ``np.float32``, so :func:`split` and the two-sums also
run on NumPy float32 scalars (host constants, e.g. the split resolution)
with f32 rounding.

Oracle citations: golden.py ``_index`` (grid_map ``getIndexFromPosition``,
double), GroundSegmentation.cpp:242-275 (ray march), GroundGrid.cpp:83-147
(double-precision center recurrence).
"""

from __future__ import annotations

import numpy as np
import torch

_SPLIT = np.float32(4097.0)  # 2^12 + 1: Dekker split constant for f32
_HALF = np.float32(0.5)
_TWO = np.float32(2.0)


def two_sum(a, b):
    """Knuth two-sum: s + e == a + b exactly, s = fl(a + b)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def split(a):
    """Dekker split: a == hi + lo, each half <= 12 significant bits."""
    t = a * _SPLIT
    d = t - a
    hi = t - d
    return hi, a - hi


def two_prod(a, b):
    """Dekker two-product: p + e == a * b exactly, p = fl(a * b)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def ds_add(ah, al, bh, bl):
    """Normalized double-single sum (ah+al) + (bh+bl)."""
    sh, se = two_sum(ah, bh)
    return two_sum(sh, se + (al + bl))


def ds_add_f32(ah, al, b):
    """Normalized (ah+al) + b for a plain f32 ``b``."""
    sh, se = two_sum(ah, b)
    return two_sum(sh, se + al)


def ds_lt0(h, l):
    """Exact (h + l) < 0 for a NORMALIZED pair (|l| <= ulp(h)/2)."""
    return (h < 0) | ((h == 0) & (l < 0))


def ds_ge0(h, l):
    """Exact (h + l) >= 0 for a normalized pair."""
    return ~ds_lt0(h, l)


def f64_to_ds(x) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: split a float64 scalar/array into an f32 (hi, lo) pair."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _ulp_above(x):
    """Spacing from positive finite normal x to the next float32 up."""
    return (x.view(torch.int32) + 1).view(torch.float32) - x


def _ulp_below(x):
    """Spacing from positive finite normal x down to the previous float32."""
    return x - (x.view(torch.int32) - 1).view(torch.float32)


def div_const(x, c: float):
    """``x / c`` for a host constant ``c``, IEEE-rounded on every device.

    A CUDA division by a host scalar multiplies by the scalar's rounded
    reciprocal, an ulp off the quotient for many ``x``; dividing by a 0-dim
    tensor on ``x``'s device (filled there, no host sync) divides, as the CPU
    and the CUDA kernels do.
    """
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def div_rn(a, b):
    """Correctly-rounded f32 a / b for b > 0, a of any sign.

    IEEE division already rounds correctly on CPU and CUDA; the Newton step
    and midpoint snap are kept so the op sequence, and thus every tie
    decision, is the JAX package's.
    """
    q0 = a / b
    ph, pl = two_prod(q0, b)
    rh, rl = two_sum(a, -ph)
    rl = rl - pl
    q1 = q0 + (rh + rl) / b
    aq = torch.abs(q1)
    sign = torch.where(q1 < 0, torch.full_like(q1, -1.0), torch.ones_like(q1))
    hu = _HALF * _ulp_above(aq)
    hd = _HALF * _ulp_below(aq)
    sa = sign * a

    p1h, p1l = two_prod(aq, b)
    dh0, dl0 = two_sum(sa, -p1h)
    dl0 = dl0 - p1l

    p2h, p2l = two_prod(hu, b)
    dh, dl = ds_add(dh0, dl0, -p2h, -p2l)
    up = (dh > 0) | ((dh == 0) & (dl > 0))

    p2h, p2l = two_prod(hd, b)
    dh, dl = ds_add(dh0, dl0, p2h, p2l)
    dn = ds_lt0(dh, dl)

    adj = torch.where(up, aq + _ulp_above(aq), torch.where(dn, aq - _ulp_below(aq), aq))
    return sign * adj


def sqrt_rn_ds(sh, sl):
    """Correctly-rounded f32 sqrt of a nonnegative ds value (sh + sl)."""
    q0 = torch.sqrt(torch.clamp_min(sh, 0.0))
    ph, pl = two_prod(q0, q0)
    rh, rl = two_sum(sh, -ph)
    rl = rl + (sl - pl)
    safe = torch.clamp_min(q0, 1e-30)
    q1 = q0 + (rh + rl) / (_TWO * safe)
    hu = _HALF * _ulp_above(q1)
    hd = _HALF * _ulp_below(q1)

    def _cmp(h):
        # s - (q1 + h)^2 = s - q1^2 - 2 q1 h - h^2, every product exact
        p1h, p1l = two_prod(q1, q1)
        p2h, p2l = two_prod(_TWO * q1, h)
        p3 = h * h
        dh, dl = two_sum(sh, -p1h)
        dl = dl + (sl - p1l)
        dh, dl = ds_add(dh, dl, -p2h, -p2l)
        return ds_add_f32(dh, dl, -p3)

    uh, ul = _cmp(hu)
    up = (uh > 0) | ((uh == 0) & (ul > 0))
    dh_, dl_ = _cmp(-hd)
    dn = ds_lt0(dh_, dl_)
    out = torch.where(up, q1 + _ulp_above(q1), torch.where(dn, q1 - _ulp_below(q1), q1))
    return torch.where(sh <= 0, torch.zeros_like(q0), out)


def sumsq3_ds(a, b, c):
    """ds value of a^2 + b^2 + c^2 (error ~2^-47 relative)."""
    ph, pl = two_prod(a, a)
    qh, ql = two_prod(b, b)
    rh, rl = two_prod(c, c)
    sh, sl = ds_add(ph, pl, qh, ql)
    return ds_add(sh, sl, rh, rl)


def res_ds(resolution: float):
    """f32 constants for :func:`ds_bin`: (rh, rl, inv_res)."""
    rh, rl = f64_to_ds(np.float64(resolution))
    inv = np.float32(1.0) / np.float32(resolution)
    return np.float32(rh), np.float32(rl), np.float32(inv)


def center_edge_ds(center64, half: float):
    """Host-side: ds image of the f64 max-corner coordinate (center + half)."""
    s64 = np.asarray(center64, np.float64) + np.float64(half)
    return f64_to_ds(s64)


def two_prod_int_const(m, c, ch, cl):
    """Exact p + e == m * c for INTEGER-VALUED f32 ``m`` (|m| < 2^21) and a
    host constant ``c`` presplit as ``ch + cl``; mh is the nearest multiple
    of 2^11, so every partial product is exact."""
    p = m * c
    mh = torch.floor(m * np.float32(2.0 ** -11) + _HALF) * np.float32(2.0 ** 11)
    ml = m - mh
    e = ((mh * ch - p) + mh * cl + ml * ch) + ml * cl
    return p, e


def ds_bin(sh, sl, x, rh, rl, inv_res):
    """Faithful cell index floor((s - x) / res), s and res as ds pairs.

    ``sh``/``sl``: the ds image of (center + half) for one axis, np.float32
    scalars (the host prep) or 0-dim f32 tensors on ``x``'s device (the
    step's scan scalars): the same f32 operations either way; ``x``: f32
    tensor; ``(rh, rl, inv_res)`` from :func:`res_ds`. Returns int32.
    """
    relh, rell = ds_add_f32(sh, sl, -x)
    m = torch.floor(relh * inv_res)
    rhh, rhl = split(np.float32(rh))
    rlh, rll = split(np.float32(rl))
    p1h, p1l = two_prod_int_const(m, np.float32(rh), rhh, rhl)
    p2h, p2l = two_prod_int_const(m, np.float32(rl), rlh, rll)
    dh, dl = ds_add(relh, rell, -p1h, -p1l)
    dh, dl = ds_add(dh, dl, -p2h, -p2l)
    below = ds_lt0(dh, dl)  # rel < m*res -> true floor is m-1
    eh, el = ds_add(dh, dl, -rh, -rl)
    at_or_above = ~ds_lt0(eh, el)  # rel >= (m+1)*res -> floor is m+1
    adj = at_or_above.to(relh.dtype) - below.to(relh.dtype)
    return (m + adj).to(torch.int32)
