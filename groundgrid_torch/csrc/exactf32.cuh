// Error-free float32 transforms on the card: core/exactf32.py op for op.
//
// The binning and the occlusion march decide cell edges, ray budgets and
// step thresholds in double-single ("ds") f32 arithmetic. The plain PyTorch
// versions run every step as one IEEE-rounded f32 operation, on the host
// (the sorted-scan prep bins the points it sorts by) and on the card alike,
// so their ids and decisions agree bitwise. The kernels that fuse those
// chains (binning.cu K5, march.cu K6 and K7) must round each step exactly as
// its PyTorch kernel does: every add, subtract, multiply, divide and square
// root below is an explicit round-to-nearest intrinsic (never contracted
// into an FMA, never approximated; the build also passes --fmad=false and
// no fast-math or flush-to-zero flag), floor is floorf (torch.floor), and
// the ulp steps and u32 keys move bits with __float_as_uint/__uint_as_float.
// Constants the plain code writes as Python floats of np.float32 values are
// double literals converted to float here, as NumPy converts them.
//
// Each function names its Python twin; the operand order of every sum is the
// twin's, left to right.
#pragma once

#include <cuda_runtime.h>

namespace gg {

struct DS {
  float h, l;
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp_min on the card: NaN passes through, else the larger value
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// two_sum: s + e == a + b exactly, s = fl(a + b)
__device__ __forceinline__ DS two_sum(float a, float b) {
  const float s = add(a, b);
  const float bb = sub(s, a);
  return {s, add(sub(a, sub(s, bb)), sub(b, bb))};
}

// split: a == hi + lo, each half <= 12 significant bits (4097 = 2^12 + 1)
__device__ __forceinline__ DS split(float a) {
  const float t = mul(a, 4097.0f);
  const float d = sub(t, a);
  const float hi = sub(t, d);
  return {hi, sub(a, hi)};
}

// two_prod: p + e == a * b exactly, p = fl(a * b)
__device__ __forceinline__ DS two_prod(float a, float b) {
  const float p = mul(a, b);
  const DS as = split(a), bs = split(b);
  const float e = add(add(add(sub(mul(as.h, bs.h), p), mul(as.h, bs.l)), mul(as.l, bs.h)),
                      mul(as.l, bs.l));
  return {p, e};
}

// ds_add: normalized (ah + al) + (bh + bl)
__device__ __forceinline__ DS ds_add(float ah, float al, float bh, float bl) {
  const DS s = two_sum(ah, bh);
  return two_sum(s.h, add(s.l, add(al, bl)));
}

// ds_add_f32: normalized (ah + al) + b
__device__ __forceinline__ DS ds_add_f32(float ah, float al, float b) {
  const DS s = two_sum(ah, b);
  return two_sum(s.h, add(s.l, al));
}

// ds_lt0: exact (h + l) < 0 for a normalized pair
__device__ __forceinline__ bool ds_lt0(float h, float l) {
  return (h < 0.0f) | ((h == 0.0f) & (l < 0.0f));
}

// (h + l) > 0 for a normalized pair: the "up" tests of div_rn and sqrt_rn_ds
__device__ __forceinline__ bool ds_gt0(float h, float l) {
  return (h > 0.0f) | ((h == 0.0f) & (l > 0.0f));
}

// _ulp_above / _ulp_below: the spacing to the next f32 up / down (the int32
// add of the twin wraps as this unsigned one does)
__device__ __forceinline__ float ulp_above(float x) {
  return sub(__uint_as_float(__float_as_uint(x) + 1u), x);
}
__device__ __forceinline__ float ulp_below(float x) {
  return sub(x, __uint_as_float(__float_as_uint(x) - 1u));
}

// div_rn: correctly rounded a / b for b > 0 (the twin's Newton step and
// midpoint snap, so every tie decision is the JAX package's)
__device__ __forceinline__ float div_rn(float a, float b) {
  const float q0 = div(a, b);
  const DS p = two_prod(q0, b);
  DS r = two_sum(a, -p.h);
  r.l = sub(r.l, p.l);
  const float q1 = add(q0, div(add(r.h, r.l), b));
  const float aq = fabsf(q1);
  const float sign = q1 < 0.0f ? -1.0f : 1.0f;
  const float hu = mul(0.5f, ulp_above(aq));
  const float hd = mul(0.5f, ulp_below(aq));
  const float sa = mul(sign, a);

  const DS p1 = two_prod(aq, b);
  DS d0 = two_sum(sa, -p1.h);
  d0.l = sub(d0.l, p1.l);

  DS p2 = two_prod(hu, b);
  DS d = ds_add(d0.h, d0.l, -p2.h, -p2.l);
  const bool up = ds_gt0(d.h, d.l);

  p2 = two_prod(hd, b);
  d = ds_add(d0.h, d0.l, p2.h, p2.l);
  const bool dn = ds_lt0(d.h, d.l);

  const float adj = up ? add(aq, ulp_above(aq)) : (dn ? sub(aq, ulp_below(aq)) : aq);
  return mul(sign, adj);
}

// sqrt_rn_ds: correctly rounded sqrt of a nonnegative ds value sh + sl
__device__ __forceinline__ float sqrt_rn_ds(float sh, float sl) {
  const float q0 = __fsqrt_rn(clamp_min(sh, 0.0f));
  const DS p = two_prod(q0, q0);
  DS r = two_sum(sh, -p.h);
  r.l = add(r.l, sub(sl, p.l));
  const float safe = clamp_min(q0, (float)1e-30);
  const float q1 = add(q0, div(add(r.h, r.l), mul(2.0f, safe)));
  const float hu = mul(0.5f, ulp_above(q1));
  const float hd = mul(0.5f, ulp_below(q1));

  // s - (q1 + h)^2 = s - q1^2 - 2 q1 h - h^2, every product exact
  auto cmp = [&](float h) {
    const DS p1 = two_prod(q1, q1);
    const DS p2 = two_prod(mul(2.0f, q1), h);
    const float p3 = mul(h, h);
    DS d = two_sum(sh, -p1.h);
    d.l = add(d.l, sub(sl, p1.l));
    d = ds_add(d.h, d.l, -p2.h, -p2.l);
    return ds_add_f32(d.h, d.l, -p3);
  };
  const DS u = cmp(hu);
  const bool up = ds_gt0(u.h, u.l);
  const DS w = cmp(-hd);
  const bool dn = ds_lt0(w.h, w.l);
  const float out = up ? add(q1, ulp_above(q1)) : (dn ? sub(q1, ulp_below(q1)) : q1);
  return sh <= 0.0f ? 0.0f : out;
}

// sumsq3_ds: ds value of a^2 + b^2 + c^2
__device__ __forceinline__ DS sumsq3_ds(float a, float b, float c) {
  const DS p = two_prod(a, a), q = two_prod(b, b), r = two_prod(c, c);
  const DS s = ds_add(p.h, p.l, q.h, q.l);
  return ds_add(s.h, s.l, r.h, r.l);
}

// two_prod_int_const: exact p + e == m * c for an integer-valued m
// (|m| < 2^21) and c presplit as ch + cl
__device__ __forceinline__ DS two_prod_int_const(float m, float c, float ch, float cl) {
  const float p = mul(m, c);
  const float mh = mul(floorf(add(mul(m, 0.00048828125f), 0.5f)), 2048.0f);  // 2^-11, 2^11
  const float ml = sub(m, mh);
  const float e = add(add(add(sub(mul(mh, ch), p), mul(mh, cl)), mul(ml, ch)), mul(ml, cl));
  return {p, e};
}

// The resolution as core/exactf32.res_ds gives it (rh + rl, inv_res = 1/res
// in f32), with the splits ds_bin takes of rh and rl
struct Res {
  float rh, rl, inv;
  DS rhs, rls;
};

__device__ __forceinline__ Res make_res(float rh, float rl, float inv) {
  return {rh, rl, inv, split(rh), split(rl)};
}

// ds_bin: the faithful cell index floor((s - x) / res), s = sh + sl
__device__ __forceinline__ int ds_bin(float sh, float sl, float x, const Res& r) {
  const DS rel = ds_add_f32(sh, sl, -x);
  const float m = floorf(mul(rel.h, r.inv));
  const DS p1 = two_prod_int_const(m, r.rh, r.rhs.h, r.rhs.l);
  const DS p2 = two_prod_int_const(m, r.rl, r.rls.h, r.rls.l);
  DS d = ds_add(rel.h, rel.l, -p1.h, -p1.l);
  d = ds_add(d.h, d.l, -p2.h, -p2.l);
  const bool below = ds_lt0(d.h, d.l);  // rel < m*res: the floor is m - 1
  const DS e = ds_add(d.h, d.l, -r.rh, -r.rl);
  const bool at_or_above = !ds_lt0(e.h, e.l);  // rel >= (m+1)*res: m + 1
  const float adj = sub(at_or_above ? 1.0f : 0.0f, below ? 1.0f : 0.0f);
  return (int)add(m, adj);  // truncates, as the twin's .to(int32)
}

// outliers._mono_u32: order-preserving f32 -> u32 (tests f >= 0, so -0.0
// maps as +0.0)
__device__ __forceinline__ unsigned int mono_u32(float f) {
  const unsigned int u = __float_as_uint(f);
  return f >= 0.0f ? (u | 0x80000000u) : ~u;
}

// The scan scalars' offsets (core/scalars.py ScanScalars): the sensor
// origin and the ds image of the grid's max corner per axis
enum Scalar { kOx = 0, kOy = 1, kOz = 2, kSh0 = 4, kSl0 = 5, kSh1 = 6, kSl1 = 7 };

}  // namespace gg
