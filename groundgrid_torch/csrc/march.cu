// K6 and K7: the occlusion march, core/outliers.py march_budget and march.
//
// Replace what XLA fuses of the JAX step's outlier rejection,
// groundgrid_tpu/core/outliers.py:116 detect_outliers (the per-point
// budgets before its lax.top_k, and the lattice march after it, whose key
// reads go through the sorted-lookup Pallas kernel there), itself the
// per-point while loop of GroundSegmentation.cpp:242-275. Eager PyTorch runs
// these chains as ~1,450 elementwise kernels a scan plus one K2 gather over
// the (steps x candidates) lattice; here they are two launches around the
// PyTorch top-k that selects the candidates.
//
// K6 march_budget, one thread a point: the candidate test against the
// previous terrain, the f64-faithful ray (sumsq3_ds, sqrt_rn_ds), the
// correctly rounded vertical direction (div_rn), the budget (the squared
// ray length of a downward candidate, else 0) and the unique int64
// selection key (outliers.selection_key: the truncated monotone budget over
// the index up to 2^17 points, the exact budget over 2^32 - 1 - index
// above). Bound on the card: bytes, 30 a point (3.9 MB at 131,072 points,
// 1.2 us at 3.35 TB/s), against 387 f32 operations a point (0.76 us at 67
// TFLOP/s).
//
// K7 march, one warp a candidate: every lane recomputes the candidate's ray
// and its three directions (the same operations, so no exchange), then the
// lanes take the steps 3 .. ray_steps-1 32 at a time. A step is live while
// step^2 < budget (monotone in the step, so a round with no live lane ends
// the walk); a live step bins its sample (ds_bin on both axes), and hits
// where the sample lies inside the grid and the cell's occlusion key
// (occlusion_key_table, a u32 per cell) reaches the monotone image of the
// sample's height plus the tolerance. `any` over the steps is order-free, so
// the warp stops at the round of the first hit (__any_sync) and lane 0
// stores a 1; the top-k indices are unique, so the store is a plain one and
// every other point keeps the 0 the wrapper wrote. Its work: 639 f32
// operations a candidate for its ray and directions, 182 a live step up to
// its first hit; a zero-budget candidate (the padding of the fixed buffer)
// ends after its ray. The data decide whether bytes or operations bound it
// (chip_smoke.py phase 2 counts both); the ray's dependent chain of ~640
// operations sets its latency.
//
// Both read the scan scalars in device memory (never by value: a captured
// graph replays on any scan) and take a batch of vehicles in one launch,
// blockIdx.y the vehicle, each vehicle bitwise its single launch.
#include <cuda_runtime.h>

#include "exactf32.cuh"

namespace {

constexpr int kIdxBits = 17;  // outliers.IDX_BITS
constexpr int kWarps = 8;     // K7: candidates a block

struct Ray {
  float dx, dy, dz, length;
};

// outliers._ray: the ray from the sensor origin, f64-faithful
__device__ __forceinline__ Ray ray(float x, float y, float z, const float* s) {
  const float dx = gg::sub(x, s[gg::kOx]);
  const float dy = gg::sub(y, s[gg::kOy]);
  const float dz = gg::sub(z, s[gg::kOz]);
  const gg::DS ss = gg::sumsq3_ds(dx, dy, dz);
  return {dx, dy, dz, gg::sqrt_rn_ds(ss.h, ss.l)};
}

__global__ void march_budget_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                    const float* __restrict__ z, const float* __restrict__ old_h,
                                    const bool* __restrict__ inmap,
                                    const bool* __restrict__ ignored, int p,
                                    const float* __restrict__ scalars, int stride,
                                    float* __restrict__ budget, long long* __restrict__ key) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const size_t k = (size_t)blockIdx.y * p + i;
  const float* s = scalars + (size_t)blockIdx.y * stride;
  const float zk = z[k];
  const bool cand = inmap[k] & !ignored[k] & (zk < gg::sub(old_h[k], (float)0.2));
  const Ray r = ray(x[k], y[k], zk, s);
  const float len2 = gg::mul(r.length, r.length);
  const float vz = gg::div_rn(r.dz, r.length);
  const float b = (cand & (vz < (float)-0.01)) ? len2 : 0.0f;
  budget[k] = b;
  if (p <= 1 << kIdxBits) {
    const long long mask = ~((1LL << kIdxBits) - 1);
    key[k] = ((long long)gg::mono_u32(b) & mask) | (long long)i;
  } else {
    key[k] = (long long)(((unsigned long long)__float_as_uint(b) << 32) |
                         (0xFFFFFFFFu - (unsigned int)i));
  }
}

struct MarchArgs {
  const long long* pidx;  // (batch, kc) candidate indices, unique a row
  const float* x;
  const float* y;
  const float* z;
  const float* budget;
  const unsigned int* keys;  // (batch, n * n) occlusion keys
  const float* scalars;
  int* out;  // (batch, p), zero but at the hits
};

__global__ void march_kernel(MarchArgs a, int kc, int p, int stride, int n, float rh, float rl,
                             float inv, float tol, int ray_steps) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= kc) return;  // the whole warp
  const size_t row = blockIdx.y;
  const float* s = a.scalars + row * stride;
  const long long q = a.pidx[row * kc + c];
  const size_t k = row * p + (size_t)q;
  const float b = a.budget[k];
  const Ray r = ray(a.x[k], a.y[k], a.z[k], s);
  const float vx = gg::div_rn(r.dx, r.length);
  const float vy = gg::div_rn(r.dy, r.length);
  const float vz = gg::div_rn(r.dz, r.length);
  const gg::Res res = gg::make_res(rh, rl, inv);
  const float ox = s[gg::kOx], oy = s[gg::kOy], oz = s[gg::kOz];
  const float sh0 = s[gg::kSh0], sl0 = s[gg::kSl0], sh1 = s[gg::kSh1], sl1 = s[gg::kSl1];
  const unsigned int* keys = a.keys + row * (size_t)n * n;
  for (int first = 3; first < ray_steps; first += 32) {
    const int t = first + lane;
    const float step = (float)t;
    const bool live = t < ray_steps && gg::mul(step, step) < b;
    if (!__any_sync(0xFFFFFFFFu, live)) return;  // no later step is live either
    bool hit = false;
    if (live) {
      const int i0 = gg::ds_bin(sh0, sl0, gg::add(ox, gg::mul(step, vx)), res);
      const int i1 = gg::ds_bin(sh1, sl1, gg::add(oy, gg::mul(step, vy)), res);
      if ((i0 > 0) & (i1 > 0) & (i0 < n - 1) & (i1 < n - 1)) {
        const unsigned int thr = gg::mono_u32(gg::add(gg::add(gg::mul(step, vz), oz), tol));
        hit = keys[i0 * n + i1] >= thr;
      }
    }
    if (__any_sync(0xFFFFFFFFu, hit)) {
      if (lane == 0) a.out[k] = 1;
      return;
    }
  }
}

}  // namespace

// x, y, z, old_h: (batch, p) f32; inmap, ignored: (batch, p) bool; scalars:
// the first row's scan scalars, rows `stride` floats apart; budget (f32) and
// key (i64) out, (batch, p). p >= 1, 1 <= batch <= 65535.
extern "C" int gg_march_budget(const float* x, const float* y, const float* z,
                               const float* old_h, const bool* inmap, const bool* ignored, int p,
                               int batch, const float* scalars, int stride, float* budget,
                               long long* key, cudaStream_t stream) {
  if (p < 1 || batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  dim3 blocks((p + threads - 1) / threads, batch);
  march_budget_kernel<<<blocks, threads, 0, stream>>>(x, y, z, old_h, inmap, ignored, p,
                                                      scalars, stride, budget, key);
  return (int)cudaGetLastError();
}

// pidx: (batch, kc) i64 point indices in [0, p), unique a row; x, y, z,
// budget: (batch, p) f32; keys: (batch, n * n) u32; out: (batch, p) i32,
// zeroed by the caller. (rh, rl, inv): core/exactf32.res_ds; tol: the
// outlier tolerance as f32. kc >= 1, 1 <= batch <= 65535.
extern "C" int gg_march(const long long* pidx, int kc, const float* x, const float* y,
                        const float* z, const float* budget, int p, int batch,
                        const void* keys, int n, const float* scalars, int stride, float rh,
                        float rl, float inv, float tol, int ray_steps, int* out,
                        cudaStream_t stream) {
  if (kc < 1 || p < 1 || batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  dim3 blocks((kc + kWarps - 1) / kWarps, batch);
  MarchArgs a{pidx, x, y, z, budget, static_cast<const unsigned int*>(keys), scalars, out};
  march_kernel<<<blocks, kWarps * 32, 0, stream>>>(a, kc, p, stride, n, rh, rl, inv, tol,
                                                   ray_steps);
  return (int)cudaGetLastError();
}
