// K6 and K7: the occlusion march, core/outliers.py march_budget and march.
//
// Replace what XLA fuses of the JAX step's outlier rejection,
// groundgrid_tpu/core/outliers.py:116 detect_outliers (the per-point
// budgets before its lax.top_k, the occlusion key table of :70, and the
// lattice march after the top-k, whose key reads go through the
// sorted-lookup Pallas kernel there), itself the per-point while loop of
// GroundSegmentation.cpp:242-275. Eager PyTorch runs these chains as ~1,480
// elementwise kernels a scan plus one K2 gather over the (steps x
// candidates) lattice; here they are two launches around K11 (select.cu),
// which selects the candidates: the stage is these three launches.
//
// K6 march_budget, one thread a point: the candidate test against the
// previous terrain first. The terrain under a point is the moved ground at
// its cell, which K6 gathers itself (no K2 launch before it; the JAX step
// gathers it by sorted_lookup): only an in-map, unignored point reads its
// cell id and then ground[cell], as K2 reads it (0 for an id outside [0,
// n2), the word as it lies, so -0.0 and NaN compare as the gathered word
// did). Only a candidate computes its f64-faithful ray (sumsq3_ds,
// sqrt_rn_ds) and its correctly rounded vertical direction (div_rn), and
// only a marchable one (a downward candidate: budget > 0) its two
// horizontal directions, which it writes beside vz for K7. Every point
// writes its budget (the squared ray length of a downward candidate, else
// +0.0) and its unique int64 selection key (outliers.selection_key: the
// truncated monotone budget over the index up to 2^17 points, the exact
// budget over 2^32 - 1 - index above), and zeroes its outlier flag (a
// bool), which K7 sets at the hits. Bound on the card: bytes, 19 a
// point (z, the flags; budget, key and outlier flag), 4 an in-map
// unignored point (its id) and 4 a distinct ground cell those ids name, 8
// a candidate (x, y) and 12 a marchable point (3.0 MB on a warm scan of
// 131,072 points, 0.90 us at 3.35 TB/s); the operations (386 a candidate's ray and vz, 246 a
// marchable point's vx and vy) are a fraction of that on the main path's
// data. The points come sorted by cell on the main path, so candidates
// cluster, whole warps skip the ray, and neighbouring threads read
// neighbouring ground words.
//
// K7 march, one warp a candidate: a warp at a position at or past
// min(n_marchable, kc), K11's count, ends after that one load: K11 puts
// every marchable point before every other, so the padding of the fixed
// candidate buffer is no candidate. Any other reads the candidate's budget
// and ends at once, the whole warp, when no step is live (3^2 < budget
// false). A
// marchable candidate reads the three directions K6 wrote (no ray of its
// own), then the lanes take the steps 3 .. ray_steps-1 32 at a time. A step
// is live while step^2 < budget (monotone in the step, so a round with no
// live lane ends the walk); a live step bins its sample (ds_bin on both
// axes), and hits where the sample lies inside the grid and the cell's
// occlusion key reaches the monotone image of the sample's height plus the
// tolerance. The key is outliers.occlusion_key_table's, computed here for
// the cell alone from the moved ground and groundpatch: mono(ground) where
// the 3x3 groundpatch block sum at the low-side-clamped centre exceeds
// min_outlier_detection_ground_confidence and the cell's own groundpatch
// exceeds 0.01, else 0. The tests run cheapest first (the key reaches the
// threshold only if mono(ground) does; then the cell's confidence; then
// the block, nine independent loads summed in the table's row-major
// order), which decides the same bit. `any` over the steps is order-free,
// so the warp stops at the round of the first hit (__any_sync) and lane 0
// stores true; the candidate indices are unique, so the store is a plain one
// and every other point keeps the false K6 wrote. Its work: 182 f32
// operations a live step up to its first hit, 8 adds a block summed; its
// bytes: the count, 12 a marchable candidate (index, budget), 12 more for
// its directions, the cells its samples read in both layers, and 1 a hit
// written; on the main path's data
// bytes and operations bound it about equally, ~0.04 us each at 364^2.
// What sets its time is the dependent chain of a round (two
// ds_bins, the cell's loads, the block's) and the launch.
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

// dirs: (3, batch, p), the planes vx, vy, vz, written where the budget is
// positive
// ground: (batch, n2), the moved grids; cell: (batch, p) the points' ids
__global__ void march_budget_kernel(const float* __restrict__ x, const float* __restrict__ y,
                                    const float* __restrict__ z, const int* __restrict__ cell,
                                    const bool* __restrict__ inmap,
                                    const bool* __restrict__ ignored, int p,
                                    const float* __restrict__ ground, int n2,
                                    const float* __restrict__ scalars, int stride,
                                    float* __restrict__ budget, long long* __restrict__ key,
                                    float* __restrict__ dirs, bool* __restrict__ flags) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const size_t k = (size_t)blockIdx.y * p + i;
  const float zk = z[k];
  float b = 0.0f;
  bool cand = inmap[k] & !ignored[k];
  if (cand) {
    const int c = cell[k];
    const float old_h = (c >= 0 && c < n2) ? ground[(size_t)blockIdx.y * n2 + c] : 0.0f;
    cand = zk < gg::sub(old_h, (float)0.2);
  }
  if (cand) {
    const Ray r = ray(x[k], y[k], zk, scalars + (size_t)blockIdx.y * stride);
    const float vz = gg::div_rn(r.dz, r.length);
    if (vz < (float)-0.01) b = gg::mul(r.length, r.length);
    if (b > 0.0f) {
      const size_t plane = (size_t)gridDim.y * p;
      dirs[k] = gg::div_rn(r.dx, r.length);
      dirs[plane + k] = gg::div_rn(r.dy, r.length);
      dirs[2 * plane + k] = vz;
    }
  }
  budget[k] = b;
  flags[k] = false;
  if (p <= 1 << kIdxBits) {
    const long long mask = ~((1LL << kIdxBits) - 1);
    key[k] = ((long long)gg::mono_u32(b) & mask) | (long long)i;
  } else {
    key[k] = (long long)(((unsigned long long)__float_as_uint(b) << 32) |
                         (0xFFFFFFFFu - (unsigned int)i));
  }
}

// Whether the occlusion key of cell (i0, i1), 0 < i0, i1 < n - 1 and n >= 5
// (outliers.occlusion_key_table), reaches thr: (ok ? mono(ground) : 0) >= thr
__device__ __forceinline__ bool occludes(const float* __restrict__ ground,
                                         const float* __restrict__ conf, int n, int i0, int i1,
                                         float min_conf, unsigned int thr) {
  if (thr == 0u) return true;  // every key reaches it, 0 too
  const size_t cell = (size_t)i0 * n + i1;
  const float g = __ldg(ground + cell);
  const float c = __ldg(conf + cell);
  if (gg::mono_u32(g) < thr || !(c > (float)0.01)) return false;
  // box3_sum at the low-side-clamped centre, inside the grid (no padding)
  const float* w = conf + (size_t)(max(i0, 3) - 1) * n + (max(i1, 3) - 1);
  float v[9];
#pragma unroll
  for (int di = 0; di < 3; ++di) {
#pragma unroll
    for (int dj = 0; dj < 3; ++dj) v[3 * di + dj] = __ldg(w + (size_t)di * n + dj);
  }
  float box = v[0];
#pragma unroll
  for (int j = 1; j < 9; ++j) box = gg::add(box, v[j]);
  return box > min_conf;
}

struct MarchArgs {
  const long long* pidx;         // (batch, kc) candidate indices, unique a row
  const long long* n_marchable;  // (batch,) K11's counts: the marchable lead pidx
  const float* budget;           // (batch, p)
  const float* dirs;      // (3, batch, p), defined where the budget is positive
  const float* ground;    // (batch, n, n), moved
  const float* conf;      // (batch, n, n), the moved groundpatch
  const float* scalars;
  bool* out;  // (batch, p), false but at the hits
};

__global__ void march_kernel(MarchArgs a, int kc, int p, int stride, int n, float rh, float rl,
                             float inv, float tol, float min_conf, int ray_steps) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const size_t row = blockIdx.y;
  if (c >= kc || c >= a.n_marchable[row]) return;  // no marchable candidate: the whole warp
  const size_t k = row * p + (size_t)a.pidx[row * kc + c];
  const float b = a.budget[k];
  if (ray_steps <= 3 || !(gg::mul(3.0f, 3.0f) < b)) return;  // no live step: the whole warp
  const size_t plane = (size_t)gridDim.y * p;
  const float vx = a.dirs[k], vy = a.dirs[plane + k], vz = a.dirs[2 * plane + k];
  const float* s = a.scalars + row * stride;
  const gg::Res res = gg::make_res(rh, rl, inv);
  const float ox = s[gg::kOx], oy = s[gg::kOy], oz = s[gg::kOz];
  const float sh0 = s[gg::kSh0], sl0 = s[gg::kSl0], sh1 = s[gg::kSh1], sl1 = s[gg::kSl1];
  const float* ground = a.ground + row * (size_t)n * n;
  const float* conf = a.conf + row * (size_t)n * n;
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
        hit = occludes(ground, conf, n, i0, i1, min_conf, thr);
      }
    }
    if (__any_sync(0xFFFFFFFFu, hit)) {
      if (lane == 0) a.out[k] = true;
      return;
    }
  }
}

}  // namespace

// x, y, z: (batch, p) f32; cell: (batch, p) i32; inmap, ignored: (batch, p)
// bool; ground: (batch, n2) f32, the moved grids; scalars: the first row's
// scan scalars, rows `stride` floats apart; budget (f32) and key (i64) out,
// (batch, p); dirs out, (3, batch, p) f32, written where the budget is
// positive; flags out, (batch, p) bool, false. p >= 1, n2 >= 1, 1 <= batch
// <= 65535.
extern "C" int gg_march_budget(const float* x, const float* y, const float* z, const int* cell,
                               const bool* inmap, const bool* ignored, int p, int batch,
                               const float* ground, int n2, const float* scalars, int stride,
                               float* budget, long long* key, float* dirs, bool* flags,
                               cudaStream_t stream) {
  if (p < 1 || n2 < 1 || batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  dim3 blocks((p + threads - 1) / threads, batch);
  march_budget_kernel<<<blocks, threads, 0, stream>>>(x, y, z, cell, inmap, ignored, p, ground,
                                                      n2, scalars, stride, budget, key, dirs,
                                                      flags);
  return (int)cudaGetLastError();
}

// pidx: (batch, kc) i64 point indices in [0, p), unique a row, the
// marchable ones first (K11's); n_marchable: (batch,) i64, K11's counts;
// budget: (batch, p) f32; dirs: (3, batch, p) f32 (gg_march_budget's);
// ground, conf: (batch, n, n) f32, the moved layers; out: (batch, p) bool,
// false (gg_march_budget's flags). (rh, rl, inv): core/exactf32.res_ds; tol
// and min_conf: the outlier tolerance and
// min_outlier_detection_ground_confidence as f32. kc >= 1, n >= 5, 1 <=
// batch <= 65535.
extern "C" int gg_march(const long long* pidx, int kc, const long long* n_marchable,
                        const float* budget, const float* dirs, const float* ground,
                        const float* conf, int p, int batch, int n, const float* scalars,
                        int stride, float rh, float rl, float inv, float tol, float min_conf,
                        int ray_steps, bool* out, cudaStream_t stream) {
  if (kc < 1 || p < 1 || n < 5 || batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  dim3 blocks((kc + kWarps - 1) / kWarps, batch);
  MarchArgs a{pidx, n_marchable, budget, dirs, ground, conf, scalars, out};
  march_kernel<<<blocks, kWarps * 32, 0, stream>>>(a, kc, p, stride, n, rh, rl, inv, tol,
                                                   min_conf, ray_steps);
  return (int)cudaGetLastError();
}
