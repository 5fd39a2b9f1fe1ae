// K4: fused ground-patch detection stencil (GroundSegmentation.cpp:314-395).
//
// Replaces the TPU kernel groundgrid_tpu/ops/pallas_detect.py:
// detect_ground_patches_fused (_detect_kernel). There, row blocks of the grid
// were fed three times (prev/self/next block specs) and the column halo came
// from jnp.roll wrap-around, so that a block and its 2-row halo fit VMEM.
// Here one thread owns one cell and reads its 5x5 neighbourhood of points,
// variance and min_ground_height straight from global memory: neighbouring
// threads read neighbouring words, so the ~25 reads per layer per cell are
// served by L1/L2 and each layer crosses HBM about once.
//
// Bound on the card: memory. Per scan it reads 5 grid layers and 4 tables
// and writes 2 layers: at 364^2 that is ~11 x 0.53 MB in and 2 x 0.53 MB out
// (use3 is one byte a cell), a few microseconds of HBM time; the launch and
// the per-cell arithmetic are the rest.
//
// Arithmetic is the TPU kernel's, in its order, so the plain PyTorch version
// (ops/detect.py detect_fused_plain) agrees bitwise: each box sum adds the
// rows r-2..r+2 (r-1..r+1) of a column left to right, then those column sums
// c-2..c+2 (c-1..c+1) left to right; min-pools take `v < acc ? v : acc` in the
// same order; the branch ladder is written as the kernel writes it. The
// library builds with --fmad=false, so no product is fused into an add.
//
// Only interior cells [2, n-2)^2 are updated, as the reference iterates them;
// every other cell copies ground and groundpatch through. An interior cell's
// window never leaves the grid, so no read is out of bounds.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float min_acc(float acc, float v) { return v < acc ? v : acc; }
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }

struct Window {
  float p, pv, pm, mn;  // box sums of points, points*variance, points*min_gh; min-pool of min_gh
};

// The (2h+1)^2 window around (r, c): per column the row sums (and row mins),
// then those column values left to right.
template <int H>
__device__ __forceinline__ Window window(const float* __restrict__ pts,
                                         const float* __restrict__ var,
                                         const float* __restrict__ mgh, int n, int r, int c) {
  float cp[2 * H + 1], cv[2 * H + 1], cm[2 * H + 1], cn[2 * H + 1];
#pragma unroll
  for (int j = 0; j < 2 * H + 1; ++j) {
    int col = c - H + j;
    float sp = 0.0f, sv = 0.0f, sm = 0.0f, mn = 0.0f;
#pragma unroll
    for (int i = 0; i < 2 * H + 1; ++i) {
      size_t at = (size_t)(r - H + i) * n + col;
      float p = pts[at];
      float m = mgh[at];
      float pv = p * var[at];
      float pm = p * m;  // empty cells: 0 * FLT_MAX == 0
      if (i == 0) {
        sp = p; sv = pv; sm = pm; mn = m;
      } else {
        sp = sp + p; sv = sv + pv; sm = sm + pm; mn = min_acc(mn, m);
      }
    }
    cp[j] = sp; cv[j] = sv; cm[j] = sm; cn[j] = mn;
  }
  Window w{cp[0], cv[0], cm[0], 0.0f};
#pragma unroll
  for (int j = 1; j < 2 * H + 1; ++j) {
    w.p = w.p + cp[j]; w.pv = w.pv + cv[j]; w.pm = w.pm + cm[j];
  }
  // the TPU kernel's column min: min(min(t[c-1], t[c]), t[c+1]) for 3x3,
  // then min(min(t[c-2], that), t[c+2]) for 5x5
  float m3 = min_acc(min_acc(cn[H - 1], cn[H]), cn[H + 1]);
  w.mn = H == 1 ? m3 : min_acc(min_acc(cn[0], m3), cn[2 * H]);
  return w;
}

__global__ void detect_kernel(const float* __restrict__ points,
                              const float* __restrict__ variance,
                              const float* __restrict__ min_gh,
                              const float* __restrict__ ground,
                              const float* __restrict__ conf,
                              const float* __restrict__ var_thr_sq,
                              const float* __restrict__ skip_thr,
                              const float* __restrict__ min_expected_s,
                              const bool* __restrict__ use3, int n, float pccvt,
                              float out_tol, float ocpcf, float* __restrict__ out_ground,
                              float* __restrict__ out_conf) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= n || c >= n) return;
  size_t at = (size_t)r * n + c;
  float g = ground[at];
  float cf = conf[at];
  if (r < 2 || r >= n - 2 || c < 2 || c >= n - 2) {
    out_ground[at] = g;
    out_conf[at] = cf;
    return;
  }
  Window w = use3[at] ? window<1>(points, variance, min_gh, n, r, c)
                      : window<2>(points, variance, min_gh, n, r, c);

  bool process = w.p >= skip_thr[at];
  float safe = clamp_min(w.p, 1.0f);
  float max_var = points[at] >= pccvt ? variance[at] : w.pv / safe;
  float groundlevel = w.pm / safe;

  float ground_diff = clamp_min((groundlevel - g) * (2.0f * cf), 1.0f);
  bool guard = (cf > 0.5f) && (groundlevel >= g + out_tol);
  bool branch1 = (var_thr_sq[at] > max_var * max_var) && (max_var > 0.0f) &&
                 (w.p > ground_diff * min_expected_s[at]);
  float new_c = clamp_max(w.p / ocpcf, 1.0f);
  float h1 = (groundlevel * new_c + cf * g * 2.0f) / (new_c + cf * 2.0f);
  float c1 = clamp_max((w.p / (ocpcf * 2.0f) + cf) / 2.0f, 1.0f);
  bool branch2 = w.mn < g;
  bool take1 = process && !guard && branch1;
  bool take2 = process && !guard && !branch1 && branch2;

  out_ground[at] = take1 ? h1 : (take2 ? w.mn : g);
  out_conf[at] = take1 ? c1 : (take2 ? clamp_max(cf + 0.1f, 0.5f) : cf);
}

}  // namespace

// All layers (n, n) f32 row-major, use3 (n, n) bool; outputs (n, n) f32.
extern "C" int gg_detect(const float* points, const float* variance, const float* min_gh,
                         const float* ground, const float* conf, const float* var_thr_sq,
                         const float* skip_thr, const float* min_expected_s,
                         const bool* use3, int n, float pccvt, float out_tol, float ocpcf,
                         float* out_ground, float* out_conf, cudaStream_t stream) {
  dim3 threads(32, 8);
  dim3 blocks((n + threads.x - 1) / threads.x, (n + threads.y - 1) / threads.y);
  detect_kernel<<<blocks, threads, 0, stream>>>(points, variance, min_gh, ground, conf,
                                                var_thr_sq, skip_thr, min_expected_s, use3,
                                                n, pccvt, out_tol, ocpcf, out_ground,
                                                out_conf);
  return (int)cudaGetLastError();
}
