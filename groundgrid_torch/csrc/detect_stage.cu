// K8: the main path's ground-patch detection stage (GroundSegmentation.cpp:
// 314-395), the sweep of core/detect.py _update in one launch.
//
// Replaces what XLA fuses of the JAX package's non-fused detect stage,
// groundgrid_tpu/core/detect.py detect_ground_patches: the 3x3 and 5x5 SAME
// box sums of points, points*variance and points*min_ground_height
// (lax.reduce_window add) and min-pools of min_ground_height (reduce_window
// min), the per-cell use3 select and the branch ladder (jnp.where). The plain
// PyTorch stage runs it as ~200 launches of shifted-slice adds and selects.
//
// Held bitwise to the plain stage on the card, so every operation is the
// one its PyTorch kernel does, in its order:
// - Each window chain starts at its first offset (the plain fold starts with
//   the first shifted slice, not 0: 0 + -0 would be +0) and folds the other
//   offsets in row-major order, every add __fadd_rn.
// - The min is ATen's torch.minimum on the card: a NaN operand, the first
//   one, propagates; else fminf(acc, v), the same min.f32 with the same
//   operand order, so +0 and -0 come out as they do there.
// - clamp_min / clamp_max are ATen's: NaN passes through, else fmaxf / fminf.
// - Divisions by constants (exactf32.div_const) are __fdiv_rn by the f32
//   constants the wrapper passes (ops/detect_stage.py), pvsum / safe and
//   pmsum / safe IEEE divisions; `+ 0.1` adds 0.1f, as PyTorch rounds the
//   Python scalar to the tensor's f32; products and sums keep the plain
//   association: (groundpatch * ground) * 2.0, (groundlevel - ground) *
//   (2.0 * groundpatch). The library builds with --fmad=false besides.
// - Padding: the plain stage pads each window's layer with 0 (sums) or +inf
//   (minimum) around the rows it is given; staged cells off those rows or
//   columns take the same values, so even a window that leaves them (a cell
//   outside the interior, whose result is not used) folds what the plain
//   stage folds.
//
// Row blocks (the spatial step's shards): the three stencil inputs carry
// `halo` (0 or 2) ghost rows above and below the output rows; input row
// r + halo is output row r. ground, groundpatch and the tables are the
// output rows' own.
//
// Layout: one block of kTileH x kTileW threads a tile of output cells. The
// tile's input rows and columns plus a 2-cell rim are staged once into
// shared memory as points, points*variance, points*min_gh (each product
// formed once per staged cell, as the plain stage forms it once per cell)
// and min_gh; after one barrier each thread folds its own cell's 9 or 25
// offsets from shared memory and runs the ladder. Row-major chains share no
// prefix between neighbouring cells, so nothing is carried between them.
// Cells outside the interior copy ground and groundpatch through.
// ops/detect_stage.py tile_plan is the Python twin of the split.
//
// Bound on the card: bytes (per output cell 5 f32 layers, 3 f32 tables and
// 2 bool tables read, 2 f32 layers written). No float atomics: two runs are
// bitwise equal. A batch of grids (the fleet's batched step) is one launch:
// blockIdx.z is the grid, whose layers lie one grid's words past the
// previous one's; the tables are shared.
#include <cuda_runtime.h>

#include "exactf32.cuh"

namespace {

constexpr int kTileW = 32;               // output columns per block
constexpr int kTileH = 8;                // output rows per block
constexpr int kStagedW = kTileW + 4;     // staged columns: the tile and a 2-cell rim
constexpr int kStagedH = kTileH + 4;
constexpr int kStaged = kStagedW * kStagedH;

struct Staged {
  float p[kStaged], pv[kStaged], pm[kStaged], m[kStaged];
};

struct Args {
  const float* points;          // (batch, rows + 2 halo, n): the stencil inputs
  const float* variance;
  const float* min_gh;
  const float* ground;          // (batch, rows, n)
  const float* conf;
  const float* var_thr_sq;      // (rows, n) tables, shared by the batch
  const float* skip_thr;
  const float* min_expected_s;
  const bool* use3;
  const bool* interior;
  float* out_ground;            // (batch, rows, n)
  float* out_conf;
  int rows, n, halo;
  float pccvt, out_tol, ocpcf, ocpcf2;  // f32 constants: ocpcf2 = ocpcf * 2
};

// torch.minimum on the card (ATen's min_elementwise): NaN of a, else NaN of
// b, else ::min(a, b), which is fminf
__device__ __forceinline__ float minimum(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

// torch.clamp_max on the card: NaN passes through, else the smaller value
__device__ __forceinline__ float clamp_max(float v, float hi) {
  return isnan(v) ? v : fminf(v, hi);
}

struct Window {
  float psum, pvsum, pmsum, localmin;
};

// the window of size kSize x kSize whose top-left staged cell is `at`,
// folded from its first offset in row-major order
template <int kSize>
__device__ __forceinline__ Window fold(const Staged& s, int at) {
  Window w{s.p[at], s.pv[at], s.pm[at], s.m[at]};
#pragma unroll
  for (int d = 1; d < kSize * kSize; ++d) {
    const int i = at + (d / kSize) * kStagedW + d % kSize;
    w.psum = gg::add(w.psum, s.p[i]);
    w.pvsum = gg::add(w.pvsum, s.pv[i]);
    w.pmsum = gg::add(w.pmsum, s.pm[i]);
    w.localmin = minimum(w.localmin, s.m[i]);
  }
  return w;
}

__global__ void __launch_bounds__(kTileW * kTileH) detect_stage_kernel(Args a) {
  __shared__ Staged s;
  const int in_rows = a.rows + 2 * a.halo;
  const size_t in_grid = (size_t)blockIdx.z * in_rows * a.n;
  const size_t out_grid = (size_t)blockIdx.z * a.rows * a.n;
  const int r0 = blockIdx.y * kTileH, c0 = blockIdx.x * kTileW;
  // staged cell (i, j) is input row r0 + halo - 2 + i, column c0 - 2 + j
  const int k0 = r0 + a.halo - 2, cs = c0 - 2;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < kStaged; i += kTileW * kTileH) {
    const int k = k0 + i / kStagedW, c = cs + i % kStagedW;
    float p = 0.0f, pv = 0.0f, pm = 0.0f, m = __int_as_float(0x7f800000);  // the pads
    if (k >= 0 && k < in_rows && c >= 0 && c < a.n) {
      const size_t at = in_grid + (size_t)k * a.n + c;
      p = a.points[at];
      m = a.min_gh[at];
      pv = gg::mul(p, a.variance[at]);
      pm = gg::mul(p, m);  // empty cells: 0 * FLT_MAX == 0
    }
    s.p[i] = p;
    s.pv[i] = pv;
    s.pm[i] = pm;
    s.m[i] = m;
  }
  __syncthreads();

  const int r = r0 + threadIdx.y, c = c0 + threadIdx.x;
  if (r >= a.rows || c >= a.n) return;
  const size_t cell = (size_t)r * a.n + c;  // the tables' index
  const size_t at = out_grid + cell;
  const float g = a.ground[at], cf = a.conf[at];
  float out_g = g, out_c = cf;
  if (a.interior[cell]) {
    // the cell is staged at (threadIdx.y + 2, threadIdx.x + 2)
    const int centre = (threadIdx.y + 2) * kStagedW + threadIdx.x + 2;
    const Window w = a.use3[cell] ? fold<3>(s, centre - kStagedW - 1)
                                  : fold<5>(s, centre - 2 * kStagedW - 2);
    const float v = a.variance[in_grid + (size_t)(r + a.halo) * a.n + c];
    const float safe = gg::clamp_min(w.psum, 1.0f);
    const float max_var = s.p[centre] >= a.pccvt ? v : gg::div(w.pvsum, safe);
    const float groundlevel = gg::div(w.pmsum, safe);
    const float ground_diff =
        gg::clamp_min(gg::mul(gg::sub(groundlevel, g), gg::mul(cf, 2.0f)), 1.0f);
    const bool process = w.psum >= a.skip_thr[cell];
    const bool guard = (cf > 0.5f) && (groundlevel >= gg::add(g, a.out_tol));
    const bool branch1 = (a.var_thr_sq[cell] > gg::mul(max_var, max_var)) &&
                         (max_var > 0.0f) &&
                         (w.psum > gg::mul(ground_diff, a.min_expected_s[cell]));
    if (process && !guard) {
      if (branch1) {
        const float new_c = clamp_max(gg::div(w.psum, a.ocpcf), 1.0f);
        out_g = gg::div(gg::add(gg::mul(groundlevel, new_c), gg::mul(gg::mul(cf, g), 2.0f)),
                        gg::add(new_c, gg::mul(cf, 2.0f)));
        out_c = clamp_max(gg::div(gg::add(gg::div(w.psum, a.ocpcf2), cf), 2.0f), 1.0f);
      } else if (w.localmin < g) {
        out_g = w.localmin;
        out_c = clamp_max(gg::add(cf, 0.1f), 0.5f);
      }
    }
  }
  a.out_ground[at] = out_g;
  a.out_conf[at] = out_c;
}

}  // namespace

// The stencil inputs (batch, rows + 2 halo, n) f32, ground and groundpatch
// and the outputs (batch, rows, n) f32, all row-major; the tables (rows, n),
// three f32 and use3 and interior bool, shared by the batch. halo is 0 or 2;
// 1 <= batch <= 65535.
extern "C" int gg_detect_stage(const float* points, const float* variance, const float* min_gh,
                               const float* ground, const float* conf, const float* var_thr_sq,
                               const float* skip_thr, const float* min_expected_s,
                               const bool* use3, const bool* interior, int rows, int n,
                               int halo, int batch, float pccvt, float out_tol, float ocpcf,
                               float ocpcf2, float* out_ground, float* out_conf,
                               cudaStream_t stream) {
  if (n < 5 || rows < 1 || (halo != 0 && halo != 2) || batch < 1 || batch > 65535 ||
      (rows + kTileH - 1) / kTileH > 65535)
    return (int)cudaErrorInvalidValue;
  const Args args{points, variance, min_gh, ground, conf, var_thr_sq, skip_thr, min_expected_s,
                  use3, interior, out_ground, out_conf, rows, n, halo, pccvt, out_tol, ocpcf,
                  ocpcf2};
  const dim3 blocks((n + kTileW - 1) / kTileW, (rows + kTileH - 1) / kTileH, batch);
  detect_stage_kernel<<<blocks, dim3(kTileW, kTileH), 0, stream>>>(args);
  return (int)cudaGetLastError();
}
