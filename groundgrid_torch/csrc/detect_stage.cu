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
// Layout: one block of kThreads threads a tile of kTileH x kTileW output
// cells; each thread a strip of kStrip consecutive cells of one row.
// - A thread first issues its own cells' loads: ground, groundpatch, the
//   centre's variance and each cell's 16-byte table record (var_thr_sq,
//   skip_thr, min_expected_s and the use3 and interior bits, packed once
//   per device by core/detect.py make_tables), so that they are in flight
//   while the block stages.
// - The tile's input rows and columns plus a rim (2 rows, 4 columns: the
//   windows need 2, the 4 keep a staged row on the input's 16-byte
//   boundaries) are staged once into shared memory as points,
//   points*variance, points*min_gh (each product formed once per staged
//   cell, as the plain stage forms it once per cell) and min_gh, in
//   16-byte loads where the rows allow (n a multiple of 4), else in 4-byte
//   ones; all of a thread's staging loads are issued before its first
//   store. The barrier also tells every thread whether any staged min_gh
//   of the block is NaN (__syncthreads_or).
// - After the barrier the thread walks its strip's window rows top to
//   bottom: each row's kStrip + 4 staged words of each layer come into
//   registers once (8-byte shared loads), and every cell of the strip
//   folds its own chain from them, in its own row-major order from its
//   first offset, so each result is bitwise the chain it was. A 5x5 cell's
//   100 shared loads become 4 (kStrip + 4) * 5 / kStrip words (60 at
//   kStrip = 2). A 3x3 cell folds its window from the same registers; a
//   strip that crosses the use3 circle folds both windows, a strip of one
//   kind only its own. In a block without a NaN min_gh every minimum is
//   fminf, which torch.minimum is when neither operand is NaN: one
//   instruction a step where its NaN tests take four more.
// Cells outside the interior copy ground and groundpatch through.
// ops/detect_stage.py tile_plan is the Python twin of the split.
//
// What sets the time on the card: at 364^2 the grid is one wave, so a
// block's critical path (its loads, the barrier, the fold, the ladder);
// over many waves (1200^2, a batch) the fold's instructions and the
// staging loads. kTileH, kTileW and kStrip were chosen from three measured
// candidates (chip_smoke.py --k8-tiles; PERF.md). Bound on the card: bytes
// (per output cell 5 f32 layers and 14 bytes of tables read, 2 f32 layers
// written). No float atomics: two runs are bitwise equal. A batch of grids
// (the fleet's batched step) is one launch: blockIdx.z is the grid, whose
// layers lie one grid's words past the previous one's; the tables are
// shared.
#include <cuda_runtime.h>

#include "exactf32.cuh"

namespace {

constexpr int kTileW = 64;                  // output columns per block
constexpr int kTileH = 8;                   // output rows per block
constexpr int kStrip = 2;                   // consecutive cells of a row per thread
constexpr int kThreadsW = kTileW / kStrip;  // threads per tile row
constexpr int kThreads = kThreadsW * kTileH;
// staged columns: the tile and a 4-cell rim a side (the windows need 2),
// so that a staged row starts on a 16-byte boundary of the input's rows
constexpr int kStagedW = kTileW + 8;
constexpr int kStagedH = kTileH + 4;        // staged rows: the 2-row rim
constexpr int kStaged = kStagedW * kStagedH;
constexpr int kPerThread = (kStaged + kThreads - 1) / kThreads;  // staged cells a thread
constexpr int kQuadsW = kStagedW / 4;       // 16-byte chunks of a staged row
constexpr int kQuads = kQuadsW * kStagedH;
constexpr int kQuadsPerThread = (kQuads + kThreads - 1) / kThreads;
constexpr int kRegs = kStrip + 4;           // a window row's staged words for a strip
static_assert(kTileW % 4 == 0 && kTileW % kStrip == 0 && kStrip % 2 == 0,
              "16-byte staged rows, 8-byte strips");

constexpr unsigned kUse3 = 1u, kInterior = 2u;  // the record's flag bits (make_tables)

struct __align__(16) Staged {
  float p[kStaged], pv[kStaged], pm[kStaged], m[kStaged];
};

struct Record {  // core/detect.py make_tables: one 16-byte record a cell
  float var_thr_sq, skip_thr, min_expected_s;
  unsigned flags;
};

struct Args {
  const float* points;          // (batch, rows + 2 halo, n): the stencil inputs
  const float* variance;
  const float* min_gh;
  const float* ground;          // (batch, rows, n)
  const float* conf;
  const int4* records;          // (rows, n) records, shared by the batch
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

// one offset of a window's chain; the first offset starts it (the plain
// fold starts with the first shifted slice, not 0: 0 + -0 would be +0).
// kNanFree: no staged min_gh of the block is NaN, so every minimum of the
// chain is fminf, one instruction where torch.minimum's NaN tests are four
template <bool kNanFree>
__device__ __forceinline__ void chain(Window& w, bool first, float p, float pv, float pm,
                                      float m) {
  if (first) {
    w = Window{p, pv, pm, m};
    return;
  }
  w.psum = gg::add(w.psum, p);
  w.pvsum = gg::add(w.pvsum, pv);
  w.pmsum = gg::add(w.pmsum, pm);
  w.localmin = kNanFree ? fminf(w.localmin, m) : minimum(w.localmin, m);
}

// the kRegs staged words of a row from `src`, 8-byte aligned
__device__ __forceinline__ void load_row(const float* src, float (&r)[kRegs]) {
#pragma unroll
  for (int q = 0; q < kRegs / 2; ++q) {
    const float2 v = reinterpret_cast<const float2*>(src)[q];
    r[2 * q] = v.x;
    r[2 * q + 1] = v.y;
  }
}

// a staged cell's four words from the input values p, v, m (on: the cell
// lies on the input; else the plain stage's pads, 0 and +inf)
struct Cell {
  float p, pv, pm, m;
};

__device__ __forceinline__ Cell stage(bool on, float p, float v, float m) {
  if (!on) return Cell{0.0f, 0.0f, 0.0f, __int_as_float(0x7f800000)};
  return Cell{p, gg::mul(p, v), gg::mul(p, m), m};  // empty cells: 0 * FLT_MAX == 0
}

// the windows of a thread's strip, row by row from the staged row `top`
// (the strip's window row 0): each row's kRegs staged words of each layer
// into registers once, then every cell's chain in its own row-major order.
// A 5x5 cell j's window starts at register j of window row 0, a 3x3 cell's
// at register j + 1 of row 1; the centre's points are register j + 2 of
// row 2. any5 / any3: the strip has an interior cell of that window
template <bool kNanFree>
__device__ __forceinline__ void fold_strip(const Staged& s, int top, bool any3, bool any5,
                                           Window (&w5)[kStrip], Window (&w3)[kStrip],
                                           float (&centre_p)[kStrip]) {
#pragma unroll
  for (int dr = 0; dr < 5; ++dr) {
    if (!any5 && (dr == 0 || dr == 4)) continue;
    const int base = top + dr * kStagedW;
    float P[kRegs], PV[kRegs], PM[kRegs], M[kRegs];
    load_row(s.p + base, P);
    load_row(s.pv + base, PV);
    load_row(s.pm + base, PM);
    load_row(s.m + base, M);
    if (dr == 2) {
#pragma unroll
      for (int j = 0; j < kStrip; ++j) centre_p[j] = P[j + 2];
    }
    if (any5) {
#pragma unroll
      for (int j = 0; j < kStrip; ++j) {
#pragma unroll
        for (int dc = 0; dc < 5; ++dc) {
          const int i5 = j + dc;  // cell j's window column dc in the row's registers
          chain<kNanFree>(w5[j], dr == 0 && dc == 0, P[i5], PV[i5], PM[i5], M[i5]);
        }
      }
    }
    if (any3 && dr >= 1 && dr <= 3) {
#pragma unroll
      for (int j = 0; j < kStrip; ++j) {
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const int i3 = j + 1 + dc;
          chain<kNanFree>(w3[j], dr == 1 && dc == 0, P[i3], PV[i3], PM[i3], M[i3]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) detect_stage_kernel(Args a) {
  __shared__ Staged s;
  const int in_rows = a.rows + 2 * a.halo;
  const size_t in_grid = (size_t)blockIdx.z * in_rows * a.n;
  const size_t out_grid = (size_t)blockIdx.z * a.rows * a.n;
  const int r0 = blockIdx.y * kTileH, c0 = blockIdx.x * kTileW;
  const int tx = threadIdx.x % kThreadsW, ty = threadIdx.x / kThreadsW;
  const int r = r0 + ty, first_c = c0 + tx * kStrip;

  // the strip's own loads, before the staging
  float g[kStrip], cf[kStrip], v[kStrip];
  Record t[kStrip];
#pragma unroll
  for (int j = 0; j < kStrip; ++j) {
    const int c = first_c + j;
    t[j].flags = 0u;  // a cell off the grid: not interior, written by no one
    g[j] = cf[j] = v[j] = 0.0f;
    if (r < a.rows && c < a.n) {
      const size_t cell = (size_t)r * a.n + c;  // the tables' index
      const int4 rec = __ldg(a.records + cell);
      t[j] = Record{__int_as_float(rec.x), __int_as_float(rec.y), __int_as_float(rec.z),
                    (unsigned)rec.w};
      g[j] = __ldg(a.ground + out_grid + cell);
      cf[j] = __ldg(a.conf + out_grid + cell);
      v[j] = __ldg(a.variance + in_grid + (size_t)(r + a.halo) * a.n + c);
    }
  }

  // staged cell (i, j) is input row r0 + halo - 2 + i, column c0 - 4 + j;
  // every load first, then the products and the stores. Rows whose words
  // lie on 16-byte boundaries (n a multiple of 4, aligned layers) are
  // staged in 16-byte chunks, which lie wholly on or off the input
  const int k0 = r0 + a.halo - 2, cs = c0 - 4;
  bool nan = false;  // a NaN among this thread's staged min_gh
  const bool quads = a.n % 4 == 0 &&
      (reinterpret_cast<size_t>(a.points) | reinterpret_cast<size_t>(a.variance) |
       reinterpret_cast<size_t>(a.min_gh)) % 16 == 0;
  if (quads) {
    float4 qp[kQuadsPerThread], qv[kQuadsPerThread], qm[kQuadsPerThread];
    bool on[kQuadsPerThread];
#pragma unroll
    for (int q = 0; q < kQuadsPerThread; ++q) {
      const int i = threadIdx.x + q * kThreads;
      const int k = k0 + i / kQuadsW, c = cs + 4 * (i % kQuadsW);
      on[q] = i < kQuads && k >= 0 && k < in_rows && c >= 0 && c < a.n;
      if (on[q]) {
        const size_t at = in_grid + (size_t)k * a.n + c;
        qp[q] = __ldg(reinterpret_cast<const float4*>(a.points + at));
        qv[q] = __ldg(reinterpret_cast<const float4*>(a.variance + at));
        qm[q] = __ldg(reinterpret_cast<const float4*>(a.min_gh + at));
      }
    }
#pragma unroll
    for (int q = 0; q < kQuadsPerThread; ++q) {
      const int i = threadIdx.x + q * kThreads;
      if (i >= kQuads) continue;
      const Cell x0 = stage(on[q], qp[q].x, qv[q].x, qm[q].x);
      const Cell x1 = stage(on[q], qp[q].y, qv[q].y, qm[q].y);
      const Cell x2 = stage(on[q], qp[q].z, qv[q].z, qm[q].z);
      const Cell x3 = stage(on[q], qp[q].w, qv[q].w, qm[q].w);
      nan |= on[q] && (x0.m != x0.m || x1.m != x1.m || x2.m != x2.m || x3.m != x3.m);
      // 16-byte stores: consecutive threads write consecutive chunks
      const int at = (i / kQuadsW) * kStagedW + 4 * (i % kQuadsW);
      reinterpret_cast<float4*>(s.p + at)[0] = make_float4(x0.p, x1.p, x2.p, x3.p);
      reinterpret_cast<float4*>(s.pv + at)[0] = make_float4(x0.pv, x1.pv, x2.pv, x3.pv);
      reinterpret_cast<float4*>(s.pm + at)[0] = make_float4(x0.pm, x1.pm, x2.pm, x3.pm);
      reinterpret_cast<float4*>(s.m + at)[0] = make_float4(x0.m, x1.m, x2.m, x3.m);
    }
  } else {
    float sp[kPerThread], sv[kPerThread], sm[kPerThread];
    bool on[kPerThread];
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int i = threadIdx.x + q * kThreads;
      const int k = k0 + i / kStagedW, c = cs + i % kStagedW;
      on[q] = i < kStaged && k >= 0 && k < in_rows && c >= 0 && c < a.n;
      if (on[q]) {
        const size_t at = in_grid + (size_t)k * a.n + c;
        sp[q] = __ldg(a.points + at);
        sv[q] = __ldg(a.variance + at);
        sm[q] = __ldg(a.min_gh + at);
      }
    }
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      const int i = threadIdx.x + q * kThreads;
      if (i >= kStaged) continue;
      const Cell c = stage(on[q], sp[q], sv[q], sm[q]);
      nan |= on[q] && c.m != c.m;
      s.p[i] = c.p;
      s.pv[i] = c.pv;
      s.pm[i] = c.pm;
      s.m[i] = c.m;
    }
  }
  const bool nan_free = !__syncthreads_or(nan);

  bool any3 = false, any5 = false;
#pragma unroll
  for (int j = 0; j < kStrip; ++j) {
    if (t[j].flags & kInterior) {
      if (t[j].flags & kUse3) any3 = true;
      else any5 = true;
    }
  }
  if (!any3 && !any5) {  // no interior cell: copied through
#pragma unroll
    for (int j = 0; j < kStrip; ++j) {
      if (r < a.rows && first_c + j < a.n) {
        const size_t at = out_grid + (size_t)r * a.n + first_c + j;
        a.out_ground[at] = g[j];
        a.out_conf[at] = cf[j];
      }
    }
    return;
  }

  Window w5[kStrip], w3[kStrip];
  float centre_p[kStrip];
  const int top = ty * kStagedW + tx * kStrip + 2;  // cell 0's window column 0
  if (nan_free) fold_strip<true>(s, top, any3, any5, w5, w3, centre_p);
  else fold_strip<false>(s, top, any3, any5, w5, w3, centre_p);
#pragma unroll
  for (int j = 0; j < kStrip; ++j) {
    const int c = first_c + j;
    if (r >= a.rows || c >= a.n) continue;
    const float gj = g[j], cfj = cf[j];
    float out_g = gj, out_c = cfj;
    if (t[j].flags & kInterior) {
      const Window w = (t[j].flags & kUse3) ? w3[j] : w5[j];
      const float safe = gg::clamp_min(w.psum, 1.0f);
      const float max_var = centre_p[j] >= a.pccvt ? v[j] : gg::div(w.pvsum, safe);
      const float groundlevel = gg::div(w.pmsum, safe);
      const float ground_diff =
          gg::clamp_min(gg::mul(gg::sub(groundlevel, gj), gg::mul(cfj, 2.0f)), 1.0f);
      const bool process = w.psum >= t[j].skip_thr;
      const bool guard = (cfj > 0.5f) && (groundlevel >= gg::add(gj, a.out_tol));
      const bool branch1 = (t[j].var_thr_sq > gg::mul(max_var, max_var)) &&
                           (max_var > 0.0f) &&
                           (w.psum > gg::mul(ground_diff, t[j].min_expected_s));
      if (process && !guard) {
        if (branch1) {
          const float new_c = clamp_max(gg::div(w.psum, a.ocpcf), 1.0f);
          out_g = gg::div(gg::add(gg::mul(groundlevel, new_c), gg::mul(gg::mul(cfj, gj), 2.0f)),
                          gg::add(new_c, gg::mul(cfj, 2.0f)));
          out_c = clamp_max(gg::div(gg::add(gg::div(w.psum, a.ocpcf2), cfj), 2.0f), 1.0f);
        } else if (w.localmin < gj) {
          out_g = w.localmin;
          out_c = clamp_max(gg::add(cfj, 0.1f), 0.5f);
        }
      }
    }
    const size_t at = out_grid + (size_t)r * a.n + c;
    a.out_ground[at] = out_g;
    a.out_conf[at] = out_c;
  }
}

}  // namespace

// The stencil inputs (batch, rows + 2 halo, n) f32, ground and groundpatch
// and the outputs (batch, rows, n) f32, all row-major; the records (rows, n)
// of 16 bytes (core/detect.py make_tables), shared by the batch. halo is 0
// or 2; 1 <= batch <= 65535.
extern "C" int gg_detect_stage(const float* points, const float* variance, const float* min_gh,
                               const float* ground, const float* conf, const void* records,
                               int rows, int n, int halo, int batch, float pccvt, float out_tol,
                               float ocpcf, float ocpcf2, float* out_ground, float* out_conf,
                               cudaStream_t stream) {
  if (n < 5 || rows < 1 || (halo != 0 && halo != 2) || batch < 1 || batch > 65535 ||
      (rows + kTileH - 1) / kTileH > 65535)
    return (int)cudaErrorInvalidValue;
  const Args args{points, variance, min_gh, ground, conf,
                  static_cast<const int4*>(records), out_ground, out_conf, rows, n, halo,
                  pccvt, out_tol, ocpcf, ocpcf2};
  const dim3 blocks((n + kTileW - 1) / kTileW, (rows + kTileH - 1) / kTileH, batch);
  detect_stage_kernel<<<blocks, kThreads, 0, stream>>>(args);
  return (int)cudaGetLastError();
}
