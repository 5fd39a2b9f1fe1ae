// K4: fused ground-patch detection stencil (GroundSegmentation.cpp:314-395).
//
// Replaces the TPU kernel groundgrid_tpu/ops/pallas_detect.py:
// detect_ground_patches_fused (_detect_kernel). There, row blocks of the grid
// were fed three times (prev/self/next block specs) and the column halo came
// from jnp.roll wrap-around, so that a block and its 2-row halo fit VMEM.
//
// Bound on the card: bytes. Per cell it reads 5 f32 layers (points,
// variance, min_ground_height, ground, groundpatch), 3 f32 tables and the
// bool use3, and writes 2 f32 layers: 41 B a cell, 5.4 MB at 364^2 and 59 MB
// at 1200^2. A cell's window needs 4-25 neighbours of three layers; one
// thread per cell reading its window (75 loads a 5x5 cell) is bound by the
// load pipeline. Here each word is loaded from memory into shared memory
// once per block that stages it, and each product is formed once:
// - Block (bx, by) owns output columns [c0, c0 + kTileW) and rows [r0, r1),
//   a strip of `rows` rows (ops/detect.py strip_rows). It stages kThreads =
//   kTileW + 4 columns, one thread each, and walks the strip's input rows
//   r0-2 .. r1+1 top down.
// - Staging: a ring of kRing row slots in shared memory, filled with
//   cp.async, 4 B a thread and layer (rows need not be 16 B aligned), 128 B
//   a warp. A slot holds one input row of points, variance and min_gh and,
//   for the output row two above it, ground, groundpatch, the three tables
//   and the use3 bytes (as aligned 4-byte words, 4 cells per copy). The
//   first window's 4 rows arrive under one wait and barrier; after that
//   the next row is in flight while one folds (kAhead: more rows in flight
//   were no faster on the card).
// - Row pass: each thread keeps its column's last 5 rows in registers,
//   forms points*variance and points*min_gh once per cell, and writes its
//   3-row and 5-row sums and mins (both, for every column: no use3
//   divergence here) to a shared column buffer.
// - Column pass, after one barrier: the thread of each output cell adds its
//   3 or 5 column values left to right and runs the branch ladder, whose
//   divisions only cells at or above the skip threshold reach.
// What sets the time is the block's serial rows (two barriers each), not the
// bytes: strips are short (2 rows at 364^2, 6 at 1200^2), and a strip's 4
// halo rows come from L2, where the neighbouring strips' blocks read them at
// about the same time (PERF.md, section 6). No float atomics, so two runs are bitwise equal.
//
// Arithmetic is the TPU kernel's, in its order, so the plain PyTorch version
// (ops/detect.py detect_fused_plain) agrees bitwise: each box sum adds the
// rows r-h..r+h of a column from the top down, then those column sums
// c-h..c+h left to right; min-pools take `v < acc ? v : acc` in the same
// order (columns: m3, then c-2 and c+2); the branch ladder is written as the
// kernel writes it. The library builds with --fmad=false, so no product is
// fused into an add.
//
// A batch of grids (the fleet's batched step) is one launch: blockIdx.z is
// the grid, whose five layers and two outputs lie n*n words past the
// previous grid's; the tables are shared. Each grid's blocks do what the
// single launch does, so each is bitwise its own launch.
//
// Only interior cells [2, n-2)^2 are updated, as the reference iterates them;
// every other cell copies ground and groundpatch through, each by the one
// block whose rows and columns, widened to the grid's edge for the first
// and last tiles, hold it (ops/detect.py tile_plan is the twin of this
// split). An interior cell's window never leaves the grid.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 124;            // output columns per block
constexpr int kThreads = kTileW + 4;   // staged columns per block, one thread each
constexpr int kAhead = 1;              // rows in flight beyond the one folding
constexpr int kRing = 4 + kAhead;      // row slots: the first window's 4 rows and those in flight
constexpr int kCellLayers = 5;         // ground, groundpatch, var_thr_sq, skip_thr, min_expected_s
constexpr int kUse3Words = 32;         // >= (3 + kTileW + 3) / 4
constexpr int kColVals = 10;           // per column: 3 sums and a min, 3- and 5-row; center p, v

struct Slot {
  float in[3][kThreads];               // points, variance, min_gh of input row k
  float cell[kCellLayers][kThreads];   // per-cell inputs of output row k - 2, by staged column
  uint32_t use3[kUse3Words];           // use3 bytes of output row k - 2, from an aligned word
};

struct Inputs {
  const float* layer[3];               // points, variance, min_gh
  const float* cell[kCellLayers];
  const bool* use3;
};

__device__ __forceinline__ float min_acc(float acc, float v) { return v < acc ? v : acc; }
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }

__device__ __forceinline__ void copy4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// byte offset of use3[at] within its aligned 4-byte word
__device__ __forceinline__ int word_offset(const bool* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
}

__device__ __forceinline__ void pass_through(const float* __restrict__ ground,
                                             const float* __restrict__ conf, int n, int r,
                                             int c, float* __restrict__ out_ground,
                                             float* __restrict__ out_conf) {
  const size_t at = (size_t)r * n + c;
  out_ground[at] = ground[at];
  out_conf[at] = conf[at];
}

__global__ void __launch_bounds__(kThreads)
detect_kernel(Inputs in, int n, int rows, float pccvt, float out_tol, float ocpcf,
              float* __restrict__ out_ground, float* __restrict__ out_conf) {
  __shared__ Slot ring[kRing];
  __shared__ float cols[kColVals][kThreads];

  const int j = threadIdx.x;
  const size_t vo = (size_t)blockIdx.z * n * n;  // this block's grid
  out_ground += vo;
  out_conf += vo;
  const int c0 = 2 + blockIdx.x * kTileW, cs = c0 - 2;
  const int tw = min(kTileW, n - 2 - c0);  // output columns of this block
  const int r0 = 2 + blockIdx.y * rows, r1 = min(r0 + rows, n - 2);
  const int k_begin = r0 - 2, k_end = r1 + 2;
  const bool mine = cs + j < n;  // this thread's staged column is on the grid

  const unsigned ring_s = static_cast<unsigned>(__cvta_generic_to_shared(ring));
  const float* lay0 = in.layer[0] + vo + cs + j;
  const float* lay1 = in.layer[1] + vo + cs + j;
  const float* lay2 = in.layer[2] + vo + cs + j;
  const float* cel0 = in.cell[0] + vo + cs + j;
  const float* cel1 = in.cell[1] + vo + cs + j;
  const float* cel2 = in.cell[2] + cs + j;
  const float* cel3 = in.cell[3] + cs + j;
  const float* cel4 = in.cell[4] + cs + j;
  // input row k (and the per-cell layers and use3 words of output row k - 2
  // when it is one of the block's) into its slot, per-cell layers by staged
  // column; one commit group per call, empty past the strip's end
  auto stage = [&](int k) {
    if (k < k_end) {
      const unsigned slot = ring_s + ((k - k_begin) % kRing) * sizeof(Slot);
      const int r = k - 2;
      const bool out = r >= r0;
      const size_t rk = (size_t)k * n, rr = (size_t)r * n;
      if (mine) {
        copy4(slot + 4 * j, lay0 + rk);
        copy4(slot + 4 * (kThreads + j), lay1 + rk);
        copy4(slot + 4 * (2 * kThreads + j), lay2 + rk);
        if (out) {
          copy4(slot + 4 * (3 * kThreads + j), cel0 + rr);
          copy4(slot + 4 * (4 * kThreads + j), cel1 + rr);
          copy4(slot + 4 * (5 * kThreads + j), cel2 + rr);
          copy4(slot + 4 * (6 * kThreads + j), cel3 + rr);
          copy4(slot + 4 * (7 * kThreads + j), cel4 + rr);
        }
      }
      if (out) {
        const bool* first = in.use3 + rr + c0;
        const int o = word_offset(first);
        if (j < (o + tw + 3) / 4) copy4(slot + 4 * (8 * kThreads + j), first - o + 4 * j);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // the first window's 4 rows and kAhead more in flight; one wait for the 4
#pragma unroll
  for (int i = 0; i < 4 + kAhead; ++i) stage(k_begin + i);
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead) : "memory");
  __syncthreads();

  // the column's last five rows, oldest first; variance of the centre row
  float wp[5] = {}, wpv[5] = {}, wpm[5] = {}, wm[5] = {}, wv[3] = {};
  auto fold = [&](const Slot& s) {
    const float p = s.in[0][j], v = s.in[1][j], m = s.in[2][j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wp[i] = wp[i + 1]; wpv[i] = wpv[i + 1]; wpm[i] = wpm[i + 1]; wm[i] = wm[i + 1];
    }
    wv[0] = wv[1]; wv[1] = wv[2];
    wp[4] = p; wpv[4] = p * v; wpm[4] = p * m;  // empty cells: 0 * FLT_MAX == 0
    wm[4] = m; wv[2] = v;
  };
  if (mine) {
#pragma unroll
    for (int i = 0; i < 4; ++i) fold(ring[i]);
  }
  for (int k = k_begin + 4; k < k_end; ++k) {
    const int slot = (k - k_begin) % kRing;
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1) : "memory");
    __syncthreads();  // row k is in; every thread is done with the slot refilled next
    stage(k + kAhead);
    const Slot& s = ring[slot];
    if (mine) {
      fold(s);
      // output row r = k - 2: rows r-2..r+2 are wp[0..4]
      cols[0][j] = (wp[1] + wp[2]) + wp[3];
      cols[1][j] = (wpv[1] + wpv[2]) + wpv[3];
      cols[2][j] = (wpm[1] + wpm[2]) + wpm[3];
      cols[3][j] = min_acc(min_acc(wm[1], wm[2]), wm[3]);
      cols[4][j] = (((wp[0] + wp[1]) + wp[2]) + wp[3]) + wp[4];
      cols[5][j] = (((wpv[0] + wpv[1]) + wpv[2]) + wpv[3]) + wpv[4];
      cols[6][j] = (((wpm[0] + wpm[1]) + wpm[2]) + wpm[3]) + wpm[4];
      cols[7][j] = min_acc(min_acc(min_acc(min_acc(wm[0], wm[1]), wm[2]), wm[3]), wm[4]);
      cols[8][j] = wp[2];
      cols[9][j] = wv[0];
    }
    __syncthreads();
    if (j >= tw) continue;
    const int r = k - 2;
    const int o = word_offset(in.use3 + (size_t)r * n + c0);
    const bool use3 = reinterpret_cast<const uint8_t*>(s.use3)[o + j] != 0;
    // output column c0 + j is staged column j + 2
    float wsum, wpvs, wpms, wmin;
    if (use3) {
      wsum = (cols[0][j + 1] + cols[0][j + 2]) + cols[0][j + 3];
      wpvs = (cols[1][j + 1] + cols[1][j + 2]) + cols[1][j + 3];
      wpms = (cols[2][j + 1] + cols[2][j + 2]) + cols[2][j + 3];
      wmin = min_acc(min_acc(cols[3][j + 1], cols[3][j + 2]), cols[3][j + 3]);
    } else {
      wsum = (((cols[4][j] + cols[4][j + 1]) + cols[4][j + 2]) + cols[4][j + 3]) + cols[4][j + 4];
      wpvs = (((cols[5][j] + cols[5][j + 1]) + cols[5][j + 2]) + cols[5][j + 3]) + cols[5][j + 4];
      wpms = (((cols[6][j] + cols[6][j + 1]) + cols[6][j + 2]) + cols[6][j + 3]) + cols[6][j + 4];
      const float m3 = min_acc(min_acc(cols[7][j + 1], cols[7][j + 2]), cols[7][j + 3]);
      wmin = min_acc(min_acc(cols[7][j], m3), cols[7][j + 4]);
    }
    const float g = s.cell[0][j + 2], cf = s.cell[1][j + 2];
    const float var_thr_sq = s.cell[2][j + 2], skip_thr = s.cell[3][j + 2];
    const float min_exp = s.cell[4][j + 2];

    // the ladder: cells below the skip threshold (most of the far field)
    // keep ground and confidence and need none of its divisions
    float out_g = g, out_c = cf;
    if (wsum >= skip_thr) {
      const float safe = clamp_min(wsum, 1.0f);
      const float groundlevel = wpms / safe;
      const bool guard = (cf > 0.5f) && (groundlevel >= g + out_tol);
      if (!guard) {
        const float max_var = cols[8][j + 2] >= pccvt ? cols[9][j + 2] : wpvs / safe;
        const float ground_diff = clamp_min((groundlevel - g) * (2.0f * cf), 1.0f);
        const bool branch1 = (var_thr_sq > max_var * max_var) && (max_var > 0.0f) &&
                             (wsum > ground_diff * min_exp);
        if (branch1) {
          const float new_c = clamp_max(wsum / ocpcf, 1.0f);
          out_g = (groundlevel * new_c + cf * g * 2.0f) / (new_c + cf * 2.0f);
          out_c = clamp_max((wsum / (ocpcf * 2.0f) + cf) / 2.0f, 1.0f);
        } else if (wmin < g) {
          out_g = wmin;
          out_c = clamp_max(cf + 0.1f, 0.5f);
        }
      }
    }
    const size_t at = (size_t)r * n + c0 + j;
    out_ground[at] = out_g;
    out_conf[at] = out_c;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // the border cells this block owns: its rows and columns, the first and
  // last tiles widened to the grid's edges
  const float* ground = in.cell[0] + vo;
  const float* conf = in.cell[1] + vo;
  const int cl = blockIdx.x == 0 ? 0 : c0;
  const int ch = blockIdx.x == gridDim.x - 1 ? n : c0 + tw;
  const int rl = blockIdx.y == 0 ? 0 : r0;
  const int rh = blockIdx.y == gridDim.y - 1 ? n : r1;
  const int wide = ch - cl;
  for (int i = j; i < (r0 - rl) * wide; i += kThreads)
    pass_through(ground, conf, n, rl + i / wide, cl + i % wide, out_ground, out_conf);
  for (int i = j; i < (rh - r1) * wide; i += kThreads)
    pass_through(ground, conf, n, r1 + i / wide, cl + i % wide, out_ground, out_conf);
  const int left = c0 - cl, side = left + ch - (c0 + tw);
  for (int i = j; i < (r1 - r0) * side; i += kThreads) {
    const int q = i % side;
    pass_through(ground, conf, n, r0 + i / side, q < left ? cl + q : c0 + tw + q - left,
                 out_ground, out_conf);
  }
}

}  // namespace

// The five layers and the outputs (batch, n, n) f32 row-major, the tables
// (n, n) f32 and use3 (n, n) bool, shared by the batch. `rows` is the strip
// height per block (ops/detect.py tile_plan). 1 <= batch <= 65535.
extern "C" int gg_detect(const float* points, const float* variance, const float* min_gh,
                         const float* ground, const float* conf, const float* var_thr_sq,
                         const float* skip_thr, const float* min_expected_s,
                         const bool* use3, int n, int batch, float pccvt, float out_tol,
                         float ocpcf, float* out_ground, float* out_conf, int rows,
                         cudaStream_t stream) {
  if (n < 5 || rows < 1 || batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  Inputs in{{points, variance, min_gh},
            {ground, conf, var_thr_sq, skip_thr, min_expected_s},
            use3};
  const int inner = n - 4;
  dim3 blocks((inner + kTileW - 1) / kTileW, (inner + rows - 1) / rows, batch);
  detect_kernel<<<blocks, kThreads, 0, stream>>>(in, n, rows, pccvt, out_tol, ocpcf,
                                                 out_ground, out_conf);
  return (int)cudaGetLastError();
}
