// K1: per-cell reductions over points sorted by flat cell id.
//
// Replaces the TPU kernel groundgrid_tpu/ops/pallas_raster.py:raster_sums
// (one-hot MXU matmul over bf16 3-way splits, _make_kernel/build_parts).
// Here each column carries its own op (sum, min, max) and is folded over
// each cell's run of points in point order, with no float atomics: every
// sum is the same chain of f32 adds as in the plain version
// (ops/raster.py raster_reduce_plain), so results are bitwise that and the
// same from run to run.
//
// Bound on the card: memory. It reads the ids and each column once (k x 4 B
// per point) and writes k x 4 B per cell: at the main path's 131,072 points
// x 7 columns and 364^2 cells ~7.5 MB, 2.2 us at 3.35 TB/s. What stands in
// the way is the data: a few near-sensor runs hold hundreds of points while
// ~90 % of the cells hold none, so a block that took a fixed number of
// points could have to write ten thousand empty cells.
//
// The split (ops/raster.py tile_plan is its Python twin), a merge path
// over points and cells:
// - Merge the points and the cells' ends in one order: cell c's points,
//   then its end. Point p lies at p + cell[p], the end of cell c after all
//   points of cells <= c. Block b takes the kTile items [b kTile,
//   (b+1) kTile) of that order: the points [i_b, i_{b+1}) and the cell ends
//   [j_b, j_{b+1}), j_b = b kTile - i_b. One warp finds i_b by a 32-way
//   search over the ids, another i_{b+1}. So every block has at most kTile
//   points and cells. (The split is clamped to that, so that ids out of
//   order give wrong values but never an access outside the block's
//   shared memory or the output.)
// - The block stages its ids and columns into shared memory with
//   asynchronous 16 B copies (cp.async), all in flight at once. A run
//   belongs to the block holding its first point (p = 0 or
//   cell[p-1] != cell[p]); the block compacts its run heads with a prefix
//   sum. Points that continue the previous block's run are skipped.
// - Its last run may go on past its points. Where it does (the warp that
//   finds i_{b+1} reads the ids on both sides), the block stages the next
//   kHalo ids and values with its own and finds the run's end among them,
//   so that its folds read shared memory; a run longer still ends where one
//   warp finds it (a 32-way search over the ids in global memory), its
//   folds reading the rest from global memory.
// - One thread folds one column of one run, from shared memory, in point
//   order. Pair i is (run i mod H', column i div H') with H' = H | 1 odd,
//   so neighbouring threads write neighbouring cells of one output row and
//   the k columns of a long run land on k different threads.
// - The block writes 0 in every empty cell of [j_b, j_{b+1}) (16 B stores
//   where four aligned cells are empty), its cells with points known from a
//   bitmap in shared memory: the cells of its runs, of its first point and
//   of the point before it. A cell with points is written by its run's
//   owner, an empty one by the block holding its end: each cell of each
//   column exactly once.
// - The column pointers arrive as one __grid_constant__ struct, read in
//   place: no stacked copy of the columns.
//
// Cell id n2 is the overflow bin and is dropped (ids outside [0, n2] count
// as n2).
// Empty cells read 0 for every op. Any point count works.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;  // points and cells per block (a multiple of 4)
constexpr int kHalo = 512;   // ids and values staged past a block's points for its last run
constexpr int kRow = kTile + 4 + kHalo;  // staged ids or values of one column
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemLimit = 232448;  // a block's shared memory on Hopper

struct Cols {
  const float* p[kMaxCols];
};

// dst[0, cnt) = src[0, cnt) by the whole block with asynchronous copies
// (cp.async: all of a thread's copies in flight at once, none through
// registers), 16 B each where both are 16 B aligned; the caller waits with
// async_wait() and a barrier
template <typename S>
__device__ __forceinline__ void stage_async(S* dst, const S* __restrict__ src, int cnt) {
  static_assert(sizeof(S) == 4, "4-byte elements");
  int i = threadIdx.x;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    for (; 4 * i < (cnt & ~3); i += kThreads) {
      const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + 4 * i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src + 4 * i));
    }
    i = (cnt & ~3) + threadIdx.x;
  }
  for (; i < cnt; i += kThreads) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src + i));
  }
}

__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The smallest i in [lo, hi] with pred(i), pred monotone and true at hi:
// one warp, 32 probes a round (every lane gets the answer).
template <typename Pred>
__device__ int warp_search(int lo, int hi, Pred pred) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int q = lo + lane * step;
    const unsigned ball = __ballot_sync(kFull, q >= hi || pred(q));
    if (ball == 0) {
      lo += 31 * step + 1;
      continue;
    }
    const int f = __ffs(ball) - 1;
    if (f == 0) return lo;
    hi = min(hi, lo + f * step);
    lo += (f - 1) * step + 1;
  }
  return lo;
}

template <unsigned Op>
__device__ __forceinline__ float fold(float acc, float v) {
  if (Op == 0u) return acc + v;
  if (Op == 1u) return v < acc ? v : acc;
  return v > acc ? v : acc;
}

// the run's points [s, e) in shared memory, then col[e, ce) in global memory
template <unsigned Op>
__device__ __forceinline__ float fold_run(const float* src, int s, int e,
                                         const float* __restrict__ col, int ce) {
  float acc = Op == 0u ? 0.0f : src[s];
#pragma unroll 8
  for (int q = Op == 0u ? s : s + 1; q < e; ++q) acc = fold<Op>(acc, src[q]);
#pragma unroll 8
  for (int q = e; q < ce; ++q) acc = fold<Op>(acc, __ldg(col + q));
  return acc;
}

// 0 in every column at the cells of [a, b) whose bit (from base) is clear
__device__ __forceinline__ void zero_cells(const unsigned* s_bits, int base, int a, int b,
                                           int k, int n2, float* __restrict__ out) {
  for (int c = a + threadIdx.x; c < b; c += kThreads) {
    const int o = c - base;
    if (!((s_bits[o >> 5] >> (o & 31)) & 1u)) {
      for (int j = 0; j < k; ++j) out[(size_t)j * n2 + c] = 0.0f;
    }
  }
}

// ids outside [0, n2] count as n2, the overflow bin
__device__ __forceinline__ int clamp_id(int c, int n2) {
  return (unsigned)c < (unsigned)n2 ? c : n2;
}

__global__ void __launch_bounds__(kThreads)
raster_reduce_kernel(const int* __restrict__ cell, const __grid_constant__ Cols cols, int p,
                     int k, unsigned ops, int n2, float* __restrict__ out) {
  // ids (from i_b rounded down to 4, with the halo), k rows of column
  // values, the run heads, the bitmap of [j_b & ~31, j_{b+1})
  extern __shared__ int4 smem4[];
  int* s_id = reinterpret_cast<int*>(smem4);
  float* s_col = reinterpret_cast<float*>(s_id + kRow);
  int* s_head = reinterpret_cast<int*>(s_col + (size_t)k * kRow);
  unsigned* s_bits = reinterpret_cast<unsigned*>(s_head + kTile);
  __shared__ int s_part[2];
  __shared__ int s_more;  // the run of point i_{b+1} - 1 goes on at i_{b+1}
  __shared__ int s_warp[kWarps];
  __shared__ int s_cont;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long items = (long)p + n2;
  const long d0 = min(items, (long)blockIdx.x * kTile);
  const long d1 = min(items, (long)(blockIdx.x + 1) * kTile);
  if (warp < 2) {  // i_b and i_{b+1}: the points before the block's first and last item
    const int d = (int)(warp ? d1 : d0);
    const int i = warp_search(max(0, d - n2), min(d, p),
                              [&](int q) { return q + clamp_id(__ldg(cell + q), n2) >= d; });
    if (lane == 0) {
      s_part[warp] = i;
      if (warp == 1) {
        const int c = i > 0 && i < p ? clamp_id(__ldg(cell + i), n2) : n2;
        s_more = c < n2 && c == clamp_id(__ldg(cell + i - 1), n2);
      }
    }
  }
  __syncthreads();
  // at most the block's d1 - d0 items in points and cells, as sorted ids
  // always give: out of order, the two searches need not agree
  const int ib = s_part[0], ie = min(max(s_part[1], ib), ib + (int)(d1 - d0));
  const int jb = (int)d0 - ib;
  const int je = min((int)d1 - ie, n2);
  const int a = ib & ~3;                  // s_id[0] and s_col[j][0] hold point a
  const int off = ib - a, cnt = ie - ib;  // the block's points: [off, off + cnt)
  const int halo = s_more && cnt > 0 ? min(kHalo, p - ie) : 0;
  const int prev = ib > 0 ? clamp_id(__ldg(cell + ib - 1), n2) : -1;

  // ids and values of the block's points and, where the last run goes on,
  // the halo past them
  stage_async(s_id, cell + a, off + cnt + halo);
  for (int j = 0; j < k; ++j) stage_async(s_col + (size_t)j * kRow, cols.p[j] + a, off + cnt + halo);
  async_wait();
  __syncthreads();
  auto id = [&](int i) { return clamp_id(s_id[i], n2); };

  // run heads: each thread flags kTile / kThreads consecutive points, then
  // a block-wide exclusive scan of the counts places them in s_head
  constexpr int per = kTile / kThreads;
  const int i0 = off + t * per, i1 = min(i0 + per, off + cnt);
  int nh = 0;
  for (int i = i0; i < i1; ++i) nh += id(i) != (i > off ? id(i - 1) : prev);
  int incl = nh;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int u = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += u;
    }
    if (lane < kWarps) s_warp[lane] = v;
  }
  __syncthreads();
  int slot = (warp ? s_warp[warp - 1] : 0) + incl - nh;
  for (int i = i0; i < i1; ++i) {
    if (id(i) != (i > off ? id(i - 1) : prev)) s_head[slot++] = i;
  }
  const int H = s_warp[kWarps - 1];
  const int stop = off + cnt;  // one past the block's last point, in s_id
  const int last = cnt > 0 ? id(stop - 1) : -1;
  if (warp == 0) {  // where the last run ends, if it goes on past the block
    int cont = stop;
    if (H > 0 && halo > 0 && last < n2 && id(stop) == last) {
      // first in the staged halo, 32 ids a round; then in global memory
      int i = stop + 1;
      for (;; i += 32) {
        const int q = i + lane;
        const unsigned ball = __ballot_sync(kFull, q >= stop + halo || id(q) != last);
        if (ball) {
          i += __ffs(ball) - 1;
          break;
        }
      }
      cont = i;
      if (i == stop + halo && a + i < p && __ldg(cell + a + i) == last) {
        cont = warp_search(a + i + 1, p, [&](int q) { return __ldg(cell + q) != last; }) - a;
      }
    }
    if (lane == 0) s_cont = cont;
  }
  // the bitmap of the cells with points in [jb, je), from a 32-cell boundary
  const int base = jb & ~31;
  for (int i = t; i < ((je - base + 31) >> 5); i += kThreads) s_bits[i] = 0u;
  __syncthreads();
  const int cont = s_cont;
  const int staged = stop + min(cont - stop, halo);  // the last run's values in the halo
  for (int r = t; r <= H + 1; r += kThreads) {  // the runs, the first point, the one before
    const int c = r < H ? id(s_head[r]) : r == H ? (cnt > 0 ? id(off) : -1) : prev;
    if (c >= jb && c < je) atomicOr(s_bits + ((c - base) >> 5), 1u << ((c - base) & 31));
  }
  __syncthreads();

  const int hp = H | 1;  // odd: a run's k pairs fall on k different threads
  for (int i = t; i < k * hp; i += kThreads) {
    const int r = i % hp, j = i / hp;
    if (r >= H) continue;
    const int s = s_head[r];
    const int c = id(s);
    if (c >= n2) continue;
    const bool tail = r + 1 == H;  // the last run: on into the halo and beyond
    const int e = tail ? staged : s_head[r + 1];
    const int ce = tail ? cont : e;  // [e, ce) from global memory
    const float* src = s_col + (size_t)j * kRow;
    const float* col = cols.p[j] + a;
    const unsigned op = (ops >> (2 * j)) & 3u;
    float acc;
    if (op == 0u) acc = fold_run<0u>(src, s, e, col, ce);
    else if (op == 1u) acc = fold_run<1u>(src, s, e, col, ce);
    else acc = fold_run<2u>(src, s, e, col, ce);
    out[(size_t)j * n2 + c] = acc;
  }

  // zeros in the empty cells of [jb, je): 16 B stores where 4 aligned cells
  // are all empty (each output row is 16 B aligned when n2 % 4 == 0),
  // single words at the ends and beside cells with points
  if ((n2 & 3) != 0) {
    zero_cells(s_bits, base, jb, je, k, n2, out);
  } else {
    const int q0 = (jb + 3) >> 2, q1 = max(je >> 2, q0);  // the quads [q0, q1)
    zero_cells(s_bits, base, jb, min(4 * q0, je), k, n2, out);
    zero_cells(s_bits, base, 4 * q1, je, k, n2, out);
    for (int q = q0 + t; q < q1; q += kThreads) {
      const int o = 4 * q - base;
      const unsigned nib = (s_bits[o >> 5] >> (o & 31)) & 15u;
      for (int j = 0; j < k; ++j) {
        float* dst = out + (size_t)j * n2 + 4 * q;
        if (nib == 0u) {
          *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else {
          for (int v = 0; v < 4; ++v) {
            if (!((nib >> v) & 1u)) dst[v] = 0.0f;
          }
        }
      }
    }
  }
}

// Dynamic shared memory of one block: ids and k columns of up to kTile
// points and the halo, the heads, the bitmap.
constexpr size_t raster_smem_bytes(int k) {
  return ((size_t)(k + 1) * kRow + kTile + (kTile + 63) / 32) * sizeof(int);
}
static_assert(kTile % kThreads == 0 && kTile % 4 == 0, "whole points per thread, 16 B rows");
static_assert(raster_smem_bytes(kMaxCols) <= kSmemLimit, "a block's shared memory");

}  // namespace

// cell: (p,) int32 nondecreasing in [0, n2]; cols: a host array of k device
// pointers to (p,) f32 columns; ops: 2 bits per column (0 sum, 1 min, 2
// max); out: (k, n2) f32. p >= 1.
extern "C" int gg_raster_reduce(const int* cell, const float* const* cols, int p, int k,
                                unsigned int ops, int n2, float* out, cudaStream_t stream) {
  if (p < 1 || k < 1 || k > kMaxCols || n2 < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = raster_smem_bytes(k);
  Cols c{};
  for (int j = 0; j < k; ++j) c.p[j] = cols[j];
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        raster_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long blocks = ((long)p + n2 + kTile - 1) / kTile;
  raster_reduce_kernel<<<(int)blocks, kThreads, smem, stream>>>(cell, c, p, k, ops, n2, out);
  return (int)cudaGetLastError();
}
