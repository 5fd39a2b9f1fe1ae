// K11 select: the occlusion march's candidate selection, ops/select.py
// select_candidates_plain.
//
// Replaces what XLA fuses of the JAX step's candidate selection,
// groundgrid_tpu/core/outliers.py:228-248 (the packed-key lax.sort and its
// slice up to 2^17 points, lax.top_k above), which the eager port ran as
// torch.topk over the int64 selection keys plus a marchable count (~39
// launches a scan). Here it is one launch, one cluster of kCluster blocks a
// row (blockIdx.y the vehicle), and its output is a function of the inputs
// alone: pidx is the stable partition of the point indices, the selected
// points first in point order, then the rest in point order, cut at k;
// n_marchable the row's count of positive budgets. The selected points are
// the marchable ones (budget > 0) while there are at most k of them;
// otherwise the k largest keys (key >= the k-th largest; the keys are
// unique, so exactly k). Either way the marchable members of pidx are
// torch.topk's and the JAX package's set, and every marchable point sits
// before every other, so K7 meets the walking candidates first.
//
// Each block of a row's cluster takes a chunk of its points (a whole number
// of 32-point words); the blocks meet through the cluster's distributed
// shared memory, each reading the others' counts or histograms:
//   1. the marchable count (budget > 0): each warp ballots 32 consecutive
//      points at a time (coalesced loads, all of a round issued before its
//      first ballot) and keeps the ballots, one bit a point, in shared
//      memory (kSegWords words; a longer chunk is taken in segments of that
//      many, its bits filled again per segment); the blocks' counts give
//      the row's count and each block's count of selected points before
//      its chunk;
//   2. common path, n_marchable <= k: each block partitions its chunk from
//      the bits, with no second read of the budgets. A thread takes a word
//      (32 points) of a tile of kThreads words; the words' counts are
//      scanned across the block (a warp scan, then warp 0 over the warps'
//      totals); a selected point lands at the count of selected points
//      before it, an unselected one at n_sel plus its count of unselected
//      ones before it, written only below k. A block stops early once no
//      later point of its chunk can land below k;
//   3. overflow path (storms): an OR of the keys gives their highest
//      nonzero byte, then an MSB-first radix select with 8-bit digits finds
//      the k-th largest key (each block histograms its chunk in shared
//      memory with warp-aggregated atomics, most keys of a pass sharing one
//      digit; every block sums the cluster's histograms and takes the same
//      bucket), at most 8 passes, ending early once the bucket holding it
//      is wholly selected; then the bits of (key & mask) >= prefix over the
//      decided digits, the blocks' counts, and the same partition.
// Bound on the card: bytes, the budgets (4 B a point) and the k indices
// written (8 B each) on the common path: 131,072 x 4 + 8,192 x 8 = 0.59 MB,
// 0.18 us at 3.35 TB/s. A block alone would read a row at one SM's load
// rate (0.024 ms at 131,072 points on an H100, PERF.md); a cluster spreads
// the row over kCluster SMs, and a batch of vehicles runs its clusters side
// by side.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // blocks a row (the portable cluster size)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned int kFull = 0xFFFFFFFFu;
constexpr int kSegWords = 2048;       // selection bits in shared memory (8 KB)
constexpr int kSeg = kSegWords * 32;  // 65,536 points a segment

struct Shared {
  unsigned int bits[kSegWords];         // a segment's selection, a word per 32 points
  unsigned int warp_count[2][kWarps];   // a tile's selected points a warp
  unsigned int warp_offset[2][kWarps];  // their exclusive scan
  unsigned int tile_total[2];
  unsigned int hist[256];  // the block's radix histogram
  unsigned long long reduce[kWarps];
  unsigned long long exchange;      // the block's count (or OR), read by the cluster
  unsigned long long prefix, mask;  // the radix select's decided digits
  unsigned int remaining;
  int done;
};

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

__device__ __forceinline__ unsigned long long warp_or(unsigned long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v |= __shfl_xor_sync(kFull, v, d);
  return v;
}

// The block's sum (or OR) of v, in every thread.
template <bool kOr>
__device__ unsigned long long block_reduce(unsigned long long v, Shared& sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = kOr ? warp_or(v) : warp_sum(v);
  if (lane == 0) sh.reduce[w] = v;
  __syncthreads();
  v = lane < kWarps ? sh.reduce[lane] : 0ull;
  v = kOr ? warp_or(v) : warp_sum(v);
  __syncthreads();  // sh.reduce is free again
  return v;
}

// The cluster's sum (or OR) of the blocks' v (the block's reduction, the
// same in every thread), in every thread; with before, the sum over the
// blocks of lower rank.
template <bool kOr>
__device__ unsigned long long cluster_reduce(unsigned long long v, Shared& sh,
                                             unsigned long long* before = nullptr) {
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) sh.exchange = v;
  cluster.sync();
  unsigned long long all = 0, lower = 0;
  const unsigned int rank = cluster.block_rank();
#pragma unroll
  for (unsigned int r = 0; r < kCluster; ++r) {
    const unsigned long long x = *cluster.map_shared_rank(&sh.exchange, r);
    all = kOr ? (all | x) : all + x;
    if (r < rank) lower += x;
  }
  cluster.sync();  // every block has read sh.exchange
  if (before != nullptr) *before = lower;
  return all;
}

// The selection bits of the len points vals[0, len) (a segment), pred(v)
// each, into sh.bits: warp w the words w * kItems + j, every kWarps *
// kItems words, each word one coalesced load of 32 points and its ballot,
// all kItems loads issued before the first ballot. Returns the selected
// points counted, in lane 0 of each warp (0 elsewhere).
template <int kItems, typename T, typename Pred>
__device__ unsigned int fill_bits(const T* __restrict__ vals, int len, Pred pred, Shared& sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int words = (len + 31) / 32;
  unsigned int count = 0;
  for (int w0 = w * kItems; w0 < words; w0 += kWarps * kItems) {
    T v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = (w0 + j) * 32 + lane;
      v[j] = i < len ? vals[i] : T(0);
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const unsigned int bal = __ballot_sync(kFull, ((w0 + j) * 32 + lane < len) && pred(v[j]));
      if (lane == 0 && w0 + j < words) sh.bits[w0 + j] = bal;
      count += __popc(bal);
    }
  }
  return lane == 0 ? count : 0u;
}

// The stable partition of a segment's points s0 + [0, len) by the selection
// bits in sh.bits into pidx[0, k): of the row's n_sel selected points, those
// before the segment (base) come first, then the segment's, each in point
// order; an unselected point lands at n_sel plus the count of unselected
// points before it. Each thread takes a word a tile of kThreads words; the
// words' counts are scanned across the block (a warp scan, then warp 0 over
// the warps' totals). Returns true once no later point can land below k.
__device__ bool partition_bits(int s0, int len, unsigned int n_sel, int k, unsigned int& base,
                               int& parity, long long* __restrict__ pidx, Shared& sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int words = (len + 31) / 32;
  for (int t0 = 0; t0 < words; t0 += kThreads, parity ^= 1) {
    // every selected point written, and every later one past k
    if (base == n_sel && (long long)n_sel + (s0 + 32ll * t0 - base) >= k) return true;
    const int wi = t0 + threadIdx.x;
    const unsigned int word = wi < words ? sh.bits[wi] : 0u;
    const unsigned int c = __popc(word);
    unsigned int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned int up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) sh.warp_count[parity][w] = incl;
    __syncthreads();
    if (w == 0) {
      const unsigned int cw = lane < kWarps ? sh.warp_count[parity][lane] : 0u;
      unsigned int iw = cw;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned int up = __shfl_up_sync(kFull, iw, d);
        if (lane >= d) iw += up;
      }
      if (lane < kWarps) sh.warp_offset[parity][lane] = iw - cw;
      if (lane == 31) sh.tile_total[parity] = iw;
    }
    __syncthreads();
    // selected points before the word's first point
    const unsigned int before = base + sh.warp_offset[parity][w] + (incl - c);
    const int i0 = s0 + wi * 32;
    for (unsigned int m = word; m; m &= m - 1) {
      const int b = __ffs(m) - 1;
      const unsigned int pos = before + __popc(word & ((1u << b) - 1u));
      if (pos < (unsigned int)k) pidx[pos] = i0 + b;
    }
    if (wi < words) {  // the word's unselected points in the row, while below k
      const int nb = min(32, len - wi * 32);
      for (unsigned int m = ~word & (nb == 32 ? kFull : (1u << nb) - 1u); m; m &= m - 1) {
        const int b = __ffs(m) - 1;
        const long long pos =
            (long long)n_sel + (i0 + b) - (long long)(before + __popc(word & ((1u << b) - 1u)));
        if (pos >= k) break;
        pidx[pos] = i0 + b;
      }
    }
    base += sh.tile_total[parity];
  }
  return false;
}

// The cluster's count of points of the row vals for which pred holds, each
// block filling its chunk [c0, c0 + len)'s bits, the last segment first, so
// that the first one's bits stay in sh.bits; in before, the count in the
// chunks of lower rank.
template <int kItems, typename T, typename Pred>
__device__ unsigned int count_selected(const T* __restrict__ vals, int c0, int len, Pred pred,
                                       unsigned long long* before, Shared& sh) {
  unsigned long long count = 0;
  for (int s0 = len > 0 ? (len - 1) / kSeg * kSeg : -1; s0 >= 0; s0 -= kSeg) {
    count += fill_bits<kItems>(vals + c0 + s0, min(kSeg, len - s0), pred, sh);
  }
  return (unsigned int)cluster_reduce<false>(block_reduce<false>(count, sh), sh, before);
}

// The block's chunk [c0, c0 + len) of the row vals partitioned by pred into
// pidx (count_selected's bits of its first segment in place), segment by
// segment; n_sel: the row's count of selected points, base: those before
// the chunk.
template <int kItems, typename T, typename Pred>
__device__ void partition(const T* __restrict__ vals, int c0, int len, int k, unsigned int n_sel,
                          Pred pred, unsigned int base, long long* __restrict__ pidx,
                          Shared& sh) {
  int parity = 0;
  for (int s0 = 0; s0 < len; s0 += kSeg) {
    if (s0 > 0) {  // the segment's bits again
      __syncthreads();  // the previous segment's bits are read
      fill_bits<kItems>(vals + c0 + s0, min(kSeg, len - s0), pred, sh);
      __syncthreads();
    }
    if (partition_bits(c0 + s0, min(kSeg, len - s0), n_sel, k, base, parity, pidx, sh)) return;
  }
}

// (mask, prefix) in sh: the k-th largest of the row's unique keys is
// selected by (key & mask) >= prefix, which holds for exactly k keys. The
// block histograms its chunk [c0, c0 + len); every block merges the
// cluster's histograms.
__device__ void radix_select(const unsigned long long* __restrict__ keys, int c0, int len, int k,
                             Shared& sh) {
  constexpr int kItems = 8;
  constexpr int kTile = kThreads * kItems;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  cg::cluster_group cluster = cg::this_cluster();
  unsigned long long any = 0;
  for (int t0 = 0; t0 < len; t0 += kTile) {
    unsigned long long v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = t0 + j * kThreads + threadIdx.x;
      v[j] = i < len ? keys[c0 + i] : 0ull;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) any |= v[j];
  }
  any = cluster_reduce<true>(block_reduce<true>(any, sh), sh);
  unsigned long long prefix = 0, mask = 0;
  unsigned int remaining = (unsigned int)k;
  for (int shift = any ? ((63 - __clzll((long long)any)) & ~7) : 0; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < 256; b += kThreads) sh.hist[b] = 0;
    __syncthreads();
    for (int t0 = 0; t0 < len; t0 += kTile) {
      const int i0 = t0 + w * 32 * kItems;
      unsigned long long v[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = i0 + j * 32 + lane;
        v[j] = i < len ? keys[c0 + i] : 0ull;
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const bool in = (i0 + j * 32 + lane < len) && (v[j] & mask) == prefix;
        const unsigned int digit = in ? (unsigned int)(v[j] >> shift) & 255u : 256u;
        const unsigned int peers = __match_any_sync(kFull, digit);
        if (in && lane == __ffs(peers) - 1) atomicAdd(&sh.hist[digit], __popc(peers));
      }
    }
    cluster.sync();  // every block's histogram is complete
    if (w == 0) {
      // lane l holds the buckets 255 - 8l - q, q = 0 .. 7, from the top,
      // summed over the cluster
      unsigned int h[8], sum = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) h[q] = 0;
      for (unsigned int r = 0; r < kCluster; ++r) {
        const unsigned int* hist = cluster.map_shared_rank(sh.hist, r);
#pragma unroll
        for (int q = 0; q < 8; ++q) h[q] += hist[255 - 8 * lane - q];
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) sum += h[q];
      unsigned int incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned int up = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += up;
      }
      const unsigned int reach = __ballot_sync(kFull, incl >= remaining);
      if (lane == __ffs(reach) - 1) {  // the lane whose buckets reach the k-th key
        unsigned int above = incl - sum;
        int q = 0;
        while (above + h[q] < remaining) above += h[q++];
        const unsigned long long bucket = 255u - 8u * lane - q;
        sh.prefix = prefix | (bucket << shift);
        sh.mask = mask | (255ull << shift);
        sh.remaining = remaining - above;
        sh.done = h[q] == remaining - above;
      }
    }
    cluster.sync();  // every block has read the histograms; sh's decision is visible
    prefix = sh.prefix;
    mask = sh.mask;
    remaining = sh.remaining;
    if (sh.done) break;  // the bucket is wholly selected: (key & mask) >= prefix
  }
}

struct Positive {
  __device__ bool operator()(float b) const { return b > 0.0f; }
};

struct AtLeast {
  unsigned long long mask, prefix;
  __device__ bool operator()(unsigned long long key) const { return (key & mask) >= prefix; }
};

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    select_kernel(const float* __restrict__ budget, const long long* __restrict__ key, int p,
                  int k, long long* __restrict__ pidx, long long* __restrict__ n_marchable) {
  __shared__ Shared sh;
  const size_t row = blockIdx.y;
  const unsigned int rank = cg::this_cluster().block_rank();
  budget += row * p;
  pidx += row * k;
  // the block's chunk: a whole number of words
  const int words = (p + 31) / 32, per = (words + kCluster - 1) / kCluster;
  const int c0 = min(p, (int)rank * per * 32), len = min(p, c0 + per * 32) - c0;
  unsigned long long before = 0;
  const unsigned int n_m = count_selected<16>(budget, c0, len, Positive{}, &before, sh);
  if (rank == 0 && threadIdx.x == 0) n_marchable[row] = n_m;
  if (n_m <= (unsigned int)k) {
    partition<16>(budget, c0, len, k, n_m, Positive{}, (unsigned int)before, pidx, sh);
    return;
  }
  const unsigned long long* keys = reinterpret_cast<const unsigned long long*>(key) + row * p;
  radix_select(keys, c0, len, k, sh);
  const AtLeast top{sh.mask, sh.prefix};
  count_selected<8>(keys, c0, len, top, &before, sh);  // k in all
  partition<8>(keys, c0, len, k, (unsigned int)k, top, (unsigned int)before, pidx, sh);
}

}  // namespace

// budget: (batch, p) f32; key: (batch, p) i64, unique a row and nonnegative
// (core/outliers.py selection_key); pidx out (batch, k) i64; n_marchable out
// (batch,) i64. 1 <= k <= p <= 2^30, 1 <= batch <= 65535.
extern "C" int gg_select(const float* budget, const long long* key, int p, int batch, int k,
                         long long* pidx, long long* n_marchable, cudaStream_t stream) {
  if (p < 1 || p > (1 << 30) || k < 1 || k > p || batch < 1 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  select_kernel<<<dim3(kCluster, batch), kThreads, 0, stream>>>(budget, key, p, k, pidx,
                                                                n_marchable);
  return (int)cudaGetLastError();
}
