// K11 select: the occlusion march's candidate selection, ops/select.py
// select_candidates_plain.
//
// Replaces what XLA fuses of the JAX step's candidate selection,
// groundgrid_tpu/core/outliers.py:228-248 (the packed-key lax.sort and its
// slice up to 2^17 points, lax.top_k above), which the eager port ran as
// torch.topk over the int64 selection keys plus a marchable count (~39
// launches a scan). Here it is one launch, one cluster of C blocks a row
// (blockIdx.y the vehicle), and its output is a function of the inputs
// alone: pidx is the stable partition of the point indices, the selected
// points first in point order, then the rest in point order, cut at k;
// n_marchable the row's count of positive budgets. The selected points are
// the marchable ones (budget > 0) while there are at most k of them;
// otherwise the k largest keys (key >= the k-th largest; the keys are
// unique, so exactly k). Either way the marchable members of pidx are
// torch.topk's and the JAX package's set, and every marchable point sits
// before every other, so K7 meets the walking candidates first.
//
// The cluster's size C is chosen at launch (gg_select_cluster): the largest
// of 16, 8, 4, 2, 1 of which the card holds a cluster a row of the batch at
// once (cudaOccupancyMaxActiveClusters; 16 is a non-portable size), with
// at least 32 words a block, so a single row spreads over 16 SMs and a
// batch of 64 runs in one wave. Each block takes a chunk of its row's
// points (`per` words of 32 points; its selection bits and their scan live
// in dynamic shared memory) and the blocks meet through the cluster's
// distributed shared memory:
//   1. the marchable count (budget > 0): each warp ballots 32 consecutive
//      points at a time (coalesced loads, 16 words of a round issued before
//      the first ballot) into the chunk's bits, a block-wide scan of the
//      words' counts gives each word's selected points before it, and the
//      blocks' counts give each chunk's count before it and the row's;
//   2. the output in its own order: the k positions are dealt to the
//      cluster's warps 32 at a time, each lane writing one position, so
//      every warp store is 32 consecutive 8-byte words. Position q < n_sel
//      holds the q-th selected point, q >= n_sel the (q - n_sel)-th
//      unselected one: the lane picks the chunk from the blocks' counts,
//      then binary-searches that chunk's scan of words (read from its
//      block's shared memory through map_shared_rank) between the bounds
//      the word size gives, and takes the bit in the word. A tail that
//      crosses from one chunk into the next reads both;
//   3. past the cap (storms): each block copies its chunk of keys into
//      shared memory once (where 32 * 8 bytes a word fit the key budget; a
//      longer chunk reads them from global memory, a size rule decided
//      before the launch), taking their OR; an MSB-first radix select with
//      8-bit digits finds the k-th largest key from there (each block
//      histograms its chunk, skipping warps with no key in the bucket, with
//      warp-aggregated atomics; double-buffered histograms, so a pass is one
//      cluster barrier, every block summing the cluster's histograms, a
//      thread a bucket, and taking the same bucket), ending once the bucket
//      holding it is wholly
//      selected; then the bits of (key & mask) >= prefix, their scan and
//      counts, and the same output, all k positions selected.
// Bound on the card: bytes, the budgets (4 B a point) and the k indices
// written (8 B each) on the common path: 131,072 x 4 + 8,192 x 8 = 0.59 MB,
// 0.18 us at 3.35 TB/s; past the cap the keys once more (8 B a point). What
// sets a single row's time is latency: one read of the row on C SMs, two
// cluster barriers and a dependent search of a few shared-memory words.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

namespace cg = cooperative_groups;

#ifdef GG_SELECT_PROBES
// clock64 breakdown (select_breakdown.py): thread 0 of each block of row 0
// records (phase, clock64, globaltimer) after a block barrier; the loops of
// the output phase add their cycles, the most of any thread, per block.
__device__ unsigned long long gg_probe_rec[16][64][3];
__device__ unsigned int gg_probe_count[16];
__device__ unsigned long long gg_probe_max[16][4];
__device__ __forceinline__ void gg_probe(int id) {
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.x < 16) {
    const unsigned int n = gg_probe_count[blockIdx.x]++;
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (n < 64) {
      gg_probe_rec[blockIdx.x][n][0] = (unsigned long long)id;
      gg_probe_rec[blockIdx.x][n][1] = (unsigned long long)clock64();
      gg_probe_rec[blockIdx.x][n][2] = t;
    }
  }
  __syncthreads();
}
#define GG_PROBE(id) gg_probe(id)
#define GG_PROBE_START(v) const long long v = clock64()
#define GG_PROBE_ADD(slot, v)                                                       \
  if (blockIdx.y == 0 && blockIdx.x < 16)                                          \
  atomicMax(&gg_probe_max[blockIdx.x][slot], (unsigned long long)(clock64() - v))
#else
#define GG_PROBE(id)
#define GG_PROBE_START(v)
#define GG_PROBE_ADD(slot, v)
#endif

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;        // blocks a row at most (above 8: non-portable)
constexpr int kMinWords = 32;          // words a block at least, below C = 1
constexpr int kMaxChunkWords = 16384;  // a chunk's words at most: bits and scan, 128 KB
constexpr int kKeyBudget = 160 * 1024;  // a chunk's keys in shared memory at most
constexpr int kMaxDynamic = 200 * 1024;
constexpr unsigned int kFull = 0xFFFFFFFFu;

struct Shared {
  unsigned long long reduce[kWarps];
  unsigned long long exchange[3];  // read by the cluster: marchable, key OR, selected
  unsigned int warp_total[kWarps];
  unsigned int before[kMaxCluster + 1];  // selected points before each chunk; [C] the row's
  unsigned int hist[2][256];             // the radix histograms, a pass's parity
  unsigned long long prefix, mask, any;  // the radix select's decided digits; the keys' OR
  unsigned int remaining;
  int done;
};

// A block's chunk of its row: points [c0, c0 + len), `words` words of 32
// (the row's last one partial), `per` words a chunk; its bits and their
// exclusive scan in dynamic shared memory, and its keys there where they fit.
struct Chunk {
  int c0, len, words, per;
  unsigned int* bits;
  unsigned int* sel;
  unsigned long long* keys;  // nullptr: the keys are read from global memory
};

__device__ __forceinline__ unsigned long long warp_or(unsigned long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v |= __shfl_xor_sync(kFull, v, d);
  return v;
}

__device__ __forceinline__ unsigned int warp_incl_scan(unsigned int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned int up = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

// The block's OR of v, in every thread.
__device__ unsigned long long block_or(unsigned long long v, Shared& sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = warp_or(v);
  if (lane == 0) sh.reduce[w] = v;
  __syncthreads();
  v = warp_or(lane < kWarps ? sh.reduce[lane] : 0ull);
  __syncthreads();  // sh.reduce is free again
  return v;
}

// The exclusive scan of v over the block's threads in order; the block's
// total in `total`, in every thread.
__device__ unsigned int block_scan(unsigned int v, unsigned int& total, Shared& sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned int incl = warp_incl_scan(v);
  if (lane == 31) sh.warp_total[w] = incl;
  __syncthreads();
  const unsigned int t = lane < kWarps ? sh.warp_total[lane] : 0u;
  const unsigned int ti = warp_incl_scan(t);  // every warp scans the warps' totals
  const unsigned int warp_before = __shfl_sync(kFull, ti - t, w);
  total = __shfl_sync(kFull, ti, kWarps - 1);
  __syncthreads();  // sh.warp_total is free again
  return warp_before + incl - v;
}

// The chunk's selection bits, pred(v) of its points vals[0, len): warp w
// the words w * kItems + j, every kWarps * kItems words, each word one
// coalesced load of 32 points and its ballot, all kItems loads issued
// before the first ballot.
template <int kItems, typename T, typename Pred>
__device__ void fill_bits(const T* __restrict__ vals, const Chunk& ch, Pred pred) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int w0 = w * kItems; w0 < ch.words; w0 += kWarps * kItems) {
    T v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = (w0 + j) * 32 + lane;
      v[j] = i < ch.len ? vals[i] : T(0);
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const unsigned int bal = __ballot_sync(kFull, ((w0 + j) * 32 + lane < ch.len) && pred(v[j]));
      if (lane == 0 && w0 + j < ch.words) ch.bits[w0 + j] = bal;
    }
  }
}

// ch.sel[w]: the chunk's selected points before its word w (a block-wide
// scan, each thread a run of consecutive words); returns the chunk's count.
__device__ unsigned int scan_bits(const Chunk& ch, Shared& sh) {
  __syncthreads();  // the bits are complete
  const int q = (ch.words + kThreads - 1) / kThreads;
  const int w0 = threadIdx.x * q;
  unsigned int c = 0;
  for (int j = 0; j < q; ++j) {
    if (w0 + j < ch.words) c += __popc(ch.bits[w0 + j]);
  }
  unsigned int total;
  unsigned int run = block_scan(c, total, sh);
  for (int j = 0; j < q; ++j) {
    if (w0 + j < ch.words) {
      ch.sel[w0 + j] = run;
      run += __popc(ch.bits[w0 + j]);
    }
  }
  return total;
}

// Publishes the block's count in sh.exchange[slot] and, past the cluster's
// barrier (which also makes every block's bits and scan visible), fills
// sh.before with each chunk's count before it and the row's in [C].
__device__ void gather_counts(unsigned int count, int slot, Shared& sh) {
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) sh.exchange[slot] = count;
  cluster.sync();
  if (threadIdx.x < 32) {
    const unsigned int lane = threadIdx.x, blocks = cluster.num_blocks();
    const unsigned int c =
        lane < blocks ? (unsigned int)*cluster.map_shared_rank(&sh.exchange[slot], lane) : 0u;
    const unsigned int incl = warp_incl_scan(c);
    if (lane <= blocks) sh.before[lane] = incl - c;
  }
  __syncthreads();
}

// The position of the r-th set bit (from 0) of m, which has more than r.
__device__ __forceinline__ int nth_bit(unsigned int m, unsigned int r) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const unsigned int low = m & ((1u << w) - 1u);
    const unsigned int c = __popc(low);
    if (r >= c) {
      r -= c;
      m >>= w;
      pos += w;
    } else {
      m = low;
    }
  }
  return pos;
}

// pidx[q] for the k positions of the row: the q-th selected point for q <
// n_sel, the (q - n_sel)-th unselected one after. The positions go to the
// cluster's warps 32 at a time, a lane each, so each warp store is 32
// consecutive words. A lane's point lies in the chunk with the most such
// points before it that are at most its rank t, and there in the last
// word whose such points before it are at most t, which a binary search of
// that chunk's scan finds (read from its block's shared memory). Every
// block's bits, scan and sh.before are complete.
__device__ void write_positions(long long* __restrict__ pidx, int p, int k, unsigned int n_sel,
                                const Chunk& ch, Shared& sh) {
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int blocks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int row_words = (p + 31) / 32, span = 32 * ch.per;
  const int units = (k + 31) / 32;
  for (int u = rank * kWarps + w; u < units; u += blocks * kWarps) {
    const int q = u * 32 + lane;
    if (q >= k) break;
    GG_PROBE_START(t0);
    const bool want = (unsigned int)q < n_sel;  // a selected point, else an unselected one
    const unsigned int t = want ? (unsigned int)q : (unsigned int)q - n_sel;
    int r = 0;
    for (int j = 1; j < blocks; ++j) {
      const unsigned int b = want ? sh.before[j] : (unsigned int)(span * j) - sh.before[j];
      if (b <= t) r = j;
    }
    const unsigned int tr =
        t - (want ? sh.before[r] : (unsigned int)(span * r) - sh.before[r]);
    const unsigned int* sel = cluster.map_shared_rank(ch.sel, r);
    const unsigned int* bits = cluster.map_shared_rank(ch.bits, r);
    // the word: at least tr / 32 (a word holds 32 points), for an
    // unselected point at most (tr + the chunk's selected) / 32
    int hi = min(ch.per, row_words - ch.per * r) - 1;
    if (!want) hi = min(hi, (int)((tr + sh.before[r + 1] - sh.before[r]) / 32));
    int lo = min((int)(tr / 32), hi);  // (equal at most; a read stays inside the chunk)
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      const unsigned int s = sel[mid];
      if ((want ? s : 32u * mid - s) <= tr) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const unsigned int s = sel[lo];
    const int wg = ch.per * r + lo;  // the word in the row
    unsigned int mask = bits[lo];
    if (!want) mask = ~mask & (wg == row_words - 1 && (p & 31) ? (1u << (p & 31)) - 1u : kFull);
    const unsigned int before = want ? s : 32u * lo - s;
    pidx[q] = (long long)wg * 32 + nth_bit(mask, tr - before);
    GG_PROBE_ADD(want ? 0 : 1, t0);
  }
}

// (mask, prefix) in sh: the k-th largest of the row's unique keys is
// selected by (key & mask) >= prefix, which holds for exactly k keys. The
// block histograms its chunk `keys` (shared or global memory); every block
// merges the cluster's histograms. sh.any: the row's OR of its keys.
__device__ void radix_select(const unsigned long long* __restrict__ keys, int len, int k,
                             Shared& sh) {
  constexpr int kItems = 8;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned int blocks = cluster.num_blocks();
  const unsigned long long any = sh.any;
  unsigned long long prefix = 0, mask = 0;
  unsigned int remaining = (unsigned int)k;
  int parity = 0;
  for (int shift = any ? ((63 - __clzll((long long)any)) & ~7) : 0; shift >= 0; shift -= 8) {
    unsigned int* hist = sh.hist[parity];
    for (int b = threadIdx.x; b < 256; b += kThreads) hist[b] = 0;
    __syncthreads();
    for (int i0 = w * 32 * kItems; i0 < len; i0 += kThreads * kItems) {
      unsigned long long v[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = i0 + j * 32 + lane;
        v[j] = i < len ? keys[i] : 0ull;
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const bool in = (i0 + j * 32 + lane < len) && (v[j] & mask) == prefix;
        if (!__any_sync(kFull, in)) continue;  // no key of the warp's 32 in the bucket
        const unsigned int digit = in ? (unsigned int)(v[j] >> shift) & 255u : 256u;
        const unsigned int peers = __match_any_sync(kFull, digit);
        if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
      }
    }
    cluster.sync();  // every block's histogram of this parity is complete
    // thread t < 256 sums bucket 255 - t over the cluster (one remote load a
    // block, all issued at once), then a scan from the top bucket down finds
    // the one holding the remaining-th key
    unsigned int v = 0, incl = 0;
    if (threadIdx.x < 256) {
      const unsigned int bucket = 255u - threadIdx.x;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < (int)blocks) v += cluster.map_shared_rank(hist, r)[bucket];
      }
      incl = warp_incl_scan(v);
      if (lane == 31) sh.warp_total[w] = incl;
    }
    __syncthreads();
    if (threadIdx.x < 256) {
      for (int u = 0; u < w; ++u) incl += sh.warp_total[u];
      const unsigned int above = incl - v;
      if (above < remaining && incl >= remaining) {  // the bucket of the remaining-th key
        const unsigned long long bucket = 255u - threadIdx.x;
        sh.prefix = prefix | (bucket << shift);
        sh.mask = mask | (255ull << shift);
        sh.remaining = remaining - above;
        sh.done = v == remaining - above;
      }
    }
    __syncthreads();  // the decision is in sh; the other parity is free
    GG_PROBE(20 + shift / 8);
    prefix = sh.prefix;
    mask = sh.mask;
    remaining = sh.remaining;
    parity ^= 1;
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

__global__ void __launch_bounds__(kThreads, 2)
    select_kernel(const float* __restrict__ budget, const long long* __restrict__ key, int p,
                  int k, int per, int keys_shared, long long* __restrict__ pidx,
                  long long* __restrict__ n_marchable) {
  __shared__ Shared sh;
  extern __shared__ __align__(16) unsigned char dyn[];
  GG_PROBE(0);
  cg::cluster_group cluster = cg::this_cluster();
  const size_t row = blockIdx.y;
  const int rank = (int)cluster.block_rank();
  Chunk ch;
  ch.per = per;
  ch.c0 = min(p, rank * per * 32);
  ch.len = min(p, ch.c0 + per * 32) - ch.c0;
  ch.words = (ch.len + 31) / 32;
  ch.bits = reinterpret_cast<unsigned int*>(dyn);
  ch.sel = ch.bits + per;
  ch.keys = keys_shared ? reinterpret_cast<unsigned long long*>(dyn + ((8 * per + 15) & ~15))
                        : nullptr;
  budget += row * p;
  pidx += row * k;
  fill_bits<16>(budget + ch.c0, ch, Positive{});
  const unsigned int count = scan_bits(ch, sh);
  GG_PROBE(1);
  gather_counts(count, 0, sh);
  GG_PROBE(2);
  const unsigned int n_m = sh.before[cluster.num_blocks()];
  if (rank == 0 && threadIdx.x == 0) n_marchable[row] = n_m;
  if (n_m <= (unsigned int)k) {
    write_positions(pidx, p, k, n_m, ch, sh);
    GG_PROBE(3);
    cluster.sync();  // no block leaves while another reads its shared memory
    return;
  }
  // past the cap: the keys (in shared memory where they fit), their OR
  const unsigned long long* gkeys =
      reinterpret_cast<const unsigned long long*>(key) + row * p + ch.c0;
  unsigned long long any = 0;
  {
    constexpr int kItems = 8;
    for (int t0 = 0; t0 < ch.len; t0 += kThreads * kItems) {
      unsigned long long v[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = t0 + j * kThreads + threadIdx.x;
        v[j] = i < ch.len ? gkeys[i] : 0ull;
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = t0 + j * kThreads + threadIdx.x;
        if (ch.keys != nullptr && i < ch.len) ch.keys[i] = v[j];
        any |= v[j];
      }
    }
  }
  any = block_or(any, sh);  // its barriers also publish the shared keys
  if (threadIdx.x == 0) sh.exchange[1] = any;
  cluster.sync();
  if (threadIdx.x < 32) {
    const unsigned int lane = threadIdx.x;
    const unsigned long long x =
        lane < cluster.num_blocks() ? *cluster.map_shared_rank(&sh.exchange[1], lane) : 0ull;
    const unsigned long long all = warp_or(x);
    if (lane == 0) sh.any = all;
  }
  __syncthreads();
  GG_PROBE(4);
  const unsigned long long* keys = ch.keys != nullptr ? ch.keys : gkeys;
  radix_select(keys, ch.len, k, sh);
  fill_bits<8>(keys, ch, AtLeast{sh.mask, sh.prefix});
  gather_counts(scan_bits(ch, sh), 2, sh);  // k in all
  GG_PROBE(5);
  write_positions(pidx, p, k, (unsigned int)k, ch, sh);
  GG_PROBE(6);
  cluster.sync();  // no block leaves while another reads its shared memory
}

// The launch's shape for a batch of rows of p points with C blocks a row:
// words a chunk, whether the keys fit shared memory, dynamic shared bytes.
struct Shape {
  int cluster, per, keys_shared, smem;
};

Shape shape_for(int p, int cluster) {
  const int words = (p + 31) / 32;
  Shape s{cluster, (words + cluster - 1) / cluster, 0, 0};
  const int scan_bytes = (8 * s.per + 15) & ~15;
  s.keys_shared = 256 * s.per <= kKeyBudget;
  s.smem = scan_bytes + (s.keys_shared ? 256 * s.per : 0);
  return s;
}

// Lets the kernel take a 16-block cluster and its dynamic shared memory, on
// the current device (once a device).
int configure() {
  static std::mutex lock;
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> guard(lock);
  if (dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(select_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxDynamic);
  }
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return (int)err;
}

// Clusters of `shape` the card holds at once, for a grid of `batch` rows.
int active_clusters(const Shape& shape, int batch) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(shape.cluster, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = shape.smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = shape.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, select_kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // a shape the card cannot place: none at once
    return 0;
  }
  return n;
}

bool valid(int p, int batch, int k) {
  return p >= 1 && k >= 1 && k <= p && batch >= 1 && batch <= 65535 &&
         (p + 31) / 32 <= kMaxCluster * kMaxChunkWords;
}

// The rule's cluster size for `batch` rows of p points: the largest C of
// 16, 8, 4, 2, 1 with at least kMinWords words a block (C = 1 always
// qualifies) whose chunk fits kMaxChunkWords and of which the card holds
// `batch` clusters at once; failing that, the one that holds the most
// blocks at once. 0 if the card places none.
int rule_cluster(int p, int batch) {
  const int words = (p + 31) / 32;
  int best = 0, best_blocks = 0;
  for (int c = kMaxCluster; c >= 1; c >>= 1) {
    if (c > 1 && words < c * kMinWords) continue;
    const Shape s = shape_for(p, c);
    if (s.per > kMaxChunkWords) break;  // a smaller C has a longer chunk
    const int n = active_clusters(s, batch);
    if (n >= batch) return c;
    if (n * c > best_blocks) best = c, best_blocks = n * c;
  }
  return best;
}

// rule_cluster, remembered a device, p and batch (the occupancy queries
// cost host time on every eager launch otherwise).
int choose_cluster(int p, int batch) {
  struct Entry {
    int dev, p, batch, cluster;
  };
  static std::mutex lock;
  static Entry cache[32];
  static int next = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  {
    std::lock_guard<std::mutex> guard(lock);
    for (const Entry& e : cache) {
      if (e.cluster > 0 && e.dev == dev && e.p == p && e.batch == batch) return e.cluster;
    }
  }
  const int c = rule_cluster(p, batch);
  std::lock_guard<std::mutex> guard(lock);
  if (c > 0) cache[next++ % 32] = Entry{dev, p, batch, c};
  return c;
}

}  // namespace

// The cluster size gg_select's rule takes for `batch` rows of p points on
// the current device: 1, 2, 4, 8 or 16; a negative cudaError on bad sizes
// or a failed set-up, 0 where the card places no shape.
extern "C" int gg_select_cluster(int p, int batch) {
  if (!valid(p, batch, 1)) return -(int)cudaErrorInvalidValue;
  const int err = configure();
  if (err != 0) return -err;
  return choose_cluster(p, batch);
}

// budget: (batch, p) f32; key: (batch, p) i64, unique a row and nonnegative
// (core/outliers.py selection_key); pidx out (batch, k) i64; n_marchable out
// (batch,) i64. cluster: the blocks a row, 0 for gg_select_cluster's rule,
// or 1, 2, 4, 8 or 16 (a sweep's forced shape; its chunk must fit). 1 <= k
// <= p <= 2^23 (16 chunks of kMaxChunkWords words), 1 <= batch <= 65535.
extern "C" int gg_select(const float* budget, const long long* key, int p, int batch, int k,
                         int cluster, long long* pidx, long long* n_marchable,
                         cudaStream_t stream) {
  if (!valid(p, batch, k)) return (int)cudaErrorInvalidValue;
  const int err = configure();
  if (err != 0) return err;
  if (cluster == 0) cluster = choose_cluster(p, batch);
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0) {
    return (int)cudaErrorInvalidConfiguration;  // no shape the card places
  }
  const Shape s = shape_for(p, cluster);
  if (s.per > kMaxChunkWords) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = s.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t launch = cudaLaunchKernelEx(&cfg, select_kernel, budget, key, p, k, s.per,
                                                s.keys_shared, pidx, n_marchable);
  if (launch != cudaSuccess) return (int)launch;
  return (int)cudaGetLastError();
}

#ifdef GG_SELECT_PROBES
// The breakdown's records of the last launch (and zeroes them): rec
// (16 x 64 x 3 u64), counts (16 u32), max (16 x 4 u64).
extern "C" int gg_select_probes(unsigned long long* rec, unsigned int* counts,
                                unsigned long long* max) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(rec, gg_probe_rec, sizeof(gg_probe_rec));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(counts, gg_probe_count, sizeof(gg_probe_count));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(max, gg_probe_max, sizeof(gg_probe_max));
  static const unsigned int zero_counts[16] = {};
  static const unsigned long long zero_max[16][4] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(gg_probe_count, zero_counts, sizeof(zero_counts));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(gg_probe_max, zero_max, sizeof(zero_max));
  return (int)err;
}
#endif
