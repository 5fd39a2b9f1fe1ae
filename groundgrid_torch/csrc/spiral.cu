// K3: the spiral terrain interpolation, the whole sweep in one launch.
//
// Replaces the TPU kernel groundgrid_tpu/ops/pallas_spiral.py:
// spiral_interpolation_pallas (_spiral_kernel, _segment, _band_update,
// _affine_hillis_steele, _narrow_refix, _writeback, _owner_masks), the
// center-outward ring walk of GroundSegmentation.cpp:398-465. The center
// cell (m, m), m = n/2 - 1, is seeded with the base height at confidence 1;
// rings of radius D = 1 .. m-1 run inner -> outer, each as 4 segments in walk
// order (top row ->, left column v, bottom row <-, right column ^; the
// corners (i, i) and (o, o), i = m - D, o = m + D, are visited twice).
// A launch may walk a range of rings d0 .. d1 (gg_spiral's arguments): the
// banded relay of parallel/spiral_shard.py runs its bands one launch each.
// Within a segment a cell's 3x3 stencil reads an updated value only from its
// walk predecessor, so the heights obey the affine recurrence
// h[k] = a[k] + b[k] * h[k-1] with coefficients known before the segment
// starts; confidence is a per-cell decay outside min_dist_squared.
//
// Bound on the card: not the 2.1 MB of HBM traffic (both layers read and
// written once, ~0.6 us at 3.35 TB/s) but the serial chain of m - 1 rings
// (180 at 364^2, 720 segments) that one thread block walks in order while
// the other SMs idle. The design shortens each link of the chain:
//
// - A ring band in shared memory. A 3x3 stencil on ring D reads only rings
//   D-1 (final), D (being walked) and D+1 (not yet walked): the Chebyshev
//   distance to the center moves by at most 1. Ring d >= 1 lives in band
//   buffer d % 3 as (height, confidence) pairs in ring order (slot_cell
//   below; ops/spiral.py slot_cell is its Python twin, ring_slot the
//   inverse), the center in a slot of its own, so each line of a ring is a
//   run of slots and a stencil's nine reads are runs plus six corner cases
//   per segment, planned once per ring. Every stencil read and write on the
//   chain hits shared memory.
// - Memory warps. The last kMemThreads threads never join the walkers'
//   barriers: during ring d they store ring d-1 (final) to global memory,
//   plan ring d+1 and, once the walkers have read ring d-1 (they signal it
//   after computing the ring's coefficients), copy ring d+2 into ring d-1's
//   buffer with cp.async. Walkers and memory warps meet once per ring.
// - A ring-wide scan. A visit reads a cell that an earlier segment of the
//   same ring writes only at the junctions (left 0, 1; bottom L-2, L-1; right
//   0, 1 and L-2, L-1). So the coefficients of all 8D+2 visits come from the
//   band as the ring starts (each thread keeps its visits' in registers),
//   warp 0 redoes the junctions at the starts, one two-level scan (warp
//   shuffles, then the warp totals) solves every segment at once, and warp 0
//   redoes the junctions at the ends. The eight ring D-1 cells those redone
//   visits read are kept in a junction cache, since ring D+2 overwrites
//   ring D-1 meanwhile (ops/spiral.py junction_cells, its twin). Ring 1,
//   whose junctions overlap, is walked segment by segment by one warp.
//
// The band takes 3 (8m + 1) + 9 (height, confidence) pairs and 192 floats of
// scratch: 35,616 B at n = 364, 117,024 B at n = 1212. A block can hold 227 KB
// (232,448 B), so n <= 2415; the wrapper (ops/spiral.py band_layout) raises
// above that. A walker keeps up to kMaxPerThread visits (n = 2415: 11).
//
// A batch of grids (the fleet's batched step) is one launch of one block a
// grid: block b walks grid b, n*n words past grid b-1, seeded with
// base_z[b * zstride]. The walk is one block's whatever the batch, so each
// grid is bitwise its own launch, and the blocks of a batch (64 at 364^2:
// 1024 threads and 35.6 KB of shared memory each) run side by side on the
// card's 132 SMs, where one launch kept one SM busy.
//
// Built with --fmad=false and with the coefficient and decay arithmetic op
// for op that of the plain PyTorch version, so confidence is bitwise. The
// scan associates the compositions differently from the plain version's
// Hillis-Steele (and in fused multiply-adds), so heights agree to a few
// ulps, not bitwise. The order is fixed and there are no atomics: two runs
// are bitwise equal.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr float kFltTiny = 1.17549435082228750797e-38f;  // C++ FLT_MIN
constexpr int kMemThreads = 128;   // the memory warps
constexpr int kPlan = 4 * 12;      // one ring's segment plans (ints)
constexpr int kBandExtra = 1 + 8;  // after the 3 buffers: the center, the junction cache (pairs)
constexpr int kExchange = 32;      // junction visits' coefficients and heights (floats)
constexpr int kScratch = 2 * 32 + kExchange + 2 * kPlan;  // scan totals (a, b), exchange, plans of two rings
constexpr int kMaxPerThread = 12;  // visits a walker keeps in registers
constexpr int kNoOverride = INT_MIN;
constexpr unsigned kFull = 0xffffffffu;

struct Consts {
  int n, cidx;
  float res2, dec, min_d2, floor_c;
};

// The confidence decay of a visited cell (f, y), branch-free: the division
// is always taken, the result only outside min_dist_squared.
__device__ __forceinline__ float decay(const Consts& K, float af2, int y, float occ) {
  const float b = (float)(y - K.cidx);
  const float d2 = (af2 + b * b) * K.res2;
  float v = occ - occ / K.dec;
  v = v > K.floor_c ? v : K.floor_c;
  return d2 > K.min_d2 ? v : occ;
}

// The slot map's inverse: flat grid index of slot s < 8d on ring d. Slots
// run clockwise from the top-left corner: top row, right column, bottom row,
// left column (8d in all, the center's 0); slot 8d is a second copy of slot
// 0 so that the left column's run does not wrap.
__device__ __forceinline__ int slot_cell(int s, int d, const Consts& K) {
  const int lo = K.cidx - d, hi = K.cidx + d;
  int r, c;
  if (s < 2 * d) { r = lo; c = lo + s; }
  else if (s < 4 * d) { r = lo + s - 2 * d; c = hi; }
  else if (s < 6 * d) { r = hi; c = hi - (s - 4 * d); }
  else { r = hi - (s - 6 * d); c = lo; }
  return r * K.n + c;
}

// The plan of segment `kind` of ring D (0 top row ->, 1 left column v, 2
// bottom row <-, 3 right column ^). Walk position j of the own line (ring
// D), the outer line (ring D+1) and the inner line (ring D-1) sits at slot
// a + s*j of its ring, s = +1 for top and bottom, -1 for left and right:
// each line is a run of slots, the outer one a - own a = kDist[kind] past
// the own one, the inner one as far before it. Only the own line's j = -1, L
// and the inner line's j = -1, 0, L-1, L leave their run (corners, other
// rings); their slots are alpha*D + beta on ring D + r. ops/spiral.py
// SEGMENT_DIST and SEGMENT_SPECIAL are the Python twins of these tables,
// held to the general slot map by tests/test_torch_spiral_band.py.
__constant__ int kDist[4] = {1, 7, 5, 3};
__constant__ int kSpecial[4][6][3] = {  // {r, alpha, beta}: own -1, own L, in -1, in 0, in L-1, in L
    {{1, 8, 7}, {0, 2, 0}, {1, 8, 6}, {0, 8, -1}, {-1, 2, -2}, {0, 2, 1}},
    {{1, 0, 1}, {0, 6, 0}, {1, 0, 2}, {0, 0, 1}, {-1, 6, -6}, {0, 6, -1}},
    {{1, 4, 3}, {1, 6, 7}, {1, 4, 2}, {0, 4, -1}, {0, 6, 1}, {1, 6, 8}},
    {{1, 4, 5}, {1, 2, 1}, {1, 4, 6}, {0, 4, 1}, {0, 2, -1}, {1, 2, 0}}};

// The junction cache: pair p holds inner-line walk positions j0, j0+1 of
// segment kJunctionKind[p] (left and right from position 1, bottom and
// right from L-3), the ring D-1 cells that the redone visits of its start
// (p 0, 1) or end (p 2, 3) read. ops/spiral.py JUNCTION_KIND is the twin.
__constant__ int kJunctionKind[4] = {1, 3, 2, 3};

__device__ __forceinline__ int ring_size(int d) { return d == 0 ? 1 : 8 * d; }

struct Band {
  float2* v;   // (height, confidence): 3 buffers of `stride` cells, the center, the junction cache
  int stride;  // 8m + 1: the largest ring and its corner copy
};

// Ring d >= 1 in buffer d % 3, the center after the three buffers.
__device__ __forceinline__ int buffer(const Band& B, int d) {
  return d == 0 ? 3 * B.stride : (d % 3) * B.stride;
}

// The inner line's base index for junction pair p of ring D: base + s*j
// lands in the pair's two cache cells for its positions j.
__device__ __forceinline__ int junction_in0(const Band& B, int p, int D) {
  const int base = 3 * B.stride + 1 + 2 * p, j0 = p < 2 ? 1 : 2 * D - 2;
  return (kJunctionKind[p] & 1) ? base + 1 + j0 : base - j0;
}

__device__ __forceinline__ void sync_walkers(int count) {
  if (count == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync 1, %0;" ::"r"(count) : "memory");
  }
}

__device__ __forceinline__ void sync_all(int count) {
  asm volatile("bar.sync 2, %0;" ::"r"(count) : "memory");
}

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned to = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(to), "l"(src) : "memory");
}

// Ring d from global memory into its band buffer, with the corner copy;
// threads [t0, t0 + T) share the work.
__device__ void fetch_ring(const Band& B, const Consts& K, const float* h, const float* c,
                           int d, int t0, int T) {
  float2* ring = B.v + buffer(B, d);
  for (int s = threadIdx.x - t0; s < ring_size(d); s += T) {
    const int q = slot_cell(s, d, K);
    copy_async(&ring[s].x, h + q);
    copy_async(&ring[s].y, c + q);
    if (s == 0) {
      copy_async(&ring[8 * d].x, h + q);
      copy_async(&ring[8 * d].y, c + q);
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ void store_ring(const Band& B, const Consts& K, float* h, float* c, int d, int t0,
                           int T) {
  const float2* ring = B.v + buffer(B, d);
  for (int s = threadIdx.x - t0; s < ring_size(d); s += T) {
    const int q = slot_cell(s, d, K);
    const float2 v = ring[s];
    h[q] = v.x;
    c[q] = v.y;
  }
}

// Entry `e` of segment `kind`'s plan for ring D, 12 ints: the band index
// of walk position 0 on the own, outer and inner lines, the six irregular
// band indices, the line f (also the grid coordinate of position 0), L.
__device__ int plan_entry(const Band& B, const Consts& K, int D, int kind, int e) {
  const int a_own = kind == 0 ? 0 : (kind == 1 ? 8 * D : 4 * D);
  switch (e) {
    case 0: return buffer(B, D) + a_own;
    case 1: return buffer(B, D + 1) + a_own + kDist[kind];
    case 2: return buffer(B, D - 1) + a_own - kDist[kind];
    case 9: return kind >= 2 ? K.cidx + D : K.cidx - D;
    case 10: return kind >= 2 ? 2 * D + 1 : 2 * D;
    case 11: return 0;
    default: {
      const int* x = kSpecial[kind][e - 3];
      return buffer(B, D + x[0]) + x[1] * D + x[2];
    }
  }
}

struct Coef {
  float a, b, cc;  // h -> a + b*h, the visit's new confidence
  int slot;        // band index of the visited cell
};

// The coefficients of walk position k of segment `kind`, from the band as
// it stands (the plain version's formulas, op for op). `in0` replaces the
// plan's inner-line base (the junction cache) unless it is kNoOverride.
__device__ Coef coefficients(const Band& B, const Consts& K, const int* plan, int kind, int k,
                             int in0x = kNoOverride) {
  const int4 pa = reinterpret_cast<const int4*>(plan)[0];
  const int4 pb = reinterpret_cast<const int4*>(plan)[1];
  const int4 pc = reinterpret_cast<const int4*>(plan)[2];
  const int own0 = pa.x, out0 = pa.y, in0 = in0x == kNoOverride ? pa.z : in0x;
  const int own_first = pa.w, own_last = pb.x;
  const int in_m1 = pb.y, in_0 = pb.z, in_l1 = pb.w, in_l = pc.x;
  const int f = pc.y, L = pc.z;
  const bool desc = kind >= 2;
  const int s = (kind & 1) ? -1 : 1;  // slot step per walk position
  const int ystep = desc ? -1 : 1;    // grid step per walk position
  const float af = (float)(f - K.cidx);
  const float af2 = af * af;
  const float2* V = B.v;

  const int y = f + ystep * k;
  const int q1 = own0 + s * k;
  const int p1 = k == 0 ? own_first : q1 - s;
  const int s1 = k == L - 1 ? own_last : q1 + s;
  const int qu = out0 + s * k;
  const int qi0 = in0 + s * k;
  const int pi = k == 0 ? in_m1 : (k == 1 ? in_0 : qi0 - s);
  const int qi = k == 0 ? in_0 : (k == L - 1 ? in_l1 : qi0);
  const int si = k == L - 1 ? in_l : (k == L - 2 ? in_l1 : qi0 + s);
  // line f-1 is the outer line of the top and left segments, the inner one
  // of the bottom and right segments; line f+1 the other
  const float2 v0p = V[desc ? pi : qu - s], v0y = V[desc ? qi : qu], v0s = V[desc ? si : qu + s];
  const float2 v2p = V[desc ? qu - s : pi], v2y = V[desc ? qu : qi], v2s = V[desc ? qu + s : si];
  const float2 v1p = V[p1], v1y = V[q1], v1s = V[s1];
  const float w0p = v0p.y * v0p.x, w0y = v0y.y * v0y.x, w0s = v0s.y * v0s.x;
  const float w2p = v2p.y * v2p.x, w2y = v2y.y * v2y.x, w2s = v2s.y * v2s.x;
  const float w1y = v1y.y * v1y.x, w1s = v1s.y * v1s.x;
  float num = w0p + w0y;
  num = num + w0s;
  num = num + w2p;
  num = num + w2y;
  num = num + w2s;
  num = num + w1y;
  num = num + w1s;
  float den = v0p.y + v0y.y;
  den = den + v0s.y;
  den = den + v2p.y;
  den = den + v2y.y;
  den = den + v2s.y;
  den = den + v1y.y;
  den = den + v1s.y;
  const bool pin = k > 0;  // predecessor inside this segment
  const float occ = v1y.y;
  const float cpred = pin ? decay(K, af2, y - ystep, v1p.y) : v1p.y;
  den = den + cpred;
  den = den + kFltTiny;
  const float blend = 1.0f - occ;
  Coef x;
  x.b = pin ? (blend * cpred) / den : 0.0f;
  const float ns = num + (pin ? 0.0f : cpred * v1p.x);
  x.a = (blend * ns) / den + occ * v1y.x;
  x.cc = decay(K, af2, y, occ);
  x.slot = q1;
  return x;
}

// A visit's result into the band; position 0 of top and left is the
// top-left corner, whose slots 0 and 8D = 4L both take it.
__device__ __forceinline__ void put(const Band& B, int kind, int k, int L, int slot, float h,
                                    float cc) {
  const float2 v = make_float2(h, cc);
  B.v[slot] = v;
  if (kind < 2 && k == 0) B.v[slot + (kind == 0 ? 4 * L : -4 * L)] = v;
}

// Ring 1 by warp 0, segment by segment: its segments are too short for the
// ring-wide scan (each one's junctions with the next overlap).
__device__ void walk_ring1(const Band& B, const Consts& K, const int* plans) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int kind = 0; kind < 4; ++kind) {
    const int* plan = plans + 12 * kind;
    const int L = plan[10];
    Coef x{0.0f, 0.0f, 0.0f, 0};
    if (lane < L) x = coefficients(B, K, plan, kind, lane);
    __syncwarp();
    float h = 0.0f;
    for (int k = 0; k < L; ++k) {  // h[k] = a[k] + b[k] h[k-1], b[0] = 0
      const float a = __shfl_sync(kFull, x.a, k), b = __shfl_sync(kFull, x.b, k);
      h = __fmaf_rn(b, h, a);
      if (lane == k) put(B, kind, k, L, x.slot, h, x.cc);
    }
    __syncwarp();
  }
}

// Ring D >= 2 by the first P threads, each with up to EM visits in
// registers. Its 8D+2 visits (top 2D, left 2D, bottom 2D+1, right 2D+1, in
// walk order) are solved together: a visit reads a cell that an earlier
// segment of the ring writes only at the junctions, left positions 0, 1
// (top's 0, 1), bottom L-2, L-1 (left's last), right 0, 1 (bottom's 0, 1)
// and right L-2, L-1 (top's last). So all coefficients come from the band
// as the ring starts; warp 0 then redoes left 0, 1 and right 0, 1 with top's
// and bottom's first results in the band; one scan over the ring gives
// every height (b = 0 at each segment's position 0 restarts the
// recurrence) and writes the visits back; warp 0 redoes bottom and right
// L-2, L-1 with top's and left's last results in the band. The junction
// visits' values pass through the exchange X; `release` tells the memory
// warps (barrier 3) that ring D-1 has been read.
template <int EM>
__device__ void walk_ring(const Band& B, const Consts& K, const int* plans, int D, int P,
                          float* scratch, bool release) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int N = 8 * D + 2;
  const int E = N > P ? (N + P - 1) / P : 1;  // visits per thread, <= EM
  const int g0 = t * E, g1 = min(N, g0 + E);
  auto locate = [&](int g, int& kind, int& k) {
    kind = g < 2 * D ? 0 : (g < 4 * D ? 1 : (g < 6 * D + 1 ? 2 : 3));
    k = g - (kind == 0 ? 0 : (kind == 1 ? 2 * D : (kind == 2 ? 4 * D : 6 * D + 1)));
  };
  const int left0 = 2 * D, bottom0 = 4 * D, right0 = 6 * D + 1;
  const int bottom_end = 6 * D - 1, right_end = 8 * D;  // position L-2 of each
  float* wa = scratch;
  float* wb = scratch + 32;
  // X: (a, b, confidence) of top 0, 1 and bottom 0, 1 at 0-11, of the redone
  // left 0, 1 and right 0, 1 at 12-23; (height, confidence) of bottom L-3
  // at 24, 25 and right L-3 at 26, 27
  float* X = scratch + 64;

  // phase 1: every visit's coefficients, from the band as the ring starts
  float ra[EM] = {}, rb[EM] = {}, rc[EM] = {};
#pragma unroll
  for (int e = 0; e < EM; ++e) {
    const int g = g0 + e;
    if (g < g1) {
      int kind, k;
      locate(g, kind, k);
      const Coef x = coefficients(B, K, plans + 12 * kind, kind, k);
      ra[e] = x.a;
      rb[e] = x.b;
      rc[e] = x.cc;
      if (g < 2 || (g >= bottom0 && g < bottom0 + 2)) {
        float* to = X + 3 * (g < 2 ? g : g - bottom0 + 2);
        to[0] = x.a;
        to[1] = x.b;
        to[2] = x.cc;
      }
    }
  }
  if (warp == 0 && lane < 8) {  // the junction cache, from ring D-1
    const int p = lane >> 1, kind = kJunctionKind[p], s = (kind & 1) ? -1 : 1;
    const int j = (p < 2 ? 1 : 2 * D - 2) + (lane & 1);
    B.v[junction_in0(B, p, D) + s * j] = B.v[plans[12 * kind + 2] + s * j];
  }
  sync_walkers(P);
  if (release && warp == 0) asm volatile("bar.arrive 3, %0;" ::"r"(32 + kMemThreads) : "memory");

  // junctions at the starts: lanes 0 and 1 put top's and bottom's positions
  // 0 and 1, lanes 0-3 redo left 0, 1 and right 0, 1
  if (warp == 0 && lane < 4) {
    if (lane < 2) {
      const int kind = lane == 0 ? 0 : 2;
      const float* from = X + 6 * lane;
      const int L = plans[12 * kind + 10];
      const float h0 = from[0], h1 = __fmaf_rn(from[4], h0, from[3]);
      put(B, kind, 0, L, plans[12 * kind], h0, from[2]);
      put(B, kind, 1, L, plans[12 * kind] + ((kind & 1) ? -1 : 1), h1, from[5]);
    }
    __syncwarp(0xfu);
    const int kind = lane < 2 ? 1 : 3, k = lane & 1;
    const Coef x = coefficients(B, K, plans + 12 * kind, kind, k, junction_in0(B, lane >> 1, D));
    float* to = X + 12 + 3 * lane;
    to[0] = x.a;
    to[1] = x.b;
    to[2] = x.cc;
  }
  sync_walkers(P);

  // phase 2: each thread composes its visits' maps h -> a + b*h (taking the
  // redone junction visits' coefficients), warps scan those with shuffles,
  // every warp scans the totals of the warps before it
  float A = 0.0f, Bm = 1.0f;
#pragma unroll
  for (int e = 0; e < EM; ++e) {
    const int g = g0 + e;
    if (g < g1) {
      const int r = g >= left0 && g < left0 + 2 ? g - left0
                    : (g >= right0 && g < right0 + 2 ? g - right0 + 2 : -1);
      if (r >= 0) {
        ra[e] = X[12 + 3 * r];
        rb[e] = X[13 + 3 * r];
        rc[e] = X[14 + 3 * r];
      }
      A = __fmaf_rn(rb[e], A, ra[e]);
      Bm = rb[e] * Bm;
    }
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float a1 = __shfl_up_sync(kFull, A, d), b1 = __shfl_up_sync(kFull, Bm, d);
    if (lane >= d) {
      A = __fmaf_rn(Bm, a1, A);
      Bm = Bm * b1;
    }
  }
  float ea = __shfl_up_sync(kFull, A, 1), eb = __shfl_up_sync(kFull, Bm, 1);
  if (lane == 0) {
    ea = 0.0f;
    eb = 1.0f;
  }
  float before = 0.0f;  // the height entering this warp
  if (P > 32) {
    if (lane == 31) {
      wa[warp] = A;
      wb[warp] = Bm;
    }
    sync_walkers(P);
    float A2 = lane < warp ? wa[lane] : 0.0f, B2 = lane < warp ? wb[lane] : 1.0f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float a1 = __shfl_up_sync(kFull, A2, d), b1 = __shfl_up_sync(kFull, B2, d);
      if (lane >= d) {
        A2 = __fmaf_rn(B2, a1, A2);
        B2 = B2 * b1;
      }
    }
    before = __shfl_sync(kFull, A2, 31);
  }
  // phase 3: the heights, each visit into the band but the first visits of
  // the corners (i, i) and (o, o), which the second ones overwrite, and
  // bottom's and right's last three, which the end junctions read first
  float hin = __fmaf_rn(eb, before, ea);
#pragma unroll
  for (int e = 0; e < EM; ++e) {
    const int g = g0 + e;
    if (g < g1) {
      hin = __fmaf_rn(rb[e], hin, ra[e]);
      if (g == bottom_end - 1 || g == right_end - 1) {
        float* to = X + (g == bottom_end - 1 ? 24 : 26);
        to[0] = hin;
        to[1] = rc[e];
      }
      const bool junction = g == 0 || g == bottom0 ||
                            (g >= bottom_end - 1 && g <= bottom_end + 1) || g >= right_end - 1;
      if (!junction) {
        int kind, k;
        locate(g, kind, k);
        const int* plan = plans + 12 * kind;
        put(B, kind, k, plan[10], plan[0] + ((kind & 1) ? -k : k), hin, rc[e]);
      }
    }
  }
  sync_walkers(P);

  // junctions at the ends: lanes 0-3 redo bottom L-2, L-1 and right L-2,
  // L-1 with top's and left's last results in the band, then put those and
  // position L-3
  if (warp == 0 && lane < 4) {
    const int kind = lane < 2 ? 2 : 3, L = 2 * D + 1, k = L - 2 + (lane & 1);
    const Coef x = coefficients(B, K, plans + 12 * kind, kind, k,
                                junction_in0(B, 2 + (lane >> 1), D));
    const float* from = X + (lane < 2 ? 24 : 26);  // position L-3
    float h = __fmaf_rn(x.b, from[0], x.a);        // position L-2 from L-3
    const float h2 = __shfl_up_sync(0xfu, h, 1);
    if (lane & 1) h = __fmaf_rn(x.b, h2, x.a);  // L-1 from the new L-2
    __syncwarp(0xfu);                            // every read before any write
    put(B, kind, k, L, x.slot, h, x.cc);
    if (!(lane & 1)) put(B, kind, k - 1, L, x.slot - ((kind & 1) ? -1 : 1), from[0], from[1]);
  }
}

// One block: the first blockDim.x - kMemThreads threads walk rings d0 .. d1;
// the last kMemThreads (the memory warps) store each finished ring, plan the
// next ring's segments and fetch the ring two ahead, and meet the walkers
// once per ring. The prologue fetches rings d0-1 (final), d0 and d0+1, and
// seeds the center (ring 0) when `seed` is set; the launch stores ring d1
// last. So the bands of a partition of 1 .. m-1, launched in order on the
// same layers, give bitwise the one launch over the whole range.
template <int EM>
__global__ void __launch_bounds__(1024, 1)
spiral_kernel(float* h, float* c, Consts K, const float* base_z, int zstride, int stride,
              int d0, int d1, int seed) {
  // this block's grid and seed
  const size_t grid = (size_t)blockIdx.x * K.n * K.n;
  h += grid;
  c += grid;
  base_z += (size_t)blockIdx.x * zstride;
  extern __shared__ float2 band[];
  const Band B{band, stride};
  float* scratch = reinterpret_cast<float*>(band + 3 * stride + kBandExtra);
  int* plans = reinterpret_cast<int*>(scratch + 2 * 32 + kExchange);  // ring d's at (d & 1) * kPlan
  const int m = K.cidx;
  const int top = min(d1 + 1, m);  // the outermost ring the launch reads
  const int T = blockDim.x, Tc = T - kMemThreads, t = threadIdx.x;

  for (int d = d0 - 1; d <= d0 + 1 && d <= m; ++d) fetch_ring(B, K, h, c, d, 0, T);
  if (seed && t == 0) B.v[buffer(B, 0)] = make_float2(*base_z, 1.0f);  // the thread that fetched it
  if (t < kPlan && d0 <= d1) plans[(d0 & 1) * kPlan + t] = plan_entry(B, K, d0, t / 12, t % 12);
  __syncthreads();

  for (int d = d0; d <= d1; ++d) {
    if (t >= Tc) {
      store_ring(B, K, h, c, d - 1, Tc, kMemThreads);
      const int u = t - Tc;
      if (u < kPlan && d + 1 <= d1) {
        plans[((d + 1) & 1) * kPlan + u] = plan_entry(B, K, d + 1, u / 12, u % 12);
      }
      if (d + 2 <= top) {
        // ring d+2 takes ring d-1's buffer once the walkers have read ring
        // d-1 (ring 0, the center, has a slot of its own)
        if (d >= 2) asm volatile("bar.sync 3, %0;" ::"r"(32 + kMemThreads) : "memory");
        fetch_ring(B, K, h, c, d + 2, Tc, kMemThreads);
      }
    } else {
      // the walkers this ring needs: one per visit, 8d+2
      const int P = min(Tc, (8 * d + 2 + 31) / 32 * 32);
      const int* plan = plans + (d & 1) * kPlan;
      if (d == 1) {
        if (t < 32) walk_ring1(B, K, plan);
      } else if (t < P) {
        walk_ring<EM>(B, K, plan, d, P, scratch, d + 2 <= top);
      }
    }
    sync_all(T);
  }
  if (t >= Tc) store_ring(B, K, h, c, d1, Tc, kMemThreads);
}

template <int EM>
int launch(float* h, float* c, const Consts& K, const float* base_z, int zstride, int stride,
           int d0, int d1, int seed, int batch, int threads, int smem_bytes,
           cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        spiral_kernel<EM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  spiral_kernel<EM><<<batch, threads, smem_bytes, stream>>>(h, c, K, base_z, zstride, stride,
                                                            d0, d1, seed);
  return (int)cudaGetLastError();
}

}  // namespace

// h, c: (batch, n, n) f32 row-major, updated in place: rings d0 .. d1
// walked, the center seeded first when seed is nonzero (1 <= d0, d0 - 1 <=
// d1 <= m - 1; the whole sweep is 1 .. m-1 seeded) with the height
// base_z[b * zstride] for grid b, device f32s read once by the launch (the
// step's scan scalars: a captured launch reads each replay's values).
// threads and smem_bytes come from ops/spiral.py band_layout; a launch
// whose geometry or range does not fit the kernel's limits returns
// cudaErrorInvalidValue without launching.
extern "C" int gg_spiral(float* h, float* c, int n, int cidx, const float* base_z, int zstride,
                         float res2, float dec, float min_d2, float floor_c, int d0, int d1,
                         int seed, int batch, int threads, int smem_bytes,
                         cudaStream_t stream) {
  const int m = cidx > 0 ? cidx : 0;
  const int stride = 8 * m + 1;
  const int walkers = threads - kMemThreads;
  const size_t band = (3 * (size_t)stride + kBandExtra) * sizeof(float2) + kScratch * sizeof(float);
  if (threads > 1024 || threads % 32 != 0 || walkers < 32 || (size_t)smem_bytes != band ||
      d0 < 1 || d1 < d0 - 1 || d1 > m - 1 || batch < 1) {
    return (int)cudaErrorInvalidValue;
  }
  // visits per walker on ring d1, the largest walked (walk_ring's E)
  const int visits = 8 * d1 + 2;
  const int per = d1 >= 2 ? (visits + walkers - 1) / walkers : 1;
  const Consts K{n, cidx, res2, dec, min_d2, floor_c};
  const int s = seed != 0;
  const int z = zstride;
  if (per <= 2) {
    return launch<2>(h, c, K, base_z, z, stride, d0, d1, s, batch, threads, smem_bytes, stream);
  }
  if (per <= 4) {
    return launch<4>(h, c, K, base_z, z, stride, d0, d1, s, batch, threads, smem_bytes, stream);
  }
  if (per <= 8) {
    return launch<8>(h, c, K, base_z, z, stride, d0, d1, s, batch, threads, smem_bytes, stream);
  }
  if (per <= kMaxPerThread) {
    return launch<kMaxPerThread>(h, c, K, base_z, z, stride, d0, d1, s, batch, threads,
                                 smem_bytes, stream);
  }
  return (int)cudaErrorInvalidValue;
}
