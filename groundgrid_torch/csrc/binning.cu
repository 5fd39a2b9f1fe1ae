// K5: the step's point binning in one pass, core/rasterize.py bin_points.
//
// Replaces what XLA fuses of the JAX step's binning,
// groundgrid_tpu/core/rasterize.py:92 bin_points (faithful_cells :61,
// exactf32.py:304 ds_bin on both axes): the f64-faithful cell of each point
// in double-single f32 arithmetic, its flat id and in-map flag, its squared
// xy distance to the sensor and the ring / near-field ignore rule. Eager
// PyTorch runs that chain as ~230 elementwise kernels, each a pass over the
// points; here one thread takes a few points through all of it.
//
// Bitwise or nothing: the sorted-scan host prep sorts the points by the ids
// the plain version computes on the CPU (pipeline.predict_cells), and the
// step counts a scan whose device ids are out of order as a fallback. Every
// operation is the plain version's, rounded alike (exactf32.cuh).
//
// Bound on the card: bytes. Per point it reads x, y (f32), the ring (i32)
// and the valid flag (1 byte) and writes gi0, gi1, cell (i32), sqdist (f32)
// and two flags: 31 bytes, 4.06 MB at 131,072 points (1.2 us at 3.35
// TB/s); its 187 f32 operations a point are 0.37 us at 67 TFLOP/s.
//
// The chain is latency: each axis's ds_bin is ~87 dependent operations. So
// a thread takes kPts consecutive points (a group), whose 2 kPts chains are
// independent and overlap, and hoists the resolution's splits and the scan
// scalars into registers once. A group loads x, y and the rings with one
// vector load each (8 bytes at kPts = 2) and the valid flags with one
// kPts-byte load, and stores each output the same way. Groups are aligned
// to the flat index of the (batch, p) arrays, so a vector access never
// straddles its alignment; a group that a row's start or end cuts (p not
// a multiple of kPts, in a batch or at the row's tail), or arrays not
// aligned for the vector accesses, take the scalar path point by point.
// kPts and kThreads come from a sweep on the card (chip_smoke.py
// --k5-variants): at 131,072 points the kernel is one wave, and 4 or 8
// points a thread leave too few warps to hide the chains (4 x 128 took
// 0.0031 ms against 0.0026 for 2 x 256); on a batch of 64 scans, 2 and 4
// points a thread are alike (0.091 ms) and one point a thread 0.100.
//
// Per-scan values are read from the scan scalars in device memory (row
// `row` of a batch at `stride` floats from the first), never passed by
// value: a CUDA graph captured on one scan replays on any other. A batch of
// vehicles, (B, P) points and B rows of scalars, is one launch with
// blockIdx.y the vehicle; each vehicle's threads do what a single launch does.
#include <cuda_runtime.h>
#include <stdint.h>

#include "exactf32.cuh"

namespace {

constexpr int kPts = 2;        // points a thread (a group); the vector width
constexpr int kThreads = 256;  // a block

template <typename T>
struct alignas(sizeof(T) * kPts) Vec {
  T v[kPts];
};

struct BinArgs {
  const float* x;
  const float* y;
  const int* rings;
  const bool* valid;
  const float* scalars;
  int* gi0;
  int* gi1;
  int* cell;
  bool* inmap;
  bool* ignored;
  float* sqdist;
};

// The scan's constants, in registers once a thread
struct Scan {
  gg::Res res;
  float sh0, sl0, sh1, sl1, ox, oy;
  int n, max_ring;
  float min_dist_squared;
};

struct Point {
  int g0, g1, cell;
  bool in, ignored;
  float sq;
};

__device__ __forceinline__ Point bin(const Scan& c, float x, float y, int ring, bool valid) {
  Point o;
  o.g0 = gg::ds_bin(c.sh0, c.sl0, x, c.res);
  o.g1 = gg::ds_bin(c.sh1, c.sl1, y, c.res);
  o.in = (o.g0 >= 0) & (o.g0 < c.n) & (o.g1 >= 0) & (o.g1 < c.n) & valid;
  const float dx = gg::sub(x, c.ox);
  const float dy = gg::sub(y, c.oy);
  o.sq = gg::add(gg::mul(dx, dx), gg::mul(dy, dy));
  o.cell = o.in ? o.g0 * c.n + o.g1 : c.n * c.n;
  o.ignored = o.in & ((ring > c.max_ring) | (o.sq < c.min_dist_squared));
  return o;
}

__global__ void __launch_bounds__(kThreads) binning_kernel(BinArgs a, int p, int stride, int n,
                                                           float rh, float rl, float inv,
                                                           int max_ring,
                                                           float min_dist_squared, int vec) {
  const long long start = (long long)blockIdx.y * p, end = start + p;
  const long long first = (start / kPts + (long long)blockIdx.x * blockDim.x + threadIdx.x) * kPts;
  if (first >= end) return;
  const float* s = a.scalars + (size_t)blockIdx.y * stride;
  const Scan c{gg::make_res(rh, rl, inv), s[gg::kSh0], s[gg::kSl0], s[gg::kSh1], s[gg::kSl1],
               s[gg::kOx], s[gg::kOy], n, max_ring, min_dist_squared};
  if (vec && first >= start && first + kPts <= end) {
    const Vec<float> x = *reinterpret_cast<const Vec<float>*>(a.x + first);
    const Vec<float> y = *reinterpret_cast<const Vec<float>*>(a.y + first);
    const Vec<int> ring = *reinterpret_cast<const Vec<int>*>(a.rings + first);
    const Vec<bool> valid = *reinterpret_cast<const Vec<bool>*>(a.valid + first);
    Vec<int> g0, g1, cell;
    Vec<bool> in, ignored;
    Vec<float> sq;
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      const Point o = bin(c, x.v[j], y.v[j], ring.v[j], valid.v[j]);
      g0.v[j] = o.g0;
      g1.v[j] = o.g1;
      cell.v[j] = o.cell;
      in.v[j] = o.in;
      ignored.v[j] = o.ignored;
      sq.v[j] = o.sq;
    }
    *reinterpret_cast<Vec<int>*>(a.gi0 + first) = g0;
    *reinterpret_cast<Vec<int>*>(a.gi1 + first) = g1;
    *reinterpret_cast<Vec<int>*>(a.cell + first) = cell;
    *reinterpret_cast<Vec<bool>*>(a.inmap + first) = in;
    *reinterpret_cast<Vec<bool>*>(a.ignored + first) = ignored;
    *reinterpret_cast<Vec<float>*>(a.sqdist + first) = sq;
    return;
  }
  // the scalar path: a group cut by the row's start or end, or unaligned arrays
  const long long lo = first > start ? first : start;
  const long long hi = first + kPts < end ? first + kPts : end;
  for (long long k = lo; k < hi; ++k) {
    const Point o = bin(c, a.x[k], a.y[k], a.rings[k], a.valid[k]);
    a.gi0[k] = o.g0;
    a.gi1[k] = o.g1;
    a.cell[k] = o.cell;
    a.inmap[k] = o.in;
    a.ignored[k] = o.ignored;
    a.sqdist[k] = o.sq;
  }
}

bool aligned(const void* ptr, size_t bytes) { return reinterpret_cast<uintptr_t>(ptr) % bytes == 0; }

}  // namespace

// x, y: (batch, p) f32; rings: (batch, p) i32; valid: (batch, p) bool;
// scalars: the first row's scan scalars, rows `stride` floats apart;
// outputs (batch, p). (rh, rl, inv): core/exactf32.res_ds of the resolution.
// p >= 1, 1 <= batch <= 65535.
extern "C" int gg_bin(const float* x, const float* y, const int* rings, const bool* valid,
                      int p, int batch, const float* scalars, int stride, int n, float rh,
                      float rl, float inv, int max_ring, float min_dist_squared, int* gi0,
                      int* gi1, int* cell, bool* inmap, bool* ignored, float* sqdist,
                      cudaStream_t stream) {
  if (p < 1 || batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  // the vector accesses need 4 kPts-byte words and kPts-byte flag groups
  const int vec = aligned(x, 4 * kPts) && aligned(y, 4 * kPts) && aligned(rings, 4 * kPts) &&
                  aligned(valid, kPts) && aligned(gi0, 4 * kPts) && aligned(gi1, 4 * kPts) &&
                  aligned(cell, 4 * kPts) && aligned(sqdist, 4 * kPts) &&
                  aligned(inmap, kPts) && aligned(ignored, kPts);
  // a row's groups: those its flat range [b p, (b + 1) p) touches
  const long long groups = (long long)p / kPts + 2;
  dim3 blocks((unsigned)((groups + kThreads - 1) / kThreads), batch);
  BinArgs a{x, y, rings, valid, scalars, gi0, gi1, cell, inmap, ignored, sqdist};
  binning_kernel<<<blocks, kThreads, 0, stream>>>(a, p, stride, n, rh, rl, inv, max_ring,
                                                  min_dist_squared, vec);
  return (int)cudaGetLastError();
}
