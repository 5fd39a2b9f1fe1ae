// K9 and K10: the step's raster stage around K1, core/rasterize.py
// raster_columns_ordered and finish_layers.
//
// Replaces what XLA fuses of the JAX step's rasterization around its Pallas
// kernel, groundgrid_tpu/core/rasterize.py:312 rasterize_sorted (the
// columns, with _plane_shift_point :123) and :409 _finish_layers (with
// _plane_shift_map :148): eager PyTorch runs the columns as 8 gathers
// through the sort's order and ~15 elementwise kernels, and the finish as
// ~35; here each is one launch.
//
// K9 (raster_columns_kernel): one thread a sorted position i, reading the point
// p = order[i] (i where there is no order). It forms accept = inmap &
// ~ignored & ~outlier and writes cell[p] and the seven K1 columns at i:
// in-map, accepted, z * acc, pdc, pdc^2, and the accepted z with the min
// and the max sentinel elsewhere. An accepted point lies in the map, where
// its cell id is gi0 * n + gi1: the plane shift takes (gi0, gi1) from the
// id, so the binning's gi0 and gi1 are not read. Its output goes to K1
// (raster.cu).
//
// K10 (raster_finish_kernel): one thread a cell. It folds S shards' seven K1
// columns in shard order (sums in order, the extrema over the shards that
// hold points of the cell) and writes the main path's three layers
// (points, variance, min_ground_height) or, with the aux layers, all eight
// (and the max); without them it reads no z sum.
//
// Bitwise or nothing: every f32 step is rounded as its PyTorch op
// (exactf32.cuh; the build passes --fmad=false): pd = z - oz, the plane
// shift (b20 * xc + b21 * yc) + b23 with no contraction, pdc = pd - s_pt,
// pdc * pdc; IEEE division for the means and the variance; clamp_min as
// torch.clamp_min (NaN passes through), and the shards' min / max as
// torch.amin / amax (NaN wins). Signed zeros that tie in the shards'
// extrema may come out either way: every layer reads them through a
// subtraction or a clamp that maps both to the same bits.
//
// Bound on the card: bytes. K9 reads the order (8 bytes), cell (4),
// inmap, ignored and outlier (3) and z (4) a point and writes its id and
// seven columns (32): 51 bytes, 6.7 MB at 131,072 points (2.0 us at 3.35
// TB/s). K10 reads 24 bytes a cell and shard (28 with the aux layers) and
// writes 4 a layer: 36 bytes at 364^2 with three layers, 4.8 MB (1.4 us).
//
// Per-scan values are read from the scan scalars in device memory (row
// blockIdx.y of a batch at `stride` floats from the first), never passed
// by value: a CUDA graph captured on one scan replays on any other. A batch
// of vehicles is one launch with blockIdx.y the vehicle; each vehicle's
// threads do what a single launch does.
#include <cuda_runtime.h>

#include "exactf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 7;
constexpr int kMaxShards = 64;
constexpr float kMinSent = 0x1p126f;  // MIN_SENT
constexpr float kFltMax = 0x1.fffffep127f;
constexpr float kFltTiny = 0x1p-126f;  // FLT_MIN
constexpr float kM2Floor = 0x1p-80f;

// the scan scalars' offsets beyond exactf32.cuh's (core/scalars.py)
enum Plane { kCxh = 8, kCyh = 9, kB20 = 12, kB21 = 13, kB23 = 14 };

// the layers K10 writes, planes of its output: the main path's three, then
// the aux layers (mean_variance is plane_dist)
enum Layer { kPoints, kVariance, kMinGh, kPointsRaw, kGroundCand, kPlaneDist, kM2, kMaxGh };

// _plane_shift_point: the ego base-plane pd at cell (gi0, gi1), -zb - oz
__device__ __forceinline__ float plane_shift(const float* s, int gi0, int gi1, float res) {
  const float xc = gg::sub(s[kCxh], gg::mul(gg::add(__int2float_rn(gi0), 0.5f), res));
  const float yc = gg::sub(s[kCyh], gg::mul(gg::add(__int2float_rn(gi1), 0.5f), res));
  const float zb = gg::add(gg::add(gg::mul(s[kB20], xc), gg::mul(s[kB21], yc)), s[kB23]);
  return gg::sub(-zb, s[gg::kOz]);
}

struct ColumnArgs {
  const long long* order;  // null: the identity
  const int* cell;
  const bool* inmap;
  const bool* ignored;
  const bool* outlier;
  const float* z;
  const float* scalars;
  int* cell_out;
  float* cols;  // (7, batch, p)
};

__global__ void __launch_bounds__(kThreads) raster_columns_kernel(ColumnArgs a, int p,
                                                                  int batch, int n,
                                                                  int stride, float res) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const size_t row = (size_t)blockIdx.y * p;
  const float* s = a.scalars + (size_t)blockIdx.y * stride;
  const size_t k = row + (a.order ? (size_t)a.order[row + i] : (size_t)i);
  const bool in = a.inmap[k];
  const bool acc = in & !a.ignored[k] & !a.outlier[k];
  const int cell = a.cell[k];
  const float z = a.z[k];
  float pdc = 0.0f;
  if (acc) {
    const int gi0 = cell / n;
    pdc = gg::sub(gg::sub(z, s[gg::kOz]), plane_shift(s, gi0, cell - gi0 * n, res));
  }
  const size_t plane = (size_t)batch * p;
  float* c = a.cols + row + i;
  c[0] = in ? 1.0f : 0.0f;
  c[plane] = acc ? 1.0f : 0.0f;
  c[2 * plane] = acc ? z : 0.0f;
  c[3 * plane] = pdc;
  c[4 * plane] = gg::mul(pdc, pdc);
  c[5 * plane] = acc ? z : kMinSent;
  c[6 * plane] = acc ? z : -kMinSent;
  a.cell_out[row + i] = cell;
}

struct FinishArgs {
  const float* cols[kMaxShards][kCols];  // shard s's column j, (batch, n2)
  const float* scalars;
  float* out;  // (3 or 8, batch, n2): the planes of Layer
};

// torch.amin / amax of two: NaN wins (the first one met), else the extremum
__device__ __forceinline__ float nan_min(float m, float v) {
  return isnan(m) ? m : ((isnan(v) || v < m) ? v : m);
}
__device__ __forceinline__ float nan_max(float m, float v) {
  return isnan(m) ? m : ((isnan(v) || v > m) ? v : m);
}

__global__ void __launch_bounds__(kThreads) raster_finish_kernel(FinishArgs a, int n,
                                                                 int shards, int stride,
                                                                 float res, int aux) {
  const int n2 = n * n;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n2) return;
  const size_t k = (size_t)blockIdx.y * n2 + c;
  const float* s = a.scalars + (size_t)blockIdx.y * stride;
  // column 2, the z sum, feeds only ground_candidates, an aux layer
  float v[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) v[j] = (j == 2 && !aux) ? 0.0f : a.cols[0][j][k];
  if (shards > 1) {
    // K1 leaves a cell without points at 0 in every column: its extrema
    // take the sentinels before they fold
    const bool has = v[0] > 0.0f;
    v[5] = has ? v[5] : kMinSent;
    v[6] = has ? v[6] : -kMinSent;
    for (int sh = 1; sh < shards; ++sh) {
      float w[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) w[j] = (j == 2 && !aux) ? 0.0f : a.cols[sh][j][k];
#pragma unroll
      for (int j = 0; j < 5; ++j) v[j] = gg::add(v[j], w[j]);
      const bool has_w = w[0] > 0.0f;
      v[5] = nan_min(v[5], has_w ? w[5] : kMinSent);
      v[6] = nan_max(v[6], has_w ? w[6] : -kMinSent);
    }
  }
  const float raw = v[0], count = v[1], zmin = v[5], zmax = v[6];
  const float safe = gg::clamp_min(count, 1.0f);
  const float mean_pdc = gg::div(v[3], safe);
  const float oz = s[gg::kOz];
  const bool spread = gg::sub(zmin, oz) < gg::sub(zmax, oz);
  const float residue = gg::sub(v[4], gg::mul(v[3], mean_pdc));
  const float m2 = ((count > 1.0f) & spread) ? gg::clamp_min(residue, kM2Floor) : 0.0f;
  const size_t plane = (size_t)gridDim.y * n2;
  float* o = a.out + k;
  o[kPoints * plane] = count;
  o[kVariance * plane] = gg::div(m2, gg::add(count, kFltTiny));
  // cells with no points read 0, all-ignored cells the sentinel
  o[kMinGh * plane] = ((raw > 0.0f) & (zmin < 1e30f)) ? gg::sub(zmin, 1e-4f) : kFltMax;
  if (aux) {
    const int gi0 = c / n;
    o[kPointsRaw * plane] = raw;
    o[kGroundCand * plane] = gg::div(v[2], safe);
    o[kPlaneDist * plane] =
        count > 0.0f ? gg::add(mean_pdc, plane_shift(s, gi0, c - gi0 * n, res)) : 0.0f;
    o[kM2 * plane] = m2;
    o[kMaxGh * plane] = raw > 0.0f ? gg::clamp_min(zmax, kFltTiny) : kFltTiny;
  }
}

}  // namespace

// K9. order: (batch, p) i64 indices into each row, or null; cell: (batch, p)
// i32, gi0 * n + gi1 in the map; inmap, ignored, outlier: (batch, p) bool;
// z: (batch, p) f32; scalars: the first row's scan scalars, rows `stride`
// floats apart; res: the resolution as f32. Writes cell_out (batch, p) i32
// and cols (7, batch, p) f32. p >= 1, 1 <= batch <= 65535.
extern "C" int gg_raster_columns(const long long* order, const int* cell, const bool* inmap,
                                 const bool* ignored, const bool* outlier, const float* z,
                                 int p, int batch, int n, const float* scalars, int stride,
                                 float res, int* cell_out, float* cols, cudaStream_t stream) {
  if (p < 1 || batch < 1 || batch > 65535 || n < 1) return (int)cudaErrorInvalidValue;
  const dim3 blocks((p + kThreads - 1) / kThreads, batch);
  const ColumnArgs a{order, cell, inmap, ignored, outlier, z, scalars, cell_out, cols};
  raster_columns_kernel<<<blocks, kThreads, 0, stream>>>(a, p, batch, n, stride, res);
  return (int)cudaGetLastError();
}

// K10. cols: a host array of shards * 7 device pointers, shard by shard,
// each column (batch, n * n) f32; out: (3, batch, n * n) f32, the points,
// variance and min_ground_height layers, or with aux (8, batch, n * n),
// then points_raw, ground_candidates, plane_dist, m2 and
// max_ground_height. 1 <= shards <= 64, 1 <= batch <= 65535.
extern "C" int gg_raster_finish(const float* const* cols, int shards, int n, int batch,
                                const float* scalars, int stride, float res, int aux,
                                float* out, cudaStream_t stream) {
  if (n < 1 || shards < 1 || shards > kMaxShards || batch < 1 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  FinishArgs a{};
  for (int sh = 0; sh < shards; ++sh) {
    for (int j = 0; j < kCols; ++j) a.cols[sh][j] = cols[sh * kCols + j];
  }
  a.scalars = scalars;
  a.out = out;
  const dim3 blocks((n * n + kThreads - 1) / kThreads, batch);
  raster_finish_kernel<<<blocks, kThreads, 0, stream>>>(a, n, shards, stride, res, aux);
  return (int)cudaGetLastError();
}
