// K1: per-cell reductions over points sorted by flat cell id.
//
// Replaces the TPU kernel groundgrid_tpu/ops/pallas_raster.py:raster_sums
// (one-hot MXU matmul over bf16 3-way splits, _make_kernel/build_parts).
// Here the reduction is a segmented one over the sorted runs: one thread per
// cell binary-searches its run [lo, hi) in the sorted cell ids and reduces
// each column over the run in point order. Every column carries its own op
// (sum, min, max), so min/max are reduced directly and bitwise, and sums are
// taken in point order with no float atomics: the result is the same from
// run to run.
//
// Bound on the card: memory. It reads each column once (k x 4 B per point)
// plus the sorted ids, and writes k x 4 B per cell; at the main path's
// 131072 points x 7 columns and 364^2 cells that is ~8.6 MB, L2-resident.
// The design keeps the reads contiguous per thread (runs are contiguous) and
// leaves load balance (near-sensor runs hold hundreds of points, most runs
// 0-1) to a later change.
//
// Cell id n2 is the overflow bin and is dropped. Empty cells read 0 for
// every op. Any point count works (no padding multiple).
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int lower_bound(const int* cell, int p, int key) {
  int lo = 0, hi = p;
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (cell[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void raster_reduce_kernel(const int* __restrict__ cell,
                                     const float* __restrict__ cols, int p,
                                     int k, unsigned int ops, int n2,
                                     float* __restrict__ out) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n2) return;
  int lo = lower_bound(cell, p, c);
  int hi = lower_bound(cell, p, c + 1);
  for (int j = 0; j < k; ++j) {
    const float* col = cols + (size_t)j * p;
    unsigned int op = (ops >> (2 * j)) & 3u;
    float acc = 0.0f;
    if (op == 0u) {
      for (int q = lo; q < hi; ++q) acc = acc + col[q];
    } else if (hi > lo) {
      acc = col[lo];
      if (op == 1u) {
        for (int q = lo + 1; q < hi; ++q) { float v = col[q]; acc = v < acc ? v : acc; }
      } else {
        for (int q = lo + 1; q < hi; ++q) { float v = col[q]; acc = v > acc ? v : acc; }
      }
    }
    out[(size_t)j * n2 + c] = acc;
  }
}

}  // namespace

// cell: (p,) int32 nondecreasing in [0, n2]; cols: (k, p) f32 row-major;
// ops: 2 bits per column (0 sum, 1 min, 2 max); out: (k, n2) f32.
extern "C" int gg_raster_reduce(const int* cell, const float* cols, int p, int k,
                                unsigned int ops, int n2, float* out,
                                cudaStream_t stream) {
  const int threads = 256;
  int blocks = (n2 + threads - 1) / threads;
  raster_reduce_kernel<<<blocks, threads, 0, stream>>>(cell, cols, p, k, ops, n2, out);
  return (int)cudaGetLastError();
}
