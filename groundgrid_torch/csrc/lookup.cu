// K2: per-point table lookups, out[c][p] = table[c][cell[p]].
//
// Replaces the TPU kernel groundgrid_tpu/ops/pallas_lookup.py:sorted_lookup
// (per-group loops over (8, 128) table tiles with lane gathers, a scheme that
// exists because the TPU has no fast per-element gather). On the card it is
// a plain gather: one thread per point reads 1 or 2 tables in one launch.
//
// Bound on the card: memory latency of the gathers. One table is n2 x 4 B
// (0.53 MB at 364^2), so the tables stay L2-resident and sorted cell ids
// make neighbouring threads hit neighbouring words. The words are copied as
// 32-bit integers, so any bit pattern (the occlusion key table is a u32
// key stored in an f32 tensor) passes through unchanged.
//
// Ids outside [0, n2) -- the overflow bin n2 -- read 0. Sortedness is not
// required for correctness.
#include <cuda_runtime.h>

namespace {

__global__ void lookup_kernel(const int* __restrict__ cell, int p,
                              const unsigned int* __restrict__ t0,
                              const unsigned int* __restrict__ t1, int n2,
                              unsigned int* __restrict__ o0,
                              unsigned int* __restrict__ o1) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  int c = cell[i];
  bool ok = c >= 0 && c < n2;
  o0[i] = ok ? t0[c] : 0u;
  if (t1 != nullptr) o1[i] = ok ? t1[c] : 0u;
}

}  // namespace

// t1/o1 may be null for a single table.
extern "C" int gg_lookup(const int* cell, int p, const void* t0, const void* t1,
                         int n2, void* o0, void* o1, cudaStream_t stream) {
  const int threads = 256;
  int blocks = (p + threads - 1) / threads;
  lookup_kernel<<<blocks, threads, 0, stream>>>(
      cell, p, static_cast<const unsigned int*>(t0),
      static_cast<const unsigned int*>(t1), n2, static_cast<unsigned int*>(o0),
      static_cast<unsigned int*>(o1));
  return (int)cudaGetLastError();
}
