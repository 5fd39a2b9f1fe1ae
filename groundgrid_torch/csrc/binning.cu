// K5: the step's point binning in one pass, core/rasterize.py bin_points.
//
// Replaces what XLA fuses of the JAX step's binning,
// groundgrid_tpu/core/rasterize.py:92 bin_points (faithful_cells :61,
// exactf32.py:304 ds_bin on both axes): the f64-faithful cell of each point
// in double-single f32 arithmetic, its flat id and in-map flag, its squared
// xy distance to the sensor and the ring / near-field ignore rule. Eager
// PyTorch runs that chain as ~230 elementwise kernels, each a pass over the
// points; here one thread takes one point through all of it.
//
// Bitwise or nothing: the sorted-scan host prep sorts the points by the ids
// the plain version computes on the CPU (pipeline.predict_cells), and the
// step counts a scan whose device ids are out of order as a fallback. Every
// operation is the plain version's, rounded alike (exactf32.cuh).
//
// Bound on the card: bytes. Per point it reads x, y (f32), the ring (i32)
// and the valid flag (1 byte) and writes gi0, gi1, cell (i32), sqdist (f32)
// and two flags: 31 bytes, 4.06 MB at 131,072 points (1.2 us at 3.35
// TB/s); its 187 f32 operations a point are 0.37 us at 67 TFLOP/s. The
// threads are independent and their loads and stores coalesced.
//
// Per-scan values are read from the scan scalars in device memory (row
// `row` of a batch at `stride` floats from the first), never passed by
// value: a CUDA graph captured on one scan replays on any other. A batch of
// vehicles, (B, P) points and B rows of scalars, is one launch with
// blockIdx.y the vehicle; each vehicle's threads do what a single launch does.
#include <cuda_runtime.h>

#include "exactf32.cuh"

namespace {

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

__global__ void binning_kernel(BinArgs a, int p, int stride, int n, float rh, float rl,
                               float inv, int max_ring, float min_dist_squared) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const size_t k = (size_t)blockIdx.y * p + i;
  const float* s = a.scalars + (size_t)blockIdx.y * stride;
  const gg::Res res = gg::make_res(rh, rl, inv);
  const float x = a.x[k], y = a.y[k];
  const int g0 = gg::ds_bin(s[gg::kSh0], s[gg::kSl0], x, res);
  const int g1 = gg::ds_bin(s[gg::kSh1], s[gg::kSl1], y, res);
  const bool in = (g0 >= 0) & (g0 < n) & (g1 >= 0) & (g1 < n) & a.valid[k];
  const float dx = gg::sub(x, s[gg::kOx]);
  const float dy = gg::sub(y, s[gg::kOy]);
  const float sq = gg::add(gg::mul(dx, dx), gg::mul(dy, dy));
  a.gi0[k] = g0;
  a.gi1[k] = g1;
  a.cell[k] = in ? g0 * n + g1 : n * n;
  a.inmap[k] = in;
  a.ignored[k] = in & ((a.rings[k] > max_ring) | (sq < min_dist_squared));
  a.sqdist[k] = sq;
}

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
  const int threads = 256;
  dim3 blocks((p + threads - 1) / threads, batch);
  BinArgs a{x, y, rings, valid, scalars, gi0, gi1, cell, inmap, ignored, sqdist};
  binning_kernel<<<blocks, threads, 0, stream>>>(a, p, stride, n, rh, rl, inv, max_ring,
                                                 min_dist_squared);
  return (int)cudaGetLastError();
}
