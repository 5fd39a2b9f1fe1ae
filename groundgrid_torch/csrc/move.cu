// K12 move: the grid relocation, core/grid.py move (ops/move.py move_plain).
//
// Replaces what XLA fuses of the JAX step's grid move,
// groundgrid_tpu/core/grid.py:143 move (jnp.roll of both layers,
// exposed_mask :198, cell_positions :215 and the two jnp.where), itself
// GroundGrid::update (GroundGrid.cpp:83-147). The eager port ran it as ~50
// small kernels a scan (the roll as a gather with device indices, the mask,
// the base plane, two where); here it is one launch, one thread a cell,
// blockIdx.y the vehicle.
//
// Each cell reads the move's shift (k0, k1, int32 bits), the new f32 centre
// (cx, cy) and t_base_map's row 2 (b20, b21, b23) from the scan scalars in
// device memory (a captured graph replays on any scan). A cell is exposed by
// the shift as core/grid.py exposed_mask says (+k exposes [0, k) of its axis,
// -k [n + k, n), |k| >= n the whole grid); an exposed cell writes ground =
// -z_base and groundpatch = +0.0, where z_base = (b20 * px + b21 * py) + b23
// at its centre px = cx + coord(i), py = cy + coord(j), coord(i) = half -
// (i + 0.5) * res, every operation rounded once as its PyTorch op (_rn
// intrinsics, no contraction). Any other cell copies the source cell ((i -
// k0) mod n, (j - k1) mod n) of both layers, its bits as they are (NaN and
// -0.0 included), as torch.roll moves them. The outputs are new buffers, so
// the inputs are untouched.
// Bound on the card: bytes, both layers read once and written once, 16 B a
// cell (2.12 MB at 364^2, 0.63 us at 3.35 TB/s; an exposed cell reads
// nothing, which a warm scan's few exposed rows barely change). The reads
// follow the writes' rows, shifted: each warp reads at most two runs of
// consecutive words a layer.
#include <cuda_runtime.h>

#include "exactf32.cuh"

namespace {

constexpr int kThreads = 256;

// the scan scalars' offsets (core/scalars.py ScanScalars, KERNEL_FIELDS)
enum Field { kCx = 10, kCy = 11, kB20 = 12, kB21 = 13, kB23 = 14, kK0 = 27, kK1 = 28 };

// exposed_mask's axis test: the index idx of an axis of n cells, shifted by k
__device__ __forceinline__ bool exposed(int idx, int k, int n) {
  return (k >= 0 ? idx < k : idx >= n + k) | (k >= n) | (k <= -n);
}

// cell_positions' coord: half - (idx + 0.5) * res
__device__ __forceinline__ float coord(int idx, float half, float res) {
  return gg::sub(half, gg::mul(gg::add((float)idx, 0.5f), res));
}

// (idx - k) mod n for |k| < n
__device__ __forceinline__ int source(int idx, int k, int n) {
  const int s = idx - k;
  return s < 0 ? s + n : (s >= n ? s - n : s);
}

__global__ void move_kernel(const float* __restrict__ ground, const float* __restrict__ conf,
                            int n, const float* __restrict__ scalars, int stride, float half,
                            float res, float* __restrict__ out_g, float* __restrict__ out_c) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= n * n) return;
  const int i = cell / n, j = cell - (cell / n) * n;
  const float* s = scalars + (size_t)blockIdx.y * stride;
  const int k0 = __float_as_int(s[kK0]), k1 = __float_as_int(s[kK1]);
  const size_t grid = (size_t)blockIdx.y * n * n;
  float g, c;
  if (exposed(i, k0, n) | exposed(j, k1, n)) {
    const float px = gg::add(s[kCx], coord(i, half, res));
    const float py = gg::add(s[kCy], coord(j, half, res));
    const float z_base = gg::add(gg::add(gg::mul(s[kB20], px), gg::mul(s[kB21], py)), s[kB23]);
    g = -z_base;
    c = 0.0f;
  } else {
    const size_t from = grid + (size_t)source(i, k0, n) * n + source(j, k1, n);
    g = ground[from];
    c = conf[from];
  }
  out_g[grid + cell] = g;
  out_c[grid + cell] = c;
}

}  // namespace

// ground, conf: (batch, n, n) f32, the layers before the move; scalars: the
// first row's scan scalars (its ox), rows `stride` floats apart; half and
// res: the config's half length and resolution as f32; out_g, out_c:
// (batch, n, n) f32, the moved layers. n >= 1, 1 <= batch <= 65535.
extern "C" int gg_move(const float* ground, const float* conf, int n, int batch,
                       const float* scalars, int stride, float half, float res, float* out_g,
                       float* out_c, cudaStream_t stream) {
  if (n < 1 || n > 46340 || batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  dim3 blocks((n * n + kThreads - 1) / kThreads, batch);
  move_kernel<<<blocks, kThreads, 0, stream>>>(ground, conf, n, scalars, stride, half, res,
                                               out_g, out_c);
  return (int)cudaGetLastError();
}
