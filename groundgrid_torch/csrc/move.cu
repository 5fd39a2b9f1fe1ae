// K12 move: the grid relocation, core/grid.py move (ops/move.py move_plain).
//
// Replaces what XLA fuses of the JAX step's grid move,
// groundgrid_tpu/core/grid.py:143 move (jnp.roll of both layers,
// exposed_mask :198, cell_positions :215 and the two jnp.where), itself
// GroundGrid::update (GroundGrid.cpp:83-147). The eager port ran it as ~50
// small kernels a scan (the roll as a gather with device indices, the mask,
// the base plane, two where); here it is one launch, blockIdx.y the vehicle.
//
// The move's shift (k0, k1, int32 bits), the new f32 centre (cx, cy) and
// t_base_map's row 2 (b20, b21, b23) come from the scan scalars in device
// memory (a captured graph replays on any scan), read once a block into
// shared memory. A cell is exposed by the shift as core/grid.py exposed_mask
// says (+k exposes [0, k) of its axis, -k [n + k, n), |k| >= n the whole
// grid); an exposed cell writes ground = -z_base and groundpatch = +0.0,
// where z_base = (b20 * px + b21 * py) + b23 at its centre px = cx +
// coord(i), py = cy + coord(j), coord(i) = half - (i + 0.5) * res, every
// operation rounded once as its PyTorch op (_rn intrinsics, no
// contraction). Any other cell copies the source cell ((i - k0) mod n, (j -
// k1) mod n) of both layers, its bits as they are (NaN and -0.0 included),
// as torch.roll moves them. The outputs are new buffers, so the inputs are
// untouched.
//
// A block takes whole rows (threadIdx.y a row, threadIdx.x its runs of
// cells), so a row's exposed test and source row are decided once and no
// thread divides a cell index. Where n % 4 == 0 and every layer is 16-byte
// aligned (364 and 1200 cells a side), a thread takes four cells: the
// rolled source row is two runs of whole 16-byte words, so the thread reads
// the one or two aligned words its four cells lie in (a neighbour reads the
// same word, from L1) and takes the four from them by the shift's offset
// (k1 mod 4, the same for the whole grid), and writes one 16-byte word a
// layer. Any other n takes one cell a thread, the same way.
// Bound on the card: bytes, both layers read once and written once, 16 B a
// kept cell, 8 an exposed one (2.12 MB at 364^2, 0.63 us at 3.35 TB/s).
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

template <int V>
struct Words;
template <>
struct Words<1> {
  using T = float;
  __device__ static void set(float& w, int, float v) { w = v; }
  __device__ static float take(const float& a, const float&, int) { return a; }
};
template <>
struct Words<4> {
  using T = float4;
  __device__ static void set(float4& w, int m, float v) {
    if (m == 0) w.x = v;
    if (m == 1) w.y = v;
    if (m == 2) w.z = v;
    if (m == 3) w.w = v;
  }
  // the four cells from offset r (1, 2 or 3) of word a on, into word b
  // past its end (selects: no indexed registers)
  __device__ static float4 take(const float4& a, const float4& b, int r) {
    return make_float4(r == 1 ? a.y : r == 2 ? a.z : a.w, r == 1 ? a.z : r == 2 ? a.w : b.x,
                       r == 1 ? a.w : r == 2 ? b.x : b.y, r == 1 ? b.x : r == 2 ? b.y : b.z);
  }
};

// V cells a thread: n % V == 0 and the layers aligned to V floats.
template <int V>
__global__ void __launch_bounds__(kThreads)
    move_kernel(const float* __restrict__ ground, const float* __restrict__ conf, int n,
                const float* __restrict__ scalars, int stride, float half, float res,
                float* __restrict__ out_g, float* __restrict__ out_c) {
  using W = Words<V>;
  using T = typename W::T;
  __shared__ float sc[7];
  const float* s = scalars + (size_t)blockIdx.y * stride;
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  if (t < 7) sc[t] = s[t < 5 ? kCx + t : kK0 + (t - 5)];
  __syncthreads();
  const int i = blockIdx.x * blockDim.y + threadIdx.y;
  if (i >= n) return;
  const float cx = sc[0], cy = sc[1], b20 = sc[2], b21 = sc[3], b23 = sc[4];
  const int k0 = __float_as_int(sc[5]), k1 = __float_as_int(sc[6]);
  const int nw = n / V;  // words a row
  const size_t grid = (size_t)blockIdx.y * n * n;
  const bool row_exposed = exposed(i, k0, n);
  const bool cols_wiped = (k1 >= n) | (k1 <= -n);
  const T* g_row = reinterpret_cast<const T*>(ground + grid);
  const T* c_row = reinterpret_cast<const T*>(conf + grid);
  if (!row_exposed) {
    const size_t from = (size_t)source(i, k0, n) * nw;
    g_row += from;
    c_row += from;
  }
  T* og = reinterpret_cast<T*>(out_g + grid + (size_t)i * n);
  T* oc = reinterpret_cast<T*>(out_c + grid + (size_t)i * n);
  // the source column of cell j is (j + off) mod n; the word's cells begin
  // at offset r of their first source word
  const int off = cols_wiped ? 0 : source(0, k1, n);
  const int r = off % V;
  for (int q = threadIdx.x; q < nw; q += blockDim.x) {
    const int j0 = q * V;
    T g = T(), c = T();  // every cell set below: copied, or exposed and reset
    if (!row_exposed && !cols_wiped) {
      int c0 = j0 + off;
      if (c0 >= n) c0 -= n;
      const int qa = c0 / V;
      const int qb = qa + 1 < nw ? qa + 1 : 0;  // the row's second run starts at word 0
      const T ga = g_row[qa], ca = c_row[qa];
      if (r == 0) {
        g = ga;
        c = ca;
      } else {
        g = W::take(ga, g_row[qb], r);
        c = W::take(ca, c_row[qb], r);
      }
    }
#pragma unroll
    for (int m = 0; m < V; ++m) {
      const int j = j0 + m;
      if (row_exposed | exposed(j, k1, n)) {
        const float px = gg::add(cx, coord(i, half, res));
        const float py = gg::add(cy, coord(j, half, res));
        const float z_base = gg::add(gg::add(gg::mul(b20, px), gg::mul(b21, py)), b23);
        W::set(g, m, -z_base);
        W::set(c, m, 0.0f);
      }
    }
    og[q] = g;
    oc[q] = c;
  }
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
  const bool aligned = n % 4 == 0 && ((reinterpret_cast<size_t>(ground) |
                                        reinterpret_cast<size_t>(conf) |
                                        reinterpret_cast<size_t>(out_g) |
                                        reinterpret_cast<size_t>(out_c)) & 15) == 0;
  const int words = aligned ? n / 4 : n;  // a row's words of V cells
  const int warps = (words + 31) / 32;
  const int tx = warps * 32 < kThreads ? warps * 32 : kThreads;  // threads along a row
  const int ty = kThreads / tx;                                  // rows a block
  const dim3 threads(tx, ty), blocks((n + ty - 1) / ty, batch);
  if (aligned) {
    move_kernel<4><<<blocks, threads, 0, stream>>>(ground, conf, n, scalars, stride, half, res,
                                                   out_g, out_c);
  } else {
    move_kernel<1><<<blocks, threads, 0, stream>>>(ground, conf, n, scalars, stride, half, res,
                                                   out_g, out_c);
  }
  return (int)cudaGetLastError();
}
