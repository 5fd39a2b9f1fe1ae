// K3, the variant for grids whose ring band does not fit a block's shared
// memory (n above 2415 cells a side; ops/spiral.py spiral_variant).
//
// Replaces, like csrc/spiral.cu, the TPU kernel
// groundgrid_tpu/ops/pallas_spiral.py:spiral_interpolation_pallas, the
// center-outward ring walk of GroundSegmentation.cpp:398-465. The center
// cell is seeded with the base height at confidence 1; rings run inner ->
// outer, each as 4 segments in walk order (top row ->, left column v, bottom
// row <-, right column ^; the corners (i, i) and (outer, outer) are visited
// twice). Within a segment a cell's 3x3 stencil reads an updated value only
// from its walk predecessor, so the heights obey the affine recurrence
// h[k] = a[k] + b[k] * h[k-1] with coefficients known before the segment
// starts; confidence is a per-cell decay outside min_dist_squared.
//
// Design: one thread block walks every ring in order, with both layers in
// global memory / L2. Per segment the block computes all coefficients in
// parallel (the formulas of ops/spiral.py _segment_update, op for op),
// solves the recurrence with a Hillis-Steele scan over per-thread affine
// maps, writes back and syncs. The three per-segment arrays (a, b and the
// decayed confidence, n floats each) live in shared memory where 3 n + 2 T
// floats fit a block (n up to 18,688), else in a global scratch buffer the
// wrapper allocates, so that any grid that fits in device memory runs.
//
// Bound on the card: the serial chain of 4 (n/2 - 2) segments, each a
// handful of dependent L2 round trips and ~20 block barriers; the SMs other
// than the one running the block idle. Built with --fmad=false so every
// product is rounded as in the plain PyTorch version: confidence is bitwise;
// heights differ from the plain scan's association by a few ulps.
#include <cuda_runtime.h>

namespace {

constexpr float kFltTiny = 1.17549435082228750797e-38f;  // C++ FLT_MIN

struct Consts {
  int n, cidx;
  float res2, dec, min_d2, floor_c;
};

__device__ __forceinline__ float decay(const Consts& K, int f, int y, float occ) {
  float a = (float)(f - K.cidx);
  float b = (float)(y - K.cidx);
  float d2 = (a * a + b * b) * K.res2;
  if (d2 > K.min_d2) {
    float v = occ - occ / K.dec;
    return v > K.floor_c ? v : K.floor_c;
  }
  return occ;
}

// One ring segment: line f (row, or column when tr), cells [lo, hi) along
// it, walked ascending or descending.
__device__ void segment(float* h, float* c, const Consts& K, int f, int lo, int hi,
                        bool tr, bool desc, float* sa, float* sb, float* sc,
                        float* ta, float* tb) {
  const int n = K.n;
  const int T = blockDim.x, t = threadIdx.x;
  const int L = hi - lo;
  const int E = (L + T - 1) / T;   // walk positions per thread
  const int nT = (L + E - 1) / E;  // threads holding positions
  const int k0 = t * E;
  const int k1 = min(L, k0 + E);
  const size_t s_r = tr ? 1 : (size_t)n;  // stride across the band lines f-1, f, f+1
  const size_t s_y = tr ? (size_t)n : 1;  // stride along the segment
  const long step = desc ? -1 : 1;

  // phase 1: coefficients, from values as they stand before the segment
  for (int k = k0; k < k1; ++k) {
    const int y = desc ? hi - 1 - k : lo + k;
    const size_t q = f * s_r + y * s_y;
    const size_t qp = q - step * s_y;  // walk predecessor
    const size_t qs = q + step * s_y;  // walk successor
    const float c0p = c[qp - s_r], c0y = c[q - s_r], c0s = c[qs - s_r];
    const float c2p = c[qp + s_r], c2y = c[q + s_r], c2s = c[qs + s_r];
    const float c1p = c[qp], c1y = c[q], c1s = c[qs];
    const float w0p = c0p * h[qp - s_r], w0y = c0y * h[q - s_r], w0s = c0s * h[qs - s_r];
    const float w2p = c2p * h[qp + s_r], w2y = c2y * h[q + s_r], w2s = c2s * h[qs + s_r];
    const float w1y = c1y * h[q], w1s = c1s * h[qs];
    float num = w0p + w0y;
    num = num + w0s;
    num = num + w2p;
    num = num + w2y;
    num = num + w2s;
    num = num + w1y;
    num = num + w1s;
    float den = c0p + c0y;
    den = den + c0s;
    den = den + c2p;
    den = den + c2y;
    den = den + c2s;
    den = den + c1y;
    den = den + c1s;
    const bool pin = k > 0;  // predecessor inside this segment
    const float occ = c1y;
    const float cpred = pin ? decay(K, f, y - (int)step, c1p) : c1p;
    den = den + cpred;
    den = den + kFltTiny;
    const float blend = 1.0f - occ;
    const float b = pin ? (blend * cpred) / den : 0.0f;
    const float ns = num + (pin ? 0.0f : cpred * h[qp]);
    const float a = (blend * ns) / den + occ * h[q];
    sa[k] = a;
    sb[k] = b;
    sc[k] = decay(K, f, y, occ);
  }
  __syncthreads();

  // phase 2: each thread composes its positions' maps h -> a + b*h, then an
  // inclusive Hillis-Steele scan over the threads
  float A = 0.0f, B = 1.0f;
  for (int k = k0; k < k1; ++k) {
    A = sa[k] + sb[k] * A;
    B = sb[k] * B;
  }
  ta[t] = A;
  tb[t] = B;
  __syncthreads();
  for (int d = 1; d < nT; d <<= 1) {
    const bool has = t >= d;
    float a1 = 0.0f, b1 = 1.0f;
    if (has) { a1 = ta[t - d]; b1 = tb[t - d]; }
    __syncthreads();
    if (has) {
      A = A + B * a1;
      B = B * b1;
      ta[t] = A;
      tb[t] = B;
    }
    __syncthreads();
  }

  // phase 3: write back (h[-1] := 0, so a prefix's A is the height)
  if (E == 1) {
    if (k0 < L) {
      const int y = desc ? hi - 1 - k0 : lo + k0;
      const size_t q = f * s_r + y * s_y;
      h[q] = A;
      c[q] = sc[k0];
    }
  } else {
    float hin = t == 0 ? 0.0f : ta[t - 1];
    for (int k = k0; k < k1; ++k) {
      const int y = desc ? hi - 1 - k : lo + k;
      const size_t q = f * s_r + y * s_y;
      hin = sa[k] + sb[k] * hin;
      h[q] = hin;
      c[q] = sc[k];
    }
  }
  __syncthreads();
}

// scratch: 3 n floats in global memory, or null to keep them in shared memory;
// up to 1024 threads, so at most 64 registers a thread
__global__ void __launch_bounds__(1024)
spiral_global_kernel(float* h, float* c, Consts K, float base_z, float* scratch) {
  extern __shared__ float smem[];
  const int n = K.n;
  float* ta = smem;
  float* tb = ta + blockDim.x;
  float* sa = scratch != nullptr ? scratch : tb + blockDim.x;
  float* sb = sa + n;
  float* sc = sb + n;
  const int m = K.cidx;
  if (threadIdx.x == 0) {
    h[(size_t)m * n + m] = base_z;
    c[(size_t)m * n + m] = 1.0f;
  }
  __syncthreads();
  for (int i = m - 1; i >= 1; --i) {
    const int outer = 2 * m - i;
    segment(h, c, K, i, i, outer, false, false, sa, sb, sc, ta, tb);          // top ->
    segment(h, c, K, i, i, outer, true, false, sa, sb, sc, ta, tb);           // left v
    segment(h, c, K, outer, i, outer + 1, false, true, sa, sb, sc, ta, tb);   // bottom <-
    segment(h, c, K, outer, i, outer + 1, true, true, sa, sb, sc, ta, tb);    // right ^
  }
}

}  // namespace

// h, c: (n, n) f32 row-major, updated in place. threads and smem_bytes come
// from ops/spiral.py global_layout: smem_bytes holds the scan's 2 threads
// floats, plus the 3 n per-segment floats when scratch is null.
extern "C" int gg_spiral_global(float* h, float* c, int n, int cidx, float base_z,
                                float res2, float dec, float min_d2, float floor_c,
                                int threads, int smem_bytes, float* scratch,
                                cudaStream_t stream) {
  const size_t want = (2 * (size_t)threads + (scratch != nullptr ? 0 : 3 * (size_t)n))
                      * sizeof(float);
  if (threads > 1024 || threads % 32 != 0 || threads < 32 || (size_t)smem_bytes != want) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        spiral_global_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const Consts K{n, cidx, res2, dec, min_d2, floor_c};
  spiral_global_kernel<<<1, threads, smem_bytes, stream>>>(h, c, K, base_z, scratch);
  return (int)cudaGetLastError();
}
