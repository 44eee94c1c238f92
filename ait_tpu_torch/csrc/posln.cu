// Positional encoding + LayerNorm glue in front of the AIT encoder and
// decoder: out[i] = LayerNorm(x[i] + pos[i mod T]) over flat pair-major rows
// of width 512, eps 1e-6, f32 statistics (dropout is off at eval).
//
// Replaces ait_tpu/ops/pallas_ffn.py:355 fused_posln (kernel
// `_posln_fwd_kernel`, :276).
//
// What bounds it on the H100: bytes.  Each row is read once and written once
// (2 KB in bf16) for about 5 operations per element, far below the card's
// ~295 operations per byte.  The design reads and writes every row exactly
// once with 16-byte vector accesses: one warp per row, 16 elements per lane
// held in registers, the two row reductions (mean, then variance about the
// mean, as the JAX code computes them) as warp shuffles.  The position table
// (T x 512) stays in L1/L2.

#include "common.cuh"

namespace {

constexpr int kD = 512;
constexpr int kRowsPerBlock = 8;

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
posln_kernel(const T* __restrict__ x, const T* __restrict__ pos,
             const float* __restrict__ lns, const float* __restrict__ lnb,
             T* __restrict__ out, int n, int t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= n) return;
  const T* xr = x + (size_t)row * kD;
  const T* pr = pos + (size_t)(row % t) * kD;
  float y[16];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = j * 256 + lane * 8;
    float a[8], p[8];
    ait::load8(xr + c, a);
    ait::load8(pr + c, p);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      y[j * 8 + e] = a[e] + p[e];
      s += y[j * 8 + e];
    }
  }
  const float mu = ait::warp_sum(s) / kD;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float d = y[i] - mu;
    q += d * d;
  }
  const float rs = rsqrtf(ait::warp_sum(q) / kD + 1e-6f);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = j * 256 + lane * 8;
    float o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = (y[j * 8 + e] - mu) * rs * lns[c + e] + lnb[c + e];
    ait::store8(out + (size_t)row * kD + c, o);
  }
}

template <typename T>
int launch(const void* x, const void* pos, const void* lns, const void* lnb,
           void* out, int n, int t, cudaStream_t stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  posln_kernel<T><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
      (const T*)x, (const T*)pos, (const float*)lns, (const float*)lnb,
      (T*)out, n, t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int posln_fwd(int bf16, const void* x, const void* pos,
                         const void* lns, const void* lnb, void* out, int n,
                         int t, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, pos, lns, lnb, out, n, t, s)
              : launch<float>(x, pos, lns, lnb, out, n, t, s);
}
