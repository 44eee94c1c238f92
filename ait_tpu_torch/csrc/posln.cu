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
//
// `ln_bwd` is the backward of the same LayerNorm, and replaces
// ait_tpu/ops/pallas_ffn.py:387 _posln_vjp_bwd (kernel `_posln_bwd_kernel`,
// :302) at dropout 0; the FFN backward (ops/fused_ffn.py) runs it too, on
// y = x + y2 with the recomputed FFN output y2 as the addend:
//   y = x + a[i mod T];  xhat = (y - mu) * r;  dxhat = g * ln_s;
//   dx = r * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
//   dln_s = sum_i g * xhat,  dln_b = sum_i g.
// Bound by bytes, like the forward: each row of x, g and dx once.  One warp
// per row again, the four row means as warp shuffles; the LayerNorm
// parameter gradients, which the Pallas kernel accumulated across its
// sequential grid, are summed per block (a fixed run of rows, then the 8
// warps in order) into [blocks, 512] partials that the wrapper reduces in a
// second, fixed-order pass: deterministic, no atomics.

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

template <typename TX, typename TA, typename TO>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
ln_bwd_kernel(const TX* __restrict__ x, const TA* __restrict__ add,
              int period, const float* __restrict__ lns,
              const TX* __restrict__ g, TO* __restrict__ dx,
              float* __restrict__ part_s, float* __restrict__ part_b, int n,
              int rows_per_block) {
  __shared__ float red[2][kRowsPerBlock][kD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(n, row0 + rows_per_block);
  float ps[16], pb[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) ps[i] = pb[i] = 0.f;
  for (int row = row0 + warp; row < row1; row += kRowsPerBlock) {
    const TX* xr = x + (size_t)row * kD;
    const TA* ar = add + (size_t)(row % period) * kD;
    float y[16], gv[16];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = j * 256 + lane * 8;
      float a[8], p[8], q[8];
      ait::load8(xr + c, a);
      ait::load8(ar + c, p);
      ait::load8(g + (size_t)row * kD + c, q);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        y[j * 8 + e] = a[e] + p[e];
        gv[j * 8 + e] = q[e];
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
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = j * 8 + e, c = j * 256 + lane * 8 + e;
        y[i] = (y[i] - mu) * rs;                 // xhat
        ps[i] += gv[i] * y[i];
        pb[i] += gv[i];
        gv[i] *= lns[c];                         // dxhat
        m1 += gv[i];
        m2 += gv[i] * y[i];
      }
    m1 = ait::warp_sum(m1) / kD;
    m2 = ait::warp_sum(m2) / kD;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = j * 256 + lane * 8;
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = j * 8 + e;
        o[e] = rs * (gv[i] - m1 - y[i] * m2);
      }
      ait::store8(dx + (size_t)row * kD + c, o);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      red[0][warp][j * 256 + lane * 8 + e] = ps[j * 8 + e];
      red[1][warp][j * 256 + lane * 8 + e] = pb[j * 8 + e];
    }
  __syncthreads();
  for (int c = threadIdx.x; c < kD; c += 32 * kRowsPerBlock) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < kRowsPerBlock; ++w) {
      a += red[0][w][c];
      b += red[1][w][c];
    }
    part_s[(size_t)blockIdx.x * kD + c] = a;
    part_b[(size_t)blockIdx.x * kD + c] = b;
  }
}

template <typename TX, typename TA, typename TO>
int launch_bwd(const void* x, const void* add, int period, const void* lns,
               const void* g, void* dx, void* part_s, void* part_b, int n,
               int rows_per_block, cudaStream_t stream) {
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  ln_bwd_kernel<TX, TA, TO><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
      (const TX*)x, (const TA*)add, period, (const float*)lns, (const TX*)g,
      (TO*)dx, (float*)part_s, (float*)part_b, n, rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// dx (and per-block partials [ceil(n / rows_per_block), 512] of dln_s and
// dln_b) of LayerNorm(x + add[i mod period]); x and g share a type
extern "C" int ln_bwd(int x_bf16, int add_bf16, int out_bf16, const void* x,
                      const void* add, int period, const void* lns,
                      const void* g, void* dx, void* part_s, void* part_b,
                      int n, int rows_per_block, void* stream) {
  using bf = __nv_bfloat16;
  cudaStream_t s = (cudaStream_t)stream;
  const int key = x_bf16 * 4 + add_bf16 * 2 + out_bf16;
  switch (key) {
    case 0: return launch_bwd<float, float, float>(x, add, period, lns, g, dx, part_s, part_b, n, rows_per_block, s);
    case 7: return launch_bwd<bf, bf, bf>(x, add, period, lns, g, dx, part_s, part_b, n, rows_per_block, s);
    case 4: return launch_bwd<bf, float, float>(x, add, period, lns, g, dx, part_s, part_b, n, rows_per_block, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int posln_fwd(int bf16, const void* x, const void* pos,
                         const void* lns, const void* lnb, void* out, int n,
                         int t, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, pos, lns, lnb, out, n, t, s)
              : launch<float>(x, pos, lns, lnb, out, n, t, s);
}
