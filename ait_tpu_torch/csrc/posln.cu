// Positional encoding + dropout + LayerNorm glue in front of the AIT encoder
// and decoder: out[i] = LayerNorm((x[i] + pos[i mod T]) * keep / keep_prob)
// over flat pair-major rows of width 512, eps 1e-6, f32 statistics.  The
// keep-mask is the Philox stream of csrc/philox.cuh (tag 4, a block per
// absolute row); with no seed (eval, or keep_prob 1) nothing is dropped.
//
// Replaces ait_tpu/ops/pallas_ffn.py:355 fused_posln (kernel
// `_posln_fwd_kernel`, :276, with its in-kernel dropout :288-294).
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
// :302, with its dropout :321-341); the FFN backward (ops/fused_ffn.py) runs
// it too, on y = x + y2 with the recomputed FFN output y2 as the addend:
//   y = x + a[i mod T];  xhat = (y - mu) * r;  dxhat = g * ln_s;
//   dy = r * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
//   dln_s = sum_i g * xhat,  dln_b = sum_i g.
// Its dropout modes regenerate the forward's mask m = keep / keep_prob:
//   kGlue (tag 4): y = (x + a) * m, and dx = dy * m;
//   kFfn (tag 3): y = x + a * m (the FFN's output dropout), and it writes
//     both dy (the residual's cotangent, into dx) and dy2 = dy * m (the
//     cotangent of the FFN's pre-dropout output, for its products).
// Bound by bytes, like the forward: each row of x, g and dx once.  One warp
// per row again, the four row means as warp shuffles; the LayerNorm
// parameter gradients, which the Pallas kernel accumulated across its
// sequential grid, are summed per block (a fixed run of rows, then the 8
// warps in order) into [blocks, 512] partials that the wrapper reduces in a
// second, fixed-order pass: deterministic, no atomics.

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kD = 512;
constexpr int kRowsPerBlock = 8;
enum DropMode { kNone = 0, kGlue = 1, kFfn = 2 };

// the dropout factors of a lane's 16 elements of row `row` (columns
// j * 256 + lane * 8 + e, two Philox groups per j)
__device__ __forceinline__ void row_scales(const ait::Dropout& d, int tag,
                                           int row, int lane, float m[16]) {
  const uint2 key = ait::seed_key(d.seed);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint4 w = ait::keep_group(key, tag, 0, row, (j * 256 + lane * 8) / 4 + q);
      const uint32_t b[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        m[j * 8 + q * 4 + e] = ait::drop_scale(b[e], d.thresh, d.inv_keep);
    }
}

template <typename T>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
posln_kernel(const T* __restrict__ x, const T* __restrict__ pos,
             const float* __restrict__ lns, const float* __restrict__ lnb,
             T* __restrict__ out, int n, int t, ait::Dropout drop) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= n) return;
  const T* xr = x + (size_t)row * kD;
  const T* pr = pos + (size_t)(row % t) * kD;
  float y[16];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int c = j * 256 + lane * 8;
    float a[8], p[8];
    ait::load8(xr + c, a);
    ait::load8(pr + c, p);
#pragma unroll
    for (int e = 0; e < 8; ++e) y[j * 8 + e] = a[e] + p[e];
  }
  if (drop.seed != nullptr) {
    float m[16];
    row_scales(drop, ait::kTagGlue, row, lane, m);
#pragma unroll
    for (int i = 0; i < 16; ++i) y[i] *= m[i];
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s += y[i];
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
           void* out, int n, int t, const ait::Dropout& drop,
           cudaStream_t stream) {
  const int blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  posln_kernel<T><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
      (const T*)x, (const T*)pos, (const float*)lns, (const float*)lnb,
      (T*)out, n, t, drop);
  return (int)cudaGetLastError();
}

template <typename TX, typename TA, typename TO>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
ln_bwd_kernel(const TX* __restrict__ x, const TA* __restrict__ add,
              int period, const float* __restrict__ lns,
              const TX* __restrict__ g, TO* __restrict__ dx,
              float* __restrict__ part_s, float* __restrict__ part_b, int n,
              int rows_per_block, int mode, ait::Dropout drop,
              float* __restrict__ dy2) {
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
    float y[16], gv[16], m[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = 1.f;
    if (mode != kNone)
      row_scales(drop, mode == kGlue ? ait::kTagGlue : ait::kTagFfn, row,
                 lane, m);
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
        const int i = j * 8 + e;
        y[i] = mode == kGlue ? (a[e] + p[e]) * m[i]
             : mode == kFfn ? a[e] + p[e] * m[i] : a[e] + p[e];
        gv[i] = q[e];
        s += y[i];
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
      float o[8], o2[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = j * 8 + e;
        o[e] = rs * (gv[i] - m1 - y[i] * m2);
        o2[e] = mode == kNone ? 0.f : o[e] * m[i];
      }
      ait::store8(dx + (size_t)row * kD + c, mode == kGlue ? o2 : o);
      if (mode == kFfn) ait::store8(dy2 + (size_t)row * kD + c, o2);
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
               int rows_per_block, int mode, const ait::Dropout& drop,
               void* dy2, cudaStream_t stream) {
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  ln_bwd_kernel<TX, TA, TO><<<blocks, 32 * kRowsPerBlock, 0, stream>>>(
      (const TX*)x, (const TA*)add, period, (const float*)lns, (const TX*)g,
      (TO*)dx, (float*)part_s, (float*)part_b, n, rows_per_block, mode, drop,
      (float*)dy2);
  return (int)cudaGetLastError();
}

}  // namespace

// dx (and per-block partials [ceil(n / rows_per_block), 512] of dln_s and
// dln_b) of LayerNorm(x + add[i mod period]); x and g share a type.  mode 0
// no dropout (seed may be null), 1 the glue's, 2 the FFN's (dy2 f32 [n, 512]
// written; else it may be null)
extern "C" int ln_bwd(int x_bf16, int add_bf16, int out_bf16, const void* x,
                      const void* add, int period, const void* lns,
                      const void* g, void* dx, void* part_s, void* part_b,
                      int n, int rows_per_block, int mode, const void* seed,
                      unsigned thresh, float inv_keep, void* dy2,
                      void* stream) {
  using bf = __nv_bfloat16;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode < kNone || mode > kFfn || (mode != kNone && seed == nullptr) ||
      (mode == kFfn && dy2 == nullptr))
    return (int)cudaErrorInvalidValue;
  const ait::Dropout d{(const int*)seed, thresh, inv_keep};
  const int key = x_bf16 * 4 + add_bf16 * 2 + out_bf16;
  switch (key) {
    case 0: return launch_bwd<float, float, float>(x, add, period, lns, g, dx, part_s, part_b, n, rows_per_block, mode, d, dy2, s);
    case 7: return launch_bwd<bf, bf, bf>(x, add, period, lns, g, dx, part_s, part_b, n, rows_per_block, mode, d, dy2, s);
    case 4: return launch_bwd<bf, float, float>(x, add, period, lns, g, dx, part_s, part_b, n, rows_per_block, mode, d, dy2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// seed null: no dropout
extern "C" int posln_fwd(int bf16, const void* x, const void* pos,
                         const void* lns, const void* lnb, void* out, int n,
                         int t, const void* seed, unsigned thresh,
                         float inv_keep, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const ait::Dropout d{(const int*)seed, thresh, inv_keep};
  return bf16 ? launch<__nv_bfloat16>(x, pos, lns, lnb, out, n, t, d, s)
              : launch<float>(x, pos, lns, lnb, out, n, t, d, s);
}
