// Fused selective-head multi-head attention forward of the AIT head, one
// block per pair-sequence:
//   q/k/v = x @ w (8 heads, d_k = d_v = 64), softmax(q k^T / 8, masked -1e9),
//   o_h = P v, gate = softmax_h(Linear(mean_t sum_h o_h)), o = sum_h gate o_h,
//   out = LayerNorm(o @ fc + x_q), eps 1e-6, f32 statistics.
// Products accumulate in f32 and everything between them is f32; o is
// rounded to the storage type before fc, as in the Pallas kernel.  D = 512
// and Tq, Tk <= 64 (the flagship shapes).
//
// Replaces ait_tpu/ops/pallas_attention.py:746 fused_sh_attention (via
// `_fused_call` :323, kernel `_kernel` :195).
//
// Dropout (training; `AttnDrop`): the probabilities are multiplied by
// keep / keep_prob after the softmax and before P v (so the saved o_h is the
// post-dropout P v that the gate consumed), and fc's output before the
// residual (pallas_attention.py:265-277, :310-314).  The masks come from the
// Philox stream of csrc/philox.cuh, generated where they are applied (tag 1
// per head and pair, tag 2 per pair: fused_sh_attention_rngdrop, :891), or
// from operand masks [H, P*Tq, Tk] and [P*Tq, D] (fused_sh_attention_dropout,
// :817).  With neither (the eval launch, keep_prob 1) no factor is applied.
//
// What bounds it on the H100: operations.  A pair costs ~100 MFLOP, nearly
// all in the three 512 x 512 projections and fc, against 64-128 KB of
// activations.  On the TPU the 512 x 512 weights sat whole in VMEM; here they
// do not fit in a block's 227 KB of shared memory next to what must stay on
// chip.  So the block walks the heads: for each head it streams the
// [512, 64] column slices of wq, wk, wv (and the x rows, from L2) through
// shared memory in k-slabs, keeps q_h, k_h, v_h and the [Tq, Tk] scores in
// shared memory, and stores o_h into an 8 x [64, 64] f32 buffer (128 KB) that
// stays on chip for the gate.  The gate, fc (its [64, 512] weight staged in
// column chunks), residual and LayerNorm then run from shared memory, so no
// intermediate reaches device memory.
//
// In bf16 the projections and fc run on the tensor cores (WMMA 16x16x16,
// f32 accumulators; each warp owns a 16-row strip of the 64 x 64 head tile);
// in f32 they are CUDA-core FMAs with 4 x 4 register tiles.  The scores,
// softmax, P.V, gate and LayerNorm (~10% of the operations) are FMAs in both.
// Decoder self-attention has only one pair per image, so few blocks.

#include <mma.h>
#include <type_traits>

#include "attn_drop.cuh"
#include "common.cuh"
#include "philox.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 512;
constexpr int kHeads = 8;
constexpr int kDk = 64;
constexpr int kTm = 64;             // longest sequence
constexpr int kThreads = 256;       // 8 warps; 16 x 16 threads for FMA tiles
constexpr int kWld = kHeads * kDk;  // row stride of wq, wk, wv, sk_w
constexpr int kLdq = kDk + 4;       // rows of q and k (f32; WMMA stores need 4 | ld)
constexpr int kLds = kTm + 1;       // rows of the scores

// f32 slabs (FMA path): x [64][33], w [2][32][64]
constexpr int kFmaK = 32;
constexpr int kFmaXsLd = kFmaK + 1;
constexpr int kFmaSlab = kTm * kFmaXsLd + 2 * kFmaK * kDk;
// bf16 slabs (WMMA path): x [64][72], w [2][64][72]
constexpr int kMmaK = 64;
constexpr int kMmaLd = kMmaK + 8;
constexpr int kMmaSlab = 3 * kTm * kMmaLd / 2;   // in floats
constexpr int kSlab = kMmaSlab > kFmaSlab ? kMmaSlab : kFmaSlab;

// shared memory layout, in floats
constexpr int kOffQ = 0;                         // q_h [kTm][kLdq]; later o
constexpr int kOffK = kOffQ + kTm * kLdq;        // k_h [kTm][kLdq]
constexpr int kOffV = kOffK + kTm * kLdq;        // v_h [kTm][kDk]
constexpr int kOffSt = kOffV + kTm * kDk;        // slabs, or the scores
constexpr int kOffO = kOffSt + kSlab;            // o_h [kHeads][kTm][kDk]; later y
constexpr int kOffS = kOffO + kHeads * kTm * kDk;  // gate input [kDk]
constexpr int kOffG = kOffS + kDk;               // gate [kHeads][kDk]
constexpr int kSmemFloats = kOffG + kHeads * kDk;

// fc staging: f32 [64][128] x 4 (FMA) or bf16 [64][264] x 2 (WMMA), in k|v|slab
constexpr int kFmaFcCols = 128;
constexpr int kMmaFcCols = 256;
constexpr int kMmaFcLd = kMmaFcCols + 8;

static_assert(kTm * kD <= kHeads * kTm * kDk, "y must fit in the o_h buffer");
static_assert(kDk * kFmaFcCols <= kOffO - kOffK, "fc chunk must fit");
static_assert(kDk * kMmaFcLd / 2 <= kOffO - kOffK, "fc chunk must fit");
static_assert(kTm * kLds <= kSlab, "scores must fit in the slab area");
static_assert(kTm * kMmaLd / 2 <= kTm * kLdq, "bf16 o must fit in q's place");
static_assert(kOffSt % 8 == 0 && kOffK % 8 == 0 && kOffV % 8 == 0 &&
              kOffO % 8 == 0, "WMMA tiles need 32-byte alignment");

// A launch's dropout (the Philox stream of a seed, or operand masks) and its
// factors: csrc/attn_drop.cuh.
using ait::AttnDrop;
using ait::attn_factor;
using ait::out_factors;

// d0[r][c] = sum_k x[r][k] w0[k][col0 + c] (and d1 with w1) for r, c < 64;
// rows r >= rows read as zero.  CUDA-core FMAs, 4 x 4 outputs per thread.
template <typename T, int NW>
__device__ __forceinline__ void project_fma(const T* __restrict__ x, int rows,
                                            const T* __restrict__ w0,
                                            const T* __restrict__ w1, int col0,
                                            float* st, float* d0, int ld0,
                                            float* d1, int ld1) {
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  float* xs = st;
  float* ws = st + kTm * kFmaXsLd;
  float acc[NW][4][4];
#pragma unroll
  for (int n = 0; n < NW; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[n][i][j] = 0.f;

  for (int k0 = 0; k0 < kD; k0 += kFmaK) {
    {
      const int r = t >> 2, k8 = (t & 3) * 8;  // 64 rows x 4 vectors of 8
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r < rows) ait::load8(x + (size_t)r * kD + k0 + k8, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) xs[r * kFmaXsLd + k8 + e] = v[e];
    }
    {
      const int kk = t >> 3, c8 = (t & 7) * 8;  // 32 rows x 8 vectors of 8
      float v[8];
      ait::load8(w0 + (size_t)(k0 + kk) * kWld + col0 + c8, v);
      ait::store8(ws + kk * kDk + c8, v);
      if (NW == 2) {
        ait::load8(w1 + (size_t)(k0 + kk) * kWld + col0 + c8, v);
        ait::store8(ws + kFmaK * kDk + kk * kDk + c8, v);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kFmaK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[(ty + 16 * i) * kFmaXsLd + kk];
#pragma unroll
      for (int n = 0; n < NW; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = ws[n * kFmaK * kDk + kk * kDk + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[n][i][j] += a[i] * b;
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      d0[(ty + 16 * i) * ld0 + tx + 16 * j] = acc[0][i][j];
      if (NW == 2) d1[(ty + 16 * i) * ld1 + tx + 16 * j] = acc[NW - 1][i][j];
    }
}

// The same product on the tensor cores: warp w owns rows 16*(w%4)..+16 and
// columns 32*(w/4)..+32 of each 64 x 64 output (two 16 x 16 tiles).
template <int NW>
__device__ __forceinline__ void project_mma(const bf16* __restrict__ x,
                                            int rows,
                                            const bf16* __restrict__ w0,
                                            const bf16* __restrict__ w1,
                                            int col0, float* st, float* d0,
                                            int ld0, float* d1, int ld1) {
  using namespace nvcuda;
  bf16* xs = reinterpret_cast<bf16*>(st);   // [64][kMmaLd]
  bf16* ws = xs + kTm * kMmaLd;             // [NW][64][kMmaLd]
  const int t = threadIdx.x, warp = t >> 5;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NW][2];
#pragma unroll
  for (int n = 0; n < NW; ++n) {
    wmma::fill_fragment(acc[n][0], 0.f);
    wmma::fill_fragment(acc[n][1], 0.f);
  }
  for (int k0 = 0; k0 < kD; k0 += kMmaK) {
#pragma unroll
    for (int v = t; v < kTm * kMmaK / 8; v += kThreads) {
      const int r = v >> 3, c8 = (v & 7) * 8;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(xs + r * kMmaLd + c8) =
          r < rows ? *reinterpret_cast<const uint4*>(x + (size_t)r * kD + k0 + c8)
                   : zero;
      *reinterpret_cast<uint4*>(ws + r * kMmaLd + c8) =
          *reinterpret_cast<const uint4*>(w0 + (size_t)(k0 + r) * kWld + col0 + c8);
      if (NW == 2)
        *reinterpret_cast<uint4*>(ws + kTm * kMmaLd + r * kMmaLd + c8) =
            *reinterpret_cast<const uint4*>(w1 + (size_t)(k0 + r) * kWld + col0 + c8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMmaK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, xs + r0 * kMmaLd + kk, kMmaLd);
#pragma unroll
      for (int n = 0; n < NW; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, ws + n * kTm * kMmaLd + kk * kMmaLd + c0 + 16 * j,
                                 kMmaLd);
          wmma::mma_sync(acc[n][j], a, b, acc[n][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::store_matrix_sync(d0 + r0 * ld0 + c0 + 16 * j, acc[0][j], ld0,
                            wmma::mem_row_major);
    if (NW == 2)
      wmma::store_matrix_sync(d1 + r0 * ld1 + c0 + 16 * j, acc[NW - 1][j], ld1,
                              wmma::mem_row_major);
  }
}

template <typename T, int NW>
__device__ __forceinline__ void project(const T* x, int rows, const T* w0,
                                        const T* w1, int col0, float* st,
                                        float* d0, int ld0, float* d1,
                                        int ld1) {
  if constexpr (std::is_same<T, bf16>::value)
    project_mma<NW>(x, rows, w0, w1, col0, st, d0, ld0, d1, ld1);
  else
    project_fma<T, NW>(x, rows, w0, w1, col0, st, d0, ld0, d1, ld1);
}

// y[64][512] = o @ fc, f32, into the o_h buffer.  o sits in q's place: f32
// [64][kLdq] (already rounded to T) for FMA, bf16 [64][kMmaLd] for WMMA.
__device__ __forceinline__ void out_proj(const float* __restrict__ fcw,
                                         float* qs, float* stage, float* y) {
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  for (int n0 = 0; n0 < kD; n0 += kFmaFcCols) {
    for (int v = t; v < kDk * kFmaFcCols / 8; v += kThreads) {
      const int d = v / (kFmaFcCols / 8), c = (v % (kFmaFcCols / 8)) * 8;
      float a[8];
      ait::load8(fcw + (size_t)d * kD + n0 + c, a);
      ait::store8(stage + d * kFmaFcCols + c, a);
    }
    __syncthreads();
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kDk; ++d) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * kLdq + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float b = stage[d * kFmaFcCols + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += a[i] * b;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) y[(ty + 16 * i) * kD + n0 + tx + 16 * j] = acc[i][j];
    __syncthreads();
  }
}

__device__ __forceinline__ void out_proj(const bf16* __restrict__ fcw,
                                         float* qs, float* stage, float* y) {
  using namespace nvcuda;
  const bf16* ob = reinterpret_cast<const bf16*>(qs);
  bf16* fs = reinterpret_cast<bf16*>(stage);   // [64][kMmaFcLd]
  const int t = threadIdx.x, warp = t >> 5;
  const int r0 = (warp & 3) * 16, cb = (warp >> 2) * 128;
  for (int n0 = 0; n0 < kD; n0 += kMmaFcCols) {
    for (int v = t; v < kDk * kMmaFcCols / 8; v += kThreads) {
      const int d = v / (kMmaFcCols / 8), c = (v % (kMmaFcCols / 8)) * 8;
      *reinterpret_cast<uint4*>(fs + d * kMmaFcLd + c) =
          *reinterpret_cast<const uint4*>(fcw + (size_t)d * kD + n0 + c);
    }
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < kDk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, ob + r0 * kMmaLd + kk, kMmaLd);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, fs + kk * kMmaFcLd + cb + 16 * j, kMmaFcLd);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      wmma::store_matrix_sync(y + r0 * kD + n0 + cb + 16 * j, acc[j], kD,
                              wmma::mem_row_major);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
sh_attn_kernel(const T* __restrict__ xq, const T* __restrict__ xkv,
               const T* __restrict__ wq, const T* __restrict__ wk,
               const T* __restrict__ wv, const T* __restrict__ skw,
               const T* __restrict__ skb, const T* __restrict__ fcw,
               const float* __restrict__ lns, const float* __restrict__ lnb,
               const uint8_t* __restrict__ mask, T* __restrict__ out,
               float* __restrict__ oh, float* __restrict__ qsv,
               float* __restrict__ ksv, float* __restrict__ vsv, int tq,
               int tk, AttnDrop drop) {
  extern __shared__ __align__(128) float sm[];
  float* qs = sm + kOffQ;
  float* ks = sm + kOffK;
  float* vs = sm + kOffV;
  float* st = sm + kOffSt;
  float* oall = sm + kOffO;
  float* sv = sm + kOffS;
  float* gt = sm + kOffG;

  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int warp = t >> 5, lane = t & 31;
  const int pair = blockIdx.x, pairs = gridDim.x;
  const uint2 key = drop.seed != nullptr ? ait::seed_key(drop.seed)
                                         : make_uint2(0u, 0u);
  xq += (size_t)blockIdx.x * tq * kD;
  xkv += (size_t)blockIdx.x * tk * kD;
  out += (size_t)blockIdx.x * tq * kD;

  for (int h = 0; h < kHeads; ++h) {
    project<T, 1>(xq, tq, wq, nullptr, h * kDk, st, qs, kLdq, nullptr, 0);
    project<T, 2>(xkv, tk, wk, wv, h * kDk, st, ks, kLdq, vs, kDk);
    __syncthreads();
    if (qsv != nullptr) {
      // the save-qkv policy: this head's q / 8, k and v [H, P*T, 64], the
      // values the backward would otherwise recompute
      for (int e = t; e < kTm * kDk; e += kThreads) {
        const int r = e / kDk, c = e % kDk;
        if (r < tq)
          qsv[((size_t)h * pairs * tq + (size_t)pair * tq + r) * kDk + c] =
              qs[r * kLdq + c] * 0.125f;
        if (r < tk) {
          const size_t i = ((size_t)h * pairs * tk + (size_t)pair * tk + r) * kDk + c;
          ksv[i] = ks[r * kLdq + c];
          vsv[i] = vs[r * kDk + c];
        }
      }
    }

    // masked scores (q k^T / 8) into the slab area
    float* sc = st;
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < kDk; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * kLdq + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * kLdq + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          if (r < tq && c < tk)
            sc[r * kLds + c] = mask[r * tk + c] ? acc[i][j] * 0.125f : -1e9f;
        }
    }
    __syncthreads();

    // row softmax, one warp per row, then the probability dropout
    for (int r = warp; r < tq; r += kThreads / 32) {
      const float v0 = lane < tk ? sc[r * kLds + lane] : -CUDART_INF_F;
      const float v1 = lane + 32 < tk ? sc[r * kLds + lane + 32] : -CUDART_INF_F;
      const float m = ait::warp_max(fmaxf(v0, v1));
      const float e0 = lane < tk ? expf(v0 - m) : 0.f;
      const float e1 = lane + 32 < tk ? expf(v1 - m) : 0.f;
      const float sum = ait::warp_sum(e0 + e1);
      float p0 = e0 / sum, p1 = e1 / sum;
      if (drop.on()) {
        if (lane < tk) p0 *= attn_factor(drop, key, h, pair, pairs, tq, tk, r, lane);
        if (lane + 32 < tk)
          p1 *= attn_factor(drop, key, h, pair, pairs, tq, tk, r, lane + 32);
      }
      if (lane < tk) sc[r * kLds + lane] = p0;
      if (lane + 32 < tk) sc[r * kLds + lane + 32] = p1;
    }
    __syncthreads();

    // o_h = P v_h
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int c = 0; c < tk; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sc[(ty + 16 * i) * kLds + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = vs[c * kDk + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i;
          oall[(h * kTm + r) * kDk + tx + 16 * j] = r < tq ? acc[i][j] : 0.f;
          // the train path's saved per-head output [H, P*Tq, 64]: exactly
          // the value the gate below consumes
          if (oh != nullptr && r < tq)
            oh[((size_t)h * gridDim.x * tq + (size_t)blockIdx.x * tq + r) * kDk +
               tx + 16 * j] = acc[i][j];
        }
    }
    __syncthreads();
  }

  // gate input: mean over tokens of the head sum
  if (t < kDk) {
    float acc = 0.f;
    for (int r = 0; r < tq; ++r) {
      float u = 0.f;
#pragma unroll
      for (int h = 0; h < kHeads; ++h) u += oall[(h * kTm + r) * kDk + t];
      acc += u;
    }
    sv[t] = acc / tq;
  }
  __syncthreads();
  for (int o = t; o < kHeads * kDk; o += kThreads) {
    float acc = 0.f;
    for (int d = 0; d < kDk; ++d) acc += sv[d] * ait::to_float(skw[d * kWld + o]);
    gt[o] = acc + ait::to_float(skb[o]);
  }
  __syncthreads();
  if (t < kDk) {  // softmax over heads, per channel
    float m = -CUDART_INF_F;
#pragma unroll
    for (int h = 0; h < kHeads; ++h) m = fmaxf(m, gt[h * kDk + t]);
    float e[kHeads], sum = 0.f;
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      e[h] = expf(gt[h * kDk + t] - m);
      sum += e[h];
    }
#pragma unroll
    for (int h = 0; h < kHeads; ++h) gt[h * kDk + t] = e[h] / sum;
  }
  __syncthreads();

  // gated head sum, rounded to the storage type (the fc input), in q's place
  for (int e = t; e < kTm * kDk; e += kThreads) {
    const int r = e / kDk, c = e % kDk;
    float acc = 0.f;
#pragma unroll
    for (int h = 0; h < kHeads; ++h) acc += oall[(h * kTm + r) * kDk + c] * gt[h * kDk + c];
    if constexpr (std::is_same<T, bf16>::value)
      reinterpret_cast<bf16*>(qs)[r * kMmaLd + c] = __float2bfloat16_rn(acc);
    else
      qs[r * kLdq + c] = acc;
  }
  __syncthreads();

  float* y = oall;
  out_proj(fcw, qs, ks, y);

  // output dropout, + residual, LayerNorm; one warp per row
  for (int r = warp; r < tq; r += kThreads / 32) {
    float v[16];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = j * 256 + lane * 8;
      float a[8], m[8];
      ait::load8(xq + (size_t)r * kD + c, a);
      out_factors(drop, key, pair, tq, r, c, m);
      const float4 y0 = *reinterpret_cast<const float4*>(y + r * kD + c);
      const float4 y1 = *reinterpret_cast<const float4*>(y + r * kD + c + 4);
      const float yy[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[j * 8 + e] = yy[e] * m[e] + a[e];
        s += v[j * 8 + e];
      }
    }
    const float mu = ait::warp_sum(s) / kD;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float d = v[i] - mu;
      q += d * d;
    }
    const float rs = rsqrtf(ait::warp_sum(q) / kD + 1e-6f);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = j * 256 + lane * 8;
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = (v[j * 8 + e] - mu) * rs * lns[c + e] + lnb[c + e];
      ait::store8(out + (size_t)r * kD + c, o);
    }
  }
}

template <typename T>
int launch(const void* const* p, void* out, void* oh, void* const* qkv,
           int pairs, int tq, int tk, const AttnDrop& drop,
           cudaStream_t stream) {
  const int smem = kSmemFloats * (int)sizeof(float);
  cudaFuncSetAttribute(sh_attn_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  sh_attn_kernel<T><<<pairs, kThreads, smem, stream>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (const T*)p[6], (const T*)p[7],
      (const float*)p[8], (const float*)p[9], (const uint8_t*)p[10], (T*)out,
      (float*)oh, (float*)qkv[0], (float*)qkv[1], (float*)qkv[2], tq, tk,
      drop);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward
//
// Replaces the per-pair body of ait_tpu/ops/pallas_attention.py:630
// _fused_bwd_call (kernel `_bwd_kernel`, :412), with or without dropout
// (`_bwd_rng` :937 and `_bwd_drop` :866 reach it with masks), and with the
// forward's saved q/k/v in place of the recompute of step 4 under the
// save-qkv policy (`qkv=`, :559-566).  One block per pair, from the
// forward's saved per-head outputs oh:
//   1. rebuild the gate exactly as the forward computed it (same loops), and
//      o = sum_h gate_h o_h rounded to the storage type (the fc input);
//   2. in 16-row tiles: y0 = o @ fc, the LayerNorm of y0 + x_q and its
//      backward (dy), and do = dy @ fc^T; fc sits in shared memory as f32;
//   3. the gate backward: dgate_h = sum_t do * o_h, the softmax-over-heads
//      backward (dlogit), ds = dlogit @ sk_w^T and du = ds / Tq;
//   4. per head: q/k/v recomputed (as in the forward: WMMA for bf16), the
//      probabilities, dP = do_h v^T with do_h = do * gate_h + du, dv = P^T
//      do_h, dS = P (dP - rowsum(P dP)), dz = dS k / 8, dk = dS^T q / 8.
// Everything between products is f32, as in the Pallas kernel.  With
// dropout (the forward's `AttnDrop`, masks regenerated from the seed or read
// from the operands) the LayerNorm input is y0 * ok / kp + x_q, the fc
// backward takes dy0 = dy * ok / kp while the residual takes dy, and per head
// dv = (P * ak / kp)^T do_h and dP = (do_h v^T) * ak / kp before the softmax
// backward (pallas_attention.py:509-599); the head's factors ak / kp sit in
// shared memory for the two uses.  It writes
// dy, o, s (the gate input), dlogit, the LayerNorm partials and the per-head
// dz/dk/dv [rows, 8 x 64] to device memory (and dy0, with dropout): the input gradients (dxq
// [64, 512] and dxkv, f32) and the weight gradients, which reduce over all
// pairs, do not fit beside this block's state in shared memory, so the
// products over the pair batch run afterwards on csrc/gemm.cu.
//
// What bounds it on the H100: operations (the three per-head projections,
// ~50 MFLOP per pair, as in the forward); the writes of dz/dk/dv (~400 KB per
// pair in f32) come next.

constexpr int kBLdp = kTm + 1;                     // probabilities, dP, dS
constexpr int kBOffGm = 0;                         // gate [8][64]
constexpr int kBOffDg = kBOffGm + kHeads * kDk;    // dgate, then dlogit
constexpr int kBOffSv = kBOffDg + kHeads * kDk;    // s [64]
constexpr int kBOffDu = kBOffSv + kDk;             // du [64]
constexpr int kBOffDo = kBOffDu + kDk;             // do [64][64]
constexpr int kBOffOs = kBOffDo + kTm * kDk;       // o, rounded [64][64]
constexpr int kBOffPh = kBOffOs + kTm * kDk;       // phase-local area
// phase 2
constexpr int kBOffFc = kBOffPh;                   // fc as f32 [64][512]
constexpr int kBOffYt = kBOffFc + kDk * kD;        // y0, then dy [16][512]
constexpr int kBEnd2 = kBOffYt + 16 * kD;
// phase 4
constexpr int kBOffQ = kBOffPh;                    // q_h / 8 [64][kLdq]
constexpr int kBOffK = kBOffQ + kTm * kLdq;        // k_h
constexpr int kBOffV = kBOffK + kTm * kLdq;        // v_h
constexpr int kBOffSt = kBOffV + kTm * kLdq;       // projection slabs
constexpr int kBOffDoh = kBOffSt + kSlab;          // do_h [64][kLdq]
constexpr int kBOffP = kBOffDoh + kTm * kLdq;      // P [64][kBLdp]
constexpr int kBOffDp = kBOffP + kTm * kBLdp;      // dP, then dS
constexpr int kBOffMk = kBOffDp + kTm * kBLdp;     // dropout factors
constexpr int kBEnd4 = kBOffMk + kTm * kBLdp;
constexpr int kBSmemFloats = kBEnd2 > kBEnd4 ? kBEnd2 : kBEnd4;
static_assert(kBOffPh % 8 == 0 && kBOffK % 8 == 0 && kBOffV % 8 == 0 &&
              kBOffSt % 8 == 0, "WMMA tiles need 32-byte alignment");
static_assert(2 * (kThreads / 32) * kD <= kDk * kD, "LN partials fit in fc's place");
static_assert(kBSmemFloats * 4 <= 232448, "shared memory of one block");

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
sh_attn_bwd_kernel(const T* __restrict__ xq, const T* __restrict__ xkv,
                   const T* __restrict__ wq, const T* __restrict__ wk,
                   const T* __restrict__ wv, const T* __restrict__ skw,
                   const T* __restrict__ skb, const T* __restrict__ fcw,
                   const float* __restrict__ lns,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ oh, const T* __restrict__ g,
                   const float* __restrict__ qsv,
                   const float* __restrict__ ksv,
                   const float* __restrict__ vsv,
                   float* __restrict__ dy_out, float* __restrict__ o_out,
                   float* __restrict__ s_out, float* __restrict__ dgl_out,
                   float* __restrict__ lnp_s, float* __restrict__ lnp_b,
                   float* __restrict__ dz_out, float* __restrict__ dk_out,
                   float* __restrict__ dv_out, int tq, int tk, AttnDrop drop,
                   float* __restrict__ dy0_out) {
  extern __shared__ __align__(128) float sm[];
  float* gm = sm + kBOffGm;
  float* dg = sm + kBOffDg;
  float* sv = sm + kBOffSv;
  float* du = sm + kBOffDu;
  float* dos = sm + kBOffDo;
  float* os = sm + kBOffOs;

  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int warp = t >> 5, lane = t & 31;
  const int pair = blockIdx.x, pairs = gridDim.x;
  const uint2 key = drop.seed != nullptr ? ait::seed_key(drop.seed)
                                         : make_uint2(0u, 0u);
  const size_t qrow0 = (size_t)pair * tq;          // first flat row of x_q
  const size_t krow0 = (size_t)pair * tk;
  auto ohp = [&](int h, int r, int c) {
    return oh[((size_t)h * pairs * tq + qrow0 + r) * kDk + c];
  };
  xq += qrow0 * kD;
  xkv += krow0 * kD;
  g += qrow0 * kD;

  // ---- 1. the gate, as the forward built it
  if (t < kDk) {
    float acc = 0.f;
    for (int r = 0; r < tq; ++r) {
      float u = 0.f;
#pragma unroll
      for (int h = 0; h < kHeads; ++h) u += ohp(h, r, t);
      acc += u;
    }
    sv[t] = acc / tq;
    s_out[(size_t)pair * kDk + t] = sv[t];
  }
  __syncthreads();
  for (int o = t; o < kHeads * kDk; o += kThreads) {
    float acc = 0.f;
    for (int d = 0; d < kDk; ++d) acc += sv[d] * ait::to_float(skw[d * kWld + o]);
    gm[o] = acc + ait::to_float(skb[o]);
  }
  __syncthreads();
  if (t < kDk) {
    float m = -CUDART_INF_F;
#pragma unroll
    for (int h = 0; h < kHeads; ++h) m = fmaxf(m, gm[h * kDk + t]);
    float e[kHeads], sum = 0.f;
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      e[h] = expf(gm[h * kDk + t] - m);
      sum += e[h];
    }
#pragma unroll
    for (int h = 0; h < kHeads; ++h) gm[h * kDk + t] = e[h] / sum;
  }
  __syncthreads();
  for (int e = t; e < kTm * kDk; e += kThreads) {
    const int r = e / kDk, c = e % kDk;
    float v = 0.f;
    if (r < tq) {
      float acc = 0.f;
#pragma unroll
      for (int h = 0; h < kHeads; ++h) acc += ohp(h, r, c) * gm[h * kDk + c];
      v = ait::round_to(acc, xq);
      o_out[(qrow0 + r) * kDk + c] = v;
    }
    os[e] = v;
  }

  // ---- 2. fc, LayerNorm and their backward, 16 rows at a time
  float* fcs = sm + kBOffFc;
  float* yt = sm + kBOffYt;
  for (int v = t; v < kDk * kD / 8; v += kThreads) {
    float a[8];
    ait::load8(fcw + (size_t)v * 8, a);
    ait::store8(fcs + v * 8, a);
  }
  __syncthreads();
  float ps[16], pb[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) ps[i] = pb[i] = 0.f;
  for (int r0 = 0; r0 < tq; r0 += 16) {
    {  // y0 = o @ fc: thread (row t / 16, columns t % 16 + 16 j)
      const int i = t >> 4;
      float acc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = 0.f;
      for (int d = 0; d < kDk; ++d) {
        const float a = os[(r0 + i) * kDk + d];
#pragma unroll
        for (int j = 0; j < 32; ++j) acc[j] += a * fcs[d * kD + tx + 16 * j];
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) yt[i * kD + tx + 16 * j] = acc[j];
    }
    __syncthreads();
    for (int i = warp; i < 16; i += kThreads / 32) {   // one warp per row
      const int r = r0 + i;
      if (r >= tq) continue;
      float y[16], gv[16], m[16];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = j * 256 + lane * 8;
        float a[8], q[8];
        ait::load8(xq + (size_t)r * kD + c, a);
        ait::load8(g + (size_t)r * kD + c, q);
        out_factors(drop, key, pair, tq, r, c, m + j * 8);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          y[j * 8 + e] = yt[i * kD + c + e] * m[j * 8 + e] + a[e];
          gv[j * 8 + e] = q[e];
          s += y[j * 8 + e];
        }
      }
      const float mu = ait::warp_sum(s) / kD;
      float q = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float d = y[e] - mu;
        q += d * d;
      }
      const float rs = rsqrtf(ait::warp_sum(q) / kD + 1e-6f);
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int k = j * 8 + e, c = j * 256 + lane * 8 + e;
          y[k] = (y[k] - mu) * rs;
          ps[k] += gv[k] * y[k];
          pb[k] += gv[k];
          gv[k] *= lns[c];
          m1 += gv[k];
          m2 += gv[k] * y[k];
        }
      m1 = ait::warp_sum(m1) / kD;
      m2 = ait::warp_sum(m2) / kD;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = j * 256 + lane * 8;
        float o[8], o0[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          o[e] = rs * (gv[j * 8 + e] - m1 - y[j * 8 + e] * m2);
          o0[e] = o[e] * m[j * 8 + e];       // fc's cotangent: dy * ok / kp
          yt[i * kD + c + e] = o0[e];
        }
        ait::store8(dy_out + (qrow0 + r) * kD + c, o);
        if (drop.on()) ait::store8(dy0_out + (qrow0 + r) * kD + c, o0);
      }
    }
    __syncthreads();
    // do = dy0 @ fc^T: warp w takes 128 of the 16 x 64 outputs, lanes split n
    for (int k = 0; k < 128; ++k) {
      const int idx = warp * 128 + k, i = idx / kDk, c = idx % kDk;
      if (r0 + i >= tq) continue;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < kD / 32; ++n)
        acc += yt[i * kD + lane + 32 * n] * fcs[c * kD + lane + 32 * n];
      acc = ait::warp_sum(acc);
      if (lane == 0) dos[(r0 + i) * kDk + c] = acc;
    }
    __syncthreads();
  }
  for (int e = tq * kDk + t; e < kTm * kDk; e += kThreads) dos[e] = 0.f;
  {  // LayerNorm partials: the 8 warps in order
    float* red = fcs;   // [2][8][512]
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        red[warp * kD + j * 256 + lane * 8 + e] = ps[j * 8 + e];
        red[(8 + warp) * kD + j * 256 + lane * 8 + e] = pb[j * 8 + e];
      }
    __syncthreads();
    for (int c = t; c < kD; c += kThreads) {
      float a = 0.f, b = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) {
        a += red[w * kD + c];
        b += red[(8 + w) * kD + c];
      }
      lnp_s[(size_t)pair * kD + c] = a;
      lnp_b[(size_t)pair * kD + c] = b;
    }
  }
  __syncthreads();

  // ---- 3. the gate backward
  for (int o = t; o < kHeads * kDk; o += kThreads) {
    const int h = o / kDk, c = o % kDk;
    float acc = 0.f;
    for (int r = 0; r < tq; ++r) acc += dos[r * kDk + c] * ohp(h, r, c);
    dg[o] = acc;
  }
  __syncthreads();
  if (t < kDk) {
    float gdot = 0.f;
#pragma unroll
    for (int h = 0; h < kHeads; ++h) gdot += gm[h * kDk + t] * dg[h * kDk + t];
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      const float v = gm[h * kDk + t] * (dg[h * kDk + t] - gdot);
      dg[h * kDk + t] = v;
      dgl_out[(size_t)pair * kHeads * kDk + h * kDk + t] = v;
    }
  }
  __syncthreads();
  if (t < kDk) {
    float acc = 0.f;
    for (int o = 0; o < kHeads * kDk; ++o)
      acc += dg[o] * ait::to_float(skw[t * kWld + o]);
    du[t] = acc / tq;
  }
  __syncthreads();

  // ---- 4. per head
  float* qs = sm + kBOffQ;
  float* ks = sm + kBOffK;
  float* vs = sm + kBOffV;
  float* st = sm + kBOffSt;
  float* doh = sm + kBOffDoh;
  float* pp = sm + kBOffP;
  float* dp = sm + kBOffDp;
  float* mk = sm + kBOffMk;
  for (int h = 0; h < kHeads; ++h) {
    if (qsv != nullptr) {
      // the save-qkv policy: the forward's q / 8, k and v instead of the
      // recompute (the same f32 values, so the same gradients bit for bit)
      for (int e = t; e < kTm * kDk; e += kThreads) {
        const int r = e / kDk, c = e % kDk;
        const size_t iq = ((size_t)h * pairs * tq + qrow0 + r) * kDk + c;
        const size_t ik = ((size_t)h * pairs * tk + krow0 + r) * kDk + c;
        qs[r * kLdq + c] = r < tq ? qsv[iq] : 0.f;
        ks[r * kLdq + c] = r < tk ? ksv[ik] : 0.f;
        vs[r * kLdq + c] = r < tk ? vsv[ik] : 0.f;
      }
    } else {
      project<T, 1>(xq, tq, wq, nullptr, h * kDk, st, qs, kLdq, nullptr, 0);
      project<T, 2>(xkv, tk, wk, wv, h * kDk, st, ks, kLdq, vs, kLdq);
    }
    __syncthreads();
    for (int e = t; e < kTm * kDk; e += kThreads) {
      const int r = e / kDk, c = e % kDk;
      // exact: the Pallas kernel's q * scale
      if (qsv == nullptr) qs[r * kLdq + c] *= 0.125f;
      doh[r * kLdq + c] = r < tq ? dos[e] * gm[h * kDk + c] + du[c] : 0.f;
    }
    __syncthreads();
    {  // masked scores; zero outside [tq, tk]
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < kDk; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * kLdq + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * kLdq + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          float v = 0.f;
          if (r < tq && c < tk) v = mask[r * tk + c] ? acc[i][j] : -1e9f;
          pp[r * kBLdp + c] = v;
        }
    }
    __syncthreads();
    for (int r = warp; r < tq; r += kThreads / 32) {
      const float v0 = lane < tk ? pp[r * kBLdp + lane] : -CUDART_INF_F;
      const float v1 = lane + 32 < tk ? pp[r * kBLdp + lane + 32] : -CUDART_INF_F;
      const float m = ait::warp_max(fmaxf(v0, v1));
      const float e0 = lane < tk ? expf(v0 - m) : 0.f;
      const float e1 = lane + 32 < tk ? expf(v1 - m) : 0.f;
      const float sum = ait::warp_sum(e0 + e1);
      if (lane < tk) pp[r * kBLdp + lane] = e0 / sum;
      if (lane + 32 < tk) pp[r * kBLdp + lane + 32] = e1 / sum;
    }
    if (drop.on()) {   // this head's factors ak / kp, 0 outside [tq, tk]
      for (int e = t; e < kTm * kTm; e += kThreads) {
        const int r = e / kTm, c = e % kTm;
        mk[r * kBLdp + c] = r < tq && c < tk
            ? attn_factor(drop, key, h, pair, pairs, tq, tk, r, c) : 0.f;
      }
    }
    __syncthreads();
    {  // dP = (do_h v^T) ak / kp and dv = (P ak / kp)^T do_h
      float a1[4][4], a2[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) a1[i][j] = a2[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < kDk; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = doh[(ty + 16 * i) * kLdq + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = vs[(tx + 16 * j) * kLdq + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) a1[i][j] += a[i] * b[j];
      }
      for (int r = 0; r < tq; ++r) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = pp[r * kBLdp + ty + 16 * i];
          if (drop.on()) a[i] *= mk[r * kBLdp + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = doh[r * kLdq + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) a2[i][j] += a[i] * b[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          dp[r * kBLdp + c] = drop.on() ? a1[i][j] * mk[r * kBLdp + c] : a1[i][j];
          if (r < tk)
            dv_out[(krow0 + r) * kD + h * kDk + c] = a2[i][j];
        }
    }
    __syncthreads();
    for (int r = warp; r < tq; r += kThreads / 32) {   // dS = P (dP - rowdot)
      const float p0 = lane < tk ? pp[r * kBLdp + lane] : 0.f;
      const float p1 = lane + 32 < tk ? pp[r * kBLdp + lane + 32] : 0.f;
      const float d0 = lane < tk ? dp[r * kBLdp + lane] : 0.f;
      const float d1 = lane + 32 < tk ? dp[r * kBLdp + lane + 32] : 0.f;
      const float rowdot = ait::warp_sum(p0 * d0 + p1 * d1);
      if (lane < tk) dp[r * kBLdp + lane] = p0 * (d0 - rowdot);
      if (lane + 32 < tk) dp[r * kBLdp + lane + 32] = p1 * (d1 - rowdot);
    }
    __syncthreads();
    {  // dz = dS k / 8 and dk = dS^T (q / 8)
      float a1[4][4], a2[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) a1[i][j] = a2[i][j] = 0.f;
      for (int s = 0; s < tk; ++s) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = dp[(ty + 16 * i) * kBLdp + s];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = ks[s * kLdq + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) a1[i][j] += a[i] * b[j];
      }
      for (int r = 0; r < tq; ++r) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = dp[r * kBLdp + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = qs[r * kLdq + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) a2[i][j] += a[i] * b[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          if (r < tq) dz_out[(qrow0 + r) * kD + h * kDk + c] = a1[i][j] * 0.125f;
          if (r < tk) dk_out[(krow0 + r) * kD + h * kDk + c] = a2[i][j];
        }
    }
    __syncthreads();
  }
}

template <typename T>
int launch_bwd(const void* const* p, void* const* out, int pairs, int tq,
               int tk, const AttnDrop& drop, cudaStream_t stream) {
  const int smem = kBSmemFloats * (int)sizeof(float);
  cudaFuncSetAttribute(sh_attn_bwd_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  sh_attn_bwd_kernel<T><<<pairs, kThreads, smem, stream>>>(
      (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const T*)p[4], (const T*)p[5], (const T*)p[6], (const T*)p[7],
      (const float*)p[8], (const uint8_t*)p[9], (const float*)p[10],
      (const T*)p[11], (const float*)p[12], (const float*)p[13],
      (const float*)p[14], (float*)out[0], (float*)out[1], (float*)out[2],
      (float*)out[3], (float*)out[4], (float*)out[5], (float*)out[6],
      (float*)out[7], (float*)out[8], tq, tk, drop, (float*)out[9]);
  return (int)cudaGetLastError();
}

}  // namespace

// oh: null at eval; on the train path the per-head outputs [8, P*Tq, 64]
// f32.  qsv, ksv, vsv: all null, or (the save-qkv policy) the per-head q / 8
// [8, P*Tq, 64], k and v [8, P*Tk, 64] f32 to write.  Dropout: the Philox stream of `seed`, or the f32 operand masks akeep
// [8, P*Tq, tk] and okeep [P*Tq, 512]; all three null at eval
extern "C" int sh_attention_fwd(int bf16_io, const void* xq, const void* xkv,
                                const void* wq, const void* wk, const void* wv,
                                const void* skw, const void* skb,
                                const void* fcw, const void* lns,
                                const void* lnb, const void* mask, void* out,
                                void* oh, void* qsv, void* ksv, void* vsv,
                                int pairs, int tq, int tk,
                                const void* seed, const void* akeep,
                                const void* okeep, unsigned thresh,
                                float inv_keep, void* stream) {
  const void* p[11] = {xq, xkv, wq, wk, wv, skw, skb, fcw, lns, lnb, mask};
  void* const qkv[3] = {qsv, ksv, vsv};
  if ((akeep == nullptr) != (okeep == nullptr) || (seed && akeep) ||
      (qsv == nullptr) != (ksv == nullptr) || (qsv == nullptr) != (vsv == nullptr))
    return (int)cudaErrorInvalidValue;
  const AttnDrop d{(const int*)seed, (const float*)akeep, (const float*)okeep,
                   thresh, inv_keep};
  cudaStream_t s = (cudaStream_t)stream;
  return bf16_io ? launch<bf16>(p, out, oh, qkv, pairs, tq, tk, d, s)
                 : launch<float>(p, out, oh, qkv, pairs, tq, tk, d, s);
}

// the per-pair part of the backward; every output is f32: dy [P*Tq, 512],
// o [P*Tq, 64], s [P, 64], dlogit [P, 512], LayerNorm partials [P, 512] x 2,
// dz [P*Tq, 512], dk and dv [P*Tk, 512] (head h in columns 64h..64h+63), and
// with dropout (the forward's) dy0 [P*Tq, 512], fc's output cotangent.
// qsv, ksv, vsv: all null (q/k/v recomputed per head), or the forward's saved
// q / 8, k, v [8, P*T, 64] f32 (the save-qkv policy)
extern "C" int sh_attention_bwd_pairs(
    int bf16_io, const void* xq, const void* xkv, const void* wq,
    const void* wk, const void* wv, const void* skw, const void* skb,
    const void* fcw, const void* lns, const void* mask, const void* oh,
    const void* g, const void* qsv, const void* ksv, const void* vsv,
    void* dy, void* o, void* s, void* dgl, void* lnp_s,
    void* lnp_b, void* dz, void* dk, void* dv, int pairs, int tq, int tk,
    const void* seed, const void* akeep, const void* okeep, unsigned thresh,
    float inv_keep, void* dy0, void* stream) {
  const void* p[15] = {xq,  xkv,  wq, wk, wv,  skw, skb, fcw,
                       lns, mask, oh, g,  qsv, ksv, vsv};
  void* out[10] = {dy, o, s, dgl, lnp_s, lnp_b, dz, dk, dv, dy0};
  if ((akeep == nullptr) != (okeep == nullptr) || (seed && akeep) ||
      ((seed || akeep) && dy0 == nullptr) ||
      (qsv == nullptr) != (ksv == nullptr) || (qsv == nullptr) != (vsv == nullptr))
    return (int)cudaErrorInvalidValue;
  const AttnDrop d{(const int*)seed, (const float*)akeep, (const float*)okeep,
                   thresh, inv_keep};
  cudaStream_t st = (cudaStream_t)stream;
  return bf16_io ? launch_bwd<bf16>(p, out, pairs, tq, tk, d, st)
                 : launch_bwd<float>(p, out, pairs, tq, tk, d, st);
}
