// Selective-head multi-head attention of the AIT head for pair-sequences of
// at most 64 tokens: the forward, and the per-pair part of the backward.
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
// Forward.  What bounds it on the H100: operations, ~90% of them in the three
// 512 x 512 projections (~100 MFLOP a pair against ~8 in the scores and
// P v).  So the projections run first, as products over all pairs on
// csrc/gemm.cu's tensor cores (wgmma fed by TMA; the wrapper in
// ops/fused_attention.py runs them): q = x_q wq, k = x_kv wk, v = x_kv wv,
// f32 [P*T, 512], each weight read once per 128-row tile rather than once
// per pair.  `sh_attn_core_kernel` is the rest, in persistent blocks (one
// per SM, each walking the pairs):
//   * per head: the pair's q, k and v from the products into shared memory
//     (`cp.async`, the next head's in flight while this one is computed),
//     the masked scores of q / 8 and the row softmax in registers (a row in
//     one half-warp), the probability dropout and o_h = P v (f32 CUDA-core
//     FMAs on 16-byte shared-memory loads, 4 x 4 outputs a thread: f32
//     products of f32 operands, as the Pallas kernel's); the eight o_h stay
//     in registers (128 a thread) for the gate;
//   * the gate: s sums the heads inside and the tokens outside, then divides
//     by Tq, the order in which the backward rebuilds it from the saved o_h;
//     o = sum_h gate_h o_h rounded to the storage type;
//   * fc: in bf16 on wgmma m64n128k16, o a swizzled tile that the threads
//     write and fc's [64, 512] weight loaded by TMA once per block; in f32
//     CUDA-core FMAs;
//   * the output dropout, the residual and the LayerNorm, a warp per row.
// The f32 q/k/v of a call are transient (0.8 GB at the eval encoder's
// 134,400 rows); the wrapper drops them after the core kernel.  On the H100
// most of the core's time goes to the scores, the softmax and P v (clock
// counts of a debug build): CUDA-core FMAs with 8 warps an SM to hide their
// latency.

#include <string.h>

#include <type_traits>

#include "attn_drop.cuh"
#include "common.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 512;
constexpr int kHeads = 8;
constexpr int kDk = 64;
constexpr int kTm = 64;             // longest sequence
constexpr int kThreads = 256;       // 8 warps; 16 x 16 threads for FMA tiles
constexpr int kWld = kHeads * kDk;  // row stride of sk_w
constexpr int kLdq = kDk + 4;       // rows of q, k and v (f32)
constexpr int kYLd = kD + 8;        // rows of fc's f32 output

// A launch's dropout (the Philox stream of a seed, or operand masks) and its
// factors, and the layouts of the projections: csrc/attn_drop.cuh.
using ait::AttnDrop;
using ait::Proj;
using ait::attn_factor;
using ait::make_proj;
using ait::out_factors;

// ---------------------------------------------------------------- forward

// shared memory of the core kernel, bytes from a 1024-byte boundary:
//   fc    bf16: fc's weight, 8 swizzled panels [64 k][64 n]; f32: o [64][kLdq]
//   o     bf16: o, one swizzled panel
//   work  per head two buffers of q, k, v [64][kLdq] (the next head's loads
//         land in the other) and the probabilities [64][kLdq]; after the
//         heads the head sum in buffer 0's q, then fc's output y [64][kYLd]
//   the gate [8][64], s [64], the mask [64][64] (bytes), fc's mbarrier
constexpr uint32_t kPanel = kTm * 128;                // 64 rows of 64 bf16
constexpr uint32_t kCOffFc = 0;
constexpr uint32_t kCOffO = kCOffFc + kDk * kD * 2;
constexpr uint32_t kCOffW = kCOffO + kPanel;
constexpr uint32_t kTile = kTm * kLdq * 4;
constexpr uint32_t kHeadBuf = 3 * kTile;
constexpr uint32_t kCOffS = kCOffW + 2 * kHeadBuf;
constexpr uint32_t kCHeads = kCOffS + kTile - kCOffW;
constexpr uint32_t kCY = kTm * kYLd * 4;
constexpr uint32_t kCOffG = kCOffW + (kCHeads > kCY ? kCHeads : kCY);
constexpr uint32_t kCOffSv = kCOffG + kHeads * kDk * 4;
constexpr uint32_t kCOffMask = kCOffSv + kDk * 4;
constexpr uint32_t kCOffBar = kCOffMask + kTm * kTm;
constexpr uint32_t kCoreSmem = 1024 + kCOffBar + 8;
static_assert(kTm * kLdq * 4 <= kDk * kD * 2, "f32 o fits in fc's place");
static_assert(kCoreSmem <= 232448, "shared memory of one block");

// head h of the pair's q, k and v [64][kLdq] (rows past tq, tk zero) into
// the buffer at shared address dst: cp.async, one committed group
__device__ __forceinline__ void load_head(const Proj& pj, size_t qrow0,
                                          size_t krow0, int h, int tq, int tk,
                                          uint32_t dst) {
  for (int e = threadIdx.x; e < kTm * kDk / 4; e += kThreads) {
    const int r = e >> 4, c = (e & 15) * 4;
    const uint32_t off = (r * kLdq + c) * 4;
    const size_t rq = qrow0 + (r < tq ? r : 0), rk = krow0 + (r < tk ? r : 0);
    const int nq = r < tq ? 16 : 0, nk = r < tk ? 16 : 0;
    hopper::cp_async16(dst + off, pj.q + rq * pj.rs + h * pj.q_hs + c, nq);
    hopper::cp_async16(dst + kTile + off,
                       pj.k + rk * pj.rs + h * pj.kv_hs + c, nk);
    hopper::cp_async16(dst + 2 * kTile + off,
                       pj.v + rk * pj.rs + h * pj.kv_hs + c, nk);
  }
  hopper::cp_async_commit();
}

// map_fc: bf16 only (fc [64, 512], boxes of 64 columns x 64 rows, 128-byte
// swizzle).  Grid: persistent blocks, pair = blockIdx.x, + gridDim.x, ...
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
sh_attn_core_kernel(const __grid_constant__ CUtensorMap map_fc, Proj pj,
                    const T* __restrict__ skw, const T* __restrict__ skb,
                    const T* __restrict__ fcw, const T* __restrict__ xq,
                    const float* __restrict__ lns,
                    const float* __restrict__ lnb,
                    const uint8_t* __restrict__ mask, T* __restrict__ out,
                    float* __restrict__ oh, float* __restrict__ qsv,
                    float* __restrict__ ksv, float* __restrict__ vsv,
                    int pairs, int tq, int tk, AttnDrop drop) {
  using namespace hopper;
  constexpr bool kTc = std::is_same<T, bf16>::value;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* sc = reinterpret_cast<float*>(smem + kCOffS);
  float* us = reinterpret_cast<float*>(smem + kCOffW);   // head sum [64][64]
  float* y = reinterpret_cast<float*>(smem + kCOffW);
  float* gt = reinterpret_cast<float*>(smem + kCOffG);
  float* sv = reinterpret_cast<float*>(smem + kCOffSv);
  float* o32 = reinterpret_cast<float*>(smem + kCOffFc);   // f32 only
  uint8_t* ms = smem + kCOffMask;
  const uint32_t base = smem_u32(smem);
  const uint32_t fcbar = base + kCOffBar;

  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int warp = t >> 5, lane = t & 31;
  const uint2 key = drop.seed != nullptr ? ait::seed_key(drop.seed)
                                         : make_uint2(0u, 0u);
  if constexpr (kTc) {
    if (t == 0) {       // fc's weight, once per block
      mbar_init(fcbar, 1);
      mbar_init_fence();
      mbar_expect_tx(fcbar, kDk * kD * 2);
      for (int p = 0; p < kD / 64; ++p)
        tma_load(base + kCOffFc + p * kPanel, &map_fc, fcbar, 64 * p, 0);
    }
  }
  bool fc_ready = false;
  for (int e = t; e < tq * tk; e += kThreads)
    ms[(e / tk) * kTm + e % tk] = mask[e];

  for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
    const size_t qrow0 = (size_t)pair * tq, krow0 = (size_t)pair * tk;
    __syncthreads();   // the last pair's LayerNorm is done with the work area
    load_head(pj, qrow0, krow0, 0, tq, tk, base + kCOffW);
    float oreg[kHeads][16];   // o_h: rows ty + 16 i, columns 4 tx + j
    // the head loop stays rolled (unrolled, its eight copies of the body, a
    // Philox call for each of 16 probabilities in each, ran markedly slower
    // on the H100); each head's o_h reaches its registers through a select
    // on h
#pragma unroll 1
    for (int h = 0; h < kHeads; ++h) {
      const uint32_t buf = kCOffW + (h & 1) * kHeadBuf;
      if (h + 1 < kHeads) {
        // the next head into the other buffer, free once every thread is
        // done with head h - 1
        __syncthreads();
        load_head(pj, qrow0, krow0, h + 1, tq, tk,
                  base + kCOffW + ((h + 1) & 1) * kHeadBuf);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();   // head h's q, k, v have landed
      const float* qs = reinterpret_cast<const float*>(smem + buf);
      const float* ks = qs + kTm * kLdq;
      const float* vs = ks + kTm * kLdq;
      if (qsv != nullptr) {
        // the save-qkv policy: q / 8 [H, P*Tq, 64], k and v [H, P*Tk, 64]
        for (int e = t; e < kTm * kDk / 4; e += kThreads) {
          const int r = e >> 4, c = (e & 15) * 4;
          if (r < tq) {
            float4 a = *reinterpret_cast<const float4*>(qs + r * kLdq + c);
            a.x *= pj.qscale;   // exact: the Pallas kernel's q * scale
            a.y *= pj.qscale;
            a.z *= pj.qscale;
            a.w *= pj.qscale;
            *reinterpret_cast<float4*>(
                qsv + ((size_t)h * pairs * tq + qrow0 + r) * kDk + c) = a;
          }
          if (r < tk) {
            const size_t i = ((size_t)h * pairs * tk + krow0 + r) * kDk + c;
            *reinterpret_cast<float4*>(ksv + i) =
                *reinterpret_cast<const float4*>(ks + r * kLdq + c);
            *reinterpret_cast<float4*>(vsv + i) =
                *reinterpret_cast<const float4*>(vs + r * kLdq + c);
          }
        }
      }

      {  // masked scores (q k^T) / 8 (the bits of (q / 8) k^T: the scale is
         // exact) and the row softmax, in registers: thread (ty, tx) holds
         // rows ty + 16 i, keys tx + 16 j, so a row lies in one half-warp
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 1
        for (int d = 0; d < kDk; d += 4) {
          float4 a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kLdq + d);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 b =
                *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kLdq + d);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][j] += a[i].x * b.x;
              acc[i][j] += a[i].y * b.y;
              acc[i][j] += a[i].z * b.z;
              acc[i][j] += a[i].w * b.w;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i;
          // keys past tk: -inf (exp 0); rows past tq: finite, never used
          float m = -CUDART_INF_F;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            float v = -CUDART_INF_F;
            if (c < tk)
              v = r >= tq ? 0.f
                          : ms[r * kTm + c] ? acc[i][j] * pj.qscale : -1e9f;
            acc[i][j] = v;
            m = fmaxf(m, v);
          }
#pragma unroll
          for (int o = 8; o > 0; o >>= 1)
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = tx + 16 * j < tk ? expf(acc[i][j] - m) : 0.f;
            sum += acc[i][j];
          }
#pragma unroll
          for (int o = 8; o > 0; o >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            float p = acc[i][j] / sum;
            // the probability dropout
            if (drop.on() && r < tq && c < tk)
              p *= attn_factor(drop, key, h, pair, pairs, tq, tk, r, c);
            sc[r * kLdq + c] = p;
          }
        }
      }
      __syncthreads();

      {  // o_h = P v_h: thread (ty, tx) rows ty + 16 i, columns 4 tx ..
         // 4 tx + 3; P and v are zero past tk
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
        for (int c = 0; c < tk; c += 4) {
          float4 a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            a[i] = *reinterpret_cast<const float4*>(sc + (ty + 16 * i) * kLdq + c);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 b =
                *reinterpret_cast<const float4*>(vs + (c + k) * kLdq + 4 * tx);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = k == 0 ? a[i].x : k == 1 ? a[i].y
                            : k == 2 ? a[i].z : a[i].w;
              acc[i][0] += p * b.x;
              acc[i][1] += p * b.y;
              acc[i][2] += p * b.z;
              acc[i][3] += p * b.w;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i;
#pragma unroll
          for (int hh = 0; hh < kHeads; ++hh)
            if (hh == h)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                oreg[hh][4 * i + j] = r < tq ? acc[i][j] : 0.f;
          // the train path's saved per-head output [H, P*Tq, 64]: exactly
          // the value the gate below consumes
          if (oh != nullptr && r < tq)
            *reinterpret_cast<float4*>(
                oh + ((size_t)h * pairs * tq + qrow0 + r) * kDk + 4 * tx) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
      }
    }

    // the head sum, in buffer 0's q (the last head's P v reads only the
    // scores and buffer 1)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float u = 0.f;
#pragma unroll
        for (int h = 0; h < kHeads; ++h) u += oreg[h][4 * i + j];
        us[(ty + 16 * i) * kDk + 4 * tx + j] = u;
      }
    __syncthreads();
    // gate input: mean over tokens of the head sum
    if (t < kDk) {
      float acc = 0.f;
      for (int r = 0; r < tq; ++r) acc += us[r * kDk + t];
      sv[t] = acc / tq;
    }
    __syncthreads();
    for (int o = t; o < kHeads * kDk; o += kThreads) {
      float acc = 0.f;
      for (int d = 0; d < kDk; ++d)
        acc += sv[d] * ait::to_float(skw[d * kWld + o]);
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

    // gated head sum, rounded to the storage type: fc's input
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = 4 * tx + j;
        float acc = 0.f;
#pragma unroll
        for (int h = 0; h < kHeads; ++h)
          acc += oreg[h][4 * i + j] * gt[h * kDk + c];
        if constexpr (kTc)
          *reinterpret_cast<bf16*>(smem + kCOffO + swizzle128(r, c, kPanel)) =
              __float2bfloat16_rn(acc);
        else
          o32[r * kLdq + c] = acc;
      }
    if constexpr (kTc) fence_proxy_async();
    __syncthreads();

    // y = o @ fc [64][512] f32 into the work area
    if constexpr (kTc) {
      if (!fc_ready) {
        mbar_wait(fcbar, 0);
        fc_ready = true;
      }
      const int wg = warp / 4, r = 16 * (warp % 4) + lane / 4;
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {   // columns 256 wg + 128 nn ..
        float acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDk / 16; ++kk)
          wgmma_128<0, 1>(
              acc, make_desc(base + kCOffO + kk * 32, 16, 1024),
              make_desc(base + kCOffFc + (4 * wg + 2 * nn) * kPanel +
                            kk * 2048,
                        kPanel, 1024),
              1);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 256 * wg + 128 * nn + 8 * j + 2 * (lane % 4);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(y + (r + 8 * hh) * kYLd + col) =
                make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
        }
      }
    } else {
      for (int n0 = 0; n0 < kD; n0 += 128) {
        float acc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < kDk; ++d) {
          float a[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = o32[(ty + 16 * i) * kLdq + d];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float b = ait::to_float(fcw[d * kD + n0 + tx + 16 * j]);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] += a[i] * b;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            y[(ty + 16 * i) * kYLd + n0 + tx + 16 * j] = acc[i][j];
      }
    }
    __syncthreads();

    // output dropout, + residual, LayerNorm; one warp per row
    for (int r = warp; r < tq; r += kThreads / 32) {
      float v[16];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = j * 256 + lane * 8;
        float a[8], m[8];
        ait::load8(xq + (qrow0 + r) * kD + c, a);
        out_factors(drop, key, pair, tq, r, c, m);
        const float4 y0 = *reinterpret_cast<const float4*>(y + r * kYLd + c);
        const float4 y1 =
            *reinterpret_cast<const float4*>(y + r * kYLd + c + 4);
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
        for (int e = 0; e < 8; ++e)
          o[e] = (v[j * 8 + e] - mu) * rs * lns[c + e] + lnb[c + e];
        ait::store8(out + (qrow0 + r) * kD + c, o);
      }
    }
  }
}

template <typename T>
int launch_core(const Proj& pj, const void* const* p, void* out, void* oh,
                void* const* qkv, int pairs, int tq, int tk,
                const AttnDrop& drop, cudaStream_t stream) {
  CUtensorMap map_fc;
  memset(&map_fc, 0, sizeof(map_fc));
  if (std::is_same<T, bf16>::value &&
      !hopper::make_map(&map_fc, p[2], false, kDk, kD, 64, 64, true))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        sh_attn_core_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kCoreSmem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = pairs < sms ? pairs : sms;
  sh_attn_core_kernel<T><<<blocks, kThreads, kCoreSmem, stream>>>(
      map_fc, pj, (const T*)p[0], (const T*)p[1], (const T*)p[2],
      (const T*)p[3], (const float*)p[4], (const float*)p[5],
      (const uint8_t*)p[6], (T*)out, (float*)oh, (float*)qkv[0],
      (float*)qkv[1], (float*)qkv[2], pairs, tq, tk, drop);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward
//
// Replaces the per-pair body of ait_tpu/ops/pallas_attention.py:630
// _fused_bwd_call (kernel `_bwd_kernel`, :412), with or without dropout
// (`_bwd_rng` :937 and `_bwd_drop` :866 reach it with masks).  One block per
// pair, from the forward's saved per-head outputs oh and the projections
// q/k/v: the forward's saved ones under the save-qkv policy (`qkv=`,
// :559-566), else csrc/gemm.cu's products, which the wrapper runs again as
// the forward ran them (the same f32 values either way):
//   1. rebuild the gate exactly as the forward computed it (same loops), and
//      o = sum_h gate_h o_h rounded to the storage type (the fc input);
//   2. in 16-row tiles: y0 = o @ fc, the LayerNorm of y0 + x_q and its
//      backward (dy), and do = dy @ fc^T; fc sits in shared memory as f32;
//   3. the gate backward: dgate_h = sum_t do * o_h, the softmax-over-heads
//      backward (dlogit), ds = dlogit @ sk_w^T and du = ds / Tq;
//   4. per head: q / 8, k and v from the projections, the probabilities,
//      dP = do_h v^T with do_h = do * gate_h + du, dv = P^T do_h,
//      dS = P (dP - rowsum(P dP)), dz = dS k / 8, dk = dS^T q / 8.
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
// What bounds it on the H100: operations (~30 MFLOP a pair in the scores,
// P, dP, dS and their products, on CUDA-core FMAs) and the writes of
// dz/dk/dv (~400 KB a pair in f32).

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
constexpr int kBOffDoh = kBOffV + kTm * kLdq;      // do_h [64][kLdq]
constexpr int kBOffP = kBOffDoh + kTm * kLdq;      // P [64][kBLdp]
constexpr int kBOffDp = kBOffP + kTm * kBLdp;      // dP, then dS
constexpr int kBOffMk = kBOffDp + kTm * kBLdp;     // dropout factors
constexpr int kBEnd4 = kBOffMk + kTm * kBLdp;
constexpr int kBSmemFloats = kBEnd2 > kBEnd4 ? kBEnd2 : kBEnd4;
static_assert(2 * (kThreads / 32) * kD <= kDk * kD, "LN partials fit in fc's place");
static_assert(kBSmemFloats * 4 <= 232448, "shared memory of one block");

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
sh_attn_bwd_kernel(Proj pj, const T* __restrict__ xq,
                   const T* __restrict__ skw,
                   const T* __restrict__ skb, const T* __restrict__ fcw,
                   const float* __restrict__ lns,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ oh, const T* __restrict__ g,
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
  float* doh = sm + kBOffDoh;
  float* pp = sm + kBOffP;
  float* dp = sm + kBOffDp;
  float* mk = sm + kBOffMk;
  for (int h = 0; h < kHeads; ++h) {
    for (int e = t; e < kTm * kDk; e += kThreads) {
      const int r = e / kDk, c = e % kDk;
      // q scaled exactly (the Pallas kernel's q * scale) unless saved so
      qs[r * kLdq + c] =
          r < tq ? pj.q[(qrow0 + r) * pj.rs + h * pj.q_hs + c] * pj.qscale
                 : 0.f;
      ks[r * kLdq + c] =
          r < tk ? pj.k[(krow0 + r) * pj.rs + h * pj.kv_hs + c] : 0.f;
      vs[r * kLdq + c] =
          r < tk ? pj.v[(krow0 + r) * pj.rs + h * pj.kv_hs + c] : 0.f;
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
int launch_bwd(const Proj& pj, const void* const* p, void* const* out,
               int pairs, int tq, int tk, const AttnDrop& drop,
               cudaStream_t stream) {
  const int smem = kBSmemFloats * (int)sizeof(float);
  cudaFuncSetAttribute(sh_attn_bwd_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  sh_attn_bwd_kernel<T><<<pairs, kThreads, smem, stream>>>(
      pj, (const T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const float*)p[4], (const uint8_t*)p[5], (const float*)p[6],
      (const T*)p[7], (float*)out[0], (float*)out[1], (float*)out[2],
      (float*)out[3], (float*)out[4], (float*)out[5], (float*)out[6],
      (float*)out[7], (float*)out[8], tq, tk, drop, (float*)out[9]);
  return (int)cudaGetLastError();
}

}  // namespace

// The core of the forward, after the projections: q [P*Tq, 512], k and v
// [P*Tk, 512] f32 (csrc/gemm.cu's products x @ w, q unscaled).  oh: null at
// eval; on the train path the per-head outputs [8, P*Tq, 64] f32.  qsv,
// ksv, vsv: all null, or (the save-qkv policy) the per-head q / 8 [8, P*Tq,
// 64], k and v [8, P*Tk, 64] f32 to write.  Dropout: the Philox stream of
// `seed`, or the f32 operand masks akeep [8, P*Tq, tk] and okeep [P*Tq,
// 512]; all three null at eval
extern "C" int sh_attention_fwd(int bf16_io, const void* q, const void* k,
                                const void* v, const void* skw,
                                const void* skb, const void* fcw,
                                const void* xq, const void* lns,
                                const void* lnb, const void* mask, void* out,
                                void* oh, void* qsv, void* ksv, void* vsv,
                                int pairs, int tq, int tk, const void* seed,
                                const void* akeep, const void* okeep,
                                unsigned thresh, float inv_keep,
                                void* stream) {
  const void* p[7] = {skw, skb, fcw, xq, lns, lnb, mask};
  void* const qkv[3] = {qsv, ksv, vsv};
  if ((akeep == nullptr) != (okeep == nullptr) || (seed && akeep) ||
      (qsv == nullptr) != (ksv == nullptr) || (qsv == nullptr) != (vsv == nullptr))
    return (int)cudaErrorInvalidValue;
  const AttnDrop d{(const int*)seed, (const float*)akeep, (const float*)okeep,
                   thresh, inv_keep};
  const Proj pj = make_proj(q, k, v, 0, pairs, tq, tk);
  cudaStream_t s = (cudaStream_t)stream;
  return bf16_io ? launch_core<bf16>(pj, p, out, oh, qkv, pairs, tq, tk, d, s)
                 : launch_core<float>(pj, p, out, oh, qkv, pairs, tq, tk, d, s);
}

// the per-pair part of the backward; every output is f32: dy [P*Tq, 512],
// o [P*Tq, 64], s [P, 64], dlogit [P, 512], LayerNorm partials [P, 512] x 2,
// dz [P*Tq, 512], dk and dv [P*Tk, 512] (head h in columns 64h..64h+63), and
// with dropout (the forward's) dy0 [P*Tq, 512], fc's output cotangent.
// q, k, v: the projections [P*T, 512] f32 (q unscaled), or with qkv_saved
// the forward's saved q / 8, k, v [8, P*T, 64] f32 (the save-qkv policy)
extern "C" int sh_attention_bwd_pairs(
    int bf16_io, const void* xq, const void* skw, const void* skb,
    const void* fcw, const void* lns, const void* mask, const void* oh,
    const void* g, const void* q, const void* k, const void* v,
    int qkv_saved, void* dy, void* o, void* s, void* dgl, void* lnp_s,
    void* lnp_b, void* dz, void* dk, void* dv, int pairs, int tq, int tk,
    const void* seed, const void* akeep, const void* okeep, unsigned thresh,
    float inv_keep, void* dy0, void* stream) {
  const void* p[8] = {xq, skw, skb, fcw, lns, mask, oh, g};
  void* out[10] = {dy, o, s, dgl, lnp_s, lnp_b, dz, dk, dv, dy0};
  if ((akeep == nullptr) != (okeep == nullptr) || (seed && akeep) ||
      ((seed || akeep) && dy0 == nullptr) || !q || !k || !v)
    return (int)cudaErrorInvalidValue;
  const AttnDrop d{(const int*)seed, (const float*)akeep, (const float*)okeep,
                   thresh, inv_keep};
  const Proj pj = make_proj(q, k, v, qkv_saved, pairs, tq, tk);
  cudaStream_t st = (cudaStream_t)stream;
  return bf16_io ? launch_bwd<bf16>(pj, p, out, pairs, tq, tk, d, st)
                 : launch_bwd<float>(pj, p, out, pairs, tq, tk, d, st);
}
