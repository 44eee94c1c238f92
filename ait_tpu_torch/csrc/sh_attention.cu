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
#include "split_mma.cuh"

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
// the per-head products on mma.sync in the six-term bf16 split:
// csrc/split_mma.cuh
using ait::split_mma;
using ait::split_mma2;
using ait::split_mma3;
using ait::store_frag;
using ait::swz;
using ait::zero44;

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
// (`_bwd_rng` :937 and `_bwd_drop` :866 reach it with masks), from the
// forward's saved per-head outputs oh and the projections q/k/v: the
// forward's saved ones under the save-qkv policy (`qkv=`, :559-566), else
// csrc/gemm.cu's products, which the wrapper runs again as the forward ran
// them (the same f32 values either way).  Per pair:
//   1. the gate, rebuilt exactly as the forward computed it (same order of
//      sums), and o = sum_h gate_h o_h rounded to the storage type;
//   2. y0 = o @ fc, the LayerNorm of y0 (* the output dropout) + x_q and its
//      backward (dy, and dy0 = dy * ok / kp, fc's output cotangent), and
//      do = dy0 @ fc^T;
//   3. the gate backward: dgate_h = sum_t do * o_h, the softmax-over-heads
//      backward (dlogit), ds = dlogit @ sk_w^T and du = ds / Tq;
//   4. per head, with do_h = do * gate_h + du: the scores S = (q / 8) k^T,
//      the probabilities P, dP = (do_h v^T) ak / kp, dv = (P ak / kp)^T do_h,
//      dS = P (dP - rowsum(P dP)), dz = dS k / 8, dk = dS^T q / 8.
// Everything between the products is f32, as in the Pallas kernel.  It
// writes dy, o, s (the gate input), dlogit, the LayerNorm partials, the
// per-head dz/dk/dv [rows, 8 x 64] (and dy0, with dropout) to device memory:
// the input gradients and the weight gradients, which reduce over all pairs,
// run afterwards as products on csrc/gemm.cu.
//
// What bounds it on the H100: bytes.  It reads the f32 q/k/v and oh and the
// bf16 g and x_q, and writes f32 dy, dy0, o, dz, dk and dv: ~1.16 MB a pair
// at 56 x 56 tokens, 1.19 GB for the encoder's 1024 pairs, 0.36 ms at
// 3.35 TB/s.  Its arithmetic, ~29 MFLOP a pair (fc's two products 8.4, the
// five per-head products 21), would take 0.44 ms on the CUDA cores' FMAs,
// so the design moves the products to the tensor cores and keeps the card
// streaming:
//   * persistent blocks, one per SM, each walking the pairs; fc [64, 512]
//     loaded once per block by TMA (bf16, 128-byte swizzle: the forward
//     core's map);
//   * y0 = o @ fc on wgmma (o is rounded to bf16, so the product is exact in
//     f32); do = dy0 @ fc^T on wgmma with dy0 in three exact bf16 terms held
//     in registers (A from registers), each warpgroup half of K = 512, each
//     64-deep stage added into a second f32 accumulator rounded to nearest
//     (the tensor cores' additions truncate);
//   * the five per-head products (f32 x f32 at depth <= 64, as JAX's
//     preferred_element_type=f32 products) on mma.sync m16n8k16, both
//     operands split into three exact bf16 terms and the six term products
//     with i + j <= 2 summed (the three dropped are below 2^-23 of |a| |b|):
//     near-f32 products, held on the card to 2^-17 sum_k |a_k| |b_k|
//     (`sh_attention_split_check`; ops/fused_attention.py::split6_matmul is
//     its plain emulation), a bound that the three-term split (i + j <= 1)
//     exceeds.  Operands sit in shared memory as f32 tiles in
//     an XOR swizzle that serves both a tile's rows and its columns (the
//     transposed operands of dv and dk) without bank conflicts;
//   * the next head's q and k load (cp.async) while this head is computed,
//     its v once this head's dP is done;
//   * the dropout factors from one Philox call per 4 probabilities
//     (attn_factors4: a lane pair shares a group of 4 columns, each lane
//     draws one of its two rows' groups and they swap halves);
//   * the gate phases spread over the block (the head sums and o by 16-byte
//     loads of 64 threads a row, du a warp per channel), and dz/dk/dv staged
//     in shared memory for coalesced 16-byte stores.
// The f32 instantiation (the parity path) keeps CUDA-core FMAs for fc's two
// products, with fc read from L2, as the forward core does.

// rows 0..n-1 of the swizzled tile X into columns col.. of the [rows, 512]
// matrix at out (row stride 512): 16-byte stores, 16 threads a row
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           const float* X, int n, int col) {
  for (int e = threadIdx.x; e < n * 16; e += kThreads) {
    const int r = e >> 4, c = (e & 15) * 4;
    *reinterpret_cast<float4*>(out + (size_t)r * kD + col + c) =
        *reinterpret_cast<const float4*>(X + swz(r, c));
  }
}

// head h of the pair's q or k/v rows (row0.., n of them; zero past n) into
// the swizzled tile at shared address dst: cp.async, uncommitted
__device__ __forceinline__ void load_rows(const float* src, int rs, size_t hs,
                                          size_t row0, int n, int h,
                                          uint32_t dst) {
  for (int e = threadIdx.x; e < kTm * kDk / 4; e += kThreads) {
    const int r = e >> 4, c = (e & 15) * 4;
    hopper::cp_async16(dst + 4 * swz(r, c),
                       src + (row0 + (r < n ? r : 0)) * rs + h * hs + c,
                       r < n ? 16 : 0);
  }
}

// elements p[0], p[1] as floats (8-byte aligned for float, 4 for bf16)
__device__ __forceinline__ float2 load2f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2f(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// shared memory of the backward kernel, bytes from a 1024-byte boundary:
//   fc    bf16: fc's weight, 8 swizzled panels [64 n][64 k] (TMA, once per
//         block); f32: o [64][kLdq]
//   work  phase 1: the head sum u [64][64]; phase 2: y0, then dy0 in place
//         [64][kYLd] f32, and o as one swizzled bf16 panel; phase 4: eight
//         swizzled f32 tiles: q and k for two heads, v, do_h, P ak / kp and
//         dS (the last three then stage dz, dk, dv); the LayerNorm partials
//         [2][8][512] between phases 2 and 3 (in tiles 2 and 3)
//   do [64][64] f32, the gate [8][64], dgate then dlogit [8][64], s [64],
//   du [64], the row reductions of the softmax [3][2][64], the mask (a
//   64-bit row each), fc's mbarrier
constexpr uint32_t kBTile = kTm * kDk * 4;
constexpr uint32_t kBOffFc = 0;
constexpr uint32_t kBOffW = kDk * kD * 2;
constexpr uint32_t kBOffOp = kBOffW + kTm * kYLd * 4;      // o panel (bf16)
constexpr uint32_t kBWork = kBOffOp + kPanel - kBOffW;
constexpr uint32_t kBOffDo = kBOffW + kBWork;
constexpr uint32_t kBOffGm = kBOffDo + kTm * kDk * 4;
constexpr uint32_t kBOffDg = kBOffGm + kHeads * kDk * 4;
constexpr uint32_t kBOffSv = kBOffDg + kHeads * kDk * 4;
constexpr uint32_t kBOffDu = kBOffSv + kDk * 4;
constexpr uint32_t kBOffRed = kBOffDu + kDk * 4;
constexpr uint32_t kBOffMask = kBOffRed + 3 * 2 * kTm * 4;
constexpr uint32_t kBOffBar = kBOffMask + kTm * 8;
constexpr uint32_t kBSmem = 1024 + kBOffBar + 8;
static_assert(kBOffOp % 1024 == 0, "the o panel on a swizzle boundary");
static_assert(8 * kBTile <= kBWork, "phase 4's tiles fit the work area");
static_assert(kTm * kLdq * 4 <= kBOffW, "f32 o fits in fc's place");
static_assert(kBSmem <= 232448, "shared memory of one block");
// phase 4's tiles
enum { kQ0 = 0, kK0 = 1, kQ1 = 2, kK1 = 3, kV = 4, kDoh = 5, kPd = 6, kDs = 7 };

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
sh_attn_bwd_kernel(const __grid_constant__ CUtensorMap map_fc, Proj pj,
                   const T* __restrict__ xq, const T* __restrict__ skw,
                   const T* __restrict__ skb, const T* __restrict__ fcw,
                   const float* __restrict__ lns,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ oh, const T* __restrict__ g,
                   float* __restrict__ dy_out, float* __restrict__ o_out,
                   float* __restrict__ s_out, float* __restrict__ dgl_out,
                   float* __restrict__ lnp_s, float* __restrict__ lnp_b,
                   float* __restrict__ dz_out, float* __restrict__ dk_out,
                   float* __restrict__ dv_out, int pairs, int tq, int tk,
                   AttnDrop drop, float* __restrict__ dy0_out) {
  using namespace hopper;
  constexpr bool kTc = std::is_same<T, bf16>::value;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t fcbar = base + kBOffBar;
  float* work = reinterpret_cast<float*>(smem + kBOffW);
  float* y = work;                                   // [64][kYLd]
  float* o32 = reinterpret_cast<float*>(smem + kBOffFc);   // f32 only
  float* dos = reinterpret_cast<float*>(smem + kBOffDo);
  float* gm = reinterpret_cast<float*>(smem + kBOffGm);
  float* dg = reinterpret_cast<float*>(smem + kBOffDg);
  float* sv = reinterpret_cast<float*>(smem + kBOffSv);
  float* du = reinterpret_cast<float*>(smem + kBOffDu);
  float* red = reinterpret_cast<float*>(smem + kBOffRed);  // [3][2][64]
  uint64_t* mbits = reinterpret_cast<uint64_t*>(smem + kBOffMask);
  auto tile = [&](int i) { return work + i * (kBTile / 4); };
  auto tile_u32 = [&](int i) { return base + kBOffW + i * kBTile; };

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
        tma_load(base + kBOffFc + p * kPanel, &map_fc, fcbar, 64 * p, 0);
    }
  }
  bool fc_ready = false;
  if (t < kTm) {        // the mask, a 64-bit row each
    uint64_t bits = 0;
    if (t < tq)
      for (int c = 0; c < tk; ++c)
        if (mask[t * tk + c]) bits |= 1ull << c;
    mbits[t] = bits;
  }

  for (int pair = blockIdx.x; pair < pairs; pair += gridDim.x) {
    const size_t qrow0 = (size_t)pair * tq, krow0 = (size_t)pair * tk;
    const float* ohp = oh + qrow0 * kDk;               // head h at h * hstride
    const size_t hstride = (size_t)pairs * tq * kDk;
    const T* xqp = xq + qrow0 * kD;
    const T* gp = g + qrow0 * kD;
    __syncthreads();   // the last pair is done with every buffer

    // ---- 1. the gate, in the forward's order: u = sum_h o_h, s = (sum_t
    // u) / Tq, logits s @ sk_w + sk_b, softmax over heads
    float* us = work;
    for (int e = t; e < tq * 16; e += kThreads) {
      const int r = e >> 4, c = (e & 15) * 4;
      float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(
            ohp + h * hstride + r * kDk + c);
        u.x += v.x;
        u.y += v.y;
        u.z += v.z;
        u.w += v.w;
      }
      *reinterpret_cast<float4*>(us + r * kDk + c) = u;
    }
    __syncthreads();
    if (t < kDk) {
      float acc = 0.f;
      for (int r = 0; r < tq; ++r) acc += us[r * kDk + t];
      sv[t] = acc / tq;
      s_out[(size_t)pair * kDk + t] = sv[t];
    }
    __syncthreads();
    {  // logits o = 2 t, 2 t + 1, each summed over d in order
      const int o = 2 * t;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 32
      for (int d = 0; d < kDk; ++d) {
        const float2 w = load2f(skw + d * kWld + o);
        a0 += sv[d] * w.x;
        a1 += sv[d] * w.y;
      }
      gm[o] = a0 + ait::to_float(skb[o]);
      gm[o + 1] = a1 + ait::to_float(skb[o + 1]);
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
    // o = sum_h gate_h o_h rounded to the storage type: fc's input (rows
    // past tq zero) and an output
    for (int e = t; e < kTm * 16; e += kThreads) {
      const int r = e >> 4, c = (e & 15) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < tq) {
#pragma unroll
        for (int h = 0; h < kHeads; ++h) {
          const float4 a = *reinterpret_cast<const float4*>(
              ohp + h * hstride + r * kDk + c);
          v[0] += a.x * gm[h * kDk + c];
          v[1] += a.y * gm[h * kDk + c + 1];
          v[2] += a.z * gm[h * kDk + c + 2];
          v[3] += a.w * gm[h * kDk + c + 3];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = ait::round_to(v[j], xq);
        ait::store4(o_out + (qrow0 + r) * kDk + c, v[0], v[1], v[2], v[3]);
      }
      if constexpr (kTc) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<bf16*>(smem + kBOffOp +
                                   swizzle128(r, c + j, kPanel)) =
              __float2bfloat16_rn(v[j]);
      } else {
        ait::store4(o32 + r * kLdq + c, v[0], v[1], v[2], v[3]);
      }
    }
    if constexpr (kTc) fence_proxy_async();
    __syncthreads();

    // ---- 2. y0 = o @ fc [64][512] into y
    if constexpr (kTc) {
      if (!fc_ready) {
        mbar_wait(fcbar, 0);
        fc_ready = true;
      }
      const int wg = warp / 4, r = 16 * (warp % 4) + lane / 4;
#pragma unroll 1
      for (int nn = 0; nn < 2; ++nn) {   // columns 256 wg + 128 nn ..
        float acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDk / 16; ++kk)
          wgmma_128<0, 1>(
              acc, make_desc(base + kBOffOp + kk * 32, 16, 1024),
              make_desc(base + kBOffFc + (4 * wg + 2 * nn) * kPanel +
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

    // LayerNorm of y0 * ok / kp + x_q and its backward, a warp per row:
    // dy to device memory, dy0 = dy * ok / kp (fc's output cotangent) there
    // with dropout and into y in place of y0
    float ps[16], pb[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) ps[i] = pb[i] = 0.f;
    float xn[16], gn[16];   // the next row's x_q and g
    auto load_row = [&](int r) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        ait::load8(xqp + (size_t)r * kD + j * 256 + lane * 8, xn + j * 8);
        ait::load8(gp + (size_t)r * kD + j * 256 + lane * 8, gn + j * 8);
      }
    };
    if (warp < tq) load_row(warp);
    for (int r = warp; r < tq; r += kThreads / 32) {
      float v[16], gv[16], m[16], a[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        a[e] = xn[e];
        gv[e] = gn[e];
      }
      if (r + kThreads / 32 < tq) load_row(r + kThreads / 32);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = j * 256 + lane * 8;
        ait::load8(y + r * kYLd + c, v + j * 8);
        out_factors(drop, key, pair, tq, r, c, m + j * 8);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[j * 8 + e] = v[j * 8 + e] * m[j * 8 + e] + a[j * 8 + e];
          s += v[j * 8 + e];
        }
      }
      const float mu = ait::warp_sum(s) / kD;
      float q = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float d = v[e] - mu;
        q += d * d;
      }
      const float rs = rsqrtf(ait::warp_sum(q) / kD + 1e-6f);
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int k = j * 8 + e, c = j * 256 + lane * 8 + e;
          v[k] = (v[k] - mu) * rs;
          ps[k] += gv[k] * v[k];
          pb[k] += gv[k];
          gv[k] *= lns[c];
          m1 += gv[k];
          m2 += gv[k] * v[k];
        }
      m1 = ait::warp_sum(m1) / kD;
      m2 = ait::warp_sum(m2) / kD;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = j * 256 + lane * 8;
        float o[8], o0[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          o[e] = rs * (gv[j * 8 + e] - m1 - v[j * 8 + e] * m2);
          o0[e] = o[e] * m[j * 8 + e];
        }
        ait::store8(y + r * kYLd + c, o0);
        ait::store8(dy_out + (qrow0 + r) * kD + c, o);
        if (drop.on()) ait::store8(dy0_out + (qrow0 + r) * kD + c, o0);
      }
    }
    __syncthreads();

    // do = dy0 @ fc^T [64][64] (rows past tq are zero: so are o's, y0's)
    if constexpr (kTc) {
      // warpgroup wg sums k = 256 wg .. 256 wg + 255 in four 64-deep
      // stages; dy0 in three bf16 terms as A from registers, fc's panel as
      // a K-major B; each stage's sum is added to `acc` in f32
      const int wg = warp / 4, t2 = 2 * (lane & 3);
      const int r = 16 * (warp % 4) + lane / 4;
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll 1
      for (int st = 0; st < 4; ++st) {
        const int k0 = 256 * wg + 64 * st;
        uint32_t a[4][3][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* y0 = y + r * kYLd + k0 + 16 * kk + t2;
          const float2 v[4] = {*reinterpret_cast<const float2*>(y0),
                               *reinterpret_cast<const float2*>(y0 + 8 * kYLd),
                               *reinterpret_cast<const float2*>(y0 + 8),
                               *reinterpret_cast<const float2*>(y0 + 8 * kYLd + 8)};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_pair(v[i].x, v[i].y, a[kk][0][i], a[kk][1][i], a[kk][2][i]);
        }
        float sum[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sum[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = make_desc(
              base + kBOffFc + (k0 / 64) * kPanel + kk * 32, 16, 1024);
          wgmma_64_rs<0>(sum, a[kk][2], db, 1);
          wgmma_64_rs<0>(sum, a[kk][1], db, 1);
          wgmma_64_rs<0>(sum, a[kk][0], db, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] += sum[i];
      }
      // do = warpgroup 0's half + warpgroup 1's
      if (wg == 1)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(dos + (r + 8 * hh) * kDk + 8 * j + t2) =
                make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
      __syncthreads();
      if (wg == 0)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float2* d =
                reinterpret_cast<float2*>(dos + (r + 8 * hh) * kDk + 8 * j + t2);
            const float2 b = *d;
            *d = make_float2(acc[4 * j + 2 * hh] + b.x,
                             acc[4 * j + 2 * hh + 1] + b.y);
          }
    } else {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
      for (int k = 0; k < kD; k += 4) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(y + (ty + 16 * i) * kYLd + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 b = *reinterpret_cast<const float4*>(
              fcw + (tx + 16 * j) * kD + k);
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
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dos[(ty + 16 * i) * kDk + tx + 16 * j] = acc[i][j];
    }
    __syncthreads();

    // head 0's q, k and v into the work area (y is spent); the LayerNorm
    // partials through tiles 2 and 3, the 8 warps in order
    load_rows(pj.q, pj.rs, pj.q_hs, qrow0, tq, 0, tile_u32(kQ0));
    load_rows(pj.k, pj.rs, pj.kv_hs, krow0, tk, 0, tile_u32(kK0));
    cp_async_commit();
    load_rows(pj.v, pj.rs, pj.kv_hs, krow0, tk, 0, tile_u32(kV));
    cp_async_commit();
    {
      float* part = tile(kQ1);   // [2][8][512]
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          part[warp * kD + j * 256 + lane * 8 + e] = ps[j * 8 + e];
          part[(8 + warp) * kD + j * 256 + lane * 8 + e] = pb[j * 8 + e];
        }
      __syncthreads();
      for (int c = t; c < kD; c += kThreads) {
        float a = 0.f, b = 0.f;
        for (int w = 0; w < kThreads / 32; ++w) {
          a += part[w * kD + c];
          b += part[(8 + w) * kD + c];
        }
        lnp_s[(size_t)pair * kD + c] = a;
        lnp_b[(size_t)pair * kD + c] = b;
      }
    }

    // ---- 3. the gate backward: dgate_h = sum_t do o_h (thread: head t /
    // 32, channels 2 lane, 2 lane + 1), then dlogit, then du = dlogit sk_w^T
    // / Tq
    {
      const int h = t >> 5, c = 2 * lane;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
      for (int r = 0; r < tq; ++r) {
        const float2 o2 =
            *reinterpret_cast<const float2*>(ohp + h * hstride + r * kDk + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dos + r * kDk + c);
        a0 += d2.x * o2.x;
        a1 += d2.y * o2.y;
      }
      dg[h * kDk + c] = a0;
      dg[h * kDk + c + 1] = a1;
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
    {  // du: 4 threads a channel, 128 columns of sk_w each
      const int c = t >> 2, q4 = t & 3;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int o = q4 * 128 + i * 8;
        float w[8];
        ait::load8(skw + c * kWld + o, w);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += dg[o + e] * w[e];
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (q4 == 0) du[c] = acc / tq;
    }
    __syncthreads();

    // ---- 4. per head; warp w computes rows 16 (w % 4) .. of the 64 x 64
    // products, columns 32 (w / 4) ..; a row of the scores spans warps w
    // and w + 4, which meet at named barrier 1 + w % 4
    const int mb = warp & 3, nh = warp >> 2, m0 = 16 * mb, n0 = 32 * nh;
    const int ra = m0 + (lane >> 2), t2 = 2 * (lane & 3);
    const bool odd = lane & 1;
    float* dohs = tile(kDoh);
#pragma unroll 1
    for (int h = 0; h < kHeads; ++h) {
      const float* qs = tile(h & 1 ? kQ1 : kQ0);
      const float* ks = tile(h & 1 ? kK1 : kK0);
      for (int e = t; e < kTm * 16; e += kThreads) {   // do_h = do gate_h + du
        const int r = e >> 4, c = (e & 15) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < tq) {
          const float4 d = *reinterpret_cast<const float4*>(dos + r * kDk + c);
          const float* gh = gm + h * kDk + c;
          v = make_float4(d.x * gh[0] + du[c], d.y * gh[1] + du[c + 1],
                          d.z * gh[2] + du[c + 2], d.w * gh[3] + du[c + 3]);
        }
        *reinterpret_cast<float4*>(dohs + swz(r, c)) = v;
      }
      if (h + 1 < kHeads) {   // the next head's q and k, into the tiles
        // that head h - 1 used
        load_rows(pj.q, pj.rs, pj.q_hs, qrow0, tq, h + 1,
                  tile_u32(h & 1 ? kQ0 : kQ1));
        load_rows(pj.k, pj.rs, pj.kv_hs, krow0, tk, h + 1,
                  tile_u32(h & 1 ? kK0 : kK1));
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();   // head h's q, k, v and do_h are in place

      // S = q k^T and do_h v^T, a warp's 16 x 32 of each
      float sc[4][4], dp[4][4];
      zero44(sc);
      zero44(dp);
      split_mma2<false, false, false, false>(sc, qs, ks, dp, dohs, tile(kV),
                                             m0, n0, lane);
      // element (j, e): row ra + 8 (e / 2), column n0 + 8 j + t2 + e % 2
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = ra + 8 * (e >> 1), c = n0 + 8 * j + t2 + (e & 1);
          // keys past tk: -inf (exp 0); rows past tq: finite, zeroed below
          float v = -CUDART_INF_F;
          if (c < tk)
            v = r >= tq ? 0.f
                        : (mbits[r] >> c) & 1 ? sc[j][e] * pj.qscale : -1e9f;
          sc[j][e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
      // the two warps of a row meet once for its max and sum: each sums
      // exp(x - its own max), and the sums are rescaled to the row's max
      float* rmax = red;
      float* rsum = red + 2 * kTm;
      float* rdot = red + 4 * kTm;
      float sm[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n0 + 8 * j + t2 + (e & 1) < tk)
            sm[e >> 1] += expf(sc[j][e] - mx[e >> 1]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        sm[hh] += __shfl_xor_sync(0xffffffffu, sm[hh], 1);
        sm[hh] += __shfl_xor_sync(0xffffffffu, sm[hh], 2);
        if ((lane & 3) == 0) {
          rmax[nh * kTm + ra + 8 * hh] = mx[hh];
          rsum[nh * kTm + ra + 8 * hh] = sm[hh];
        }
      }
      named_sync(1 + mb, 64);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = ra + 8 * hh;
        const float m0 = rmax[r], m1 = rmax[kTm + r];
        const float m = fmaxf(m0, m1);
        // a warp whose columns are all past tk has max -inf and sum 0
        sm[hh] = (m0 > -CUDART_INF_F ? rsum[r] * expf(m0 - m) : 0.f) +
                 (m1 > -CUDART_INF_F ? rsum[kTm + r] * expf(m1 - m) : 0.f);
        mx[hh] = m;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n0 + 8 * j + t2 + (e & 1);
          sc[j][e] = c < tk ? expf(sc[j][e] - mx[e >> 1]) : 0.f;
        }

      // the dropout factors ak / kp (0 outside [tq, tk]): a lane pair
      // shares a group of 4 columns; the even lane draws row ra's group,
      // the odd one row ra + 8's, and they swap the halves the other needs
      float fa[4][4];
      if (drop.on()) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cb = n0 + 8 * j + 4 * ((lane & 3) >> 1);
          const float4 f = ait::attn_factors4(drop, key, h, pair, pairs, tq,
                                              tk, odd ? ra + 8 : ra, cb);
          const float s0 = odd ? f.x : f.z, s1 = odd ? f.y : f.w;
          const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
          fa[j][0] = odd ? r0 : f.x;
          fa[j][1] = odd ? r1 : f.y;
          fa[j][2] = odd ? f.z : r0;
          fa[j][3] = odd ? f.w : r1;
        }
      }
      // P (times the reciprocal of the row sum), dP ak / kp and
      // rowsum(P dP)
      sm[0] = 1.f / sm[0];
      sm[1] = 1.f / sm[1];
      float dot[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = ra + 8 * (e >> 1);
          const float p = r < tq ? sc[j][e] * sm[e >> 1] : 0.f;
          sc[j][e] = p;
          if (drop.on()) dp[j][e] *= fa[j][e];
          dot[e >> 1] += p * dp[j][e];
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        dot[hh] += __shfl_xor_sync(0xffffffffu, dot[hh], 1);
        dot[hh] += __shfl_xor_sync(0xffffffffu, dot[hh], 2);
        if ((lane & 3) == 0) rdot[nh * kTm + ra + 8 * hh] = dot[hh];
      }
      named_sync(1 + mb, 64);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        dot[hh] = rdot[ra + 8 * hh] + rdot[kTm + ra + 8 * hh];
      // P ak / kp (for dv) and dS = P (dP - rowsum) into their tiles
      float* pds = tile(kPd);
      float* dss = tile(kDs);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = ra + 8 * hh, c = n0 + 8 * j + t2;
          float2 pd = make_float2(sc[j][2 * hh], sc[j][2 * hh + 1]);
          if (drop.on()) {
            pd.x *= fa[j][2 * hh];
            pd.y *= fa[j][2 * hh + 1];
          }
          *reinterpret_cast<float2*>(pds + swz(r, c)) = pd;
          *reinterpret_cast<float2*>(dss + swz(r, c)) = make_float2(
              sc[j][2 * hh] * (dp[j][2 * hh] - dot[hh]),
              sc[j][2 * hh + 1] * (dp[j][2 * hh + 1] - dot[hh]));
        }
      __syncthreads();   // P ak / kp and dS complete; v is free
      if (h + 1 < kHeads) {
        load_rows(pj.v, pj.rs, pj.kv_hs, krow0, tk, h + 1, tile_u32(kV));
        cp_async_commit();
      }

      // dv = (P ak / kp)^T do_h, dk = dS^T q / 8, dz = dS k / 8
      float dv[4][4], dk[4][4], dz[4][4];
      zero44(dv);
      zero44(dk);
      zero44(dz);
      split_mma3<true, true, true, true, false, true>(
          dv, pds, dohs, dk, dss, qs, dz, dss, ks, m0, n0, lane);
      __syncthreads();   // every warp is done with the operands
      store_frag(pds, dv, m0, n0, lane, 1.f);
      store_frag(dss, dk, m0, n0, lane, pj.qscale);
      store_frag(dohs, dz, m0, n0, lane, 0.125f);
      __syncthreads();
      store_tile(dv_out + krow0 * kD, pds, tk, h * kDk);
      store_tile(dk_out + krow0 * kD, dss, tk, h * kDk);
      store_tile(dz_out + qrow0 * kD, dohs, tq, h * kDk);
      __syncthreads();   // the staging tiles are read before the next head
    }
  }
}

template <typename T>
int launch_bwd(const Proj& pj, const void* const* p, void* const* out,
               int pairs, int tq, int tk, const AttnDrop& drop,
               cudaStream_t stream) {
  CUtensorMap map_fc;
  memset(&map_fc, 0, sizeof(map_fc));
  if (std::is_same<T, bf16>::value &&
      !hopper::make_map(&map_fc, p[3], false, kDk, kD, 64, 64, true))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        sh_attn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBSmem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int blocks = pairs < sms ? pairs : sms;
  sh_attn_bwd_kernel<T><<<blocks, kThreads, kBSmem, stream>>>(
      map_fc, pj, (const T*)p[0], (const T*)p[1], (const T*)p[2],
      (const T*)p[3], (const float*)p[4], (const uint8_t*)p[5],
      (const float*)p[6], (const T*)p[7], (float*)out[0], (float*)out[1],
      (float*)out[2], (float*)out[3], (float*)out[4], (float*)out[5],
      (float*)out[6], (float*)out[7], (float*)out[8], pairs, tq, tk, drop,
      (float*)out[9]);
  return (int)cudaGetLastError();
}

// the per-head products' arithmetic on its own (split_mma, one block per
// [64, 64] x [64, 64] product): out_i = op(a_i) op(b_i), op a transpose
// where TA / TB, so that a check on the card holds the three-term split to
// its stated bound
template <bool TA, bool TB>
__global__ void __launch_bounds__(kThreads)
split_check_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out) {
  __shared__ __align__(16) float sa[kTm * kDk];
  __shared__ __align__(16) float sb[kTm * kDk];
  const size_t off = (size_t)blockIdx.x * kTm * kDk;
  for (int e = threadIdx.x; e < kTm * 16; e += kThreads) {
    const int r = e >> 4, c = (e & 15) * 4;
    *reinterpret_cast<float4*>(sa + swz(r, c)) =
        *reinterpret_cast<const float4*>(a + off + r * kDk + c);
    *reinterpret_cast<float4*>(sb + swz(r, c)) =
        *reinterpret_cast<const float4*>(b + off + r * kDk + c);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  float acc[4][4];
  zero44(acc);
  // split_mma's B is its tile transposed unless TB: op(b) = b^T means the
  // tile b is read as given
  split_mma<TA, !TB>(acc, sa, sb, m0, n0, lane);
  __syncthreads();
  store_frag(sa, acc, m0, n0, lane, 1.f);
  __syncthreads();
  for (int e = threadIdx.x; e < kTm * 16; e += kThreads) {
    const int r = e >> 4, c = (e & 15) * 4;
    *reinterpret_cast<float4*>(out + off + r * kDk + c) =
        *reinterpret_cast<const float4*>(sa + swz(r, c));
  }
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

// sh_attn_bwd_kernel's per-head products on their own: out_i = op(a_i)
// op(b_i) for n products of [64, 64] f32 matrices, op(x) = x^T where ta /
// tb (the three-term split on mma.sync, as the kernel runs it)
extern "C" int sh_attention_split_check(const void* a, const void* b,
                                        void* out, int n, int ta, int tb,
                                        void* stream) {
  const float* pa = (const float*)a;
  const float* pb = (const float*)b;
  float* po = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (ta && tb) split_check_kernel<true, true><<<n, kThreads, 0, st>>>(pa, pb, po);
  else if (ta) split_check_kernel<true, false><<<n, kThreads, 0, st>>>(pa, pb, po);
  else if (tb) split_check_kernel<false, true><<<n, kThreads, 0, st>>>(pa, pb, po);
  else split_check_kernel<false, false><<<n, kThreads, 0, st>>>(pa, pb, po);
  return (int)cudaGetLastError();
}
