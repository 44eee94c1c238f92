// The selective-head attention block of csrc/sh_attention.cu for sequences
// that do not fit one thread block: 65-128 tokens on either side, and the
// co-attention's long regime (one side up to 128 tokens, Tq * Tk <= 192 K:
// 1900 image tokens against 64 query tokens, both ways).  Forward (eval and
// with saved per-head outputs) and backward, each with dropout from the
// Philox stream of a seed or from operand masks (csrc/attn_drop.cuh).
//
// Replaces ait_tpu/ops/pallas_attention.py:400 `_fused_call` and :724
// `_fused_bwd_call` where they run with a shrunken pair tile (`pair_tile =
// max(1, 2048 // max(Tq, Tk))`, `_pair_group` 1, the unaligned-row 4-D
// layout `_oh_4d`), and their 65-128 token shapes.  It computes what
// `_kernel` (:195) and `_bwd_kernel` (:412) compute, f32 between the
// products, the gated head sum rounded to the storage type before fc.
//
// On the TPU a whole pair sat in VMEM.  Here nothing of a pair fits on chip:
// one head's scores at 1900 x 64 are 486 KB and the eight per-head outputs of
// a 1900-row pair 3.9 MB, against 227 KB of shared memory; and the gate is a
// mean over all rows of the pair, a dependency across any tiling of the long
// side.  So the block is a sequence of launches over 64-row tiles, with the
// per-head projections and the per-head outputs in device memory between
// them (the projections themselves, x @ w over all pairs, run on csrc/gemm.cu
// from the wrapper, ops/fused_attention.py):
//
//   forward   core_fwd  (q tile, head, pair): scores against 64-key tiles in
//                       two passes (row max and sum, then P = exp(s - m) / l,
//                       dropout, P v), so the softmax streams any number of
//                       keys; writes o_h [H, P*Tq, 64]
//             gate      (pair): s = mean_t sum_h o_h in a fixed order, the
//                       gate's Linear and its softmax over heads
//             out_fwd   (q tile, pair): o = sum_h gate_h o_h, fc, output
//                       dropout, residual, LayerNorm
//   backward  gate, then
//             out_bwd   (q tile, pair): fc and LayerNorm forward and backward
//                       (dy, dy0, do = dy0 fc^T), per-tile partials of the
//                       LayerNorm scale and bias and of dgate = sum_t do o_h
//             gate_bwd  (pair): the partials in tile order, the softmax
//                       backward, du = dlogit sk_w^T / Tq
//             core_bwd_q  (q tile, head, pair): row max and sum again,
//                       rowdot = sum_d do_h o_h (equal to sum_c P dP, and
//                       complete without a pass over the keys), then per key
//                       tile dS = P (dP - rowdot) and dz += dS k; writes the
//                       row statistics
//             core_bwd_kv (key tile, head, pair): per q tile, P and dS from
//                       the row statistics, dv += (P ak)^T do_h, dk += dS^T q
// Sums across tiles are taken by one block in tile order, no atomics: a step
// is deterministic.  Padded key columns get a score of -inf (their exp is
// exactly 0); padded query rows are computed and never stored.
//
// What bounds it on the H100: operations.  At the co-attention's shapes the
// 1900-row projections are ~75% of the work (on csrc/gemm.cu); the tiles here
// are CUDA-core FMAs with 4 x 4 outputs per thread.  Tensor cores and fewer
// trips through device memory are later work.

#include <type_traits>

#include "attn_drop.cuh"
#include "common.cuh"
#include "philox.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ait::AttnDrop;
using ait::Proj;
using ait::make_proj;
using ait::attn_factor;
using ait::out_factors;

constexpr int kD = 512;
constexpr int kHeads = 8;
constexpr int kDk = 64;
constexpr int kHD = kHeads * kDk;
constexpr int kT = 64;            // tile of query rows, and of keys
constexpr int kThreads = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLd = kDk + 4;      // rows of the q, k, v and do_h tiles
constexpr int kLds = kT + 1;      // rows of the score tiles
constexpr int kTile = kT * kLd;
constexpr int kGateThreads = 1024;

// dst[r][0..63] = scale * src[(row0 + r) * rs + 0..63] for row0 + r < rows,
// else 0
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int rs, int row0, int rows,
                                          float scale, float* dst) {
  for (int e = threadIdx.x; e < kT * kDk / 4; e += kThreads) {
    const int r = e >> 4, c = (e & 15) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) {
      v = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * rs + c);
      v.x *= scale;
      v.y *= scale;
      v.z *= scale;
      v.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * kLd + c) = v;
  }
}

// s[i][j] = sum_d a[ty + 16 i][d] b[tx + 16 j][d] over two [64][kLd] tiles
__device__ __forceinline__ void dot_rows(const float* a, const float* b,
                                         float s[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kDk; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * kLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += av[i] * bv[j];
  }
}

// acc[i][j] += sum_r a[r][ty + 16 i] b[r][tx + 16 j] (a: [64][lda])
__device__ __forceinline__ void dot_cols(const float* a, int lda,
                                         const float* b, float acc[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int r = 0; r < kT; ++r) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[r * lda + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[r * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
  }
}

// acc[i][j] += sum_c p[ty + 16 i][c] b[c][tx + 16 j] (p: [64][kLds])
__device__ __forceinline__ void dot_pv(const float* p, const float* b,
                                       float acc[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
  for (int c = 0; c < kT; ++c) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = p[(ty + 16 * i) * kLds + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[c * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
  }
}

// the masked score of query row gr and key gc: -inf for a padded key (its
// exp is exactly 0), 0 for a padded query row (finite, never stored)
__device__ __forceinline__ float masked(float s, const uint8_t* __restrict__ mask,
                                        int gr, int gc, int tq, int tk) {
  if (gc >= tk) return -CUDART_INF_F;
  if (gr >= tq) return 0.f;
  return mask[(size_t)gr * tk + gc] ? s : -1e9f;
}

// m[r] = max_c score and l[r] = sum_c exp(score - m[r]) over all tk keys for
// the 64 query rows at qs (rows r0.. of the pair); kb: the head's k rows of
// the pair.  Uses ks and sc; ends with a barrier.
__device__ __forceinline__ void row_stats(const float* qs, float* ks, float* sc,
                                          float* m, float* l,
                                          const float* __restrict__ kb, int rs,
                                          const uint8_t* __restrict__ mask,
                                          int r0, int tq, int tk) {
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int warp = t >> 5, lane = t & 31;
  if (t < kT) {
    m[t] = -CUDART_INF_F;
    l[t] = 0.f;
  }
  for (int c0 = 0; c0 < tk; c0 += kT) {
    load_tile(kb, rs, c0, tk, 1.f, ks);
    __syncthreads();
    float s[4][4];
    dot_rows(qs, ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        sc[r * kLds + c] = masked(s[i][j], mask, r0 + r, c0 + c, tq, tk);
      }
    __syncthreads();
    for (int r = warp; r < kT; r += kThreads / 32) {
      const float v0 = sc[r * kLds + lane], v1 = sc[r * kLds + lane + 32];
      const float mo = m[r], lo = l[r];
      const float mn = fmaxf(mo, ait::warp_max(fmaxf(v0, v1)));
      const float sum = ait::warp_sum(expf(v0 - mn) + expf(v1 - mn));
      __syncwarp();
      if (lane == 0) {
        m[r] = mn;
        l[r] = lo * expf(mo - mn) + sum;
      }
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------------ forward

constexpr int kFwdSmem = 3 * kTile + kT * kLds + 2 * kT;   // floats

// grid (q tiles, heads, pairs).  qsv/ksv/vsv: null, or the save-qkv outputs
// [H, P*T, 64] (q scaled), written by the blocks that hold the tiles.
__global__ void __launch_bounds__(kThreads)
core_fwd(Proj pj, const uint8_t* __restrict__ mask, float* __restrict__ oh,
         float* __restrict__ qsv, float* __restrict__ ksv,
         float* __restrict__ vsv, int pairs, int tq, int tk, AttnDrop drop) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* ks = qs + kTile;
  float* vs = ks + kTile;
  float* sc = vs + kTile;
  float* m = sc + kT * kLds;
  float* l = m + kT;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int r0 = blockIdx.x * kT, h = blockIdx.y, pair = blockIdx.z;
  const uint2 key = drop.seed != nullptr ? ait::seed_key(drop.seed)
                                         : make_uint2(0u, 0u);
  const float* qb = pj.q + (size_t)pair * tq * pj.rs + h * pj.q_hs;
  const float* kb = pj.k + (size_t)pair * tk * pj.rs + h * pj.kv_hs;
  const float* vb = pj.v + (size_t)pair * tk * pj.rs + h * pj.kv_hs;
  const size_t qhead = ((size_t)h * pairs + pair) * tq;   // flat row of o_h
  const size_t khead = ((size_t)h * pairs + pair) * tk;

  load_tile(qb, pj.rs, r0, tq, pj.qscale, qs);
  row_stats(qs, ks, sc, m, l, kb, pj.rs, mask, r0, tq, tk);
  if (qsv != nullptr)
    for (int e = t; e < kT * kDk; e += kThreads) {
      const int r = e / kDk, c = e % kDk;
      if (r0 + r < tq) qsv[(qhead + r0 + r) * kDk + c] = qs[r * kLd + c];
    }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int c0 = 0; c0 < tk; c0 += kT) {
    load_tile(kb, pj.rs, c0, tk, 1.f, ks);
    load_tile(vb, pj.rs, c0, tk, 1.f, vs);
    __syncthreads();
    if (ksv != nullptr && blockIdx.x == 0)
      for (int e = t; e < kT * kDk; e += kThreads) {
        const int r = e / kDk, c = e % kDk;
        if (c0 + r < tk) {
          ksv[(khead + c0 + r) * kDk + c] = ks[r * kLd + c];
          vsv[(khead + c0 + r) * kDk + c] = vs[r * kLd + c];
        }
      }
    float s[4][4];
    dot_rows(qs, ks, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int gr = r0 + r, gc = c0 + c;
        float p = 0.f;
        if (gc < tk) {
          p = expf(masked(s[i][j], mask, gr, gc, tq, tk) - m[r]) / l[r];
          if (drop.on() && gr < tq)
            p *= attn_factor(drop, key, h, pair, pairs, tq, tk, gr, gc);
        }
        sc[r * kLds + c] = p;
      }
    __syncthreads();
    dot_pv(sc, vs, acc);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = r0 + ty + 16 * i;
      if (gr < tq) oh[(qhead + gr) * kDk + tx + 16 * j] = acc[i][j];
    }
}

// grid (pairs): s = mean over rows of the head sum (rows r = g, g + 16, ...
// per thread group g, the 16 groups then in order), the gate's Linear, and
// its softmax over heads per channel; writes s [P, 64] and gate [P, 512]
template <typename T>
__global__ void __launch_bounds__(kGateThreads)
gate_kernel(const float* __restrict__ oh, const T* __restrict__ skw,
            const T* __restrict__ skb, float* __restrict__ s_out,
            float* __restrict__ gate_out, int tq) {
  __shared__ float part[kGateThreads / kDk][kDk];
  __shared__ float sv[kDk];
  __shared__ float gt[kHD];
  const int t = threadIdx.x, c = t & (kDk - 1), g = t / kDk;
  const int pair = blockIdx.x, pairs = gridDim.x;
  float acc = 0.f;
  for (int r = g; r < tq; r += kGateThreads / kDk) {
    float u = 0.f;
#pragma unroll
    for (int h = 0; h < kHeads; ++h)
      u += oh[(((size_t)h * pairs + pair) * tq + r) * kDk + c];
    acc += u;
  }
  part[g][c] = acc;
  __syncthreads();
  if (t < kDk) {
    float a = 0.f;
    for (int i = 0; i < kGateThreads / kDk; ++i) a += part[i][t];
    sv[t] = a / tq;
    s_out[(size_t)pair * kDk + t] = sv[t];
  }
  __syncthreads();
  for (int o = t; o < kHD; o += kGateThreads) {
    float a = 0.f;
    for (int d = 0; d < kDk; ++d) a += sv[d] * ait::to_float(skw[d * kHD + o]);
    gt[o] = a + ait::to_float(skb[o]);
  }
  __syncthreads();
  if (t < kDk) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int h = 0; h < kHeads; ++h) mx = fmaxf(mx, gt[h * kDk + t]);
    float e[kHeads], sum = 0.f;
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      e[h] = expf(gt[h * kDk + t] - mx);
      sum += e[h];
    }
#pragma unroll
    for (int h = 0; h < kHeads; ++h)
      gate_out[(size_t)pair * kHD + h * kDk + t] = e[h] / sum;
  }
}

// shared memory of out_fwd and out_bwd, in floats
constexpr int kOOffGm = 0;                      // gate [8][64]
constexpr int kOOffOs = kOOffGm + kHD;          // o, rounded [64][64]
constexpr int kOOffDo = kOOffOs + kT * kDk;     // do [64][64] (backward)
constexpr int kOOffFc = kOOffDo + kT * kDk;     // fc as f32 [64][512]
constexpr int kOOffYt = kOOffFc + kDk * kD;     // y0, then dy0 [16][512]
constexpr int kOutSmem = kOOffYt + 16 * kD;
static_assert(kOutSmem * 4 <= 232448, "shared memory of one block");
static_assert(2 * (kThreads / 32) * kD <= kDk * kD, "LN partials fit in fc's place");

// the gate and fc into shared memory (no barrier)
template <typename T>
__device__ __forceinline__ void stage_gate_fc(const float* __restrict__ gate,
                                              const T* __restrict__ fcw,
                                              int pair, float* gm, float* fcs) {
  const int t = threadIdx.x;
  for (int o = t; o < kHD; o += kThreads) gm[o] = gate[(size_t)pair * kHD + o];
  for (int v = t; v < kDk * kD / 8; v += kThreads) {
    float a[8];
    ait::load8(fcw + (size_t)v * 8, a);
    ait::store8(fcs + v * 8, a);
  }
}

// os[r][c] = the gated head sum of row r0 + r rounded to the storage type
// (the fc input), 0 beyond `rows`; also to o_out [P*Tq, 64] where given
template <typename T>
__device__ __forceinline__ void gated_sum(const float* __restrict__ oh,
                                          const float* gm, const T* type_of,
                                          int pairs, int pair, int tq, int r0,
                                          int rows, float* os,
                                          float* __restrict__ o_out) {
  for (int e = threadIdx.x; e < kT * kDk; e += kThreads) {
    const int r = e / kDk, c = e % kDk;
    float v = 0.f;
    if (r < rows) {
      float acc = 0.f;
#pragma unroll
      for (int h = 0; h < kHeads; ++h)
        acc += oh[(((size_t)h * pairs + pair) * tq + r0 + r) * kDk + c] *
               gm[h * kDk + c];
      v = ait::round_to(acc, type_of);
      if (o_out != nullptr) o_out[((size_t)pair * tq + r0 + r) * kDk + c] = v;
    }
    os[e] = v;
  }
}

// yt[i][n] = sum_d os16[i][d] fcs[d][n] for 16 rows: thread (row t / 16,
// columns t % 16 + 16 j)
__device__ __forceinline__ void fc_rows(const float* os16, const float* fcs,
                                        float* yt) {
  const int t = threadIdx.x, tx = t & 15, i = t >> 4;
  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
  for (int d = 0; d < kDk; ++d) {
    const float a = os16[i * kDk + d];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] += a * fcs[d * kD + tx + 16 * j];
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) yt[i * kD + tx + 16 * j] = acc[j];
}

// grid (q tiles, pairs)
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
out_fwd(const float* __restrict__ oh, const float* __restrict__ gate,
        const T* __restrict__ fcw, const T* __restrict__ xq,
        const float* __restrict__ lns, const float* __restrict__ lnb,
        T* __restrict__ out, int tq, AttnDrop drop) {
  extern __shared__ __align__(16) float sm[];
  float* gm = sm + kOOffGm;
  float* os = sm + kOOffOs;
  float* fcs = sm + kOOffFc;
  float* yt = sm + kOOffYt;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int r0 = blockIdx.x * kT, pair = blockIdx.y, pairs = gridDim.y;
  const int rows = min(kT, tq - r0);
  const uint2 key = drop.seed != nullptr ? ait::seed_key(drop.seed)
                                         : make_uint2(0u, 0u);
  const size_t row0 = (size_t)pair * tq + r0;
  stage_gate_fc(gate, fcw, pair, gm, fcs);
  __syncthreads();
  gated_sum(oh, gm, xq, pairs, pair, tq, r0, rows, os, nullptr);
  __syncthreads();
  for (int i0 = 0; i0 < rows; i0 += 16) {
    fc_rows(os + i0 * kDk, fcs, yt);
    __syncthreads();
    for (int i = warp; i < 16; i += kThreads / 32) {   // one warp per row
      const int r = i0 + i;
      if (r >= rows) continue;
      float v[16];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = j * 256 + lane * 8;
        float a[8], mk[8];
        ait::load8(xq + (row0 + r) * kD + c, a);
        out_factors(drop, key, pair, tq, r0 + r, c, mk);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[j * 8 + e] = yt[i * kD + c + e] * mk[e] + a[e];
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
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = j * 256 + lane * 8;
        float o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] = (v[j * 8 + e] - mu) * rs * lns[c + e] + lnb[c + e];
        ait::store8(out + (row0 + r) * kD + c, o);
      }
    }
    __syncthreads();
  }
}

// ----------------------------------------------------------------- backward

// grid (q tiles, pairs).  Writes dy (the LayerNorm input's cotangent), dy0
// (fc's output cotangent, with dropout; else it is dy), o, do [P*Tq, 64], and
// per tile the LayerNorm partials and dgate partials [P * tiles, 512].
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
out_bwd(const float* __restrict__ oh, const float* __restrict__ gate,
        const T* __restrict__ fcw, const T* __restrict__ xq,
        const float* __restrict__ lns, const T* __restrict__ g,
        float* __restrict__ dy_out, float* __restrict__ dy0_out,
        float* __restrict__ o_out, float* __restrict__ do_out,
        float* __restrict__ lnp_s, float* __restrict__ lnp_b,
        float* __restrict__ dgp, int tq, AttnDrop drop) {
  extern __shared__ __align__(16) float sm[];
  float* gm = sm + kOOffGm;
  float* os = sm + kOOffOs;
  float* dos = sm + kOOffDo;
  float* fcs = sm + kOOffFc;
  float* yt = sm + kOOffYt;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int r0 = blockIdx.x * kT, pair = blockIdx.y, pairs = gridDim.y;
  const int rows = min(kT, tq - r0);
  const size_t tile = (size_t)pair * gridDim.x + blockIdx.x;
  const uint2 key = drop.seed != nullptr ? ait::seed_key(drop.seed)
                                         : make_uint2(0u, 0u);
  const size_t row0 = (size_t)pair * tq + r0;
  stage_gate_fc(gate, fcw, pair, gm, fcs);
  for (int e = t; e < kT * kDk; e += kThreads) dos[e] = 0.f;
  __syncthreads();
  gated_sum(oh, gm, xq, pairs, pair, tq, r0, rows, os, o_out);
  __syncthreads();
  float ps[16], pb[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) ps[i] = pb[i] = 0.f;
  for (int i0 = 0; i0 < rows; i0 += 16) {
    fc_rows(os + i0 * kDk, fcs, yt);
    __syncthreads();
    for (int i = warp; i < 16; i += kThreads / 32) {   // one warp per row
      const int r = i0 + i;
      if (r >= rows) continue;
      float y[16], gv[16], mk[16];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = j * 256 + lane * 8;
        float a[8], q[8];
        ait::load8(xq + (row0 + r) * kD + c, a);
        ait::load8(g + (row0 + r) * kD + c, q);
        out_factors(drop, key, pair, tq, r0 + r, c, mk + j * 8);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          y[j * 8 + e] = yt[i * kD + c + e] * mk[j * 8 + e] + a[e];
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
          o0[e] = o[e] * mk[j * 8 + e];       // fc's cotangent: dy * ok / kp
          yt[i * kD + c + e] = o0[e];
        }
        ait::store8(dy_out + (row0 + r) * kD + c, o);
        if (drop.on()) ait::store8(dy0_out + (row0 + r) * kD + c, o0);
      }
    }
    __syncthreads();
    // do = dy0 @ fc^T: warp w takes 128 of the 16 x 64 outputs, lanes split n
    for (int k = 0; k < 128; ++k) {
      const int idx = warp * 128 + k, i = idx / kDk, c = idx % kDk;
      if (i0 + i >= rows) continue;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < kD / 32; ++n)
        acc += yt[i * kD + lane + 32 * n] * fcs[c * kD + lane + 32 * n];
      acc = ait::warp_sum(acc);
      if (lane == 0) {
        dos[(i0 + i) * kDk + c] = acc;
        do_out[(row0 + i0 + i) * kDk + c] = acc;
      }
    }
    __syncthreads();
  }
  {  // LayerNorm partials of this tile: the 8 warps in order
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
      lnp_s[tile * kD + c] = a;
      lnp_b[tile * kD + c] = b;
    }
  }
  // this tile's part of dgate_h = sum_t do o_h
  for (int o = t; o < kHD; o += kThreads) {
    const int h = o / kDk, c = o % kDk;
    float acc = 0.f;
    for (int r = 0; r < rows; ++r)
      acc += dos[r * kDk + c] *
             oh[(((size_t)h * pairs + pair) * tq + r0 + r) * kDk + c];
    dgp[tile * kHD + o] = acc;
  }
}

// grid (pairs), 512 threads: dgate from the tiles' partials in tile order,
// the softmax-over-heads backward (dlogit [P, 512]) and du = dlogit sk_w^T /
// Tq [P, 64]
template <typename T>
__global__ void __launch_bounds__(kHD)
gate_bwd(const float* __restrict__ gate, const float* __restrict__ dgp,
         const T* __restrict__ skw, float* __restrict__ dgl_out,
         float* __restrict__ du_out, int tiles, int tq) {
  __shared__ float gm[kHD];
  __shared__ float dg[kHD];
  const int t = threadIdx.x, pair = blockIdx.x;
  float acc = 0.f;
  for (int i = 0; i < tiles; ++i)
    acc += dgp[((size_t)pair * tiles + i) * kHD + t];
  dg[t] = acc;
  gm[t] = gate[(size_t)pair * kHD + t];
  __syncthreads();
  if (t < kDk) {
    float gdot = 0.f;
#pragma unroll
    for (int h = 0; h < kHeads; ++h) gdot += gm[h * kDk + t] * dg[h * kDk + t];
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      const float v = gm[h * kDk + t] * (dg[h * kDk + t] - gdot);
      dg[h * kDk + t] = v;
      dgl_out[(size_t)pair * kHD + h * kDk + t] = v;
    }
  }
  __syncthreads();
  if (t < kDk) {
    float a = 0.f;
    for (int o = 0; o < kHD; ++o) a += dg[o] * ait::to_float(skw[t * kHD + o]);
    du_out[(size_t)pair * kDk + t] = a / tq;
  }
}

// do_h tile: doh[r][c] = do[r0 + r][c] gate_h[c] + du[c], 0 beyond tq
__device__ __forceinline__ void load_doh(const float* __restrict__ dos,
                                         const float* __restrict__ gate,
                                         const float* __restrict__ du,
                                         int pair, int h, int tq, int r0,
                                         float* doh) {
  for (int e = threadIdx.x; e < kT * kDk; e += kThreads) {
    const int r = e / kDk, c = e % kDk;
    float v = 0.f;
    if (r0 + r < tq)
      v = dos[((size_t)pair * tq + r0 + r) * kDk + c] *
              gate[(size_t)pair * kHD + h * kDk + c] +
          du[(size_t)pair * kDk + c];
    doh[r * kLd + c] = v;
  }
}

constexpr int kBwdQSmem = 4 * kTile + kT * kLds + 3 * kT;    // floats
constexpr int kBwdKvSmem = 4 * kTile + 2 * kT * kLds;

// grid (q tiles, heads, pairs).  stats [3][H * P * Tq]: row max, row sum and
// rowdot, for core_bwd_kv; dz [P*Tq, 512] (head h in columns 64h..).
__global__ void __launch_bounds__(kThreads)
core_bwd_q(Proj pj, const uint8_t* __restrict__ mask,
           const float* __restrict__ oh, const float* __restrict__ dos,
           const float* __restrict__ gate, const float* __restrict__ du,
           float* __restrict__ stats, float* __restrict__ dz, int pairs,
           int tq, int tk, AttnDrop drop) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* ks = qs + kTile;
  float* vs = ks + kTile;
  float* doh = vs + kTile;
  float* sc = doh + kTile;
  float* m = sc + kT * kLds;
  float* l = m + kT;
  float* rd = l + kT;
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int warp = t >> 5, lane = t & 31;
  const int r0 = blockIdx.x * kT, h = blockIdx.y, pair = blockIdx.z;
  const uint2 key = drop.seed != nullptr ? ait::seed_key(drop.seed)
                                         : make_uint2(0u, 0u);
  const float* qb = pj.q + (size_t)pair * tq * pj.rs + h * pj.q_hs;
  const float* kb = pj.k + (size_t)pair * tk * pj.rs + h * pj.kv_hs;
  const float* vb = pj.v + (size_t)pair * tk * pj.rs + h * pj.kv_hs;
  const size_t qhead = ((size_t)h * pairs + pair) * tq;

  load_tile(qb, pj.rs, r0, tq, pj.qscale, qs);
  load_doh(dos, gate, du, pair, h, tq, r0, doh);
  __syncthreads();
  // rowdot = sum_c P dP = sum_d do_h o_h (o_h is the post-dropout P v)
  for (int r = warp; r < kT; r += kThreads / 32) {
    float v = 0.f;
    if (r0 + r < tq) {
      const float* o = oh + (qhead + r0 + r) * kDk;
      v = doh[r * kLd + lane] * o[lane] + doh[r * kLd + lane + 32] * o[lane + 32];
    }
    v = ait::warp_sum(v);
    if (lane == 0) rd[r] = v;
  }
  row_stats(qs, ks, sc, m, l, kb, pj.rs, mask, r0, tq, tk);
  if (t < kT && r0 + t < tq) {
    const size_t n = (size_t)kHeads * pairs * tq, i = qhead + r0 + t;
    stats[i] = m[t];
    stats[n + i] = l[t];
    stats[2 * n + i] = rd[t];
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int c0 = 0; c0 < tk; c0 += kT) {
    load_tile(kb, pj.rs, c0, tk, 1.f, ks);
    load_tile(vb, pj.rs, c0, tk, 1.f, vs);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_rows(qs, ks, s);
    dot_rows(doh, vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int gr = r0 + r, gc = c0 + c;
        float ds = 0.f;
        if (gr < tq && gc < tk) {
          const float p =
              expf(masked(s[i][j], mask, gr, gc, tq, tk) - m[r]) / l[r];
          const float f = drop.on() ? attn_factor(drop, key, h, pair, pairs,
                                                  tq, tk, gr, gc)
                                    : 1.f;
          ds = p * (dp[i][j] * f - rd[r]);
        }
        sc[r * kLds + c] = ds;
      }
    __syncthreads();
    dot_pv(sc, ks, acc);   // dz += dS k
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gr = r0 + ty + 16 * i;
      if (gr < tq)
        dz[((size_t)pair * tq + gr) * kHD + h * kDk + tx + 16 * j] =
            acc[i][j] * 0.125f;
    }
}

// grid (key tiles, heads, pairs): dk, dv [P*Tk, 512] of this block's 64 keys,
// summed over the q tiles in order
__global__ void __launch_bounds__(kThreads)
core_bwd_kv(Proj pj, const uint8_t* __restrict__ mask,
            const float* __restrict__ dos, const float* __restrict__ gate,
            const float* __restrict__ du, const float* __restrict__ stats,
            float* __restrict__ dk, float* __restrict__ dv, int pairs, int tq,
            int tk, AttnDrop drop) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* ks = qs + kTile;
  float* vs = ks + kTile;
  float* doh = vs + kTile;
  float* pm = doh + kTile;            // P ak / kp
  float* dsm = pm + kT * kLds;        // dS
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int c0 = blockIdx.x * kT, h = blockIdx.y, pair = blockIdx.z;
  const uint2 key = drop.seed != nullptr ? ait::seed_key(drop.seed)
                                         : make_uint2(0u, 0u);
  const float* qb = pj.q + (size_t)pair * tq * pj.rs + h * pj.q_hs;
  const float* kb = pj.k + (size_t)pair * tk * pj.rs + h * pj.kv_hs;
  const float* vb = pj.v + (size_t)pair * tk * pj.rs + h * pj.kv_hs;
  const size_t qhead = ((size_t)h * pairs + pair) * tq;
  const size_t n = (size_t)kHeads * pairs * tq;

  load_tile(kb, pj.rs, c0, tk, 1.f, ks);
  load_tile(vb, pj.rs, c0, tk, 1.f, vs);
  float adk[4][4], adv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) adk[i][j] = adv[i][j] = 0.f;
  for (int r0 = 0; r0 < tq; r0 += kT) {
    load_tile(qb, pj.rs, r0, tq, pj.qscale, qs);
    load_doh(dos, gate, du, pair, h, tq, r0, doh);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_rows(qs, ks, s);
    dot_rows(doh, vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, gr = r0 + r;
      float mr = 0.f, lr = 1.f, rdr = 0.f;
      if (gr < tq) {
        mr = stats[qhead + gr];
        lr = stats[n + qhead + gr];
        rdr = stats[2 * n + qhead + gr];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, gc = c0 + c;
        float pf = 0.f, ds = 0.f;
        if (gr < tq && gc < tk) {
          const float p =
              expf(masked(s[i][j], mask, gr, gc, tq, tk) - mr) / lr;
          const float f = drop.on() ? attn_factor(drop, key, h, pair, pairs,
                                                  tq, tk, gr, gc)
                                    : 1.f;
          pf = p * f;
          ds = p * (dp[i][j] * f - rdr);
        }
        pm[r * kLds + c] = pf;
        dsm[r * kLds + c] = ds;
      }
    }
    __syncthreads();
    dot_cols(pm, kLds, doh, adv);    // dv += (P ak / kp)^T do_h
    dot_cols(dsm, kLds, qs, adk);    // dk += dS^T (q / 8)
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = c0 + ty + 16 * i;
      if (gc < tk) {
        const size_t o = ((size_t)pair * tk + gc) * kHD + h * kDk + tx + 16 * j;
        dk[o] = adk[i][j];
        dv[o] = adv[i][j];
      }
    }
}

template <typename K>
int opt_in(K kernel, int floats) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      floats * (int)sizeof(float));
}

template <typename T>
int forward(const Proj& pj, const void* skw, const void* skb, const void* fcw,
            const void* xq, const void* lns, const void* lnb, const void* mask,
            void* oh, void* const* qkv, void* s, void* gate, void* out,
            int pairs, int tq, int tk, const AttnDrop& drop, cudaStream_t st) {
  const int tiles = (tq + kT - 1) / kT;
  int err = opt_in(core_fwd, kFwdSmem);
  if (err) return err;
  err = opt_in(out_fwd<T>, kOutSmem);
  if (err) return err;
  core_fwd<<<dim3(tiles, kHeads, pairs), kThreads, kFwdSmem * sizeof(float), st>>>(
      pj, (const uint8_t*)mask, (float*)oh, (float*)qkv[0], (float*)qkv[1],
      (float*)qkv[2], pairs, tq, tk, drop);
  gate_kernel<T><<<pairs, kGateThreads, 0, st>>>(
      (const float*)oh, (const T*)skw, (const T*)skb, (float*)s, (float*)gate,
      tq);
  out_fwd<T><<<dim3(tiles, pairs), kThreads, kOutSmem * sizeof(float), st>>>(
      (const float*)oh, (const float*)gate, (const T*)fcw, (const T*)xq,
      (const float*)lns, (const float*)lnb, (T*)out, tq, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const Proj& pj, const void* skw, const void* skb, const void* fcw,
             const void* xq, const void* lns, const void* mask, const void* oh,
             const void* g, void* const* o, int pairs, int tq, int tk,
             const AttnDrop& drop, cudaStream_t st) {
  // o: gate, s, dy, dy0, o, do, lnp_s, lnp_b, dgp, dgl, du, stats, dz, dk, dv
  const int qtiles = (tq + kT - 1) / kT, ktiles = (tk + kT - 1) / kT;
  int err = opt_in(out_bwd<T>, kOutSmem);
  if (err) return err;
  err = opt_in(core_bwd_q, kBwdQSmem);
  if (err) return err;
  err = opt_in(core_bwd_kv, kBwdKvSmem);
  if (err) return err;
  gate_kernel<T><<<pairs, kGateThreads, 0, st>>>(
      (const float*)oh, (const T*)skw, (const T*)skb, (float*)o[1],
      (float*)o[0], tq);
  out_bwd<T><<<dim3(qtiles, pairs), kThreads, kOutSmem * sizeof(float), st>>>(
      (const float*)oh, (const float*)o[0], (const T*)fcw, (const T*)xq,
      (const float*)lns, (const T*)g, (float*)o[2], (float*)o[3], (float*)o[4],
      (float*)o[5], (float*)o[6], (float*)o[7], (float*)o[8], tq, drop);
  gate_bwd<T><<<pairs, kHD, 0, st>>>(
      (const float*)o[0], (const float*)o[8], (const T*)skw, (float*)o[9],
      (float*)o[10], qtiles, tq);
  core_bwd_q<<<dim3(qtiles, kHeads, pairs), kThreads,
               kBwdQSmem * sizeof(float), st>>>(
      pj, (const uint8_t*)mask, (const float*)oh, (const float*)o[5],
      (const float*)o[0], (const float*)o[10], (float*)o[11], (float*)o[12],
      pairs, tq, tk, drop);
  core_bwd_kv<<<dim3(ktiles, kHeads, pairs), kThreads,
                kBwdKvSmem * sizeof(float), st>>>(
      pj, (const uint8_t*)mask, (const float*)o[5], (const float*)o[0],
      (const float*)o[10], (const float*)o[11], (float*)o[13], (float*)o[14],
      pairs, tq, tk, drop);
  return (int)cudaGetLastError();
}

bool bad_drop(const void* seed, const void* akeep, const void* okeep) {
  return (akeep == nullptr) != (okeep == nullptr) || (seed && akeep);
}

}  // namespace

// The forward from the projections q [P*Tq, 512], k, v [P*Tk, 512] (f32, q
// unscaled).  oh [8, P*Tq, 64], s [P, 64] and gate [P, 512] are f32 outputs
// (scratch at eval); out [P, Tq, 512] in the storage type.  qsv, ksv, vsv: all
// null, or the save-qkv outputs [8, P*T, 64] f32 (q scaled).  Dropout as in
// csrc/sh_attention.cu.
extern "C" int sh_attention_general_fwd(
    int bf16_io, const void* q, const void* k, const void* v, const void* skw,
    const void* skb, const void* fcw, const void* xq, const void* lns,
    const void* lnb, const void* mask, void* oh, void* qsv, void* ksv,
    void* vsv, void* s, void* gate, void* out, int pairs, int tq, int tk,
    const void* seed, const void* akeep, const void* okeep, unsigned thresh,
    float inv_keep, void* stream) {
  if (bad_drop(seed, akeep, okeep) || (qsv == nullptr) != (ksv == nullptr) ||
      (qsv == nullptr) != (vsv == nullptr))
    return (int)cudaErrorInvalidValue;
  const AttnDrop d{(const int*)seed, (const float*)akeep, (const float*)okeep,
                   thresh, inv_keep};
  const Proj pj = make_proj(q, k, v, 0, pairs, tq, tk);
  void* const qkv[3] = {qsv, ksv, vsv};
  cudaStream_t st = (cudaStream_t)stream;
  return bf16_io ? forward<bf16>(pj, skw, skb, fcw, xq, lns, lnb, mask, oh, qkv,
                                 s, gate, out, pairs, tq, tk, d, st)
                 : forward<float>(pj, skw, skb, fcw, xq, lns, lnb, mask, oh,
                                  qkv, s, gate, out, pairs, tq, tk, d, st);
}

// The per-pair part of the backward.  q, k, v: the projections [P*T, 512]
// (heads_major 0), or the forward's saved [8, P*T, 64] with q scaled
// (heads_major 1).  Outputs, all f32: gate [P, 512] (scratch), s [P, 64], dy
// and dy0 [P*Tq, 512] (dy0 null without dropout), o and do [P*Tq, 64], the
// LayerNorm and dgate partials [P * ceil(Tq / 64), 512] each, dlogit
// [P, 512], du [P, 64] (scratch), stats [3, 8 * P * Tq] (scratch), dz
// [P*Tq, 512], dk and dv [P*Tk, 512].
extern "C" int sh_attention_general_bwd(
    int bf16_io, int heads_major, const void* q, const void* k, const void* v,
    const void* skw, const void* skb, const void* fcw, const void* xq,
    const void* lns, const void* mask, const void* oh, const void* g,
    void* gate, void* s, void* dy, void* dy0, void* o, void* dout,
    void* lnp_s, void* lnp_b, void* dgp, void* dgl, void* du, void* stats,
    void* dz, void* dk, void* dv, int pairs, int tq, int tk, const void* seed,
    const void* akeep, const void* okeep, unsigned thresh, float inv_keep,
    void* stream) {
  if (bad_drop(seed, akeep, okeep) || ((seed || akeep) && dy0 == nullptr))
    return (int)cudaErrorInvalidValue;
  const AttnDrop d{(const int*)seed, (const float*)akeep, (const float*)okeep,
                   thresh, inv_keep};
  const Proj pj = make_proj(q, k, v, heads_major, pairs, tq, tk);
  void* const outs[15] = {gate, s,   dy,  dy0, o,     dout, lnp_s, lnp_b,
                          dgp,  dgl, du,  stats, dz,  dk,   dv};
  cudaStream_t st = (cudaStream_t)stream;
  return bf16_io ? backward<bf16>(pj, skw, skb, fcw, xq, lns, mask, oh, g,
                                  outs, pairs, tq, tk, d, st)
                 : backward<float>(pj, skw, skb, fcw, xq, lns, mask, oh, g,
                                   outs, pairs, tq, tk, d, st);
}
