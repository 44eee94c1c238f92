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
// from the wrapper, ops/fused_attention.py).  The wrapper's plan
// (ops/fused_attention.py::general_plan) splits the long side of a
// (head, pair) across blocks wherever the grid would leave the card's SMs
// idle, and every sum across blocks is a second pass in a fixed order:
//
//   forward   core_fwd  (q tile x key split, head, pair): per 64-key tile the
//                       scores, a running row max and sum (one pass, the
//                       accumulated P v rescaled when the max grows), the
//                       dropout factor on e^(s - m), P v, and the division
//                       by the row sum after the key loop (the reference
//                       puts the factor on the normalized probability: the
//                       same product in another rounding order); writes
//                       o_h [H, P*Tq, 64] and each tile's column sums of o_h
//                       (the gate's row-sum partials); with a key split, the
//                       unnormalized partial (m, l, o) per split instead
//             combine   (q tile, head, pair): the splits' (m, l, o) in split
//                       order, o = sum_s e^(m_s - M) o_s / L; o_h and its
//                       column sums
//             gate      (pair): s = the column sums in (tile, head) order /
//                       Tq, the gate's Linear and its softmax over heads
//             out_fwd   (persistent, 16-row items): o = sum_h gate_h o_h
//                       rounded to the storage type, fc, the output dropout,
//                       residual, LayerNorm
//   backward  gate_sums (q tile, head, pair): the column sums from the saved
//                       o_h, in the forward's order; then gate, then
//             out_bwd   (persistent, 16-row items): fc and the LayerNorm
//                       forward and backward (dy, dy0, do = dy0 fc^T), the
//                       item's LayerNorm partials and dgate = sum_t do o_h
//             gate_bwd  (pair): the items' dgate in order, the softmax
//                       backward, du = dlogit sk_w^T / Tq
//             core_bwd_q  (q tile x key split, head, pair): rowdot = sum_d
//                       do_h o_h (equal to sum_c P dP), then per key tile
//                       dS = P (dP - rowdot) with a running row max and sum
//                       as in core_fwd, dz += dS k; writes dz and the row
//                       statistics (with a key split: partials, combined by
//                       `combine` as in the forward)
//             core_bwd_kv (key tile x q split, head, pair): per q tile, P and
//                       dS from the row statistics, dv += (P ak)^T do_h,
//                       dk += dS^T q; with a q split, per-split partials
//                       that `reduce_kv` sums in split order
// No atomics: two calls give bit-equal results.  Padded key columns score
// -inf (their exp is exactly 0); padded query rows are computed and never
// stored; the mask gives -1e9; the LayerNorm eps is 1e-6.
//
// What bounds it on the H100: operations (the projections on csrc/gemm.cu
// are ~75% of them at the co-attention's shapes) and, at q2i, the bytes of
// o_h (31 MB a trip).  The design:
//   * every per-head product (the scores q k^T, P v, dP = do_h v^T, dS k,
//     (P ak)^T do_h, dS^T q) on mma.sync with both f32 operands in three
//     exact bf16 terms and six term products (csrc/split_mma.cuh, as the
//     per-pair backward): near-f32 products on the tensor cores; each
//     64-deep product lands in its own accumulator and is added to the
//     running sum in f32 (the tensor cores' additions truncate);
//   * one pass over the keys in core_fwd and core_bwd_q (running max and
//     sum), and the grid split over the long side (the keys at i2q, the
//     query tiles of core_bwd_kv at q2i);
//   * fc staged once per persistent block in the storage type, its two
//     products on mma.sync (bf16: o is bf16-exact, one term; dy0 in three
//     terms; f32, the parity path: six term products), 16-row items;
//   * o_h makes two trips (core_fwd writes it, out_fwd reads it): the gate's
//     row sums come from core_fwd's epilogue;
//   * the dropout factors from one Philox call per 4 probabilities
//     (attn_factors4, shared by a lane pair, as the per-pair backward).
// On the H100 the core kernels run latency-bound at 2 blocks (16 warps) an
// SM, as many as their registers allow; the six term products are about a
// third of their time (ops/attention_general.py emulates their sums).

#include <type_traits>

#include "attn_drop.cuh"
#include "common.cuh"
#include "hopper.cuh"
#include "philox.cuh"
#include "split_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ait::AttnDrop;
using ait::Proj;
using ait::make_proj;
using ait::out_factors;
using ait::split_mma;
using ait::store_frag;
using ait::swz;
using ait::zero44;

constexpr int kD = 512;
constexpr int kHeads = 8;
constexpr int kDk = 64;
constexpr int kHD = kHeads * kDk;
constexpr int kT = 64;             // rows of a core tile: query rows, or keys
constexpr int kTileF = kT * kDk;   // floats of a swizzled [64][64] tile
constexpr int kThreads = 256;      // 8 warps
constexpr int kRows = 16;          // rows of an out_fwd / out_bwd item
constexpr int kFcLd = kD + 8;      // row stride of the staged fc (elements)
constexpr int kYLd = kD + 4;       // row stride of fc's f32 output rows
constexpr int kOLd = kDk + 4;      // row stride of the o and do rows

// ------------------------------------------------------------ tiles, rows

// rows r0.. of one pair's head (src: its row 0, row stride rs), n rows in
// all, into the swizzled tile at shared address dst; zero past n (cp.async,
// uncommitted)
__device__ __forceinline__ void load_tile(const float* src, int rs, int r0,
                                          int n, uint32_t dst) {
  for (int e = threadIdx.x; e < kT * 16; e += kThreads) {
    const int r = e >> 4, c = (e & 15) * 4;
    const bool ok = r0 + r < n;
    hopper::cp_async16(dst + 4 * swz(r, c),
                       src + (size_t)(ok ? r0 + r : 0) * rs + c, ok ? 16 : 0);
  }
}

// rows 0..n-1 of the swizzled tile X * scale into rows of dst (row stride
// ld): 16-byte stores, 16 threads a row
__device__ __forceinline__ void store_rows(float* __restrict__ dst, int ld,
                                           const float* X, int n,
                                           float scale) {
  for (int e = threadIdx.x; e < n * 16; e += kThreads) {
    const int r = e >> 4, c = (e & 15) * 4;
    float4 v = *reinterpret_cast<const float4*>(X + swz(r, c));
    v.x *= scale;
    v.y *= scale;
    v.z *= scale;
    v.w *= scale;
    *reinterpret_cast<float4*>(dst + (size_t)r * ld + c) = v;
  }
}

// the gate's row-sum partial of one (q tile, head, pair): dst[c] = the sum
// over rows 0..n-1 of X[r][c]: each quarter of 16 rows in row order, then
// the four quarters in order (the forward's epilogue, `combine` and
// `gate_sums` all sum this way, so the backward rebuilds the gate bit for
// bit).  All threads; `quarters` [4][64] of shared scratch
__device__ __forceinline__ void tile_colsum(const float* X, int n,
                                            float* quarters,
                                            float* __restrict__ dst) {
  const int c = threadIdx.x & (kDk - 1), q = threadIdx.x >> 6;
  float s = 0.f;
  for (int r = 16 * q; r < min(n, 16 * q + 16); ++r) s += X[swz(r, c)];
  quarters[q * kDk + c] = s;
  __syncthreads();
  if (threadIdx.x < kDk)
    dst[c] = ((quarters[c] + quarters[kDk + c]) + quarters[2 * kDk + c]) +
             quarters[3 * kDk + c];
}

// the masked, scaled score of query row gr and key gc: -inf for a padded key
// (its exp is exactly 0), 0 for a padded query row (finite, never stored),
// -1e9 where the mask is off
__device__ __forceinline__ float masked(float s,
                                        const uint8_t* __restrict__ mask,
                                        int gr, int gc, int tq, int tk) {
  if (gc >= tk) return -CUDART_INF_F;
  if (gr >= tq) return 0.f;
  return mask[(size_t)gr * tk + gc] ? s : -1e9f;
}

// The warp's fragment of a 64 x 64 block of the scores (split_mma's layout:
// element (j, e) at row ra + 8 (e / 2), column n0 + 8 j + t2 + e % 2):
// the probability dropout's factors ak / kp of head h, 0 outside [tq, tk].
// A lane pair shares a group of 4 columns: the even lane draws row ra's
// group, the odd one row ra + 8's, and they swap the halves the other needs.
// gr, gc: the fragment's first row and column in the pair's [tq, tk] block
__device__ __forceinline__ void frag_factors(const AttnDrop& d, uint2 key,
                                             int h, int pair, int pairs,
                                             int tq, int tk, int gr, int gc,
                                             int lane, float (&fa)[4][4]) {
  const bool odd = lane & 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int cb = gc + 8 * j + 4 * ((lane & 3) >> 1);
    const float4 f = ait::attn_factors4(d, key, h, pair, pairs, tq, tk,
                                        odd ? gr + 8 : gr, cb);
    const float s0 = odd ? f.x : f.z, s1 = odd ? f.y : f.w;
    const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    fa[j][0] = odd ? r0 : f.x;
    fa[j][1] = odd ? r1 : f.y;
    fa[j][2] = odd ? f.z : r0;
    fa[j][3] = odd ? f.w : r1;
  }
}

// the fragment's row maxima (rows ra, ra + 8) over the lane quad
__device__ __forceinline__ void quad_max(float (&m)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
    m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
  }
}

__device__ __forceinline__ void quad_sum(float (&s)[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 1);
    s[hh] += __shfl_xor_sync(0xffffffffu, s[hh], 2);
  }
}

// ------------------------------------------------ one pass over the keys

// What core_fwd and core_bwd_q share: warp w computes rows 16 (w % 4) ..
// of a 64 x 64 tile's products, columns 32 (w / 4) ..; a row spans warps w
// and w + 4, which meet at named barrier 1 + w % 4 to agree on its running
// max.  The q tile, and a ring of two k and v tiles for the key tiles
// kt0..kt1-1 (the next tile's cp.async copies in flight while one is
// computed).
struct KeyPass {
  int mb, nh, m0, n0, ra, t2, lane;
  float m[2], l[2];   // running row max, and the lane's part of the sum

  __device__ __forceinline__ KeyPass() {
    const int warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    mb = warp & 3;
    nh = warp >> 2;
    m0 = 16 * mb;
    n0 = 32 * nh;
    ra = m0 + (lane >> 2);
    t2 = 2 * (lane & 3);
    m[0] = m[1] = -CUDART_INF_F;
    l[0] = l[1] = 0.f;
  }

  // masks and scales the scores `sc` of key tile c0 (rows r0..), raises the
  // running max with the partner warp's (rmax [2][64]), and turns sc into
  // P = exp(s - m) (0 past tk), adding it to l; returns alpha = exp(m_old -
  // m_new) per row, the factor that rescales what was summed so far
  __device__ __forceinline__ void softmax_step(float (&sc)[4][4], float qscale,
                                               const uint8_t* __restrict__ mask,
                                               int r0, int c0, int tq, int tk,
                                               float* rmax, float (&alpha)[2]) {
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = ra + 8 * (e >> 1), c = n0 + 8 * j + t2 + (e & 1);
        const float v =
            masked(sc[j][e] * qscale, mask, r0 + r, c0 + c, tq, tk);
        sc[j][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    quad_max(mx);
    if ((lane & 3) == 0) {
      rmax[nh * kT + ra] = mx[0];
      rmax[nh * kT + ra + 8] = mx[1];
    }
    hopper::named_sync(1 + mb, 64);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = ra + 8 * hh;
      const float mn = fmaxf(m[hh], fmaxf(rmax[r], rmax[kT + r]));
      alpha[hh] = expf(m[hh] - mn);   // 0 at the first tile (m = -inf)
      m[hh] = mn;
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n0 + 8 * j + t2 + (e & 1);
        const float p = c0 + c < tk ? expf(sc[j][e] - m[e >> 1]) : 0.f;
        sc[j][e] = p;
        l[e >> 1] += p;
      }
  }

  // the row sums of P over all keys of the pass: the lane quads', then the
  // two warps' (rsum [2][64])
  __device__ __forceinline__ void row_sums(float* rsum, float (&sum)[2]) {
    float s[2] = {l[0], l[1]};
    quad_sum(s);
    if ((lane & 3) == 0) {
      rsum[nh * kT + ra] = s[0];
      rsum[nh * kT + ra + 8] = s[1];
    }
    hopper::named_sync(1 + mb, 64);
    sum[0] = rsum[ra] + rsum[kT + ra];
    sum[1] = rsum[ra + 8] + rsum[kT + ra + 8];
  }
};

// acc = acc * alpha (per row) + part
__device__ __forceinline__ void rescale_add(float (&acc)[4][4],
                                            const float (&part)[4][4],
                                            const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[j][e] = acc[j][e] * alpha[e >> 1] + part[j][e];
}

// a fragment times a per-row factor into the swizzled tile X
__device__ __forceinline__ void store_frag_rows(float* X,
                                                const float (&acc)[4][4],
                                                int m0, int n0, int lane,
                                                const float (&f)[2]) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(X + swz(m0 + g + 8 * hh, n0 + 8 * j + t2)) =
          make_float2(acc[j][2 * hh] * f[hh], acc[j][2 * hh + 1] * f[hh]);
}

// ------------------------------------------------------------------ forward

// shared memory, bytes: core_fwd's swizzled tiles q, k and v twice, P, and
// the two warps' row maxima (then sums) [2][64]; core_bwd_q's q, do_h, k and
// v twice, dS, the row maxima and rowdot [64]; core_bwd_kv's k, v, q, do_h,
// P ak / kp and dS.  Two blocks an SM
constexpr int kFwdSmem = (6 * kTileF + 2 * kT) * 4;
constexpr int kBwdQSmem = (7 * kTileF + 3 * kT) * 4;
constexpr int kBwdKvSmem = 6 * kTileF * 4;
static_assert(2 * (kBwdQSmem + 1024) <= 233472, "two blocks an SM");

// Where a split's partials go: o (or dz) [splits, H, P*Tq, 64] unnormalized,
// and (m, l) [splits, 2, H * P * Tq]
struct Partials {
  float* x;
  float* ml;
};

// grid (q tiles x splits, heads, pairs); key split `split` takes key tiles
// split * chunk .. .  oh [H, P*Tq, 64] and colsum [P, q tiles, H, 64] where
// there is one split, else the partials.  qsv/ksv/vsv: null, or the
// save-qkv outputs [H, P*T, 64] (q scaled), written by split 0 (q) and by
// the blocks of q tile 0 (k, v)
__global__ void __launch_bounds__(kThreads, 2)
core_fwd(Proj pj, const uint8_t* __restrict__ mask, float* __restrict__ oh,
         float* __restrict__ colsum, Partials part, float* __restrict__ qsv,
         float* __restrict__ ksv, float* __restrict__ vsv, int pairs, int tq,
         int tk, int splits, int chunk, AttnDrop drop) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* ks = sm + kTileF;       // two buffers
  float* vs = sm + 3 * kTileF;   // two buffers
  float* ps = sm + 5 * kTileF;
  float* red = sm + 6 * kTileF;   // the row maxima, then the row sums
  const uint32_t base = hopper::smem_u32(sm);
  const int qt = blockIdx.x / splits, split = blockIdx.x - qt * splits;
  const int h = blockIdx.y, pair = blockIdx.z;
  const int r0 = qt * kT, qtiles = gridDim.x / splits;
  const int ktiles = (tk + kT - 1) / kT;
  const int kt0 = split * chunk, kt1 = min(ktiles, kt0 + chunk);
  const uint2 key = drop.seed != nullptr ? ait::seed_key(drop.seed)
                                         : make_uint2(0u, 0u);
  const float* qb = pj.q + (size_t)pair * tq * pj.rs + h * pj.q_hs;
  const float* kb = pj.k + (size_t)pair * tk * pj.rs + h * pj.kv_hs;
  const float* vb = pj.v + (size_t)pair * tk * pj.rs + h * pj.kv_hs;
  const size_t qhead = ((size_t)h * pairs + pair) * tq;   // flat row of o_h
  const size_t khead = ((size_t)h * pairs + pair) * tk;

  load_tile(qb, pj.rs, r0, tq, base);
  load_tile(kb, pj.rs, kt0 * kT, tk, base + 4 * kTileF);
  load_tile(vb, pj.rs, kt0 * kT, tk, base + 4 * 3 * kTileF);
  hopper::cp_async_commit();

  KeyPass kp;
  float acc[4][4];
  zero44(acc);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int b = (kt - kt0) & 1, c0 = kt * kT;
    const float* kbuf = ks + b * kTileF;
    const float* vbuf = vs + b * kTileF;
    hopper::cp_async_wait<0>();
    __syncthreads();   // tile kt is in; every warp is done with tile kt - 1
    if (kt + 1 < kt1) {
      load_tile(kb, pj.rs, c0 + kT, tk, base + 4 * (1 + (b ^ 1)) * kTileF);
      load_tile(vb, pj.rs, c0 + kT, tk, base + 4 * (3 + (b ^ 1)) * kTileF);
      hopper::cp_async_commit();
    }
    if (qsv != nullptr) {
      if (kt == kt0 && split == 0)
        store_rows(qsv + (qhead + r0) * kDk, kDk, qs, min(kT, tq - r0),
                   pj.qscale);
      if (qt == 0) {
        store_rows(ksv + (khead + c0) * kDk, kDk, kbuf, min(kT, tk - c0), 1.f);
        store_rows(vsv + (khead + c0) * kDk, kDk, vbuf, min(kT, tk - c0), 1.f);
      }
    }
    float sc[4][4], alpha[2];
    zero44(sc);
    split_mma<false, false>(sc, qs, kbuf, kp.m0, kp.n0, kp.lane);
    kp.softmax_step(sc, pj.qscale, mask, r0, c0, tq, tk, red, alpha);
    if (drop.on()) {   // on e^(s - m): the division by l follows the loop
      float fa[4][4];
      frag_factors(drop, key, h, pair, pairs, tq, tk, r0 + kp.ra,
                   c0 + kp.n0, kp.lane, fa);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= fa[j][e];
    }
    const float one[2] = {1.f, 1.f};
    store_frag_rows(ps, sc, kp.m0, kp.n0, kp.lane, one);
    hopper::named_sync(1 + kp.mb, 64);   // the row pair's P is complete
    float pv[4][4];
    zero44(pv);
    split_mma<false, true>(pv, ps, vbuf, kp.m0, kp.n0, kp.lane);
    rescale_add(acc, pv, alpha);
  }
  float l[2];
  kp.row_sums(red, l);   // also: the row pair is done with ps
  const int rows = min(kT, tq - r0);
  if (splits == 1) {
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    store_frag_rows(ps, acc, kp.m0, kp.n0, kp.lane, inv);
    __syncthreads();
    store_rows(oh + (qhead + r0) * kDk, kDk, ps, rows, 1.f);
    tile_colsum(ps, rows, qs,
                colsum + (((size_t)pair * qtiles + qt) * kHeads + h) * kDk);
    return;
  }
  const float one[2] = {1.f, 1.f};
  store_frag_rows(ps, acc, kp.m0, kp.n0, kp.lane, one);
  const size_t n = (size_t)kHeads * pairs * tq;
  if (kp.nh == 0 && (kp.lane & 3) == 0)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = kp.ra + 8 * hh;
      if (r0 + r < tq) {
        part.ml[(size_t)split * 2 * n + qhead + r0 + r] = kp.m[hh];
        part.ml[(size_t)split * 2 * n + n + qhead + r0 + r] = l[hh];
      }
    }
  __syncthreads();
  store_rows(part.x + ((size_t)split * n + qhead + r0) * kDk, kDk, ps, rows,
             1.f);
}

// grid (q tiles, heads, pairs): the splits' partials of 64 rows in split
// order, M = max_s m_s, L = sum_s e^(m_s - M) l_s, x = sum_s e^(m_s - M)
// x_s / L.  Forward: x is o_h, written with its column sums; backward: x is
// dz / 8's numerator, written as dz (head h in columns 64 h..) with the row
// statistics (M, L) in stats [3, H * P * Tq]
template <bool kFwd>
__global__ void __launch_bounds__(kThreads)
combine(Partials part, int splits, int pairs, int tq,
        float* __restrict__ out, float* __restrict__ colsum,
        float* __restrict__ stats) {
  __shared__ __align__(16) float xs[kTileF];
  __shared__ float ml[kT][2];   // per row: M and L
  __shared__ float quarters[4 * kDk];
  const int t = threadIdx.x, qt = blockIdx.x, h = blockIdx.y,
            pair = blockIdx.z;
  const int r0 = qt * kT, rows = min(kT, tq - r0);
  const size_t n = (size_t)kHeads * pairs * tq;
  const size_t qhead = ((size_t)h * pairs + pair) * tq;
  if (t < rows) {
    const size_t i = qhead + r0 + t;
    float mm = -CUDART_INF_F;
    for (int s = 0; s < splits; ++s) mm = fmaxf(mm, part.ml[s * 2 * n + i]);
    float big_l = 0.f;
    for (int s = 0; s < splits; ++s)
      big_l += part.ml[s * 2 * n + n + i] * expf(part.ml[s * 2 * n + i] - mm);
    ml[t][0] = mm;
    ml[t][1] = big_l;
    if (!kFwd) {
      stats[i] = mm;
      stats[n + i] = big_l;
    }
  }
  __syncthreads();
  for (int e = t; e < kT * 16; e += kThreads) {
    const int r = e >> 4, c = (e & 15) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      const size_t i = qhead + r0 + r;
      for (int s = 0; s < splits; ++s) {
        const float w = expf(part.ml[s * 2 * n + i] - ml[r][0]);
        const float4 x = *reinterpret_cast<const float4*>(
            part.x + ((size_t)s * n + i) * kDk + c);
        v.x += x.x * w;
        v.y += x.y * w;
        v.z += x.z * w;
        v.w += x.w * w;
      }
      const float lv = ml[r][1];
      v.x /= lv;
      v.y /= lv;
      v.z /= lv;
      v.w /= lv;
    }
    *reinterpret_cast<float4*>(xs + swz(r, c)) = v;
  }
  __syncthreads();
  if (kFwd) {
    store_rows(out + (qhead + r0) * kDk, kDk, xs, rows, 1.f);
    tile_colsum(xs, rows, quarters,
                colsum + (((size_t)pair * gridDim.x + qt) * kHeads + h) * kDk);
  } else {
    store_rows(out + ((size_t)pair * tq + r0) * kD + h * kDk, kD, xs, rows,
               0.125f);
  }
}

// grid (q tiles, heads, pairs): the gate's row-sum partials from the saved
// o_h, as core_fwd's epilogue sums them
__global__ void __launch_bounds__(kThreads)
gate_sums(const float* __restrict__ oh, float* __restrict__ colsum, int pairs,
          int tq) {
  __shared__ __align__(16) float xs[kTileF];
  __shared__ float quarters[4 * kDk];
  const int qt = blockIdx.x, h = blockIdx.y, pair = blockIdx.z;
  const int r0 = qt * kT, rows = min(kT, tq - r0);
  const float* src = oh + (((size_t)h * pairs + pair) * tq + r0) * kDk;
  for (int e = threadIdx.x; e < kT * 16; e += kThreads) {
    const int r = e >> 4, c = (e & 15) * 4;
    *reinterpret_cast<float4*>(xs + swz(r, c)) =
        r < rows ? *reinterpret_cast<const float4*>(src + (size_t)r * kDk + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  tile_colsum(xs, rows, quarters,
              colsum + (((size_t)pair * gridDim.x + qt) * kHeads + h) * kDk);
}

// grid (pairs), 512 threads: s = (sum over q tiles of the sum over heads of
// the row-sum partials) / Tq, the gate's Linear, its softmax over heads per
// channel; writes s [P, 64] and gate [P, 512]
template <typename T>
__global__ void __launch_bounds__(kHD)
gate_kernel(const float* __restrict__ colsum, const T* __restrict__ skw,
            const T* __restrict__ skb, float* __restrict__ s_out,
            float* __restrict__ gate_out, int qtiles, int tq) {
  __shared__ float sv[kDk];
  __shared__ float gt[kHD];
  const int t = threadIdx.x, pair = blockIdx.x;
  if (t < kDk) {
    float acc = 0.f;
#pragma unroll 8
    for (int qt = 0; qt < qtiles; ++qt) {
      const float* p = colsum + ((size_t)pair * qtiles + qt) * kHD + t;
      float u = 0.f;
#pragma unroll
      for (int h = 0; h < kHeads; ++h) u += p[h * kDk];
      acc += u;
    }
    sv[t] = acc / tq;
    s_out[(size_t)pair * kDk + t] = sv[t];
  }
  __syncthreads();
  float a = 0.f;
#pragma unroll 16
  for (int d = 0; d < kDk; ++d) a += sv[d] * ait::to_float(skw[d * kHD + t]);
  gt[t] = a + ait::to_float(skb[t]);
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

// ------------------------------------------- fc on mma.sync, 16-row items

// bf16 x bf16 operands are one term (o is rounded to bf16 before fc, fc is
// bf16): the product is exact in f32.  f32 (the parity path): three terms
template <typename T>
struct Terms {
  static constexpr int n = std::is_same<T, bf16>::value ? 1 : 3;
};

template <int NT>
__device__ __forceinline__ void to_terms(float a, float b, uint32_t (&t)[NT]) {
  if constexpr (NT == 1) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    t[0] = *reinterpret_cast<const uint32_t*>(&h);
  } else {
    hopper::split_pair(a, b, t[0], t[1], t[2]);
  }
}

// d += A B over the term products with i + j <= 2, smallest first
template <int NA, int NB>
__device__ __forceinline__ void mma_terms(float (&d)[4],
                                          const uint32_t (&a)[4][NA],
                                          const uint32_t (&b)[2][NB]) {
#pragma unroll
  for (int s = NA + NB - 2; s >= 0; --s)
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int j = s - i;
      if (j < 0 || j >= NB || i + j > 2) continue;
      const uint32_t ai[4] = {a[0][i], a[1][i], a[2][i], a[3][i]};
      hopper::mma_16816(d, ai, b[0][j], b[1][j]);
    }
}

// the A fragment (rows g, g + 8; columns k0 + t2 (+1), + 8) of 16 f32 rows
// (row stride ld) in NT terms
template <int NT>
__device__ __forceinline__ void a_frag(const float* A, int ld, int k0,
                                       int lane, uint32_t (&a)[4][NT]) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // rows g, g + 8, then columns + 8
    const float2 v = *reinterpret_cast<const float2*>(
        A + (g + 8 * (i & 1)) * ld + k0 + t2 + 8 * (i >> 1));
    to_terms<NT>(v.x, v.y, a[i]);
  }
}

// fc [64, 512] into shared memory in its storage type, row stride kFcLd
template <typename T>
__device__ __forceinline__ void stage_fc(const T* __restrict__ fcw, T* fcs) {
  constexpr int kPer = 16 / sizeof(T);
  for (int v = threadIdx.x; v < kDk * kD / kPer; v += kThreads) {
    const int r = v / (kD / kPer), c = (v % (kD / kPer)) * kPer;
    *reinterpret_cast<uint4*>(fcs + r * kFcLd + c) =
        *reinterpret_cast<const uint4*>(fcw + (size_t)r * kD + c);
  }
}

// y[16][512] = o[16][64] fc: warp w the columns 64 w .. 64 w + 63
template <typename T>
__device__ __forceinline__ void fc_fwd(const float* os, const T* fcs,
                                       float* ys) {
  constexpr int NT = Terms<T>::n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < kDk; k0 += 16) {
    uint32_t a[4][NT];
    a_frag<NT>(os, kOLd, k0, lane, a);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 64 * warp + 8 * j + g;
      uint32_t b[2][NT];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int k = k0 + t2 + 8 * q;
        to_terms<NT>(ait::to_float(fcs[k * kFcLd + n]),
                     ait::to_float(fcs[(k + 1) * kFcLd + n]), b[q]);
      }
      mma_terms<NT, NT>(acc[j], a, b);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(ys + (g + 8 * hh) * kYLd + 64 * warp + 8 * j +
                                 t2) =
          make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
}

// do[16][64] = dy0[16][512] fc^T: warp w the columns 8 w .. 8 w + 7, dy0 in
// three terms; each 64-deep stage summed in its own accumulator, then added
// in f32
template <typename T>
__device__ __forceinline__ void fc_bwd(const float* ys, const T* fcs,
                                       float* dos) {
  constexpr int NT = Terms<T>::n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int col = 8 * warp + g;   // fc's row for the B fragment
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int st = 0; st < kD; st += 64) {
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k0 = st; k0 < st + 64; k0 += 16) {
      uint32_t a[4][3];
      a_frag<3>(ys, kYLd, k0, lane, a);
      uint32_t b[2][NT];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int k = k0 + t2 + 8 * q;
        to_terms<NT>(ait::to_float(fcs[col * kFcLd + k]),
                     ait::to_float(fcs[col * kFcLd + k + 1]), b[q]);
      }
      mma_terms<3, NT>(sum, a, b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += sum[e];
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    *reinterpret_cast<float2*>(dos + (g + 8 * hh) * kOLd + 8 * warp + t2) =
        make_float2(acc[2 * hh], acc[2 * hh + 1]);
}

// shared memory of out_fwd and out_bwd, bytes: fc [64][kFcLd] in T, y
// [16][kYLd], o and do [16][kOLd], the pair's gate [512]
template <typename T>
struct OutSmem {
  static constexpr int kFc = kDk * kFcLd * (int)sizeof(T);
  static constexpr int kY = kFc;
  static constexpr int kO = kY + kRows * kYLd * 4;
  static constexpr int kDo = kO + kRows * kOLd * 4;
  static constexpr int kGm = kDo + kRows * kOLd * 4;
  static constexpr int kBytes = kGm + kHD * 4;
};
static_assert(OutSmem<float>::kBytes <= 232448, "shared memory of one block");
static_assert(2 * kHeads * kD * 4 <= kRows * kYLd * 4,
              "the LayerNorm partials fit in y's place");

// os[r][c] = the gated head sum of row r0 + r rounded to the storage type
// (fc's input), 0 beyond `rows`; also to o_out [P*Tq, 64] where given
template <typename T>
__device__ __forceinline__ void gated_sum(const float* __restrict__ oh,
                                          const float* gm, int pairs, int pair,
                                          int tq, int r0, int rows, float* os,
                                          float* __restrict__ o_out) {
  const int r = threadIdx.x >> 4, c = (threadIdx.x & 15) * 4;   // 16 x 16
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (r < rows) {
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      const float4 a = *reinterpret_cast<const float4*>(
          oh + (((size_t)h * pairs + pair) * tq + r0 + r) * kDk + c);
      v[0] += a.x * gm[h * kDk + c];
      v[1] += a.y * gm[h * kDk + c + 1];
      v[2] += a.z * gm[h * kDk + c + 2];
      v[3] += a.w * gm[h * kDk + c + 3];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = ait::round_to(v[j], (const T*)nullptr);
    if (o_out != nullptr)
      ait::store4(o_out + ((size_t)pair * tq + r0 + r) * kDk + c, v[0], v[1],
                  v[2], v[3]);
  }
  ait::store4(os + r * kOLd + c, v[0], v[1], v[2], v[3]);
}

// persistent blocks over the items (pair, 16 rows r0..) of all pairs
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
out_fwd(const float* __restrict__ oh, const float* __restrict__ gate,
        const T* __restrict__ fcw, const T* __restrict__ xq,
        const float* __restrict__ lns, const float* __restrict__ lnb,
        T* __restrict__ out, int pairs, int tq, AttnDrop drop) {
  extern __shared__ __align__(16) uint8_t smo[];
  using L = OutSmem<T>;
  T* fcs = reinterpret_cast<T*>(smo);
  float* ys = reinterpret_cast<float*>(smo + L::kY);
  float* os = reinterpret_cast<float*>(smo + L::kO);
  float* gm = reinterpret_cast<float*>(smo + L::kGm);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int per = (tq + kRows - 1) / kRows;
  const uint2 key = drop.seed != nullptr ? ait::seed_key(drop.seed)
                                         : make_uint2(0u, 0u);
  stage_fc(fcw, fcs);
  for (int item = blockIdx.x; item < pairs * per; item += gridDim.x) {
    const int pair = item / per, r0 = (item - pair * per) * kRows;
    const int rows = min(kRows, tq - r0);
    const size_t row0 = (size_t)pair * tq + r0;
    __syncthreads();   // fc is staged; the last item is done with the rest
    for (int o = t; o < kHD; o += kThreads)
      gm[o] = gate[(size_t)pair * kHD + o];
    __syncthreads();
    gated_sum<T>(oh, gm, pairs, pair, tq, r0, rows, os, nullptr);
    __syncthreads();
    fc_fwd(os, fcs, ys);
    __syncthreads();
    for (int r = warp; r < rows; r += kThreads / 32) {   // a warp per row
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
          v[j * 8 + e] = ys[r * kYLd + c + e] * mk[e] + a[e];
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
  }
}

// ----------------------------------------------------------------- backward

// persistent blocks over the items (pair, 16 rows).  Writes dy (the
// LayerNorm input's cotangent), dy0 (fc's output cotangent, with dropout;
// else it is dy), o, do [P*Tq, 64], and per item the LayerNorm partials and
// the dgate partials [P * items a pair, 512]
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
out_bwd(const float* __restrict__ oh, const float* __restrict__ gate,
        const T* __restrict__ fcw, const T* __restrict__ xq,
        const float* __restrict__ lns, const T* __restrict__ g,
        float* __restrict__ dy_out, float* __restrict__ dy0_out,
        float* __restrict__ o_out, float* __restrict__ do_out,
        float* __restrict__ lnp_s, float* __restrict__ lnp_b,
        float* __restrict__ dgp, int pairs, int tq, AttnDrop drop) {
  extern __shared__ __align__(16) uint8_t smo[];
  using L = OutSmem<T>;
  T* fcs = reinterpret_cast<T*>(smo);
  float* ys = reinterpret_cast<float*>(smo + L::kY);
  float* os = reinterpret_cast<float*>(smo + L::kO);
  float* dos = reinterpret_cast<float*>(smo + L::kDo);
  float* gm = reinterpret_cast<float*>(smo + L::kGm);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int per = (tq + kRows - 1) / kRows;
  const uint2 key = drop.seed != nullptr ? ait::seed_key(drop.seed)
                                         : make_uint2(0u, 0u);
  stage_fc(fcw, fcs);
  for (int item = blockIdx.x; item < pairs * per; item += gridDim.x) {
    const int pair = item / per, r0 = (item - pair * per) * kRows;
    const int rows = min(kRows, tq - r0);
    const size_t row0 = (size_t)pair * tq + r0;
    __syncthreads();
    for (int o = t; o < kHD; o += kThreads)
      gm[o] = gate[(size_t)pair * kHD + o];
    __syncthreads();
    gated_sum<T>(oh, gm, pairs, pair, tq, r0, rows, os, o_out);
    __syncthreads();
    fc_fwd(os, fcs, ys);
    __syncthreads();
    // the LayerNorm of y0 * ok / kp + x_q and its backward, a warp per row
    // (rows w, w + 8): dy to device memory, dy0 = dy * ok / kp there with
    // dropout and into ys in place of y0 (rows past `rows` stay y0 = 0)
    float ps[16], pb[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) ps[i] = pb[i] = 0.f;
    for (int r = warp; r < rows; r += kThreads / 32) {
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
          y[j * 8 + e] = ys[r * kYLd + c + e] * mk[j * 8 + e] + a[e];
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
        }
        ait::store8(ys + r * kYLd + c, o0);
        ait::store8(dy_out + (row0 + r) * kD + c, o);
        if (drop.on()) ait::store8(dy0_out + (row0 + r) * kD + c, o0);
      }
    }
    __syncthreads();
    fc_bwd(ys, fcs, dos);
    __syncthreads();   // do is complete; ys is free
    {  // this item's LayerNorm partials: the 8 warps in order
      float* red = ys;   // [2][8][512]
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          red[warp * kD + j * 256 + lane * 8 + e] = ps[j * 8 + e];
          red[(8 + warp) * kD + j * 256 + lane * 8 + e] = pb[j * 8 + e];
        }
    }
    for (int e = t; e < rows * 16; e += kThreads) {
      const int r = e >> 4, c = (e & 15) * 4;
      *reinterpret_cast<float4*>(do_out + (row0 + r) * kDk + c) =
          *reinterpret_cast<const float4*>(dos + r * kOLd + c);
    }
    __syncthreads();
    for (int c = t; c < kD; c += kThreads) {
      float a = 0.f, b = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) {
        a += ys[w * kD + c];
        b += ys[(8 + w) * kD + c];
      }
      lnp_s[(size_t)item * kD + c] = a;
      lnp_b[(size_t)item * kD + c] = b;
    }
    // this item's part of dgate_h = sum_t do o_h (the item's o_h rows
    // loaded at once, then summed in row order)
    for (int o = t; o < kHD; o += kThreads) {
      const int h = o / kDk, c = o % kDk;
      const float* src = oh + (((size_t)h * pairs + pair) * tq + r0) * kDk + c;
      float x[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) x[r] = r < rows ? src[r * kDk] : 0.f;
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows) acc += dos[r * kOLd + c] * x[r];
      dgp[(size_t)item * kHD + o] = acc;
    }
  }
}

// grid (pairs), 512 threads: dgate from the items' partials in item order,
// the softmax-over-heads backward (dlogit [P, 512]) and du = dlogit sk_w^T /
// Tq [P, 64] (a warp a channel at a time, each lane 16 consecutive logits,
// then the warp's fixed tree)
template <typename T>
__global__ void __launch_bounds__(kHD)
gate_bwd(const float* __restrict__ gate, const float* __restrict__ dgp,
         const T* __restrict__ skw, float* __restrict__ dgl_out,
         float* __restrict__ du_out, int items, int tq) {
  __shared__ float gm[kHD];
  __shared__ float dg[kHD];
  const int t = threadIdx.x, pair = blockIdx.x;
  float acc = 0.f;
#pragma unroll 8
  for (int i = 0; i < items; ++i)
    acc += dgp[((size_t)pair * items + i) * kHD + t];
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
  const int warp = t >> 5, lane = t & 31;
  for (int c = warp; c < kDk; c += kHD / 32) {
    float w[16], a = 0.f;
    ait::load8(skw + c * kHD + lane * 16, w);
    ait::load8(skw + c * kHD + lane * 16 + 8, w + 8);
#pragma unroll
    for (int e = 0; e < 16; ++e) a += dg[lane * 16 + e] * w[e];
    a = ait::warp_sum(a);
    if (lane == 0) du_out[(size_t)pair * kDk + c] = a / tq;
  }
}

// the do_h tile of q rows r0..: do[r][c] gate_h[c] + du[c], 0 beyond tq
__device__ __forceinline__ void load_doh(const float* __restrict__ dos,
                                         const float* __restrict__ gate,
                                         const float* __restrict__ du,
                                         int pair, int h, int tq, int r0,
                                         float* doh) {
  const float* gh = gate + (size_t)pair * kHD + h * kDk;
  const float* dup = du + (size_t)pair * kDk;
  for (int e = threadIdx.x; e < kT * 16; e += kThreads) {
    const int r = e >> 4, c = (e & 15) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < tq) {
      const float4 d = *reinterpret_cast<const float4*>(
          dos + ((size_t)pair * tq + r0 + r) * kDk + c);
      v = make_float4(d.x * gh[c] + dup[c], d.y * gh[c + 1] + dup[c + 1],
                      d.z * gh[c + 2] + dup[c + 2],
                      d.w * gh[c + 3] + dup[c + 3]);
    }
    *reinterpret_cast<float4*>(doh + swz(r, c)) = v;
  }
}

// grid (q tiles x splits, heads, pairs), key split `split` over key tiles
// split * chunk ...  stats [3, H * P * Tq]: row max, row sum and rowdot
// (the first two from `combine` where there are splits); dz [P*Tq, 512]
// (head h in columns 64 h..), or the partials
__global__ void __launch_bounds__(kThreads, 2)
core_bwd_q(Proj pj, const uint8_t* __restrict__ mask,
           const float* __restrict__ oh, const float* __restrict__ dos,
           const float* __restrict__ gate, const float* __restrict__ du,
           float* __restrict__ stats, float* __restrict__ dz, Partials part,
           int pairs, int tq, int tk, int splits, int chunk, AttnDrop drop) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;
  float* dohs = sm + kTileF;
  float* ks = sm + 2 * kTileF;   // two buffers
  float* vs = sm + 4 * kTileF;   // two buffers
  float* dss = sm + 6 * kTileF;
  float* red = sm + 7 * kTileF;   // the row maxima, then the row sums
  float* rd = red + 2 * kT;
  const uint32_t base = hopper::smem_u32(sm);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int qt = blockIdx.x / splits, split = blockIdx.x - qt * splits;
  const int h = blockIdx.y, pair = blockIdx.z;
  const int r0 = qt * kT, rows = min(kT, tq - r0);
  const int ktiles = (tk + kT - 1) / kT;
  const int kt0 = split * chunk, kt1 = min(ktiles, kt0 + chunk);
  const uint2 key = drop.seed != nullptr ? ait::seed_key(drop.seed)
                                         : make_uint2(0u, 0u);
  const float* qb = pj.q + (size_t)pair * tq * pj.rs + h * pj.q_hs;
  const float* kb = pj.k + (size_t)pair * tk * pj.rs + h * pj.kv_hs;
  const float* vb = pj.v + (size_t)pair * tk * pj.rs + h * pj.kv_hs;
  const size_t qhead = ((size_t)h * pairs + pair) * tq;
  const size_t n = (size_t)kHeads * pairs * tq;

  load_tile(qb, pj.rs, r0, tq, base);
  load_tile(kb, pj.rs, kt0 * kT, tk, base + 4 * 2 * kTileF);
  load_tile(vb, pj.rs, kt0 * kT, tk, base + 4 * 4 * kTileF);
  hopper::cp_async_commit();
  load_doh(dos, gate, du, pair, h, tq, r0, dohs);
  __syncthreads();
  // rowdot = sum_c P dP = sum_d do_h o_h (o_h is the post-dropout P v)
  for (int r = warp; r < kT; r += kThreads / 32) {
    float v = 0.f;
    if (r < rows) {
      const float* o = oh + (qhead + r0 + r) * kDk;
      v = dohs[swz(r, lane)] * o[lane] + dohs[swz(r, lane + 32)] * o[lane + 32];
    }
    v = ait::warp_sum(v);
    if (lane == 0) rd[r] = v;
  }
  KeyPass kp;
  float acc[4][4];
  zero44(acc);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int b = (kt - kt0) & 1, c0 = kt * kT;
    const float* kbuf = ks + b * kTileF;
    const float* vbuf = vs + b * kTileF;
    hopper::cp_async_wait<0>();
    __syncthreads();   // tile kt is in (and rowdot); tile kt - 1 is done
    if (kt + 1 < kt1) {
      load_tile(kb, pj.rs, c0 + kT, tk, base + 4 * (2 + (b ^ 1)) * kTileF);
      load_tile(vb, pj.rs, c0 + kT, tk, base + 4 * (4 + (b ^ 1)) * kTileF);
      hopper::cp_async_commit();
    }
    float sc[4][4], dp[4][4], alpha[2];
    zero44(sc);
    zero44(dp);
    split_mma<false, false>(sc, qs, kbuf, kp.m0, kp.n0, kp.lane);
    split_mma<false, false>(dp, dohs, vbuf, kp.m0, kp.n0, kp.lane);
    kp.softmax_step(sc, pj.qscale, mask, r0, c0, tq, tk, red, alpha);
    float fa[4][4];
    if (drop.on())
      frag_factors(drop, key, h, pair, pairs, tq, tk, r0 + kp.ra, c0 + kp.n0,
                   kp.lane, fa);
    // dS = P (dP ak / kp - rowdot), P unnormalized
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = drop.on() ? dp[j][e] * fa[j][e] : dp[j][e];
        sc[j][e] *= d - rd[kp.ra + 8 * (e >> 1)];
      }
    const float one[2] = {1.f, 1.f};
    store_frag_rows(dss, sc, kp.m0, kp.n0, kp.lane, one);
    hopper::named_sync(1 + kp.mb, 64);   // the row pair's dS is complete
    float pz[4][4];
    zero44(pz);
    split_mma<false, true>(pz, dss, kbuf, kp.m0, kp.n0, kp.lane);
    rescale_add(acc, pz, alpha);
  }
  float l[2];
  kp.row_sums(red, l);   // also: the row pair is done with dss
  if (split == 0 && t < rows) stats[2 * n + qhead + r0 + t] = rd[t];
  if (splits == 1) {
    if (kp.nh == 0 && (lane & 3) == 0)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = kp.ra + 8 * hh;
        if (r < rows) {
          stats[qhead + r0 + r] = kp.m[hh];
          stats[n + qhead + r0 + r] = l[hh];
        }
      }
    const float inv[2] = {0.125f / l[0], 0.125f / l[1]};
    store_frag_rows(dss, acc, kp.m0, kp.n0, kp.lane, inv);
    __syncthreads();
    store_rows(dz + ((size_t)pair * tq + r0) * kD + h * kDk, kD, dss, rows,
               1.f);
    return;
  }
  const float one[2] = {1.f, 1.f};
  store_frag_rows(dss, acc, kp.m0, kp.n0, kp.lane, one);
  if (kp.nh == 0 && (lane & 3) == 0)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = kp.ra + 8 * hh;
      if (r < rows) {
        part.ml[(size_t)split * 2 * n + qhead + r0 + r] = kp.m[hh];
        part.ml[(size_t)split * 2 * n + n + qhead + r0 + r] = l[hh];
      }
    }
  __syncthreads();
  store_rows(part.x + ((size_t)split * n + qhead + r0) * kDk, kDk, dss, rows,
             1.f);
}

// grid (key tiles x splits, heads, pairs), q split `split` over q tiles
// split * chunk ..: dk, dv [P*Tk, 512] of this block's 64 keys, summed over
// its q tiles in order (with splits: dkv [splits, 2, P*Tk, 512] partials)
__global__ void __launch_bounds__(kThreads, 2)
core_bwd_kv(Proj pj, const uint8_t* __restrict__ mask,
            const float* __restrict__ dos, const float* __restrict__ gate,
            const float* __restrict__ du, const float* __restrict__ stats,
            float* __restrict__ dk, float* __restrict__ dv,
            float* __restrict__ dkv, int pairs, int tq, int tk, int splits,
            int chunk, AttnDrop drop) {
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;
  float* vs = sm + kTileF;
  float* qs = sm + 2 * kTileF;
  float* dohs = sm + 3 * kTileF;
  float* pfs = sm + 4 * kTileF;   // P ak / kp
  float* dss = sm + 5 * kTileF;   // dS
  const uint32_t base = hopper::smem_u32(sm);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mb = warp & 3, m0 = 16 * mb, n0 = 32 * (warp >> 2);
  const int ra = m0 + (lane >> 2), t2 = 2 * (lane & 3);
  const int kt = blockIdx.x / splits, split = blockIdx.x - kt * splits;
  const int h = blockIdx.y, pair = blockIdx.z;
  const int c0 = kt * kT, keys = min(kT, tk - c0);
  const int qtiles = (tq + kT - 1) / kT;
  const int qt0 = split * chunk, qt1 = min(qtiles, qt0 + chunk);
  const uint2 key = drop.seed != nullptr ? ait::seed_key(drop.seed)
                                         : make_uint2(0u, 0u);
  const float* qb = pj.q + (size_t)pair * tq * pj.rs + h * pj.q_hs;
  const float* kb = pj.k + (size_t)pair * tk * pj.rs + h * pj.kv_hs;
  const float* vb = pj.v + (size_t)pair * tk * pj.rs + h * pj.kv_hs;
  const size_t qhead = ((size_t)h * pairs + pair) * tq;
  const size_t n = (size_t)kHeads * pairs * tq;

  load_tile(kb, pj.rs, c0, tk, base);
  load_tile(vb, pj.rs, c0, tk, base + 4 * kTileF);
  hopper::cp_async_commit();
  float adk[4][4], adv[4][4];
  zero44(adk);
  zero44(adv);
  for (int qt = qt0; qt < qt1; ++qt) {
    const int r0 = qt * kT;
    __syncthreads();   // every warp is done with the last q tile
    load_tile(qb, pj.rs, r0, tq, base + 4 * 2 * kTileF);
    hopper::cp_async_commit();
    load_doh(dos, gate, du, pair, h, tq, r0, dohs);
    hopper::cp_async_wait<0>();
    __syncthreads();
    float sc[4][4], dp[4][4];
    zero44(sc);
    zero44(dp);
    split_mma<false, false>(sc, qs, ks, m0, n0, lane);
    split_mma<false, false>(dp, dohs, vs, m0, n0, lane);
    float fa[4][4];
    if (drop.on())
      frag_factors(drop, key, h, pair, pairs, tq, tk, r0 + ra, c0 + n0, lane,
                   fa);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int gr = r0 + ra + 8 * hh;
      float mr = 0.f, lr = 1.f, rdr = 0.f;
      if (gr < tq) {
        mr = stats[qhead + gr];
        lr = stats[n + qhead + gr];
        rdr = stats[2 * n + qhead + gr];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          const int gc = c0 + n0 + 8 * j + t2 + (e & 1);
          float pf = 0.f, ds = 0.f;
          if (gr < tq && gc < tk) {
            const float p =
                expf(masked(sc[j][e] * pj.qscale, mask, gr, gc, tq, tk) - mr) /
                lr;
            const float f = drop.on() ? fa[j][e] : 1.f;
            pf = p * f;
            ds = p * (dp[j][e] * f - rdr);
          }
          sc[j][e] = pf;
          dp[j][e] = ds;
        }
    }
    const float one[2] = {1.f, 1.f};
    store_frag_rows(pfs, sc, m0, n0, lane, one);
    store_frag_rows(dss, dp, m0, n0, lane, one);
    __syncthreads();   // P ak / kp and dS complete
    float pv[4][4], pk[4][4];
    zero44(pv);
    zero44(pk);
    split_mma<true, true>(pv, pfs, dohs, m0, n0, lane);   // (P ak / kp)^T do_h
    split_mma<true, true>(pk, dss, qs, m0, n0, lane);     // dS^T q
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        adv[j][e] += pv[j][e];
        adk[j][e] += pk[j][e];
      }
  }
  __syncthreads();   // every warp is done with the operands
  store_frag(pfs, adv, m0, n0, lane, 1.f);
  store_frag(dss, adk, m0, n0, lane, pj.qscale);
  __syncthreads();
  const size_t o = ((size_t)pair * tk + c0) * kD + h * kDk;
  if (splits == 1) {
    store_rows(dv + o, kD, pfs, keys, 1.f);
    store_rows(dk + o, kD, dss, keys, 1.f);
  } else {
    const size_t m = (size_t)pairs * tk * kD;
    store_rows(dkv + (2 * split) * m + o, kD, dss, keys, 1.f);
    store_rows(dkv + (2 * split + 1) * m + o, kD, pfs, keys, 1.f);
  }
}

// dk, dv [P*Tk, 512] = the splits' partials [splits, 2, P*Tk, 512] summed in
// split order (16 bytes a thread)
__global__ void __launch_bounds__(kThreads)
reduce_kv(const float* __restrict__ dkv, float* __restrict__ dk,
          float* __restrict__ dv, int splits, long long m) {
  const long long e = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (e >= 2 * m) return;
  const int which = e >= m;
  const long long i = e - which * m;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float4 x =
        *reinterpret_cast<const float4*>(dkv + (2 * s + which) * m + i);
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  }
  *reinterpret_cast<float4*>((which ? dv : dk) + i) = a;
}

template <typename K>
int opt_in(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the wrapper's plan (ops/fused_attention.py::general_plan): key splits
// of core_fwd / core_bwd_q and their key tiles each, q splits of
// core_bwd_kv and their q tiles each, the persistent blocks of out_fwd /
// out_bwd
struct Plan {
  int ksplits, kchunk, qsplits, qchunk, out_blocks;
};

template <typename T>
int forward(const Proj& pj, const void* skw, const void* skb, const void* fcw,
            const void* xq, const void* lns, const void* lnb, const void* mask,
            void* oh, void* const* qkv, void* s, void* gate, void* out,
            void* colsum, Partials part, int pairs, int tq, int tk,
            const Plan& plan, const AttnDrop& drop, cudaStream_t st) {
  const int qtiles = (tq + kT - 1) / kT;
  int err = opt_in(core_fwd, kFwdSmem);
  if (err) return err;
  err = opt_in(out_fwd<T>, OutSmem<T>::kBytes);
  if (err) return err;
  core_fwd<<<dim3(qtiles * plan.ksplits, kHeads, pairs), kThreads,
             kFwdSmem, st>>>(
      pj, (const uint8_t*)mask, (float*)oh, (float*)colsum, part,
      (float*)qkv[0], (float*)qkv[1], (float*)qkv[2], pairs, tq, tk,
      plan.ksplits, plan.kchunk, drop);
  if (plan.ksplits > 1)
    combine<true><<<dim3(qtiles, kHeads, pairs), kThreads, 0, st>>>(
        part, plan.ksplits, pairs, tq, (float*)oh, (float*)colsum, nullptr);
  gate_kernel<T><<<pairs, kHD, 0, st>>>(
      (const float*)colsum, (const T*)skw, (const T*)skb, (float*)s,
      (float*)gate, qtiles, tq);
  out_fwd<T><<<plan.out_blocks, kThreads, OutSmem<T>::kBytes, st>>>(
      (const float*)oh, (const float*)gate, (const T*)fcw, (const T*)xq,
      (const float*)lns, (const float*)lnb, (T*)out, pairs, tq, drop);
  return (int)cudaGetLastError();
}

template <typename T>
int backward(const Proj& pj, const void* skw, const void* skb, const void* fcw,
             const void* xq, const void* lns, const void* mask, const void* oh,
             const void* g, void* const* o, Partials part, float* dkv,
             int pairs, int tq, int tk, const Plan& plan, const AttnDrop& drop,
             cudaStream_t st) {
  // o: gate, s, dy, dy0, o, do, lnp_s, lnp_b, dgp, dgl, du, stats, dz, dk,
  // dv, colsum
  const int qtiles = (tq + kT - 1) / kT, ktiles = (tk + kT - 1) / kT;
  const int items = (tq + kRows - 1) / kRows;
  int err = opt_in(out_bwd<T>, OutSmem<T>::kBytes);
  if (err) return err;
  err = opt_in(core_bwd_q, kBwdQSmem);
  if (err) return err;
  err = opt_in(core_bwd_kv, kBwdKvSmem);
  if (err) return err;
  float* stats = (float*)o[11];
  gate_sums<<<dim3(qtiles, kHeads, pairs), kThreads, 0, st>>>(
      (const float*)oh, (float*)o[15], pairs, tq);
  gate_kernel<T><<<pairs, kHD, 0, st>>>(
      (const float*)o[15], (const T*)skw, (const T*)skb, (float*)o[1],
      (float*)o[0], qtiles, tq);
  out_bwd<T><<<plan.out_blocks, kThreads, OutSmem<T>::kBytes, st>>>(
      (const float*)oh, (const float*)o[0], (const T*)fcw, (const T*)xq,
      (const float*)lns, (const T*)g, (float*)o[2], (float*)o[3], (float*)o[4],
      (float*)o[5], (float*)o[6], (float*)o[7], (float*)o[8], pairs, tq, drop);
  gate_bwd<T><<<pairs, kHD, 0, st>>>(
      (const float*)o[0], (const float*)o[8], (const T*)skw, (float*)o[9],
      (float*)o[10], items, tq);
  core_bwd_q<<<dim3(qtiles * plan.ksplits, kHeads, pairs), kThreads,
               kBwdQSmem, st>>>(
      pj, (const uint8_t*)mask, (const float*)oh, (const float*)o[5],
      (const float*)o[0], (const float*)o[10], stats, (float*)o[12], part,
      pairs, tq, tk, plan.ksplits, plan.kchunk, drop);
  if (plan.ksplits > 1)
    combine<false><<<dim3(qtiles, kHeads, pairs), kThreads, 0, st>>>(
        part, plan.ksplits, pairs, tq, (float*)o[12], nullptr, stats);
  core_bwd_kv<<<dim3(ktiles * plan.qsplits, kHeads, pairs), kThreads,
                kBwdKvSmem, st>>>(
      pj, (const uint8_t*)mask, (const float*)o[5], (const float*)o[0],
      (const float*)o[10], stats, (float*)o[13], (float*)o[14], dkv, pairs, tq,
      tk, plan.qsplits, plan.qchunk, drop);
  if (plan.qsplits > 1) {
    const long long m = (long long)pairs * tk * kD;
    reduce_kv<<<(unsigned)((2 * m / 4 + kThreads - 1) / kThreads), kThreads, 0,
                st>>>(dkv, (float*)o[13], (float*)o[14], plan.qsplits, m);
  }
  return (int)cudaGetLastError();
}

bool bad_drop(const void* seed, const void* akeep, const void* okeep) {
  return (akeep == nullptr) != (okeep == nullptr) || (seed && akeep);
}

bool bad_plan(const Plan& p, int tq, int tk, bool need_parts,
              bool need_dkv) {
  const int qtiles = (tq + kT - 1) / kT, ktiles = (tk + kT - 1) / kT;
  auto bad = [](int splits, int chunk, int tiles) {
    return splits < 1 || chunk < 1 || (splits - 1) * chunk >= tiles ||
           splits * chunk < tiles;
  };
  return bad(p.ksplits, p.kchunk, ktiles) || bad(p.qsplits, p.qchunk, qtiles) ||
         p.out_blocks < 1 || need_parts || need_dkv;
}

}  // namespace

// The forward from the projections q [P*Tq, 512], k, v [P*Tk, 512] (f32, q
// unscaled).  oh [8, P*Tq, 64], s [P, 64] and gate [P, 512] are f32 outputs
// (scratch at eval); out [P, Tq, 512] in the storage type.  qsv, ksv, vsv: all
// null, or the save-qkv outputs [8, P*T, 64] f32 (q scaled).  Scratch:
// colsum [P, ceil(Tq / 64), 8, 64]; with key splits part_x [ksplits, 8,
// P*Tq, 64] and part_ml [ksplits, 2, 8 * P * Tq].  Dropout as in
// csrc/sh_attention.cu.
extern "C" int sh_attention_general_fwd(
    int bf16_io, const void* q, const void* k, const void* v, const void* skw,
    const void* skb, const void* fcw, const void* xq, const void* lns,
    const void* lnb, const void* mask, void* oh, void* qsv, void* ksv,
    void* vsv, void* s, void* gate, void* out, void* colsum, void* part_x,
    void* part_ml, int pairs, int tq, int tk, int ksplits, int kchunk,
    int out_blocks, const void* seed, const void* akeep, const void* okeep,
    unsigned thresh, float inv_keep, void* stream) {
  const Plan plan{ksplits, kchunk, 1, (tq + kT - 1) / kT, out_blocks};
  if (bad_drop(seed, akeep, okeep) || (qsv == nullptr) != (ksv == nullptr) ||
      (qsv == nullptr) != (vsv == nullptr) || colsum == nullptr ||
      bad_plan(plan, tq, tk, ksplits > 1 && (!part_x || !part_ml), false))
    return (int)cudaErrorInvalidValue;
  const AttnDrop d{(const int*)seed, (const float*)akeep, (const float*)okeep,
                   thresh, inv_keep};
  const Proj pj = make_proj(q, k, v, 0, pairs, tq, tk);
  void* const qkv[3] = {qsv, ksv, vsv};
  const Partials part{(float*)part_x, (float*)part_ml};
  cudaStream_t st = (cudaStream_t)stream;
  return bf16_io ? forward<bf16>(pj, skw, skb, fcw, xq, lns, lnb, mask, oh, qkv,
                                 s, gate, out, colsum, part, pairs, tq, tk,
                                 plan, d, st)
                 : forward<float>(pj, skw, skb, fcw, xq, lns, lnb, mask, oh,
                                  qkv, s, gate, out, colsum, part, pairs, tq,
                                  tk, plan, d, st);
}

// The per-pair part of the backward.  q, k, v: the projections [P*T, 512]
// (heads_major 0), or the forward's saved [8, P*T, 64] with q scaled
// (heads_major 1).  Outputs, all f32: gate [P, 512] (scratch), s [P, 64], dy
// and dy0 [P*Tq, 512] (dy0 null without dropout), o and do [P*Tq, 64], the
// LayerNorm and dgate partials [P * ceil(Tq / 16), 512] each, dlogit
// [P, 512], du [P, 64] (scratch), stats [3, 8 * P * Tq] (scratch), dz
// [P*Tq, 512], dk and dv [P*Tk, 512].  Scratch: colsum as the forward's;
// with key splits part_x and part_ml as the forward's; with q splits dkv
// [qsplits, 2, P*Tk, 512].
extern "C" int sh_attention_general_bwd(
    int bf16_io, int heads_major, const void* q, const void* k, const void* v,
    const void* skw, const void* skb, const void* fcw, const void* xq,
    const void* lns, const void* mask, const void* oh, const void* g,
    void* gate, void* s, void* dy, void* dy0, void* o, void* dout,
    void* lnp_s, void* lnp_b, void* dgp, void* dgl, void* du, void* stats,
    void* dz, void* dk, void* dv, void* colsum, void* part_x, void* part_ml,
    void* dkv, int pairs, int tq, int tk, int ksplits, int kchunk,
    int qsplits, int qchunk, int out_blocks, const void* seed,
    const void* akeep, const void* okeep, unsigned thresh, float inv_keep,
    void* stream) {
  const Plan plan{ksplits, kchunk, qsplits, qchunk, out_blocks};
  if (bad_drop(seed, akeep, okeep) || ((seed || akeep) && dy0 == nullptr) ||
      colsum == nullptr ||
      bad_plan(plan, tq, tk, ksplits > 1 && (!part_x || !part_ml),
               qsplits > 1 && !dkv))
    return (int)cudaErrorInvalidValue;
  const AttnDrop d{(const int*)seed, (const float*)akeep, (const float*)okeep,
                   thresh, inv_keep};
  const Proj pj = make_proj(q, k, v, heads_major, pairs, tq, tk);
  void* const outs[16] = {gate, s,   dy, dy0,   o,  dout, lnp_s, lnp_b,
                          dgp,  dgl, du, stats, dz, dk,   dv,    colsum};
  const Partials part{(float*)part_x, (float*)part_ml};
  cudaStream_t st = (cudaStream_t)stream;
  return bf16_io ? backward<bf16>(pj, skw, skb, fcw, xq, lns, mask, oh, g,
                                  outs, part, (float*)dkv, pairs, tq, tk, plan,
                                  d, st)
                 : backward<float>(pj, skw, skb, fcw, xq, lns, mask, oh, g,
                                   outs, part, (float*)dkv, pairs, tq, tk,
                                   plan, d, st);
}
