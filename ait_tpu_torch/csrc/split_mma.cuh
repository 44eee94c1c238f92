// The per-head products of the attention kernels (csrc/sh_attention.cu's
// per-pair backward and csrc/sh_attention_general.cu's tiled kernels): a
// warp's 16 x 32 block of a 64 x 64 x 64 product of f32 tiles in shared
// memory on mma.sync m16n8k16, both operands split into three exact bf16
// terms (hopper::split_pair) and the six term products with i + j <= 2
// summed in f32.  The three dropped terms are below 2^-23 of |a| |b|, so the
// products are near-f32 (held on the card to 2^-17 sum_k |a_k| |b_k|;
// ops/fused_attention.py::split6_matmul is the plain emulation).  Tiles are
// [64][64] f32 in an XOR swizzle (`swz`) that serves a tile's rows and its
// columns (the transposed operands) without bank conflicts.
#pragma once

#include "hopper.cuh"

namespace ait {

// a [64][64] f32 tile in shared memory: element (r, c) at word r * 64 +
// (c ^ 8 g(r)), g(r) = (r ^ (r >> 1)) & 3.  A warp's fragment reads, pairs
// (r, c), (r, c + 1) for r = r0 + lane / 4, c = c0 + 2 (lane % 4), and the
// same pairs of the transposed tile, meet no bank conflict; 16-byte chunks
// (c % 4 == 0) stay contiguous
__device__ __forceinline__ int swz(int r, int c) {
  return r * 64 + (c ^ ((((r >> 1) ^ r) & 3) << 3));
}

// logical (r, c), (r, c + 1) of the tile X, or of X^T where T
template <bool T>
__device__ __forceinline__ float2 pair_at(const float* X, int r, int c) {
  if (T) return make_float2(X[swz(c, r)], X[swz(c + 1, r)]);
  return *reinterpret_cast<const float2*>(X + swz(r, c));
}

// term product e of the six with i + j <= 2, smallest first: (2, 0), (1,
// 1), (0, 2), (1, 0), (0, 1), (0, 0)
__device__ constexpr int term_a(int e) { return e < 3 ? 2 - e : e == 3; }
__device__ constexpr int term_b(int e) { return e < 3 ? e : e == 4; }

// one 16-deep step of a split product: the warp's fragments of A (16 x
// 16) and B (16 x 32) in three terms each, and their six term products
template <bool TA, bool TB>
struct SplitStep {
  uint32_t at[3][4], bt[4][3][2];

  __device__ __forceinline__ void load(const float* a, const float* b,
                                       int m0, int n0, int k0, int lane) {
    const int g = lane >> 2, t2 = 2 * (lane & 3);
    const float2 v[4] = {pair_at<TA>(a, m0 + g, k0 + t2),
                         pair_at<TA>(a, m0 + g + 8, k0 + t2),
                         pair_at<TA>(a, m0 + g, k0 + t2 + 8),
                         pair_at<TA>(a, m0 + g + 8, k0 + t2 + 8)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      hopper::split_pair(v[i].x, v[i].y, at[0][i], at[1][i], at[2][i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 w0 = pair_at<TB>(b, n0 + 8 * j + g, k0 + t2);
      const float2 w1 = pair_at<TB>(b, n0 + 8 * j + g, k0 + t2 + 8);
      hopper::split_pair(w0.x, w0.y, bt[j][0][0], bt[j][1][0], bt[j][2][0]);
      hopper::split_pair(w1.x, w1.y, bt[j][0][1], bt[j][1][1], bt[j][2][1]);
    }
  }

  // term by term, the four column tiles' accumulators interleaved
  __device__ __forceinline__ void mma(float (&acc)[4][4]) const {
#pragma unroll
    for (int e = 0; e < 6; ++e)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        hopper::mma_16816(acc[j], at[term_a(e)], bt[j][term_b(e)][0],
                          bt[j][term_b(e)][1]);
  }
};

// acc += A B for a warp's 16 x 32 block (rows m0.., columns n0..) of a 64 x
// 64 x 64 product of swizzled f32 tiles: A[m][k] is tile `a` (TA: a^T),
// B[k][n] is tile `b`^T (TB: b itself).  Each operand in three bf16 terms,
// the six products with i + j <= 2.  acc[j]: rows m0 + lane / 4 (+ 8 in
// [2], [3]), columns n0 + 8 j + 2 (lane % 4) (+ 1).  The k loop stays
// rolled: unrolled, the kernel's code grew by 40%, it spilled, and it ran
// slower on the H100
template <bool TA, bool TB>
__device__ __forceinline__ void split_mma(float (&acc)[4][4], const float* a,
                                          const float* b, int m0, int n0,
                                          int lane) {
#pragma unroll 1
  for (int k0 = 0; k0 < 64; k0 += 16) {
    SplitStep<TA, TB> st;
    st.load(a, b, m0, n0, k0, lane);
    st.mma(acc);
  }
}

// two or three such products in one k loop: more independent loads and
// mma chains in flight (8 warps an SM leave little else to hide latency)
template <bool TA1, bool TB1, bool TA2, bool TB2>
__device__ __forceinline__ void split_mma2(float (&acc1)[4][4],
                                           const float* a1, const float* b1,
                                           float (&acc2)[4][4],
                                           const float* a2, const float* b2,
                                           int m0, int n0, int lane) {
#pragma unroll 1
  for (int k0 = 0; k0 < 64; k0 += 16) {
    SplitStep<TA1, TB1> s1;
    SplitStep<TA2, TB2> s2;
    s1.load(a1, b1, m0, n0, k0, lane);
    s2.load(a2, b2, m0, n0, k0, lane);
    s1.mma(acc1);
    s2.mma(acc2);
  }
}

template <bool TA1, bool TB1, bool TA2, bool TB2, bool TA3, bool TB3>
__device__ __forceinline__ void split_mma3(
    float (&acc1)[4][4], const float* a1, const float* b1,
    float (&acc2)[4][4], const float* a2, const float* b2,
    float (&acc3)[4][4], const float* a3, const float* b3, int m0, int n0,
    int lane) {
#pragma unroll 1
  for (int k0 = 0; k0 < 64; k0 += 16) {
    SplitStep<TA1, TB1> s1;
    SplitStep<TA2, TB2> s2;
    SplitStep<TA3, TB3> s3;
    s1.load(a1, b1, m0, n0, k0, lane);
    s2.load(a2, b2, m0, n0, k0, lane);
    s3.load(a3, b3, m0, n0, k0, lane);
    s1.mma(acc1);
    s2.mma(acc2);
    s3.mma(acc3);
  }
}

__device__ __forceinline__ void zero44(float (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.f;
}

// a warp's 16 x 32 block (split_mma's fragment) * scale into the swizzled
// tile X
__device__ __forceinline__ void store_frag(float* X, const float (&acc)[4][4],
                                           int m0, int n0, int lane,
                                           float scale) {
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(X + swz(m0 + g + 8 * hh, n0 + 8 * j + t2)) =
          make_float2(acc[j][2 * hh] * scale, acc[j][2 * hh + 1] * scale);
}

}  // namespace ait
