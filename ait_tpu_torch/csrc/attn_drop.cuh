// What the attention kernels (the one-block ones of csrc/sh_attention.cu and
// the tiled ones of csrc/sh_attention_general.cu) share: where the per-head
// projections lie (`Proj`), and the dropout of one launch:
// the Philox stream of `seed` (csrc/philox.cuh: tag 1 per head and pair for
// the probabilities, tag 2 per pair for fc's output), or the operand masks
// akeep [H, P*Tq, Tk] and okeep [P*Tq, D] (f32 0/1); neither: none.  The
// stream counts by absolute pair and by the element's place in the pair's
// [Tq, Tk] or [Tq, D] block, so the factors do not depend on how a kernel
// tiles its work: a forward, a backward that tiles differently and the mask
// dump (csrc/dropout.cu) see the same bits.  The element index r * Tk + c and
// the group index (r * D + c) / 4 are whole 32-bit counter words, far above
// the 1900 x 64 and 1900 x 512 blocks of the co-attention.
#pragma once

#include "common.cuh"
#include "philox.cuh"

namespace ait {

constexpr int kAttnD = 512;   // the model width the attention kernels are built for

// Where the per-head projections lie: element c of head h of flat row `row`
// (pair * T + t) of q at q[row * rs + h * q_hs + c].  The projections' own
// layout is [P*T, 512] (rs 512, head stride 64, q unscaled: qscale 1/8); the
// save-qkv layout is [H, P*T, 64] (rs 64, head strides P*T*64, q already
// scaled: qscale 1).
struct Proj {
  const float* q;
  const float* k;
  const float* v;
  int rs;
  size_t q_hs, kv_hs;
  float qscale;
};

// heads_major: the save-qkv layout, else the projections' own
inline Proj make_proj(const void* q, const void* k, const void* v,
                      int heads_major, int pairs, int tq, int tk) {
  if (heads_major)
    return Proj{(const float*)q, (const float*)k, (const float*)v, 64,
                (size_t)pairs * tq * 64, (size_t)pairs * tk * 64, 1.f};
  return Proj{(const float*)q, (const float*)k, (const float*)v, kAttnD, 64,
              64, 0.125f};
}

struct AttnDrop {
  const int* seed;
  const float* akeep;
  const float* okeep;
  uint32_t thresh;
  float inv_keep;
  __device__ __forceinline__ bool on() const {
    return seed != nullptr || akeep != nullptr;
  }
};

// the probability dropout's factor of head h, pair `pair` of `pairs`,
// element (r, c) of its [tq, tk] block
__device__ __forceinline__ float attn_factor(const AttnDrop& d, uint2 key,
                                             int h, int pair, int pairs,
                                             int tq, int tk, int r, int c) {
  if (d.seed != nullptr)
    return drop_scale(keep_word(key, kTagAttn, h, pair, r * tk + c),
                      d.thresh, d.inv_keep);
  return d.akeep[((size_t)h * pairs * tq + (size_t)pair * tq + r) * tk + c] *
         d.inv_keep;
}

// the group form: the factors of elements (r, c .. c + 3) of head h's [tq,
// tk] block (c % 4 == 0), 0 past tq and tk.  Where tk % 4 == 0 the four
// elements are word 0..3 of group (r tk + c) / 4, one Philox call; else each
// element's word is drawn on its own.  The same bits as attn_factor
__device__ __forceinline__ float4 attn_factors4(const AttnDrop& d, uint2 key,
                                               int h, int pair, int pairs,
                                               int tq, int tk, int r, int c) {
  float f[4] = {0.f, 0.f, 0.f, 0.f};
  if (r < tq && c < tk) {
    if (d.seed != nullptr && (tk & 3) == 0) {
      const uint4 w = keep_group(key, kTagAttn, h, pair, (r * tk + c) >> 2);
      f[0] = drop_scale(w.x, d.thresh, d.inv_keep);
      f[1] = drop_scale(w.y, d.thresh, d.inv_keep);
      f[2] = drop_scale(w.z, d.thresh, d.inv_keep);
      f[3] = drop_scale(w.w, d.thresh, d.inv_keep);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < tk) f[j] = attn_factor(d, key, h, pair, pairs, tq, tk, r, c + j);
    }
  }
  return make_float4(f[0], f[1], f[2], f[3]);
}

// the output dropout's factors of columns c..c+7 (c % 8 == 0) of row r of
// pair `pair`; 1 without dropout
__device__ __forceinline__ void out_factors(const AttnDrop& d, uint2 key,
                                            int pair, int tq, int r, int c,
                                            float m[8]) {
  if (d.seed != nullptr) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const uint4 w = keep_group(key, kTagOut, 0, pair,
                                 (r * kAttnD + c) / 4 + q);
      m[4 * q + 0] = drop_scale(w.x, d.thresh, d.inv_keep);
      m[4 * q + 1] = drop_scale(w.y, d.thresh, d.inv_keep);
      m[4 * q + 2] = drop_scale(w.z, d.thresh, d.inv_keep);
      m[4 * q + 3] = drop_scale(w.w, d.thresh, d.inv_keep);
    }
  } else if (d.akeep != nullptr) {
    load8(d.okeep + ((size_t)pair * tq + r) * kAttnD + c, m);
#pragma unroll
    for (int e = 0; e < 8; ++e) m[e] *= d.inv_keep;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) m[e] = 1.f;
  }
}

}  // namespace ait
