// The port's dropout stream: Philox4x32-10 (Salmon et al., "Parallel random
// numbers: as easy as 1, 2, 3", SC'11), keyed by a dropout site's two seed
// words and counted by (tag, head, index, group).  Every kernel that draws a
// keep-mask includes this header, and ait_tpu_torch/ops/philox.py is its
// plain version, so a forward kernel, its backward kernel, the mask dump and
// the plain PyTorch code see the same bits.
//
// It replaces the TPU kernels' `pltpu.prng_*` seeding per (tag, head,
// absolute pair) and (tag, absolute row tile) (ait_tpu/ops/
// pallas_attention.py:125-183 `_keep_thresh`, `_seed2`, `_gen_attn_rows`,
// `_gen_out_rows`; ait_tpu/ops/pallas_ffn.py:70 `_gen_keep`), whose bits no
// other device reproduces.  Like those, the stream does not depend on how a
// kernel tiles its work:
//   key     = (seed[0], seed[1]) as uint32;
//   counter = (tag, head, index, group): tag 1 the attention probabilities,
//             2 the attention output after fc, 3 the FFN output, 4 the input
//             glue; index the absolute pair (tags 1, 2) or the absolute row
//             (tags 3, 4); head the attention head for tag 1, else 0;
//   element e of the index's block ([Tq, Tk] per head and pair, [Tq, D] per
//   pair, [D] per row, flattened row-major) is word e % 4 of group e / 4.
// A block whose length is not a multiple of 4 uses its last group in part.
// keep = bits < thresh with thresh = min(2^32 - 1, round(keep_prob * 2^32)),
// as `_keep_thresh` computes it.
#pragma once

#include <stdint.h>

namespace ait {

constexpr int kTagAttn = 1, kTagOut = 2, kTagFfn = 3, kTagGlue = 4;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// the key of a site: its [2] int32 seed, read on the device
__device__ __forceinline__ uint2 seed_key(const int* seed) {
  return make_uint2((uint32_t)seed[0], (uint32_t)seed[1]);
}

// the 4 words of group g of block (tag, head, index)
__device__ __forceinline__ uint4 keep_group(uint2 key, int tag, int head,
                                            int index, int g) {
  return philox4x32_10(
      make_uint4((uint32_t)tag, (uint32_t)head, (uint32_t)index, (uint32_t)g),
      key);
}

// the word of element e of block (tag, head, index)
__device__ __forceinline__ uint32_t keep_word(uint2 key, int tag, int head,
                                              int index, int e) {
  const uint4 w = keep_group(key, tag, head, index, e >> 2);
  const int j = e & 3;
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

// the dropout factor of one element: 1 / keep_prob where kept, else 0
__device__ __forceinline__ float drop_scale(uint32_t bits, uint32_t thresh,
                                            float inv_keep) {
  return bits < thresh ? inv_keep : 0.f;
}

// a site's dropout as a kernel argument: seed null = no dropout
struct Dropout {
  const int* seed;
  uint32_t thresh;
  float inv_keep;
};

}  // namespace ait
