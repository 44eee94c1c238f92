// The dropout keep-mask dump: out[h][i][e] = 1.0 where the Philox stream of
// csrc/philox.cuh keeps element e of block (tag, h, i), else 0.0, as f32.
//
// Replaces ait_tpu/ops/pallas_attention.py:954 dropout_keep_masks (kernels
// `ak_kern` :965 and `ok_kern` :973; tags 1 and 2, [H, P*Tq, Tk] and
// [P*Tq, D]) and ait_tpu/ops/pallas_ffn.py:423 _mask_dump (`ffn_keep_mask`
// :442, `posln_keep_mask` :449; tags 3 and 4, [N, D]).  Those layouts are
// [heads][blocks][length] with a block per pair or per row, so one kernel
// writes all of them.  The port also draws the co-attention's plain-path
// dropout masks with it (models/attention.py).
//
// What bounds it on the H100: bytes, closely followed by integer issue.  It
// writes 4 bytes per element and spends one Philox4x32-10 call (58
// instructions at the int32 rate, half the f32 one) on 4 elements: at the
// co-attention's 4 dumps of a train step, 94 MB (28 us at 3.35 TB/s)
// against 20 us of Philox.  So every instruction beside the Philox rounds
// costs time.  One thread per group of 4 elements (the most threads in
// flight: a persistent grid-stride walk with several groups a thread,
// measured on an H100, ran 30-44% slower), the group's (h, i, g) by 32-bit
// division wherever the dump's groups fit in 31 bits (every dump of the
// flagship; 64-bit division is a long software sequence), and a 16-byte
// streaming store (st.global.cs: the mask is written once and read once,
// later) where the block length is a multiple of 4 (the flagship's widths
// 56, 64 and 512 all are), element stores else.

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

// I: the index type, unsigned where the groups fit in 31 bits
template <typename I>
__global__ void __launch_bounds__(kThreads)
keep_mask_kernel(const int* __restrict__ seed, int tag, int blocks,
                 int length, int groups, uint32_t thresh, long long total,
                 float* __restrict__ out) {
  const I t = (I)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (I)total) return;
  const I hb = t / (I)groups;                   // h * blocks + i
  const int g = (int)(t - hb * (I)groups);
  const I h = hb / (I)blocks;
  const int i = (int)(hb - h * (I)blocks);
  const uint4 w = ait::keep_group(ait::seed_key(seed), tag, (int)h, i, g);
  const float k[4] = {w.x < thresh ? 1.f : 0.f, w.y < thresh ? 1.f : 0.f,
                      w.z < thresh ? 1.f : 0.f, w.w < thresh ? 1.f : 0.f};
  float* o = out + (long long)hb * length + 4 * g;
  if ((length & 3) == 0) {
    __stcs(reinterpret_cast<float4*>(o), make_float4(k[0], k[1], k[2], k[3]));
  } else {
    const int n = min(4, length - 4 * g);
    for (int e = 0; e < n; ++e) o[e] = k[e];
  }
}

}  // namespace

// out: f32 [heads, blocks, length]
extern "C" int keep_mask_dump(const void* seed, int tag, int heads, int blocks,
                              int length, unsigned thresh, void* out,
                              void* stream) {
  const int groups = (length + 3) / 4;
  const long long total = (long long)heads * blocks * groups;
  if (total == 0) return (int)cudaGetLastError();
  const unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  // the 64-bit instance serves dumps of 2^31 groups or more (a 34 GB mask):
  // no caller and no test reaches it
  if (total < (1ll << 31))
    keep_mask_kernel<unsigned><<<grid, kThreads, 0, st>>>(
        (const int*)seed, tag, blocks, length, groups, (uint32_t)thresh,
        total, (float*)out);
  else
    keep_mask_kernel<unsigned long long><<<grid, kThreads, 0, st>>>(
        (const int*)seed, tag, blocks, length, groups, (uint32_t)thresh,
        total, (float*)out);
  return (int)cudaGetLastError();
}
