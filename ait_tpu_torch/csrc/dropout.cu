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
// What bounds it on the H100: bytes.  It writes 4 bytes per element and
// spends one Philox4x32-10 call (~100 integer operations) on 4 elements, far
// below the card's operations per byte.  One thread per group of 4 elements,
// one Philox call each, a 16-byte store where the block length is a multiple
// of 4 (the flagship's widths 56, 64 and 512 all are), element stores else.

#include "common.cuh"
#include "philox.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
keep_mask_kernel(const int* __restrict__ seed, int tag, int blocks,
                 int length, int groups, uint32_t thresh, long long total,
                 float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int g = (int)(t % groups);
  const long long hb = t / groups;               // h * blocks + i
  const int i = (int)(hb % blocks), h = (int)(hb / blocks);
  const uint4 w = ait::keep_group(ait::seed_key(seed), tag, h, i, g);
  const float k[4] = {w.x < thresh ? 1.f : 0.f, w.y < thresh ? 1.f : 0.f,
                      w.z < thresh ? 1.f : 0.f, w.w < thresh ? 1.f : 0.f};
  float* o = out + hb * length + 4 * g;
  if ((length & 3) == 0) {
    ait::store4(o, k[0], k[1], k[2], k[3]);
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
  keep_mask_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)seed, tag, blocks, length, groups, (uint32_t)thresh, total,
      (float*)out);
  return (int)cudaGetLastError();
}
