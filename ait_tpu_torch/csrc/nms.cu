// Greedy NMS keep-mask over score-sorted boxes, one block per image.
//
// Replaces ait_tpu/ops/nms_pallas.py:133 nms_keep_mask_batched (kernel
// `_kernel`, :60).  Same algorithm and the same keep bits for the first
// `cap` survivors of every image: boxes are swept in tiles of 256; each tile
// is first suppressed by the survivors of earlier tiles (a compacted buffer
// of at most cap_pad boxes in shared memory), then resolved inside by the
// sequential greedy rule; the sweep of an image stops at `cap` survivors and
// the rest of its keep row is written as zeros.
//
// What bounds it on the H100: neither bytes (a few hundred KB per call) nor
// operations (at most 256 x (cap_pad + 256) IoU tests per tile) but the
// serial dependence of greedy NMS: a box's fate depends on every kept box
// before it.  The design keeps that serial part to one warp walking 256 bits
// per tile: all IoU tests of a tile run in parallel, one thread per box,
// into a 256 x 256 suppression bitmask in shared memory; warp 0 then walks
// the tile in score order, each of 8 lanes owning one 32-bit word of the
// "removed" mask, so a kept box removes its victims with one OR per lane.
// Survivors are compacted with popcounts.  Images run in parallel blocks.
//
// The IoU test is division-free, inter > thr * union with +1 areas, and
// every multiply and add is rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn, and the source is built with --fmad=false), as in the JAX
// package's XLA and Mosaic versions, so the keep bits agree exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;
constexpr int kWords = kTile / 32;

__device__ __forceinline__ float plus1_extent(float lo, float hi) {
  return __fadd_rn(__fsub_rn(hi, lo), 1.0f);
}

__device__ __forceinline__ bool iou_exceeds(float4 a, float4 b, float thr) {
  float iw = __fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.0f);
  float ih = __fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.0f);
  float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
  float area_a = __fmul_rn(plus1_extent(a.x, a.z), plus1_extent(a.y, a.w));
  float area_b = __fmul_rn(plus1_extent(b.x, b.z), plus1_extent(b.y, b.w));
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return inter > __fmul_rn(thr, uni);
}

__global__ void __launch_bounds__(kTile)
nms_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
           uint8_t* __restrict__ keep, int n, float thr, int cap,
           int cap_pad) {
  extern __shared__ float4 surv[];                  // [cap_pad]
  __shared__ float4 tb[kTile];
  __shared__ uint32_t sup[kTile][kWords];           // row k: boxes k suppresses
  __shared__ uint32_t alive_w[kWords];
  __shared__ uint32_t keep_w[kWords];

  const int t = threadIdx.x;
  const int lane = t & 31;
  boxes += (size_t)blockIdx.x * n;
  valid += (size_t)blockIdx.x * n;
  keep += (size_t)blockIdx.x * n;

  int scount = 0;  // identical in every thread
  for (int start = 0; start < n; start += kTile) {
    const int idx = start + t;
    if (scount >= cap) {
      if (idx < n) keep[idx] = 0;
      continue;
    }
    const float4 bx = idx < n ? boxes[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
    bool alive = idx < n && valid[idx] != 0;
    tb[t] = bx;

    // suppression by the survivors of earlier tiles
    const int ns = min(scount, cap_pad);
    for (int s = 0; s < ns && alive; ++s) {
      if (iou_exceeds(bx, surv[s], thr)) alive = false;
    }
    const uint32_t ab = __ballot_sync(0xffffffffu, alive);
    if (lane == 0) alive_w[t >> 5] = ab;
    __syncthreads();

    // this box's row of the in-tile suppression mask: later boxes only
    for (int w = 0; w < kWords; ++w) {
      uint32_t bits = 0;
      for (int j = 0; j < 32; ++j) {
        const int c = w * 32 + j;
        if (c > t && iou_exceeds(bx, tb[c], thr)) bits |= 1u << j;
      }
      sup[t][w] = bits;
    }
    __syncthreads();

    // the greedy walk in score order: lane w < 8 owns word w
    if (t < 32) {
      const uint32_t aw = lane < kWords ? alive_w[lane] : 0u;
      uint32_t removed = 0;
      for (int k = 0; k < kTile; ++k) {
        const uint32_t a = __shfl_sync(0xffffffffu, aw, k >> 5);
        const uint32_t r = __shfl_sync(0xffffffffu, removed, k >> 5);
        const uint32_t bit = 1u << (k & 31);
        if ((a & bit) && !(r & bit) && lane < kWords) removed |= sup[k][lane];
      }
      if (lane < kWords) keep_w[lane] = aw & ~removed;
    }
    __syncthreads();

    // compact this tile's survivors into the buffer, in score order
    const int my_w = t >> 5;
    const uint32_t word = keep_w[my_w];
    const bool kept = (word >> lane) & 1u;
    int before = __popc(word & ((1u << lane) - 1u));
    int total = 0;
    for (int w = 0; w < kWords; ++w) {
      const int c = __popc(keep_w[w]);
      if (w < my_w) before += c;
      total += c;
    }
    const int pos = scount + before;
    if (kept && pos < cap_pad) surv[pos] = bx;
    if (idx < n) keep[idx] = kept ? 1 : 0;
    scount += total;
    __syncthreads();
  }
}

}  // namespace

extern "C" int nms_keep_mask(const void* boxes, const void* valid, void* keep,
                             int b, int n, float thr, int cap, int cap_pad,
                             void* stream) {
  const size_t smem = (size_t)cap_pad * sizeof(float4);
  cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  nms_kernel<<<b, kTile, smem, (cudaStream_t)stream>>>(
      (const float4*)boxes, (const uint8_t*)valid, (uint8_t*)keep, n, thr, cap,
      cap_pad);
  return (int)cudaGetLastError();
}
