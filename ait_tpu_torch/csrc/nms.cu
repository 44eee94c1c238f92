// Greedy NMS keep-mask over score-sorted boxes, a thread-block cluster per
// image.
//
// Replaces ait_tpu/ops/nms_pallas.py:133 nms_keep_mask_batched (kernel
// `_kernel`, :60).  Same algorithm and the same keep bits for the first
// `cap` survivors of every image: boxes are swept in tiles of 256; each tile
// is first suppressed by the survivors of earlier tiles (a compacted buffer
// of at most cap_pad boxes), then resolved inside by the sequential greedy
// rule; the sweep of an image stops at `cap` survivors and the rest of its
// keep row is written as zeros.
//
// What bounds it on the H100: neither bytes (a few hundred KB per call) nor
// operations (the IoU tests: 256 x (survivors + 128) a tile, ~13 M an image
// on the flagship's own proposals at the train tops, 40 tiles walked) but
// how many SMs share them and the serial dependence of greedy NMS (a box's
// fate depends on every kept box before it).  One block per image ran the
// tests on 8 of the 132 SMs.  So each image gets a cluster of kCluster = 16
// blocks (the non-portable cluster size: 128 SMs at a batch of 8; of 1, 8
// and 16 blocks an image, 16 swept the flagship's train-time proposals
// fastest on an H100, PERF.md) that split every tile's tests:
//   * the survivors are dealt round robin, survivor s to block s % kCluster,
//     so each block tests the tile's 256 boxes (kSplit threads a box, each
//     stopping at its first hit) against its share, and ORs the warps'
//     "suppressed" words into the leader's (block 0's) shared memory through
//     distributed shared memory;
//   * the tile's 256 x 256 in-tile mask is split by rows the same way, each
//     block writing its rows into the leader's mask;
//   * after a cluster barrier the leader's first warp walks the tile in
//     score order: lane w < 8 owns word w of the "removed" mask, and the
//     walk jumps from one kept box to the next (__ffs over the alive, not
//     removed bits), one OR per kept box;
//   * after a second barrier every block reads the keep words, counts the
//     new survivors with popcounts and appends those dealt to it.
//
// The IoU test is division-free, inter > thr * union with +1 areas, and
// every multiply and add is rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn, and the source is built with --fmad=false), as in the JAX
// package's XLA and Mosaic versions, so the keep bits agree exactly; which
// block tests which survivor changes no bit ("suppressed" is an OR).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 256;
constexpr int kWords = kTile / 32;
// blocks per image, one thread-block cluster (above 8 the non-portable size)
constexpr int kCluster = 16;
// threads per box in the survivor test: a block of kSplit x 256 threads (2
// swept the flagship's proposals faster than 1 or 4 on an H100)
constexpr int kSplit = 2;
constexpr int kThreads = kSplit * kTile;

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

// grid: images x kCluster blocks, clusters of kCluster along x
__global__ void __launch_bounds__(kThreads)
nms_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
           uint8_t* __restrict__ keep, int n, float thr, int cap,
           int cap_pad) {
  // survivors s with s % kCluster == rank, at s / kCluster
  extern __shared__ float4 share[];
  __shared__ float4 tb[kTile];
  __shared__ uint32_t sup[kTile][kWords];  // leader: row k, boxes k suppresses
  __shared__ uint32_t supp_w[kWords];      // leader: suppressed by survivors
  __shared__ uint32_t keep_w[kWords];      // leader: the tile's keep bits
  __shared__ uint32_t ok_w[kWords];        // valid bits of the tile
  __shared__ uint32_t kw[kWords];          // this block's copy of keep_w

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  uint32_t* lsup = cluster.map_shared_rank(&sup[0][0], 0);
  uint32_t* lsupp = cluster.map_shared_rank(&supp_w[0], 0);
  const uint32_t* lkeep = cluster.map_shared_rank(&keep_w[0], 0);

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int box = t & (kTile - 1), part = t / kTile;
  const size_t img = blockIdx.x / kCluster;
  boxes += img * n;
  valid += img * n;
  keep += img * n;
  if (rank == 0 && t < kWords) supp_w[t] = 0;
  cluster.sync();   // every block runs, the leader's words are zero

  int scount = 0;   // identical in every thread of the cluster
  for (int start = 0; start < n; start += kTile) {
    const int idx = start + box;
    if (scount >= cap) {
      if (rank == 0 && part == 0 && idx < n) keep[idx] = 0;
      continue;
    }
    if (part == 0) {
      tb[t] = idx < n ? boxes[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
      const uint32_t okb = __ballot_sync(0xffffffffu, idx < n && valid[idx]);
      if (lane == 0) ok_w[warp] = okb;
    }
    __syncthreads();   // tb and ok_w complete
    const float4 bx = tb[box];
    const bool ok = (ok_w[box >> 5] >> (box & 31)) & 1u;

    // suppression by this block's share of the earlier survivors, the
    // kSplit threads of a box taking every kSplit-th of them
    const int ns = min(scount, cap_pad);
    const int mine = ns > rank ? (ns - rank + kCluster - 1) / kCluster : 0;
    bool hit = false;
    if (ok)
      for (int i = part; i < mine; i += kSplit)
        if (iou_exceeds(bx, share[i], thr)) {
          hit = true;
          break;
        }
    const uint32_t hb = __ballot_sync(0xffffffffu, hit);
    if (lane == 0 && hb) atomicOr(lsupp + (warp & (kWords - 1)), hb);

    // this block's rows of the in-tile mask (later boxes only): thread t
    // takes word t % 8 of rows rank + kCluster (t / 8),
    // rank + kCluster (t / 8 + kThreads / 8), ...
    for (int k = rank + kCluster * (t >> 3); k < kTile;
         k += kCluster * (kThreads / 8)) {
      const int w = t & 7;
      uint32_t bits = 0;
      if ((ok_w[k >> 5] >> (k & 31)) & 1u) {
        const float4 a = tb[k];
        for (int j = 0; j < 32; ++j) {
          const int c = w * 32 + j;
          if (c > k && iou_exceeds(a, tb[c], thr)) bits |= 1u << j;
        }
      }
      lsup[k * kWords + w] = bits;
    }
    cluster.sync();

    // the leader's greedy walk in score order, kept box to kept box
    if (rank == 0 && t < 32) {
      const uint32_t aw = lane < kWords ? ok_w[lane] & ~supp_w[lane] : 0u;
      uint32_t removed = 0;
      for (int w = 0; w < kWords; ++w) {
        uint32_t cand = __shfl_sync(0xffffffffu, aw & ~removed, w);
        while (cand) {
          const int b = __ffs(cand) - 1;
          if (lane < kWords) removed |= sup[w * 32 + b][lane];
          cand &= __shfl_sync(0xffffffffu, ~removed, w) & ~((2u << b) - 1u);
        }
      }
      if (lane < kWords) {
        keep_w[lane] = aw & ~removed;
        supp_w[lane] = 0;
      }
    }
    cluster.sync();

    // the new survivors, in score order; each block keeps those dealt to it
    if (t < kWords) kw[t] = lkeep[t];
    __syncthreads();
    int total = 0;
    for (int w = 0; w < kWords; ++w) total += __popc(kw[w]);
    if (part == 0) {
      const uint32_t word = kw[warp];
      const bool kept = (word >> lane) & 1u;
      int before = __popc(word & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) before += __popc(kw[w]);
      const int pos = scount + before;
      if (kept && pos < cap_pad && pos % kCluster == rank)
        share[pos / kCluster] = bx;
      if (rank == 0 && idx < n) keep[idx] = kept ? 1 : 0;
    }
    scount += total;
    __syncthreads();
  }
  cluster.sync();   // no block leaves while another may read its memory
}

}  // namespace

// keep [b, n] (uint8) of score-sorted boxes [b, n, 4] with valid [b, n]
extern "C" int nms_keep_mask(const void* boxes, const void* valid, void* keep,
                             int b, int n, float thr, int cap, int cap_pad,
                             void* stream) {
  if (b < 1) return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)((cap_pad + kCluster - 1) / kCluster) * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, nms_kernel, (const float4*)boxes,
                           (const uint8_t*)valid, (uint8_t*)keep, n, thr, cap,
                           cap_pad);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
