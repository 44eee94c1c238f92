// The products and column sums of the port's backward kernels: the forward
// recompute, the input gradients and the weight gradients of the FFN
// backward (ops/fused_ffn.py), the projections' input and weight gradients
// of the attention backward, and the long-sequence regime's projections
// (ops/fused_attention.py).  The Pallas backward kernels compute these
// products inside their own bodies (ait_tpu/ops/pallas_ffn.py:104
// `_bwd_kernel`, ait_tpu/ops/pallas_attention.py:412 `_bwd_kernel`); here
// they are one hand-written product kernel, launched by the wrappers.
//
//   C[m][n] = epilogue(sum_k A(m, k) B(k, n)),  f32 accumulators
//
// with three layouts of row-major operands: NN (A [M, K], B [K, N]), NT
// (A [M, K], B [N, K]: x @ w^T) and TN (A [K, M], B [K, N]: x^T @ dy, the
// weight gradients, whose K is the row count of the batch).  The epilogue
// adds a per-column bias and an f32 addend (which may alias the output),
// applies relu or a "> 0" mask (the relu derivative), and stores f32 or
// bf16.
//
// What bounds it on the H100: operations.  At the train shapes (B = 8, 128
// rois per image) the FFN's products are 0.12-0.14 TFLOP each and the
// attention's 0.03-0.07 against tens to hundreds of MB of operands, above
// the card's ~295 operations per byte in bf16.
// The JAX kernels take bf16 x bf16 operands in four of the FFN backward's
// six products and an f32 cotangent in the rest (pallas_ffn.py:154-161,
// pallas_attention.py:535-554, :608-624), so the design is:
//
// * Tensor cores: `wgmma.mma_async` m64n128k16, bf16 operands from shared
//   memory, f32 accumulators in registers.  A block computes a 128 x 128
//   tile with two consumer warpgroups (64 rows each) and one producer warp;
//   one block per SM (288 threads).  The tensor cores' additions truncate:
//   over a 65k-row weight gradient the sum drifts ~1e-4 toward zero, so
//   with an f32 operand each 64-deep stage is summed on its own and added
//   to a second register accumulator in f32, rounded to nearest (drift
//   ~2e-7).  bf16 x bf16 (K <= 2048 on the train path) keeps one stage's
//   MMAs in flight while the next stage's are issued.
// * TMA: the producer warp keeps a ring of 64-deep k-stages in flight
//   (`cp.async.bulk.tensor` into shared memory, `mbarrier` full/empty pairs):
//   5 stages of 32 KB for bf16 x bf16, 3 of 48 KB when one operand is f32.
//   bf16 tiles land with the 128-byte swizzle that the wgmma descriptors
//   name; each operand is read K-major or MN-major (the descriptors'
//   transpose bits), so NN, NT and TN need no transposing copy.  The maps
//   are encoded on the host per call; ragged M, N and K edges are TMA's zero
//   fill.
// * An f32 operand (the cotangents dy1, dy2, dz, dk, dv, dy0) is exact in
//   three bf16 terms, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi -
//   mid) (for |v| >= 2^-110; below, lo loses the bits under 2^-133; an
//   infinite hi gives nan).  Its f32 tile arrives unswizzled; the consumer
//   warps split it into three swizzled bf16 tiles and issue three wgmmas into
//   one accumulator: the f32 product up to the order of summation, at a
//   third of the bf16 rate.
// * Split-K for the weight gradients (K up to 65,536 rows onto 4-64 output
//   tiles): the wrapper takes the fewest splits whose waves fill >= 90% of
//   the SMs with >= 8 k-stages each; every split writes its partial tile and
//   a second kernel sums the partials in split order.  Deterministic, no
//   atomics.  Blocks that share the larger operand's tile run next to each
//   other, so it is read from L2.
// * The epilogue works on the accumulator fragments in registers (pairs of
//   columns, 8- or 4-byte stores).
//
// Shared memory: 161 KB (bf16 x bf16) or 193 KB (one f32 operand: its three
// bf16 tiles take 48 KB beside the ring); one block per SM.
//
// f32 x f32 (the f32 check path, and the gate's dsk_w = s^T dlogit, where s
// is a true f32 mean) keeps the CUDA-core FMA tiles: 64 x 64 tiles, 16-deep
// k-slabs, 4 x 4 outputs a thread, the same split-K scheme.

#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using hopper::make_desc;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;
using hopper::split_pair;
using hopper::tma_load;
using hopper::wgmma_128;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;

enum Layout { kNN = 0, kNT = 1, kTN = 2 };

struct Epilogue {
  const float* bias;    // [N] or null
  const float* cadd;    // [M, N] f32 or null (may alias out)
  const void* mask;     // [M, N] (mask_bf16 ? bf16 : f32) or null
  int mask_bf16;
  int relu;
  void* out;            // [M, N]
  int out_bf16;
};

__device__ __forceinline__ void finish(const Epilogue& e, int m, int n, int N,
                                       float v) {
  const size_t i = (size_t)m * N + n;
  if (e.bias) v += e.bias[n];
  if (e.cadd) v += e.cadd[i];
  if (e.relu) v = fmaxf(v, 0.f);
  if (e.mask) {
    const float mv = e.mask_bf16
                         ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(e.mask)[i])
                         : reinterpret_cast<const float*>(e.mask)[i];
    if (!(mv > 0.f)) v = 0.f;
  }
  if (e.out_bf16)
    reinterpret_cast<__nv_bfloat16*>(e.out)[i] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(e.out)[i] = v;
}

// the same for columns n, n + 1 (n and N even)
__device__ __forceinline__ void finish2(const Epilogue& e, int m, int n, int N,
                                        float v0, float v1) {
  const size_t i = (size_t)m * N + n;
  if (e.bias) {
    const float2 b = *reinterpret_cast<const float2*>(e.bias + n);
    v0 += b.x;
    v1 += b.y;
  }
  if (e.cadd) {
    const float2 c = *reinterpret_cast<const float2*>(e.cadd + i);
    v0 += c.x;
    v1 += c.y;
  }
  if (e.relu) {
    v0 = fmaxf(v0, 0.f);
    v1 = fmaxf(v1, 0.f);
  }
  if (e.mask) {
    float2 mv;
    if (e.mask_bf16)
      mv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          reinterpret_cast<const __nv_bfloat16*>(e.mask) + i));
    else
      mv = *reinterpret_cast<const float2*>(
          reinterpret_cast<const float*>(e.mask) + i);
    if (!(mv.x > 0.f)) v0 = 0.f;
    if (!(mv.y > 0.f)) v1 = 0.f;
  }
  if (e.out_bf16)
    *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(e.out) + i) =
        __floats2bfloat162_rn(v0, v1);
  else
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(e.out) + i) =
        make_float2(v0, v1);
}

// ------------------------------------------------ tensor cores (wgmma, TMA)

constexpr int kTileM = 128, kTileN = 128, kTileK = 64;  // block tile, stage depth
constexpr int kTile = 8192;                     // elements of one operand stage
constexpr int kTcThreads = 288;                 // 2 consumer warpgroups + 1 warp
constexpr int kConsumers = 256;

// An operand's stage is a logical [R][C] tile, R x C = 8192: K-major (A of
// NN/NT, B of NT) R = 128 rows of the M or N side by C = 64 k; MN-major (A
// of TN, B of NN/TN) R = 64 k by C = 128.  In bf16 it is kept as panels of 64
// columns (128 bytes a row), panel p at p * R * 128 bytes, 16-byte chunk j
// of row r at chunk j ^ (r % 8): what TMA's 128-byte swizzle writes for a
// box of 64 columns, and what a wgmma descriptor with layout type 1 reads.
// In f32 it is the unswizzled row-major box.
template <bool KMajor>
struct Geo {
  static constexpr int C = KMajor ? 64 : 128;
  static constexpr int R = kTile / C;
  // descriptor strides: the leading byte offset steps to the next 64
  // elements of the M/N side (MN-major only), the stride byte offset to the
  // next group of 8 rows of the swizzle atom; one k16 step of the MMA moves
  // the start 32 bytes along a K-major row or 16 rows of an MN-major panel
  static constexpr uint32_t lbo = KMajor ? 16 : R * 128;
  static constexpr uint32_t sbo = 1024;
  static constexpr uint32_t kstep = KMajor ? 32 : 16 * 128;
};

// the f32 stage `src` ([R][C] row-major) -> three swizzled bf16 tiles at
// dst, dst + 16 KB, dst + 32 KB; by the 256 consumer threads, 8 columns each
template <bool KMajor>
__device__ __forceinline__ void split_stage(const float* src, uint8_t* dst,
                                            int t) {
  using G = Geo<KMajor>;
#pragma unroll
  for (int i = 0; i < kTile / 8 / kConsumers; ++i) {
    const int g = t + i * kConsumers;
    const int r = g / (G::C / 8), c = (g % (G::C / 8)) * 8;
    const float4 v0 = *reinterpret_cast<const float4*>(src + r * G::C + c);
    const float4 v1 = *reinterpret_cast<const float4*>(src + r * G::C + c + 4);
    uint4 h, m, l;
    split_pair(v0.x, v0.y, h.x, m.x, l.x);
    split_pair(v0.z, v0.w, h.y, m.y, l.y);
    split_pair(v1.x, v1.y, h.z, m.z, l.z);
    split_pair(v1.z, v1.w, h.w, m.w, l.w);
    const int off = (c / 64) * (G::R * 128) + r * 128 +
                    ((((c % 64) / 8) ^ (r % 8)) * 16);
    *reinterpret_cast<uint4*>(dst + off) = h;
    *reinterpret_cast<uint4*>(dst + 2 * kTile + off) = m;
    *reinterpret_cast<uint4*>(dst + 4 * kTile + off) = l;
  }
}

// one operand's stage: its bytes, and the TMA copies that fill it
template <bool KMajor, bool F32>
struct Operand {
  static constexpr uint32_t bytes = F32 ? 4 * kTile : 2 * kTile;
  __device__ static void load(const CUtensorMap* map, uint32_t dst,
                              uint32_t bar, int mn0, int k0) {
    if (KMajor)                 // box {64 k, 128 rows}
      tma_load(dst, map, bar, k0, mn0);
    else if (F32)               // box {128 columns, 64 k}
      tma_load(dst, map, bar, mn0, k0);
    else {                      // two boxes {64 columns, 64 k}, one a panel
      tma_load(dst, map, bar, mn0, k0);
      tma_load(dst + 64 * 128, map, bar, mn0 + 64, k0);
    }
  }
};

template <int L, bool AF, bool BF>
struct TcConfig {
  static constexpr bool a_kmajor = L != kTN, b_kmajor = L == kNT;
  using OA = Operand<a_kmajor, AF>;
  using OB = Operand<b_kmajor, BF>;
  static constexpr bool split = AF || BF;
  static constexpr int stages = split ? 3 : 5;
  static constexpr uint32_t stage_bytes = OA::bytes + OB::bytes;
  static constexpr uint32_t split_bytes = split ? 3 * 2 * kTile : 0;
  static constexpr uint32_t bar_off = stages * stage_bytes + split_bytes;
  static constexpr uint32_t smem = 1024 + bar_off + 2 * stages * 8;
};

template <int L, bool AF, bool BF>
__global__ void __launch_bounds__(kTcThreads, 1)
tc_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b, int M, int N, int K,
               int kchunk, int n_fast, Epilogue e, float* __restrict__ partial) {
  using Cfg = TcConfig<L, AF, BF>;
  using GA = Geo<Cfg::a_kmajor>;
  using GB = Geo<Cfg::b_kmajor>;
  constexpr int S = Cfg::stages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + Cfg::bar_off, empty = full + 8 * S;

  const int tiles_m = (M + kTileM - 1) / kTileM;
  const int tiles_n = (N + kTileN - 1) / kTileN;
  const int tm = n_fast ? blockIdx.x / tiles_n : blockIdx.x % tiles_m;
  const int tn = n_fast ? blockIdx.x % tiles_n : blockIdx.x / tiles_m;
  const int m0 = tm * kTileM, n0 = tn * kTileN;
  const int kbeg = blockIdx.y * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const int iters = kend > kbeg ? (kend - kbeg + kTileK - 1) / kTileK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == kConsumers / 32) {              // the producer warp
    if (threadIdx.x % 32 == 0) {
      for (int it = 0; it < iters; ++it) {
        const int s = it % S;
        const uint32_t ph = (it / S) & 1;
        mbar_wait(empty + 8 * s, ph ^ 1);
        mbar_expect_tx(full + 8 * s, Cfg::stage_bytes);
        const uint32_t a = base + s * Cfg::stage_bytes;
        const int k0 = kbeg + it * kTileK;
        Cfg::OA::load(&map_a, a, full + 8 * s, m0, k0);
        Cfg::OB::load(&map_b, a + Cfg::OA::bytes, full + 8 * s, n0, k0);
      }
    }
    return;
  }

  const int wg = warp / 4;                    // rows 64 wg .. 64 wg + 63
  // the tensor cores sum the products into `acc` (their additions
  // truncate); with an f32 operand (the 65k-row weight gradients) each
  // stage's sum goes on into `tot` in f32, rounded to nearest
  float acc[64], tot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
  uint8_t* terms = smem + S * Cfg::stage_bytes;   // hi, mid, lo (split only)
  const uint32_t terms_u32 = base + S * Cfg::stage_bytes;
  // warpgroup 1 reads the A stage's rows 64..127: 64 rows of 128 bytes
  // (K-major) or the second 64-column panel (MN-major); 8 KB either way
  constexpr uint32_t wg_off = 64 * 128;

  for (int it = 0; it < iters; ++it) {
    const int s = it % S;
    mbar_wait(full + 8 * s, (it / S) & 1);
    const uint32_t a = base + s * Cfg::stage_bytes;
    const uint32_t b = a + Cfg::OA::bytes;
    if (Cfg::split) {
      // every warpgroup is done with the last stage's terms (wait_group 0)
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      const float* src = reinterpret_cast<const float*>(
          smem + s * Cfg::stage_bytes + (AF ? 0 : Cfg::OA::bytes));
      split_stage<AF ? Cfg::a_kmajor : Cfg::b_kmajor>(src, terms,
                                                      threadIdx.x);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      if (AF) {
        const uint64_t db = make_desc(b + kk * GB::kstep, GB::lbo, GB::sbo);
#pragma unroll
        for (int t = 0; t < 3; ++t)
          wgmma_128<!Cfg::a_kmajor, !Cfg::b_kmajor>(
              acc,
              make_desc(terms_u32 + t * 2 * kTile + wg * wg_off +
                            kk * GA::kstep,
                        GA::lbo, GA::sbo),
              db, kk + t > 0);
      } else if (BF) {
        const uint64_t da = make_desc(a + wg * wg_off + kk * GA::kstep,
                                      GA::lbo, GA::sbo);
#pragma unroll
        for (int t = 0; t < 3; ++t)
          wgmma_128<!Cfg::a_kmajor, !Cfg::b_kmajor>(
              acc, da,
              make_desc(terms_u32 + t * 2 * kTile + kk * GB::kstep, GB::lbo,
                        GB::sbo),
              kk + t > 0);
      } else {
        wgmma_128<!Cfg::a_kmajor, !Cfg::b_kmajor>(
            acc,
            make_desc(a + wg * wg_off + kk * GA::kstep, GA::lbo, GA::sbo),
            make_desc(b + kk * GB::kstep, GB::lbo, GB::sbo), 1);
      }
    }
    wgmma_commit();
    if (Cfg::split) {
      wgmma_wait<0>();
      mbar_arrive(empty + 8 * s);
      // the stage's sum into the f32 total (the other warpgroup's MMAs
      // keep the tensor cores busy meanwhile)
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] += acc[i];
    } else {
      // keep one group in flight: the previous stage is free once it is done
      wgmma_wait<1>();
      if (it > 0) mbar_arrive(empty + 8 * ((it - 1) % S));
    }
  }
  wgmma_wait<0>();

  // accumulator fragment: warp w of the warpgroup holds rows 16 w + lane / 4
  // (+ 8), columns 8 j + 2 (lane % 4) (+ 1) in [4 j .. 4 j + 3] of the sum
  const int lane = threadIdx.x % 32, w = warp % 4;
  const int row = m0 + wg * 64 + w * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < kTileN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= M) continue;
      const int i = 4 * j + 2 * h;
      const float v0 = Cfg::split ? tot[i] : acc[i];
      const float v1 = Cfg::split ? tot[i + 1] : acc[i + 1];
      if (partial)
        *reinterpret_cast<float2*>(
            partial + ((size_t)blockIdx.y * M + r) * N + col) =
            make_float2(v0, v1);
      else
        finish2(e, r, col, N, v0, v1);
    }
  }
}

// the map of one operand, a row-major [outer, inner] matrix, for its stage's
// box (see Operand::load); false if the encoder refuses it
template <bool KMajor, bool F32>
bool make_map(CUtensorMap* map, const void* ptr, int outer, int inner) {
  return hopper::make_map(map, ptr, F32, outer, inner,
                          KMajor ? 64 : (F32 ? 128 : 64), KMajor ? 128 : 64,
                          !F32);
}

// ------------------------------------------------ f32 x f32: CUDA-core FMAs

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kThreads = 256;

template <int L>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const float* __restrict__ a, const float* __restrict__ b, int M,
            int N, int K, int kchunk, Epilogue e, float* __restrict__ partial) {
  __shared__ float as[kBK][kBM + 4];
  __shared__ float bs[kBK][kBN + 4];
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < kBM * kBK / kThreads; ++r) {
      const int idx = t + r * kThreads;
      int mm, kk;
      if (L == kTN) { kk = idx / kBM; mm = idx % kBM; }   // A [K, M]: m contiguous
      else          { mm = idx / kBK; kk = idx % kBK; }   // A [M, K]: k contiguous
      const int m = m0 + mm, k = k0 + kk;
      float v = 0.f;
      if (m < M && k < kend)
        v = L == kTN ? a[(size_t)k * M + m] : a[(size_t)m * K + k];
      as[kk][mm] = v;
    }
#pragma unroll
    for (int r = 0; r < kBN * kBK / kThreads; ++r) {
      const int idx = t + r * kThreads;
      int nn, kk;
      if (L == kNT) { nn = idx / kBK; kk = idx % kBK; }   // B [N, K]: k contiguous
      else          { kk = idx / kBN; nn = idx % kBN; }   // B [K, N]: n contiguous
      const int n = n0 + nn, k = k0 + kk;
      float v = 0.f;
      if (n < N && k < kend)
        v = L == kNT ? b[(size_t)n * K + k] : b[(size_t)k * N + n];
      bs[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m >= M || n >= N) continue;
      if (partial)
        partial[((size_t)blockIdx.z * M + m) * N + n] = acc[i][j];
      else
        finish(e, m, n, N, acc[i][j]);
    }
}

// out = epilogue(sum over the splits, in split order)
__global__ void __launch_bounds__(kThreads)
reduce_splits(const float* __restrict__ partial, int splits, int M, int N,
              Epilogue e) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += partial[s * mn + i];
  finish(e, (int)(i / N), (int)(i % N), N, v);
}

// part[s][c] = sum of rows [s * chunk, (s + 1) * chunk) of column c, in order
__global__ void __launch_bounds__(kThreads)
colsum_kernel(const float* __restrict__ x, int rows, int cols, int chunk,
              float* __restrict__ part) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.y * chunk, r1 = min(rows, r0 + chunk);
  float v = 0.f;
  for (int r = r0; r < r1; ++r) v += x[(size_t)r * cols + c];
  part[(size_t)blockIdx.y * cols + c] = v;
}

void launch_reduce(float* partial, int splits, int M, int N, const Epilogue& e,
                   cudaStream_t s) {
  const size_t mn = (size_t)M * N;
  reduce_splits<<<(unsigned)((mn + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      partial, splits, M, N, e);
}

// k-chunk of each split (a multiple of `depth`) and the splits it leaves
int chunk_of(int K, int& splits, int depth) {
  const int kchunk = ((K + splits - 1) / splits + depth - 1) / depth * depth;
  splits = (K + kchunk - 1) / kchunk;
  return kchunk;
}

template <int L, bool AF, bool BF>
int launch_tc(const void* a, const void* b, int M, int N, int K, int splits,
              float* partial, const Epilogue& e, cudaStream_t s) {
  using Cfg = TcConfig<L, AF, BF>;
  CUtensorMap ma, mb;
  // A: [M, K] (K-major) or [K, M]; B: [N, K] (K-major) or [K, N]
  if (!make_map<Cfg::a_kmajor, AF>(&ma, a, Cfg::a_kmajor ? M : K,
                                   Cfg::a_kmajor ? K : M) ||
      !make_map<Cfg::b_kmajor, BF>(&mb, b, Cfg::b_kmajor ? N : K,
                                   Cfg::b_kmajor ? K : N))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        tc_gemm_kernel<L, AF, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Cfg::smem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const int kchunk = chunk_of(K, splits, kTileK);
  const int tiles = ((M + kTileM - 1) / kTileM) * ((N + kTileN - 1) / kTileN);
  tc_gemm_kernel<L, AF, BF><<<dim3(tiles, splits), kTcThreads, Cfg::smem, s>>>(
      ma, mb, M, N, K, kchunk, M >= N, e, splits > 1 ? partial : nullptr);
  if (splits > 1) launch_reduce(partial, splits, M, N, e, s);
  return (int)cudaGetLastError();
}

template <int L>
int launch_fma(const void* a, const void* b, int M, int N, int K, int splits,
               float* partial, const Epilogue& e, cudaStream_t s) {
  const int kchunk = chunk_of(K, splits, kBK);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  gemm_kernel<L><<<grid, kThreads, 0, s>>>(
      (const float*)a, (const float*)b, M, N, K, kchunk, e,
      splits > 1 ? partial : nullptr);
  if (splits > 1) launch_reduce(partial, splits, M, N, e, s);
  return (int)cudaGetLastError();
}

template <int L>
int launch_types(int a_bf16, int b_bf16, const void* a, const void* b, int M,
                 int N, int K, int splits, float* partial, const Epilogue& e,
                 cudaStream_t s) {
  if (a_bf16 && b_bf16)
    return launch_tc<L, false, false>(a, b, M, N, K, splits, partial, e, s);
  if (a_bf16)
    return launch_tc<L, false, true>(a, b, M, N, K, splits, partial, e, s);
  if (b_bf16)
    return launch_tc<L, true, false>(a, b, M, N, K, splits, partial, e, s);
  return launch_fma<L>(a, b, M, N, K, splits, partial, e, s);
}

}  // namespace

// layout 0 NN, 1 NT, 2 TN.  A bf16 operand on either side takes the tensor
// cores (an f32 one in three bf16 terms); f32 x f32 the FMA tiles.  With
// splits > 1, partial holds splits * M * N f32.  The tensor-core path needs
// each operand's rows 16-byte aligned (the wrapper checks).
extern "C" int gemm(int layout, int a_bf16, int b_bf16, int M, int N, int K,
                    const void* a, const void* b, int splits, void* partial,
                    const void* bias, const void* cadd, const void* mask,
                    int mask_bf16, int relu, void* out, int out_bf16,
                    void* stream) {
  Epilogue e{(const float*)bias, (const float*)cadd, mask, mask_bf16, relu,
             out, out_bf16};
  cudaStream_t s = (cudaStream_t)stream;
  float* p = (float*)partial;
  if (splits < 1) splits = 1;
  switch (layout) {
    case kNN: return launch_types<kNN>(a_bf16, b_bf16, a, b, M, N, K, splits, p, e, s);
    case kNT: return launch_types<kNT>(a_bf16, b_bf16, a, b, M, N, K, splits, p, e, s);
    case kTN: return launch_types<kTN>(a_bf16, b_bf16, a, b, M, N, K, splits, p, e, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out[c] = sum_r x[r][c] over f32 x [rows, cols], in a fixed order: `splits`
// row chunks into scratch [splits, cols], then the chunks in order
extern "C" int colsum(const void* x, int rows, int cols, int splits,
                      void* scratch, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int chunk = (rows + splits - 1) / splits;
  splits = rows > 0 ? (rows + chunk - 1) / chunk : 1;
  const unsigned cb = (cols + kThreads - 1) / kThreads;
  if (rows == 0) {
    cudaMemsetAsync(out, 0, (size_t)cols * sizeof(float), s);
    return (int)cudaGetLastError();
  }
  colsum_kernel<<<dim3(cb, splits), kThreads, 0, s>>>(
      (const float*)x, rows, cols, chunk, (float*)scratch);
  colsum_kernel<<<dim3(cb, 1), kThreads, 0, s>>>(
      (const float*)scratch, splits, cols, splits, (float*)out);
  return (int)cudaGetLastError();
}
