// Fused position-wise FFN forward of the AIT head, over flat rows:
//   out = LayerNorm((relu(x @ w1 + b1) @ w2 + b2) * keep / keep_prob + x),
// D = 512, hidden 2048, eps 1e-6, f32 statistics; the hidden activation is
// rounded to the storage type before the second product, as in the JAX code.
// The output dropout's keep-mask is the Philox stream of csrc/philox.cuh
// (tag 3, a block per absolute row), drawn in the epilogue where each lane
// holds 4 consecutive columns of a row: one Philox call per lane and row
// tile.  With no seed (eval, or keep_prob 1) nothing is dropped.
//
// Replaces ait_tpu/ops/pallas_ffn.py:195 fused_ffn (kernel `_fwd_kernel`,
// :77, with its in-kernel dropout :91-95).
//
// What bounds it on the H100: operations.  Each row costs 4.2 MFLOP against
// 2 KB of row traffic in bf16, far above the card's ~295 operations per
// byte.  The design keeps the whole block on chip so that neither the
// [rows, 2048] hidden activation nor the [rows, 512] pre-LayerNorm sum ever
// reaches device memory: one block per row tile holds its x tile in shared
// memory (it is also the residual), walks the hidden dimension in chunks
// (h = relu(x @ w1[:, chunk] + b1), then y += h @ w2[chunk, :]), streams the
// w1 and w2 slices through shared memory, and keeps the [rows, 512] f32
// accumulator in registers.  The weights (4 MB) come from L2 once per row
// tile: 8.4 GB of L2 reads per eval encoder call at 64 rows a tile.
//
// bf16 (the path's type) multiplies on the tensor cores: `wgmma` fed by a
// TMA ring (see the bf16 section below; the TMA, mbarrier and descriptor
// helpers are csrc/hopper.cuh's, shared with csrc/gemm.cu).  f32 (kept for
// the tight check against the plain version) uses CUDA-core FMAs, 32 rows
// per block, 4 rows x 16 columns per thread so that each warp owns whole
// rows.

#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace {

constexpr int kD = 512;
constexpr int kHid = 2048;
constexpr int kRows = 32;      // rows per block
constexpr int kChunk = 64;     // hidden units per step
constexpr int kSlab1 = 64;     // rows of w1 staged at once
constexpr int kSlab2 = 16;     // rows of w2 staged at once
constexpr int kThreads = 256;  // 8 warps

// the output dropout's factors of columns c..c+3 of row `row` (one Philox
// group; 1 when there is no dropout or the row is past the end)
__device__ __forceinline__ void drop_scales(const ait::Dropout& d, int row,
                                            int c, float m[4]) {
  m[0] = m[1] = m[2] = m[3] = 1.f;
  if (d.seed == nullptr) return;
  const uint4 w = ait::keep_group(ait::seed_key(d.seed), ait::kTagFfn, 0, row,
                                  c / 4);
  m[0] = ait::drop_scale(w.x, d.thresh, d.inv_keep);
  m[1] = ait::drop_scale(w.y, d.thresh, d.inv_keep);
  m[2] = ait::drop_scale(w.z, d.thresh, d.inv_keep);
  m[3] = ait::drop_scale(w.w, d.thresh, d.inv_keep);
}

constexpr int kOffW1 = kRows * kD;
constexpr int kOffH = kOffW1 + kSlab1 * kChunk;
constexpr int kOffW2 = kOffH + kRows * kChunk;
constexpr int kSmemFloats = kOffW2 + kSlab2 * kD;

// ---- f32: CUDA-core FMAs, 32 rows per block, 4 rows per warp -------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
ffn_kernel(const T* __restrict__ x, const T* __restrict__ w1,
           const float* __restrict__ b1, const T* __restrict__ w2,
           const float* __restrict__ b2, const float* __restrict__ lns,
           const float* __restrict__ lnb, T* __restrict__ out, int n,
           ait::Dropout drop) {
  extern __shared__ float sm[];
  float* xs = sm;            // [kRows][kD]
  float* w1s = sm + kOffW1;  // [kSlab1][kChunk]
  float* hs = sm + kOffH;    // [kRows][kChunk]
  float* w2s = sm + kOffW2;  // [kSlab2][kD]

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);

  for (int v = t; v < kRows * kD / 8; v += kThreads) {
    const int r = v / (kD / 8), c = (v % (kD / 8)) * 8;
    float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < rows) ait::load8(x + (size_t)(row0 + r) * kD + c, a);
    ait::store8(xs + r * kD + c, a);
  }

  // y[i][4j + e]: row 4*warp + i, column 128*j + 4*lane + e
  float y[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 16; ++c) y[i][c] = 0.f;

  for (int c0 = 0; c0 < kHid; c0 += kChunk) {
    // h[i][e]: row 4*warp + i, hidden unit c0 + 2*lane + e
    float h[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    for (int k0 = 0; k0 < kD; k0 += kSlab1) {
      __syncthreads();
      for (int v = t; v < kSlab1 * kChunk / 8; v += kThreads) {
        const int kk = v / (kChunk / 8), c = (v % (kChunk / 8)) * 8;
        float a[8];
        ait::load8(w1 + (size_t)(k0 + kk) * kHid + c0 + c, a);
        ait::store8(w1s + kk * kChunk + c, a);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kSlab1; ++kk) {
        const float2 wv = *reinterpret_cast<const float2*>(w1s + kk * kChunk + 2 * lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = xs[(4 * warp + i) * kD + k0 + kk];
          h[i][0] += xv * wv.x;
          h[i][1] += xv * wv.y;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * lane + e;
        hs[(4 * warp + i) * kChunk + c] =
            ait::round_to(fmaxf(h[i][e] + b1[c0 + c], 0.f), x);
      }

    for (int k0 = 0; k0 < kChunk; k0 += kSlab2) {
      __syncthreads();
      for (int v = t; v < kSlab2 * kD / 8; v += kThreads) {
        const int kk = v / (kD / 8), c = (v % (kD / 8)) * 8;
        float a[8];
        ait::load8(w2 + (size_t)(c0 + k0 + kk) * kD + c, a);
        ait::store8(w2s + kk * kD + c, a);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kSlab2; ++kk) {
        float hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) hv[i] = hs[(4 * warp + i) * kChunk + k0 + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 wv = *reinterpret_cast<const float4*>(w2s + kk * kD + 128 * j + 4 * lane);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            y[i][4 * j + 0] += hv[i] * wv.x;
            y[i][4 * j + 1] += hv[i] * wv.y;
            y[i][4 * j + 2] += hv[i] * wv.z;
            y[i][4 * j + 3] += hv[i] * wv.w;
          }
        }
      }
    }
  }

  // + b2, dropout, + residual, LayerNorm; each warp owns its 4 rows whole
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * warp + i;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float m[4];
      drop_scales(drop, row0 + r, 128 * j + 4 * lane, m);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 128 * j + 4 * lane + e;
        y[i][4 * j + e] = (y[i][4 * j + e] + b2[c]) * m[e] + xs[r * kD + c];
        s += y[i][4 * j + e];
      }
    }
    const float mu = ait::warp_sum(s) / kD;
    float q = 0.f;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const float d = y[i][c] - mu;
      q += d * d;
    }
    const float rs = rsqrtf(ait::warp_sum(q) / kD + 1e-6f);
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 128 * j + 4 * lane;
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = (y[i][4 * j + e] - mu) * rs * lns[c + e] + lnb[c + e];
        ait::store4(out + (size_t)(row0 + r) * kD + c, o[0], o[1], o[2], o[3]);
      }
    }
  }
}

// ---- bf16: the two products on the tensor cores (wgmma, TMA) -------------
//
// One block per tile of 64 rows, one block per SM: two warpgroups (256
// threads, so up to 255 registers a thread: y's and h's accumulators alone
// take 160, and ptxas caps a block of 288 or 384 threads at 168, where the
// accumulators spill and the wgmmas serialize).  Thread 0 is also the
// producer: it loads the block's x tile once (TMA, 8 swizzled panels of 64
// columns, 64 KB; it is also the residual), then keeps a ring of 8 stages of
// 16 KB in flight, refilling each slot once the warpgroups have moved on
// from it (so neither warpgroup waits on the other there): per hidden chunk
// of 128 units, the chunk's w1 columns in 8 k-stages [64 k, 128 n], then its
// w2 rows in 8 stages [16 k, 512 n] (`mbarrier` full/empty pairs).  Per
// chunk the warpgroups compute
//   h  = x w1[:, chunk]    wgmma m64n64k16, warpgroup g the chunk's columns
//                          64 g .. 64 g + 63 (32 registers a thread);
//   h  = relu(h + b1), rounded to bf16 into a swizzled [64, 128] tile in
//                          shared memory (two tiles, used in turn), then a
//                          barrier across both warpgroups;
//   y += h w2[chunk, :]    wgmma m64n128k16 twice, warpgroup g the output
//                          columns 256 g .. 256 g + 255 (128 registers),
// keeping one step's MMAs in flight while the next step's are issued, so
// neither h nor y leaves the SM.  After the last chunk the two warpgroups
// put y into shared memory (over the h tiles and the ring) and each warp
// runs + b2, dropout, + residual and the LayerNorm of 8 rows.  K = 2048 for
// y in one f32 accumulator, as csrc/gemm.cu's bf16 products.
//
// What holds it back on the H100 (debug builds of source variants): the
// weight stream.  Each 64-row tile reads all of w1 and w2 (4 MB) through the
// ring, and with its MMAs taken out the kernel took nearly as long; so the
// ring's 96 KB in flight per SM over the loads' latency sets the pace.  A
// cluster of two blocks sharing each stage by multicast TMA (each weight
// byte out of L2 once per 128 rows) ran slower: the bytes that land in each
// SM stay the same, and the two blocks wait on each other's releases.

constexpr int kTcRows = 64;                    // rows per block
constexpr int kHc = 128;                       // hidden units per chunk
constexpr int kChunks = kHid / kHc;
constexpr int kW1Steps = kD / 64;              // w1 stages per chunk
constexpr int kW2Steps = kHc / 16;             // w2 stages per chunk
constexpr int kStepsPerChunk = kW1Steps + kW2Steps;
constexpr int kStages = 8;
constexpr uint32_t kStage = 16384;             // bytes of a ring stage
constexpr uint32_t kPanel = kTcRows * 128;     // 64 rows of a 64-column panel
constexpr uint32_t kW2Panel = 16 * 128;        // 16 k rows of a w2 panel
constexpr int kTcThreads = 256;
// shared memory, bytes from a 1024-byte boundary
constexpr uint32_t kOffX = 0;                                  // 8 panels
constexpr uint32_t kOffHt = kOffX + kTcRows * kD * 2;          // 2 h tiles
constexpr uint32_t kHtBytes = kTcRows * kHc * 2;
constexpr uint32_t kOffRing = kOffHt + 2 * kHtBytes;
constexpr uint32_t kOffBar = kOffRing + kStages * kStage;
constexpr uint32_t kTcSmem = 1024 + kOffBar + 8 * (2 * kStages + 1);
constexpr int kTcSteps = kChunks * kStepsPerChunk;
// wgmma groups a warpgroup keeps in flight while it issues the next step's
// (two measured no faster than one on an H100); a step's slot is refilled
// once both warpgroups are past that
constexpr int kInFlight = 1;
constexpr int kAhead = kStages - kInFlight - 1;   // steps loaded ahead
constexpr int kYLd = kD + 8;                   // f32 epilogue rows, at kOffHt
static_assert(kTcRows * kYLd * 4 <= kOffBar - kOffHt,
              "y fits over the h tiles and the ring");
static_assert(kTcSmem <= 232448, "shared memory of one block");

// ring step j of a block: w1[64 k, 128 n] or w2[16 k, 512 n] of chunk j / 16
// into slot j % kStages, once both warpgroups have released its last use
__device__ __forceinline__ void ffn_issue(const CUtensorMap* map_w1,
                                          const CUtensorMap* map_w2,
                                          uint32_t base, int j) {
  using namespace hopper;
  const int s = j % kStages;
  const uint32_t full = base + kOffBar + 8 * s, empty = full + 8 * kStages;
  if (j >= kStages) mbar_wait(empty, ((j / kStages) & 1) ^ 1);
  mbar_expect_tx(full, kStage);
  const uint32_t dst = base + kOffRing + s * kStage;
  const int c = j / kStepsPerChunk, k = j % kStepsPerChunk;
  if (k < kW1Steps) {           // two panels [64 k][64 n]
    tma_load(dst, map_w1, full, kHc * c, 64 * k);
    tma_load(dst + kPanel, map_w1, full, kHc * c + 64, 64 * k);
  } else {                      // eight panels [16 k][64 n]
    const int k0 = kHc * c + 16 * (k - kW1Steps);
    for (int q = 0; q < kD / 64; ++q)
      tma_load(dst + q * kW2Panel, map_w2, full, 64 * q, k0);
  }
}

__global__ void __launch_bounds__(kTcThreads, 1)
ffn_tc_kernel(const __grid_constant__ CUtensorMap map_x,
              const __grid_constant__ CUtensorMap map_w1,
              const __grid_constant__ CUtensorMap map_w2,
              const float* __restrict__ b1, const float* __restrict__ b2,
              const float* __restrict__ lns, const float* __restrict__ lnb,
              __nv_bfloat16* __restrict__ out, int n, ait::Dropout drop) {
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + kOffBar, empty = full + 8 * kStages;
  const uint32_t xbar = empty + 8 * kStages;
  const int row0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kTcThreads / 128);   // one per warpgroup
    }
    mbar_init(xbar, 1);
    mbar_init_fence();
    mbar_expect_tx(xbar, kTcRows * kD * 2);
    for (int p = 0; p < kD / 64; ++p)
      tma_load(base + kOffX + p * kPanel, &map_x, xbar, 64 * p, row0);
    for (int j = 0; j < kAhead; ++j) ffn_issue(&map_w1, &map_w2, base, j);
  }
  __syncthreads();

  const int wg = warp / 4, w = warp % 4;
  const int r = 16 * w + lane / 4;             // fragment rows r, r + 8
  float y0[64], y1[64];                        // columns 256 wg + [0, 256)
#pragma unroll
  for (int i = 0; i < 64; ++i) y0[i] = y1[i] = 0.f;
  mbar_wait(xbar, 0);
  // ring step, and the first step not yet released.  A step's slot is
  // released once its MMAs are done (`wgmma.wait_group` waits for the whole
  // warpgroup's, so one thread of each warpgroup arrives)
  int it = 0, rel = 0;
  auto release = [&](int step) {
    if (threadIdx.x % 128 == 0) mbar_arrive(empty + 8 * (step % kStages));
  };
  for (int c = 0; c < kChunks; ++c) {
    float h[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) h[i] = 0.f;
    for (int j = 0; j < kW1Steps; ++j, ++it) {
      // step it + kAhead into the slot of step it - kInFlight - 1, which
      // both warpgroups have released by now (each releases a step once
      // kInFlight later steps' MMAs are issued, or at a drain before chunk
      // c's barrier)
      if (threadIdx.x == 0 && it + kAhead < kTcSteps)
        ffn_issue(&map_w1, &map_w2, base, it + kAhead);
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const uint32_t st = base + kOffRing + s * kStage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_64<0, 1>(h,
                       make_desc(base + kOffX + j * kPanel + kk * 32, 16, 1024),
                       make_desc(st + wg * kPanel + kk * 2048, kPanel, 1024),
                       1);
      wgmma_commit();
      wgmma_wait<kInFlight>();
      for (; rel <= it - kInFlight; ++rel) release(rel);
    }
    wgmma_wait<0>();
    for (; rel < it; ++rel) release(rel);

    // relu(h + b1) as bf16 into h tile c % 2 (its last reader, chunk c - 2's
    // products, finished before either warpgroup passed chunk c - 1's barrier)
    const uint32_t ht = kOffHt + (c % 2) * kHtBytes;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = 64 * wg + 8 * jj + 2 * (lane % 4);
      const float2 bb = *reinterpret_cast<const float2*>(b1 + kHc * c + col);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<__nv_bfloat162*>(
            smem + ht + swizzle128(r + 8 * hh, col, kPanel)) =
            __floats2bfloat162_rn(fmaxf(h[4 * jj + 2 * hh] + bb.x, 0.f),
                                  fmaxf(h[4 * jj + 2 * hh + 1] + bb.y, 0.f));
    }
    fence_proxy_async();
    __syncthreads();

    for (int j = 0; j < kW2Steps; ++j, ++it) {
      if (threadIdx.x == 0 && it + kAhead < kTcSteps)
        ffn_issue(&map_w1, &map_w2, base, it + kAhead);
      const int s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const uint32_t st = base + kOffRing + s * kStage;
      const uint64_t da = make_desc(
          base + ht + (j / 4) * kPanel + (j % 4) * 32, 16, 1024);
      wgmma_fence();
      wgmma_128<0, 1>(y0, da, make_desc(st + 4 * wg * kW2Panel, kW2Panel, 1024),
                      1);
      wgmma_128<0, 1>(y1, da,
                      make_desc(st + (4 * wg + 2) * kW2Panel, kW2Panel, 1024),
                      1);
      wgmma_commit();
      wgmma_wait<kInFlight>();
      for (; rel <= it - kInFlight; ++rel) release(rel);
    }
  }
  wgmma_wait<0>();
  for (; rel < it; ++rel) release(rel);

  // y into shared memory once both warpgroups' MMAs are done with the h
  // tiles and the ring
  __syncthreads();
  float* ybuf = reinterpret_cast<float*>(smem + kOffHt);
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    const int col = 256 * wg + 8 * jj + 2 * (lane % 4);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* dst = ybuf + (r + 8 * hh) * kYLd + col;
      *reinterpret_cast<float2*>(dst) =
          make_float2(y0[4 * jj + 2 * hh], y0[4 * jj + 2 * hh + 1]);
      *reinterpret_cast<float2*>(dst + 128) =
          make_float2(y1[4 * jj + 2 * hh], y1[4 * jj + 2 * hh + 1]);
    }
  }
  __syncthreads();

  // + b2, dropout, + residual, LayerNorm; warp `warp` takes 8 rows whole
  for (int i = 0; i < 8; ++i) {
    const int rl = 8 * warp + i;
    float v[16];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 128 * j + 4 * lane;
      const float4 yy = *reinterpret_cast<const float4*>(ybuf + rl * kYLd + c);
      const uint2 xr = *reinterpret_cast<const uint2*>(
          smem + kOffX + swizzle128(rl, c, kPanel));
      const float2 x01 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.x));
      const float2 x23 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.y));
      float m[4];
      drop_scales(drop, row0 + rl, c, m);
      v[4 * j + 0] = (yy.x + b2[c + 0]) * m[0] + x01.x;
      v[4 * j + 1] = (yy.y + b2[c + 1]) * m[1] + x01.y;
      v[4 * j + 2] = (yy.z + b2[c + 2]) * m[2] + x23.x;
      v[4 * j + 3] = (yy.w + b2[c + 3]) * m[3] + x23.y;
      s += v[4 * j] + v[4 * j + 1] + v[4 * j + 2] + v[4 * j + 3];
    }
    const float mu = ait::warp_sum(s) / kD;
    float q = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float d = v[e] - mu;
      q += d * d;
    }
    const float rs = rsqrtf(ait::warp_sum(q) / kD + 1e-6f);
    if (row0 + rl < n) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 128 * j + 4 * lane;
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[e] = (v[4 * j + e] - mu) * rs * lns[c + e] + lnb[c + e];
        ait::store4(out + (size_t)(row0 + rl) * kD + c, o[0], o[1], o[2], o[3]);
      }
    }
  }
}

int launch_fma(const void* x, const void* w1, const void* b1, const void* w2,
               const void* b2, const void* lns, const void* lnb, void* out,
               int n, const ait::Dropout& drop, cudaStream_t stream) {
  using T = float;
  const int smem = kSmemFloats * (int)sizeof(float);
  cudaFuncSetAttribute(ffn_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int blocks = (n + kRows - 1) / kRows;
  ffn_kernel<T><<<blocks, kThreads, smem, stream>>>(
      (const T*)x, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)b2, (const float*)lns, (const float*)lnb, (T*)out, n,
      drop);
  return (int)cudaGetLastError();
}

// x [n, 512] in boxes of 64 columns x 64 rows; w1 [512, 2048] and w2
// [2048, 512] in boxes of 64 columns x 64 (w1) or 16 (w2) rows; all
// 128-byte swizzled
int launch_tc(const void* x, const void* w1, const void* b1, const void* w2,
              const void* b2, const void* lns, const void* lnb, void* out,
              int n, const ait::Dropout& drop, cudaStream_t stream) {
  CUtensorMap mx, m1, m2;
  if (!hopper::make_map(&mx, x, false, n, kD, 64, kTcRows, true) ||
      !hopper::make_map(&m1, w1, false, kD, kHid, 64, 64, true) ||
      !hopper::make_map(&m2, w2, false, kHid, kD, 64, 16, true))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        ffn_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  ffn_tc_kernel<<<(n + kTcRows - 1) / kTcRows, kTcThreads, kTcSmem, stream>>>(
      mx, m1, m2, (const float*)b1, (const float*)b2, (const float*)lns,
      (const float*)lnb, (__nv_bfloat16*)out, n, drop);
  return (int)cudaGetLastError();
}

}  // namespace

// seed null: no dropout
extern "C" int ffn_fwd(int bf16, const void* x, const void* w1, const void* b1,
                       const void* w2, const void* b2, const void* lns,
                       const void* lnb, void* out, int n, const void* seed,
                       unsigned thresh, float inv_keep, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const ait::Dropout d{(const int*)seed, thresh, inv_keep};
  return bf16 ? launch_tc(x, w1, b1, w2, b2, lns, lnb, out, n, d, s)
              : launch_fma(x, w1, b1, w2, b2, lns, lnb, out, n, d, s);
}
