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
// 2 KB of row traffic in bf16 (the weights, 4 MB, stay in L2), far above the
// card's ~295 operations per byte.  The design keeps the whole block on chip
// so that neither the [rows, 2048] hidden activation nor the [rows, 512]
// pre-LayerNorm sum ever reaches device memory: one block per row tile holds
// its x tile in shared memory (it is also the residual), walks the hidden
// dimension in chunks of 64 (h = relu(x @ w1[:, chunk] + b1) into shared
// memory, then y += h @ w2[chunk, :]), streams the w1 and w2 slices through
// shared memory, and keeps the [rows, 512] f32 accumulator in registers.
//
// bf16 (the path's type) multiplies on the tensor cores with WMMA 16x16x16
// tiles, 64 rows per block; f32 (kept for the tight check against the plain
// version) uses CUDA-core FMAs, 32 rows per block, 4 rows x 16 columns per
// thread so that each warp owns whole rows.  wgmma, TMA and a pipelined
// ring of slabs are later work.

#include <mma.h>

#include "common.cuh"
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

// ---- bf16: the two products on the tensor cores --------------------------
//
// One block per tile of 64 rows, 8 warps.  The x tile (bf16, also the
// residual) stays in shared memory; per hidden chunk of 64, w1's slice
// streams through in k-slabs of 128 rows and w2's [64, 512] rows are staged
// whole.  Warp w owns rows 16*(w%4)..+16: two 16x16 tiles of the chunk's
// hidden activation (columns 32*(w/4)..+32) and sixteen 16x16 f32
// accumulator tiles of the output (columns 256*(w/4)..+256), which stay in
// registers across all 32 chunks.  The epilogue moves the accumulators
// through shared memory, 32 rows at a time, for the LayerNorm.

constexpr int kMRows = 64;
constexpr int kMSlab1 = 128;
constexpr int kXLd = kD + 8;          // bf16 row strides padded by 16 bytes
constexpr int kW1Ld = kChunk + 8;
constexpr int kHLd = kChunk + 4;      // f32 hidden accumulators
constexpr int kHbLd = kChunk + 8;
constexpr int kYLd = kD + 4;          // f32 epilogue rows
constexpr int kMOffW1 = kMRows * kXLd * 2;            // byte offsets
constexpr int kMOffH = kMOffW1 + kMSlab1 * kW1Ld * 2;
constexpr int kMOffHb = kMOffH + kMRows * kHLd * 4;
constexpr int kMOffW2 = kMOffHb + kMRows * kHbLd * 2;
constexpr int kMSmemBytes = kMOffW2 + kChunk * kXLd * 2;
static_assert(32 * kYLd * 4 <= kChunk * kXLd * 2, "epilogue rows fit in w2's place");
static_assert(kMOffW1 % 32 == 0 && kMOffH % 32 == 0 && kMOffHb % 32 == 0 &&
              kMOffW2 % 32 == 0, "WMMA tiles need 32-byte alignment");

__global__ void __launch_bounds__(kThreads, 1)
ffn_mma_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w1,
               const float* __restrict__ b1,
               const __nv_bfloat16* __restrict__ w2,
               const float* __restrict__ b2, const float* __restrict__ lns,
               const float* __restrict__ lnb, __nv_bfloat16* __restrict__ out,
               int n, ait::Dropout drop) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smb[];
  bf16* xs = reinterpret_cast<bf16*>(smb);               // [64][kXLd]
  bf16* w1s = reinterpret_cast<bf16*>(smb + kMOffW1);    // [128][kW1Ld]
  float* hacc = reinterpret_cast<float*>(smb + kMOffH);  // [64][kHLd]
  bf16* hb = reinterpret_cast<bf16*>(smb + kMOffHb);     // [64][kHbLd]
  bf16* w2s = reinterpret_cast<bf16*>(smb + kMOffW2);    // [64][kXLd]
  float* ybuf = reinterpret_cast<float*>(smb + kMOffW2); // [32][kYLd], at the end

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int row0 = blockIdx.x * kMRows;
  const int rows = min(kMRows, n - row0);
  const int r0 = (warp & 3) * 16;
  const int hc = (warp >> 2) * 32;     // hidden columns of this warp
  const int yc = (warp >> 2) * 256;    // output columns of this warp
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int v = t; v < kMRows * kD / 8; v += kThreads) {
    const int r = v / (kD / 8), c = (v % (kD / 8)) * 8;
    *reinterpret_cast<uint4*>(xs + r * kXLd + c) =
        r < rows ? *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * kD + c)
                 : zero;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> y[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) wmma::fill_fragment(y[j], 0.f);

  for (int c0 = 0; c0 < kHid; c0 += kChunk) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> h[2];
    wmma::fill_fragment(h[0], 0.f);
    wmma::fill_fragment(h[1], 0.f);
    for (int k0 = 0; k0 < kD; k0 += kMSlab1) {
      __syncthreads();
      for (int v = t; v < kMSlab1 * kChunk / 8; v += kThreads) {
        const int r = v / (kChunk / 8), c = (v % (kChunk / 8)) * 8;
        *reinterpret_cast<uint4*>(w1s + r * kW1Ld + c) =
            *reinterpret_cast<const uint4*>(w1 + (size_t)(k0 + r) * kHid + c0 + c);
      }
      if (k0 == 0) {   // this chunk's w2 rows (the previous chunk is done)
        for (int v = t; v < kChunk * kD / 8; v += kThreads) {
          const int r = v / (kD / 8), c = (v % (kD / 8)) * 8;
          *reinterpret_cast<uint4*>(w2s + r * kXLd + c) =
              *reinterpret_cast<const uint4*>(w2 + (size_t)(c0 + r) * kD + c);
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kMSlab1; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, xs + r0 * kXLd + k0 + kk, kXLd);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, w1s + kk * kW1Ld + hc + 16 * j, kW1Ld);
          wmma::mma_sync(h[j], a, b, h[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(hacc + r0 * kHLd + hc + 16 * j, h[j], kHLd,
                              wmma::mem_row_major);
    __syncthreads();
    for (int e = t; e < kMRows * kChunk; e += kThreads) {
      const int r = e / kChunk, c = e % kChunk;
      hb[r * kHbLd + c] =
          __float2bfloat16_rn(fmaxf(hacc[r * kHLd + c] + b1[c0 + c], 0.f));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, hb + r0 * kHbLd + kk, kHbLd);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, w2s + kk * kXLd + yc + 16 * j, kXLd);
        wmma::mma_sync(y[j], a, b, y[j]);
      }
    }
  }

  // + b2, + residual, LayerNorm: 32 rows at a time through shared memory
  for (int half = 0; half < 2; ++half) {
    __syncthreads();
    if ((warp & 3) >> 1 == half) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        wmma::store_matrix_sync(ybuf + (r0 - 32 * half) * kYLd + yc + 16 * j,
                                y[j], kYLd, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = 0; i < 4; ++i) {
      const int rl = 4 * warp + i, r = 32 * half + rl;
      float v[16];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 128 * j + 4 * lane;
        const float4 yy = *reinterpret_cast<const float4*>(ybuf + rl * kYLd + c);
        const float2 x01 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xs + r * kXLd + c));
        const float2 x23 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xs + r * kXLd + c + 2));
        float m[4];
        drop_scales(drop, row0 + r, c, m);
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
      if (r < rows) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 128 * j + 4 * lane;
          float o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[e] = (v[4 * j + e] - mu) * rs * lns[c + e] + lnb[c + e];
          ait::store4(out + (size_t)(row0 + r) * kD + c, o[0], o[1], o[2], o[3]);
        }
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

int launch_mma(const void* x, const void* w1, const void* b1, const void* w2,
               const void* b2, const void* lns, const void* lnb, void* out,
               int n, const ait::Dropout& drop, cudaStream_t stream) {
  using T = __nv_bfloat16;
  cudaFuncSetAttribute(ffn_mma_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kMSmemBytes);
  const int blocks = (n + kMRows - 1) / kMRows;
  ffn_mma_kernel<<<blocks, kThreads, kMSmemBytes, stream>>>(
      (const T*)x, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)b2, (const float*)lns, (const float*)lnb, (T*)out, n,
      drop);
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
  return bf16 ? launch_mma(x, w1, b1, w2, b2, lns, lnb, out, n, d, s)
              : launch_fma(x, w1, b1, w2, b2, lns, lnb, out, n, d, s);
}
