// Positional encoding + dropout + LayerNorm glue in front of the AIT encoder
// and decoder: out[i] = LayerNorm((x[i] + pos[i mod T]) * keep / keep_prob)
// over flat pair-major rows of width 512, eps 1e-6, f32 statistics.  The
// keep-mask is the Philox stream of csrc/philox.cuh (tag 4, a block per
// absolute row); with no seed (eval, or keep_prob 1) nothing is dropped.
//
// Replaces ait_tpu/ops/pallas_ffn.py:355 fused_posln (kernel
// `_posln_fwd_kernel`, :276, with its in-kernel dropout :288-294).
//
// `ln_bwd` is the backward of the same LayerNorm, and replaces
// ait_tpu/ops/pallas_ffn.py:387 _posln_vjp_bwd (kernel `_posln_bwd_kernel`,
// :302, with its dropout :321-341) and the LayerNorm part of the FFN
// backward's `_bwd_kernel` (:104, lines :135-151), which the FFN backward
// (ops/fused_ffn.py) runs on y = x + y2 with the recomputed FFN output y2 as
// the addend:
//   y = x + a[i mod T];  xhat = (y - mu) * r;  dxhat = g * ln_s;
//   dy = r * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)),
//   dln_s = sum_i g * xhat,  dln_b = sum_i g.
// Its dropout modes regenerate the forward's mask m = keep / keep_prob:
//   kGlue (tag 4): y = (x + a) * m, and dx = dy * m;
//   kFfn (tag 3): y = x + a * m (the FFN's output dropout), and it writes
//     both dy (the residual's cotangent, into dx) and dy2 = dy * m (the
//     cotangent of the FFN's pre-dropout output, for its products).
//
// What bounds both on the H100: bytes.  A row is read once and written once
// (the forward 2 KB in bf16; the glue backward 3 KB; the FFN backward 8 KB:
// x bf16, y2 f32, g bf16 in, dy and dy2 f32 out) for ~10 f32 operations and,
// with dropout, 4 Philox4x32-10 calls a lane and row (58 integer
// instructions each in this library's SASS, issued at half the f32 rate):
// in the glue about half as much integer time as byte time, so the two
// have to overlap.  The design:
// * persistent blocks (a few per SM, `blocks` from the wrapper), 8 warps
//   each; warp w of block b walks rows b * 8 + w + k * (8 * blocks), so all
//   warps sweep one band of rows at a time;
// * a ring of 3 row slots per warp in shared memory, filled with 16-byte
//   `cp.async` (lane l copies chunks l, l + 32, ...: coalesced for any
//   type): two rows ahead are in flight while the warp computes the third;
//   the row's Philox words are drawn after its successors' copies are
//   issued and before it waits for its own, so the integer work overlaps
//   the copies;
// * each lane owns 16 fixed columns, c = (i / 4) * 128 + lane * 4 + i % 4
//   (i < 16): its LayerNorm parameters stay in registers for the warp's
//   life, each group of 4 is one Philox group (element c takes word c % 4
//   of group c / 4, the stream's rule), and loads from the ring and stores
//   to device memory are 8 (bf16) or 16 (f32) bytes a lane, consecutive
//   across the warp;
// * the statistics as warp shuffles: the mean, then the variance about the
//   mean, as the JAX code computes them (and the backward's two means);
// * dln_s and dln_b in a fixed order, no atomics: each lane sums its
//   columns over the warp's rows in row order (an FMA a row), the block
//   adds its 8 warps in order into a [2, 512] partial, and a second kernel
//   (`ln_param_reduce_kernel`, launched by the same entry) sums the blocks'
//   partials: warp v of 32 takes partials v, v + 32, ... in order, then the
//   32 warp sums are added in order.  Two calls give the same bits; ops/
//   fused_ffn.py `ln_bwd_reference(blocks=)` emulates the order.

#include "common.cuh"
#include "hopper.cuh"
#include "philox.cuh"

namespace {

constexpr int kD = 512;
constexpr int kWarps = 8;               // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;              // ring slots a warp: 2 rows ahead
constexpr int kRedWarps = 32;           // warps a block of the second pass
enum DropMode { kNone = 0, kGlue = 1, kFfn = 2 };

// 4 consecutive elements -> float (8-byte aligned bf16, 16-byte f32)
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// a lane's 16 elements of a row (columns j * 128 + lane * 4 + e)
template <typename T>
__device__ __forceinline__ void lane_load(const T* row, int lane, float v[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) load4(row + j * 128 + lane * 4, v + 4 * j);
}

template <typename T>
__device__ __forceinline__ void lane_store(T* row, int lane, const float v[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    ait::store4(row + j * 128 + lane * 4, v[4 * j], v[4 * j + 1],
                v[4 * j + 2], v[4 * j + 3]);
}

// the keep bits of a lane's 16 elements of `row`: bit i for column
// (i / 4) * 128 + lane * 4 + i % 4, which takes word i % 4 of group
// (i / 4) * 32 + lane of block (tag, 0, row)
__device__ __forceinline__ uint32_t keep_bits(uint2 key, int tag, int row,
                                              int lane, uint32_t thresh) {
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint4 w = ait::keep_group(key, tag, 0, row, j * 32 + lane);
    bits |= ((uint32_t)(w.x < thresh) | (uint32_t)(w.y < thresh) << 1 |
             (uint32_t)(w.z < thresh) << 2 | (uint32_t)(w.w < thresh) << 3)
            << (4 * j);
  }
  return bits;
}

__device__ __forceinline__ float keep_scale(uint32_t bits, int i,
                                            float inv_keep) {
  return (bits >> i) & 1u ? inv_keep : 0.f;
}

// one row of kBytes from device memory into a ring slot: 16-byte chunks,
// lane l copying chunks l, l + 32, ...
template <int kBytes>
__device__ __forceinline__ void copy_row(uint32_t dst, const void* src,
                                         int lane) {
  const char* s = static_cast<const char*>(src);
#pragma unroll
  for (int k = 0; k < kBytes / 16 / 32; ++k) {
    const int off = (lane + 32 * k) * 16;
    hopper::cp_async16(dst + off, s + off, 16);
  }
}

// two warp sums at once (independent shuffles, interleaved)
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
}

template <typename T, bool kDrop>
__global__ void __launch_bounds__(kThreads, 3)
posln_kernel(const T* __restrict__ x, const T* __restrict__ pos,
             const float* __restrict__ lns, const float* __restrict__ lnb,
             T* __restrict__ out, int n, int t, ait::Dropout drop) {
  constexpr int kRow = kD * (int)sizeof(T);
  constexpr int kSlot = 2 * kRow;              // x, then pos
  extern __shared__ __align__(16) unsigned char ring[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  const int first = blockIdx.x * kWarps + warp;
  unsigned char* slots = ring + warp * (kStages * kSlot);
  const uint32_t slots_s = hopper::smem_u32(slots);
  float ls[16], lb[16];
  lane_load(lns, lane, ls);
  lane_load(lnb, lane, lb);
  uint2 key = make_uint2(0u, 0u);
  if (kDrop) key = ait::seed_key(drop.seed);

  auto fetch = [&](int k) {                    // the warp's k-th row
    const int row = first + k * stride;
    if (row < n) {
      const uint32_t dst = slots_s + (k % kStages) * kSlot;
      copy_row<kRow>(dst, x + (size_t)row * kD, lane);
      copy_row<kRow>(dst + kRow, pos + (size_t)(row % t) * kD, lane);
    }
    hopper::cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) fetch(k);
  int k = 0;
  for (int row = first; row < n; row += stride, ++k) {
    fetch(k + kStages - 1);
    const uint32_t keep =
        kDrop ? keep_bits(key, ait::kTagGlue, row, lane, drop.thresh) : 0u;
    hopper::cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* slot = slots + (k % kStages) * kSlot;
    float y[16], p[16];
    lane_load(reinterpret_cast<const T*>(slot), lane, y);
    lane_load(reinterpret_cast<const T*>(slot + kRow), lane, p);
    __syncwarp();                              // the slot may be refilled
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      y[i] += p[i];
      if (kDrop) y[i] *= keep_scale(keep, i, drop.inv_keep);
      s += y[i];
    }
    const float mu = ait::warp_sum(s) / kD;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float d = y[i] - mu;
      q += d * d;
    }
    const float rs = rsqrtf(ait::warp_sum(q) / kD + 1e-6f);
#pragma unroll
    for (int i = 0; i < 16; ++i) y[i] = (y[i] - mu) * rs * ls[i] + lb[i];
    lane_store(out + (size_t)row * kD, lane, y);
  }
}

template <typename T, bool kDrop>
int launch(const void* x, const void* pos, const void* lns, const void* lnb,
           void* out, int n, int t, int blocks, const ait::Dropout& drop,
           cudaStream_t stream) {
  constexpr int smem = kWarps * kStages * 2 * kD * (int)sizeof(T);
  auto kern = posln_kernel<T, kDrop>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, kThreads, smem, stream>>>(
      (const T*)x, (const T*)pos, (const float*)lns, (const float*)lnb,
      (T*)out, n, t, drop);
  return (int)cudaGetLastError();
}

template <typename TX, typename TA, typename TO, int kMode>
__global__ void __launch_bounds__(kThreads, 2)
ln_bwd_kernel(const TX* __restrict__ x, const TA* __restrict__ add,
              int period, const float* __restrict__ lns,
              const TX* __restrict__ g, TO* __restrict__ dx,
              float* __restrict__ part, int n, ait::Dropout drop,
              float* __restrict__ dy2) {
  constexpr int kX = kD * (int)sizeof(TX), kA = kD * (int)sizeof(TA);
  constexpr int kSlot = 2 * kX + kA;           // x, the addend, g
  extern __shared__ __align__(16) unsigned char ring[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  const int first = blockIdx.x * kWarps + warp;
  unsigned char* slots = ring + warp * (kStages * kSlot);
  const uint32_t slots_s = hopper::smem_u32(slots);
  float ls[16], ps[16], pb[16];
  lane_load(lns, lane, ls);
#pragma unroll
  for (int i = 0; i < 16; ++i) ps[i] = pb[i] = 0.f;
  uint2 key = make_uint2(0u, 0u);
  if (kMode != kNone) key = ait::seed_key(drop.seed);

  auto fetch = [&](int k) {
    const int row = first + k * stride;
    if (row < n) {
      const uint32_t dst = slots_s + (k % kStages) * kSlot;
      copy_row<kX>(dst, x + (size_t)row * kD, lane);
      copy_row<kA>(dst + kX, add + (size_t)(row % period) * kD, lane);
      copy_row<kX>(dst + kX + kA, g + (size_t)row * kD, lane);
    }
    hopper::cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) fetch(k);
  int k = 0;
  for (int row = first; row < n; row += stride, ++k) {
    fetch(k + kStages - 1);
    const uint32_t keep =
        kMode == kNone ? 0u
                       : keep_bits(key, kMode == kGlue ? ait::kTagGlue
                                                        : ait::kTagFfn,
                                   row, lane, drop.thresh);
    hopper::cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* slot = slots + (k % kStages) * kSlot;
    float y[16], a[16], gv[16];
    lane_load(reinterpret_cast<const TX*>(slot), lane, y);
    lane_load(reinterpret_cast<const TA*>(slot + kX), lane, a);
    lane_load(reinterpret_cast<const TX*>(slot + kX + kA), lane, gv);
    __syncwarp();                              // the slot may be refilled
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (kMode == kGlue)
        y[i] = (y[i] + a[i]) * keep_scale(keep, i, drop.inv_keep);
      else if (kMode == kFfn)
        y[i] = y[i] + a[i] * keep_scale(keep, i, drop.inv_keep);
      else
        y[i] = y[i] + a[i];
      s += y[i];
    }
    const float mu = ait::warp_sum(s) / kD;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float d = y[i] - mu;
      q += d * d;
    }
    const float rs = rsqrtf(ait::warp_sum(q) / kD + 1e-6f);
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      y[i] = (y[i] - mu) * rs;                 // xhat
      ps[i] = fmaf(gv[i], y[i], ps[i]);
      pb[i] += gv[i];
      gv[i] *= ls[i];                          // dxhat
      m1 += gv[i];
      m2 = fmaf(gv[i], y[i], m2);
    }
    warp_sum2(m1, m2);
    m1 /= kD;
    m2 /= kD;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      gv[i] = rs * (gv[i] - m1 - y[i] * m2);   // dy
      if (kMode != kNone) a[i] = gv[i] * keep_scale(keep, i, drop.inv_keep);
    }
    lane_store(dx + (size_t)row * kD, lane, kMode == kGlue ? a : gv);
    if (kMode == kFfn) lane_store(dy2 + (size_t)row * kD, lane, a);
  }

  // the block's partial: its warps' sums added in warp order
  hopper::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);  // [2][kWarps][kD]
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = j * 128 + lane * 4;
    ait::store4(red + warp * kD + c, ps[4 * j], ps[4 * j + 1], ps[4 * j + 2],
                ps[4 * j + 3]);
    ait::store4(red + (kWarps + warp) * kD + c, pb[4 * j], pb[4 * j + 1],
                pb[4 * j + 2], pb[4 * j + 3]);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * kD; c += kThreads) {
    const float* col = red + (c / kD) * kWarps * kD + c % kD;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += col[w * kD];
    part[(size_t)blockIdx.x * 2 * kD + c] = acc;
  }
}

// dln_s (columns 0..511 of the partials) and dln_b (512..1023): column c of
// block c / 32, lane c % 32; warp v sums partials v, v + 32, ... in order,
// then the warps' sums are added in warp order
__global__ void __launch_bounds__(32 * kRedWarps)
ln_param_reduce_kernel(const float* __restrict__ part, int blocks,
                       float* __restrict__ ds, float* __restrict__ db) {
  __shared__ float red[kRedWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.f;
#pragma unroll 4
  for (int r = warp; r < blocks; r += kRedWarps)
    acc += part[(size_t)r * 2 * kD + c];
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kRedWarps; ++w) sum += red[w][lane];
    if (c < kD) ds[c] = sum;
    else db[c - kD] = sum;
  }
}

template <typename TX, typename TA, typename TO, int kMode>
int launch_bwd(const void* x, const void* add, int period, const void* lns,
               const void* g, void* dx, void* part, void* ds, void* db, int n,
               int blocks, const ait::Dropout& drop, void* dy2,
               cudaStream_t stream) {
  constexpr int smem =
      kWarps * kStages * kD * (2 * (int)sizeof(TX) + (int)sizeof(TA));
  auto kern = ln_bwd_kernel<TX, TA, TO, kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, kThreads, smem, stream>>>(
      (const TX*)x, (const TA*)add, period, (const float*)lns, (const TX*)g,
      (TO*)dx, (float*)part, n, drop, (float*)dy2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_param_reduce_kernel<<<2 * kD / 32, 32 * kRedWarps, 0, stream>>>(
      (const float*)part, blocks, (float*)ds, (float*)db);
  return (int)cudaGetLastError();
}

template <typename TX, typename TA, typename TO>
int launch_bwd_mode(int mode, const void* x, const void* add, int period,
                    const void* lns, const void* g, void* dx, void* part,
                    void* ds, void* db, int n, int blocks,
                    const ait::Dropout& d, void* dy2, cudaStream_t s) {
  switch (mode) {
    case kNone: return launch_bwd<TX, TA, TO, kNone>(x, add, period, lns, g, dx, part, ds, db, n, blocks, d, dy2, s);
    case kGlue: return launch_bwd<TX, TA, TO, kGlue>(x, add, period, lns, g, dx, part, ds, db, n, blocks, d, dy2, s);
    default: return launch_bwd<TX, TA, TO, kFfn>(x, add, period, lns, g, dx, part, ds, db, n, blocks, d, dy2, s);
  }
}

}  // namespace

// dx, dln_s and dln_b (f32 [512] each) of LayerNorm(x + add[i mod period]);
// x and g share a type; part is f32 scratch [blocks, 2, 512] for the
// blocks' partials; blocks >= 1 persistent blocks of 8 warps (the wrapper's
// grid, ops/fused_ffn.py `ln_bwd_grid`).  mode 0 no dropout (seed may be
// null), 1 the glue's, 2 the FFN's (dy2 f32 [n, 512] written; else it may be
// null)
extern "C" int ln_bwd(int x_bf16, int add_bf16, int out_bf16, const void* x,
                      const void* add, int period, const void* lns,
                      const void* g, void* dx, void* part, void* ds, void* db,
                      int n, int blocks, int mode, const void* seed,
                      unsigned thresh, float inv_keep, void* dy2,
                      void* stream) {
  using bf = __nv_bfloat16;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode < kNone || mode > kFfn || (mode != kNone && seed == nullptr) ||
      (mode == kFfn && dy2 == nullptr) || blocks < 1 || n < 1 || period < 1)
    return (int)cudaErrorInvalidValue;
  const ait::Dropout d{(const int*)seed, thresh, inv_keep};
  switch (x_bf16 * 4 + add_bf16 * 2 + out_bf16) {
    case 0: return launch_bwd_mode<float, float, float>(mode, x, add, period, lns, g, dx, part, ds, db, n, blocks, d, dy2, s);
    case 7: return launch_bwd_mode<bf, bf, bf>(mode, x, add, period, lns, g, dx, part, ds, db, n, blocks, d, dy2, s);
    case 4: return launch_bwd_mode<bf, float, float>(mode, x, add, period, lns, g, dx, part, ds, db, n, blocks, d, dy2, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// seed null: no dropout; blocks >= 1 persistent blocks of 8 warps (the
// wrapper's grid, ops/fused_ffn.py `posln_grid`)
extern "C" int posln_fwd(int bf16, const void* x, const void* pos,
                         const void* lns, const void* lnb, void* out, int n,
                         int t, int blocks, const void* seed, unsigned thresh,
                         float inv_keep, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks < 1 || n < 1 || t < 1) return (int)cudaErrorInvalidValue;
  const ait::Dropout d{(const int*)seed, thresh, inv_keep};
  if (bf16)
    return seed ? launch<__nv_bfloat16, true>(x, pos, lns, lnb, out, n, t, blocks, d, s)
                : launch<__nv_bfloat16, false>(x, pos, lns, lnb, out, n, t, blocks, d, s);
  return seed ? launch<float, true>(x, pos, lns, lnb, out, n, t, blocks, d, s)
              : launch<float, false>(x, pos, lns, lnb, out, n, t, blocks, d, s);
}

// Never launched: chip_smoke.py counts one Philox4x32-10 call's instructions
// in this library's SASS as the difference between these two kernels (the
// same loads and stores around one `keep_group`, or around none).
__global__ void philox_probe_kernel(const uint4* __restrict__ in,
                                    uint4* __restrict__ out) {
  const uint4 c = in[threadIdx.x];
  const uint2 key = make_uint2(in[blockDim.x].x, in[blockDim.x].y);
  out[threadIdx.x] = ait::keep_group(key, (int)c.x, (int)c.y, (int)c.z,
                                     (int)c.w);
}

__global__ void philox_probe_base_kernel(const uint4* __restrict__ in,
                                         uint4* __restrict__ out) {
  const uint4 c = in[threadIdx.x];
  const uint2 key = make_uint2(in[blockDim.x].x, in[blockDim.x].y);
  out[threadIdx.x] = make_uint4(c.x ^ key.x, c.y, c.z ^ key.y, c.w);
}
