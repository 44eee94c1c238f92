// The products and column sums of the port's backward kernels: the weight
// gradients, the input gradients and the forward recompute of the FFN
// backward (ops/fused_ffn.py), and the projections' input and weight
// gradients of the attention backward (ops/fused_attention.py).  The Pallas
// backward kernels compute these products inside their own bodies
// (ait_tpu/ops/pallas_ffn.py:104 `_bwd_kernel`, ait_tpu/ops/
// pallas_attention.py:412 `_bwd_kernel`); here they are one hand-written
// tiled product, launched by the backward wrappers.
//
//   C[m][n] = epilogue(sum_k A(m, k) B(k, n)),  f32 accumulators
//
// with three layouts of row-major operands: NN (A [M, K], B [K, N]), NT
// (A [M, K], B [N, K]: x @ w^T) and TN (A [K, M], B [K, N]: x^T @ dy, the
// weight gradients, whose K is the row count of the batch).  Each operand is
// float or bf16 (a bf16 element is exact in f32, so the products are the
// f32 products of the JAX code).  The epilogue adds a per-column bias and an
// f32 addend, applies relu or a "> 0" mask (the relu derivative), and
// stores f32 or bf16.
//
// What bounds it on the H100: operations.  The products here are 0.1-0.3
// TFLOP each at the train shapes and run on the CUDA cores in f32
// (64 x 64 tiles, 16-deep k-slabs in shared memory, 4 x 4 outputs per
// thread).  The weight gradients reduce over up to 65k rows onto a few
// hundred output tiles: they split K into `splits` chunks, each block writes
// its partial tile, and a second kernel sums the partials in a fixed order,
// so the result is deterministic (no atomics).  Tensor cores (WMMA or wgmma
// on bf16 copies where the JAX code rounds to bf16) are later work.

#include "common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kThreads = 256;
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

template <int L, typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const TA* __restrict__ a, const TB* __restrict__ b, int M, int N,
            int K, int kchunk, Epilogue e, float* __restrict__ partial) {
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
        v = ait::to_float(L == kTN ? a[(size_t)k * M + m] : a[(size_t)m * K + k]);
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
        v = ait::to_float(L == kNT ? b[(size_t)n * K + k] : b[(size_t)k * N + n]);
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

template <int L, typename TA, typename TB>
int launch(const void* a, const void* b, int M, int N, int K, int splits,
           float* partial, const Epilogue& e, cudaStream_t s) {
  const int kchunk = ((K + splits - 1) / splits + kBK - 1) / kBK * kBK;
  splits = (K + kchunk - 1) / kchunk;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits > 0 ? splits : 1);
  if (splits <= 1) {
    gemm_kernel<L, TA, TB><<<grid, kThreads, 0, s>>>(
        (const TA*)a, (const TB*)b, M, N, K, kchunk > 0 ? kchunk : kBK, e,
        nullptr);
  } else {
    gemm_kernel<L, TA, TB><<<grid, kThreads, 0, s>>>(
        (const TA*)a, (const TB*)b, M, N, K, kchunk, e, partial);
    const size_t mn = (size_t)M * N;
    reduce_splits<<<(unsigned)((mn + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        partial, splits, M, N, e);
  }
  return (int)cudaGetLastError();
}

template <int L>
int launch_types(int a_bf16, int b_bf16, const void* a, const void* b, int M,
                 int N, int K, int splits, float* partial, const Epilogue& e,
                 cudaStream_t s) {
  using bf = __nv_bfloat16;
  if (a_bf16 && b_bf16) return launch<L, bf, bf>(a, b, M, N, K, splits, partial, e, s);
  if (a_bf16) return launch<L, bf, float>(a, b, M, N, K, splits, partial, e, s);
  if (b_bf16) return launch<L, float, bf>(a, b, M, N, K, splits, partial, e, s);
  return launch<L, float, float>(a, b, M, N, K, splits, partial, e, s);
}

}  // namespace

// layout 0 NN, 1 NT, 2 TN; with splits > 1, partial holds splits * M * N f32
extern "C" int gemm(int layout, int a_bf16, int b_bf16, int M, int N, int K,
                    const void* a, const void* b, int splits, void* partial,
                    const void* bias, const void* cadd, const void* mask,
                    int mask_bf16, int relu, void* out, int out_bf16,
                    void* stream) {
  Epilogue e{(const float*)bias, (const float*)cadd, mask, mask_bf16, relu,
             out, out_bf16};
  cudaStream_t s = (cudaStream_t)stream;
  float* p = (float*)partial;
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
