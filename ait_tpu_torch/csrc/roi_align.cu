// ROI Align of a batch in one launch: out[b, r, i, j, c] from feat[b, H, W,
// C] and rois[b, r] (x1, y1, x2, y2 in image coordinates).
//
// Replaces no TPU kernel: the JAX package computes ROI Align with XLA
// (ait_tpu/ops/roi_align.py), and the port's plain version
// (ops/roi_align.py::roi_align_reference) loops over the images, builds two
// dense interpolation matrices per image and contracts them with the map in
// two einsums.  This kernel computes the same function with the same
// contract (ROIAlign_cuda.cu:64-122 of the reference): no half-pixel shift
// and no rounding of roi coordinates; rois at least 1x1; samples with
// y < -1 or y > H contribute zero, y in [-1, 0] clamps to 0, y >= H-1 puts
// weight 1 on row H-1; with ratio <= 0 the adaptive grid
// g = clamp(ceil(bin), 1, ceil(H / out)) a bin and axis, averaged over
// g_y * g_x samples.
//
// Precision: every sample position, tap and fraction is computed in f32 with
// the plain version's operations in its order, start + ph * bin +
// (s + 0.5) * bin / g, each rounded on its own (__fmul_rn / __fadd_rn /
// __fdiv_rn, which the compiler never contracts into an FMA), so they equal
// the plain version's.  The weights stay in f32 and the sums are f32; the
// output is rounded once, to the storage type, at the store (the plain
// version rounds the weights and its [R, 7, H, C] intermediate to bf16).
//
// What bounds it on the H100: neither the output (8 x 1000 x 49 x 1024 bf16
// = 803 MB, 0.24 ms at 3.35 TB/s, on the largest serving shape) nor the
// maps (3.9-7.0 MB an image, held in the 50 MB L2) alone, but the loads
// from L1/L2 of every roi's window: a roi needs about
// (roi_h + 2) x (roi_w + 7..14) pixel vectors.  The design keeps those loads
// few and wide:
//   * separable form, out[i, j] = sum_h Wy[i, h] sum_w Wx[j, w] feat[h, w]:
//     a block computes one roi's 7 + 7 sparse weight rows in shared memory
//     first (14 threads, a bin each), then walks, for each output column j,
//     every row of the roi's span once, two rows at a time, the x-pass over
//     bin j's columns, and adds it to each y-bin that covers the row: a row
//     shared by two y-bins is read once per column bin, and the sums of all
//     7 y-bins (7 x 8 floats a thread) stay in registers (128 registers a
//     thread, no spill);
//   * a thread owns 8 channels (one 16-byte bf16 vector; 32 bytes in f32),
//     a block 1024 channels, so a warp reads 512 contiguous bytes a pixel;
//   * blocks are numbered image-major (roi-major inside an image), so one
//     image's map is read by the blocks in flight together and stays in L2.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 8;                       // channels a thread
constexpr int kChannels = kThreads * kVec;    // channels a block
constexpr int kMaxOut = 7;                    // the largest output side

// One bin's weights along one axis (ops/roi_align.py::_interp_weights):
// the sum of the bilinear taps of its n samples, over denom.  w: the bin's
// dense row of `size` zeros on entry; lo / hi: the first and last tap
// (lo > hi when every sample lies outside [-1, size]).
__device__ void bin_weights(float start, float bin, float denom, int n,
                            int ph, int size, float* w, int* lo, int* hi) {
  int first = size, last = -1;
  const float base = __fadd_rn(start, __fmul_rn((float)ph, bin));
  for (int s = 0; s < n; ++s) {
    float pos = __fadd_rn(
        base, __fdiv_rn(__fmul_rn(__fadd_rn((float)s, 0.5f), bin), denom));
    if (pos < -1.0f || pos > (float)size) continue;
    pos = fminf(fmaxf(pos, 0.0f), (float)(size - 1));
    const float low = floorf(pos);
    const float frac = __fsub_rn(pos, low);
    const int l = (int)low;
    w[l] = __fadd_rn(w[l], __fsub_rn(1.0f, frac));
    if (l + 1 < size) w[l + 1] = __fadd_rn(w[l + 1], frac);
    first = min(first, l);
    last = max(last, min(l + 1, size - 1));
  }
  for (int k = first; k <= last; ++k) w[k] = __fdiv_rn(w[k], denom);
  *lo = first;
  *hi = last;
}

// grid: rois x channel slices, image-major; block: kThreads.  Dynamic shared
// memory: out x (H + W) floats (the dense weight rows).
template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_kernel(const T* __restrict__ feat, const float* __restrict__ rois,
                 long long roi_bstride, int roi_rstride, int n_rois,
                 int slices, int h, int w, int c, int out, float scale,
                 int ratio, T* __restrict__ dst) {
  extern __shared__ float smem[];
  float* wy = smem;               // [out][h]
  float* wx = smem + out * h;     // [out][w]
  __shared__ int ylo[kMaxOut], yhi[kMaxOut], xlo[kMaxOut], xhi[kMaxOut];

  const int roi = blockIdx.x / slices;          // b * n_rois + r
  const int slice = blockIdx.x - roi * slices;
  const int b = roi / n_rois;
  const int r = roi - b * n_rois;
  const int t = threadIdx.x;

  for (int k = t; k < out * (h + w); k += kThreads) smem[k] = 0.0f;
  __syncthreads();
  if (t < 2 * out) {
    const bool is_y = t < out;
    const int ph = is_y ? t : t - out;
    const int size = is_y ? h : w;
    const float* rb = rois + b * roi_bstride + (long long)r * roi_rstride;
    const float a1 = __fmul_rn(rb[is_y ? 1 : 0], scale);
    const float a2 = __fmul_rn(rb[is_y ? 3 : 2], scale);
    const float bin = __fdiv_rn(fmaxf(__fsub_rn(a2, a1), 1.0f), (float)out);
    float denom;
    if (ratio > 0) {
      denom = (float)ratio;
    } else {
      const int cap = (size + out - 1) / out;
      denom = fminf(fmaxf(ceilf(bin), 1.0f), (float)cap);
    }
    int lo, hi;
    bin_weights(a1, bin, denom, (int)denom, ph, size,
                (is_y ? wy : wx) + ph * size, &lo, &hi);
    (is_y ? ylo : xlo)[ph] = lo;
    (is_y ? yhi : xhi)[ph] = hi;
  }
  __syncthreads();

  const int c0 = slice * kChannels + t * kVec;
  if (c0 >= c) return;
  int lo_r[kMaxOut], hi_r[kMaxOut];
  int y_first = h, y_last = -1;
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    lo_r[i] = i < out ? ylo[i] : h;
    hi_r[i] = i < out ? yhi[i] : -1;
    y_first = min(y_first, lo_r[i]);
    y_last = max(y_last, hi_r[i]);
  }
  const T* img = feat + (long long)b * h * w * c + c0;
  T* o = dst + (long long)roi * out * out * c + c0;

  for (int j = 0; j < out; ++j) {
    const int x_first = xlo[j], x_last = xhi[j];
    const float* wxj = wx + j * w;
    float acc[kMaxOut][kVec];
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) acc[i][k] = 0.0f;
    }

    // two rows at a time: two independent loads in flight a column (on an
    // H100 20% faster than one row; three or four rows were no faster)
    for (int y = y_first; y <= y_last; y += 2) {
      const bool two = y < y_last;
      float row0[kVec], row1[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        row0[k] = 0.0f;
        row1[k] = 0.0f;
      }
      const T* px = img + (long long)y * w * c;
      const long long next = two ? (long long)w * c : 0;   // else re-read y
      for (int x = x_first; x <= x_last; ++x) {
        float v0[kVec], v1[kVec];
        ait::load8(px + (long long)x * c, v0);
        ait::load8(px + next + (long long)x * c, v1);
        const float a = wxj[x];
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          row0[k] = fmaf(a, v0[k], row0[k]);
          row1[k] = fmaf(a, v1[k], row1[k]);
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxOut; ++i) {
        if (lo_r[i] <= y && y <= hi_r[i]) {
          const float a = wy[i * h + y];
#pragma unroll
          for (int k = 0; k < kVec; ++k) acc[i][k] = fmaf(a, row0[k], acc[i][k]);
        }
        if (two && lo_r[i] <= y + 1 && y + 1 <= hi_r[i]) {
          const float a = wy[i * h + y + 1];
#pragma unroll
          for (int k = 0; k < kVec; ++k) acc[i][k] = fmaf(a, row1[k], acc[i][k]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i)
      if (i < out) ait::store8(o + (long long)(i * out + j) * c, acc[i]);
  }
}

}  // namespace

// out [b, n_rois, out, out, c] in feat's type (bf16 when is_bf16, else f32)
// from feat [b, h, w, c] and the f32 rois at rois + bi * roi_bstride +
// ri * roi_rstride (x1, y1, x2, y2 contiguous).  c % 8 == 0, out <= 7,
// out * (h + w) * 4 bytes of shared memory at most 48 KB: the wrapper
// checks.
extern "C" int roi_align_fwd(const void* feat, const void* rois,
                             long long roi_bstride, int roi_rstride, int b,
                             int n_rois, int h, int w, int c, int out,
                             float scale, int ratio, int is_bf16, void* dst,
                             void* stream) {
  if (out < 1 || out > kMaxOut || c % kVec != 0)
    return (int)cudaErrorInvalidValue;
  const int slices = (c + kChannels - 1) / kChannels;
  const long long blocks = (long long)b * n_rois * slices;
  if (blocks == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)out * (h + w) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    roi_align_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, smem, st>>>(
        (const __nv_bfloat16*)feat, (const float*)rois, roi_bstride,
        roi_rstride, n_rois, slices, h, w, c, out, scale, ratio,
        (__nv_bfloat16*)dst);
  else
    roi_align_kernel<float><<<(unsigned)blocks, kThreads, smem, st>>>(
        (const float*)feat, (const float*)rois, roi_bstride, roi_rstride,
        n_rois, slices, h, w, c, out, scale, ratio, (float*)dst);
  return (int)cudaGetLastError();
}
