// Multi-level RoIAlign forward (aligned=False, torchvision edge rules).
//
// Replaces: the Pallas TPU kernel
// podtpu/ops/pallas/roi_align_kernel.py::_fwd_kernel (entry
// batched_roi_align_pallas through _fwd_call).  It computes the semantics of
// podtpu/ops/roi_align.py::multilevel_roi_align directly: for RoI r of image
// b on its assigned level l (computed by the caller, podtpu_torch/ops/
// roi_align.py::assign_levels, long-side bump included), each of the out*out
// bins averages ratio*ratio bilinear samples.  Samples outside [-1, size]
// give 0; coordinates clamp to [0, size-1]; lo = min(floor(c),
// max(size-2, 0)); hi = min(lo+1, size-1); RoI width and height are floored
// at 1.  There is no VMEM window, so the TPU kernel's 8-aligned window
// origins and small-level padding do not exist here.
//
// Bound on the H100: bytes.  Per call it must read the feature cells its
// RoIs touch (at most the whole P2..P5 pyramid, 2 bytes a value in bf16) and
// the boxes, and write B*K*out*out*C outputs (100 MB in bf16 at B=4, K=1000,
// C=256); the arithmetic is ~8 float32 operations per sample and channel,
// far below the card's rate for those bytes.
//
// Design: one 128-thread block per (RoI, tile of 128 channels); each thread
// owns one channel, so the four neighbours of a sample are read as
// channel-contiguous rows of the NHWC level (64 coalesced bytes per warp in
// bf16) and every output value is written once, coalesced.  The
// block's first threads compute the out*ratio sample positions of each axis
// (neighbour indices, fractions, inside flags) once into shared memory.
// Accumulation is float32; the store rounds once to the output type.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 5;
constexpr int kMaxSamples = 64;  // out_size * ratio per axis
constexpr int kThreads = 128;

struct LevelTable {
  const void* data[kMaxLevels];  // [B, H, W, C] contiguous
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];  // 1 / stride
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void roi_align_fwd_kernel(LevelTable levels,
                                     const float* __restrict__ boxes,
                                     const int* __restrict__ level_idx,
                                     T* __restrict__ out, int k_per_image,
                                     int channels, int out_size, int ratio) {
  __shared__ int lo_s[2][kMaxSamples];
  __shared__ int hi_s[2][kMaxSamples];
  __shared__ float frac_s[2][kMaxSamples];
  __shared__ bool in_s[2][kMaxSamples];

  const int roi = blockIdx.x;
  const int b = roi / k_per_image;
  const int lvl = level_idx[roi];
  const int height = levels.height[lvl];
  const int width = levels.width[lvl];
  const float scale = levels.scale[lvl];
  const int ns = out_size * ratio;

  if (threadIdx.x < 2 * ns) {
    const int axis = threadIdx.x >= ns;  // 0: y, 1: x
    const int s = axis ? threadIdx.x - ns : threadIdx.x;
    const float* box = boxes + static_cast<size_t>(roi) * 4;
    const float c1 = __fmul_rn(box[axis ? 0 : 1], scale);
    const float c2 = __fmul_rn(box[axis ? 2 : 3], scale);
    const float len = fmaxf(__fsub_rn(c2, c1), 1.0f);
    const float bin = __fdiv_rn(len, static_cast<float>(out_size));
    const float grid = __fadd_rn(
        static_cast<float>(s / ratio),
        __fdiv_rn(__fadd_rn(static_cast<float>(s % ratio), 0.5f),
                  static_cast<float>(ratio)));
    const float coord = __fadd_rn(c1, __fmul_rn(grid, bin));
    const int size = axis ? width : height;
    const float sizef = static_cast<float>(size);
    const float cc = fminf(fmaxf(coord, 0.0f), __fsub_rn(sizef, 1.0f));
    const float lo = fminf(floorf(cc), fmaxf(__fsub_rn(sizef, 2.0f), 0.0f));
    const int lo_i = static_cast<int>(lo);
    lo_s[axis][s] = lo_i;
    hi_s[axis][s] = min(lo_i + 1, size - 1);
    frac_s[axis][s] = __fsub_rn(cc, lo);
    in_s[axis][s] = coord >= -1.0f && coord <= sizef;
  }
  __syncthreads();

  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= channels) return;
  const T* feat = static_cast<const T*>(levels.data[lvl]) +
                  static_cast<size_t>(b) * height * width * channels + c;
  T* dst = out + static_cast<size_t>(roi) * out_size * out_size * channels + c;
  const float count = static_cast<float>(ratio * ratio);

  for (int py = 0; py < out_size; ++py) {
    for (int px = 0; px < out_size; ++px) {
      float acc = 0.0f;
      for (int iy = 0; iy < ratio; ++iy) {
        const int sy = py * ratio + iy;
        if (!in_s[0][sy]) continue;
        const float fy = frac_s[0][sy];
        const size_t row_lo = static_cast<size_t>(lo_s[0][sy]) * width;
        const size_t row_hi = static_cast<size_t>(hi_s[0][sy]) * width;
        for (int ix = 0; ix < ratio; ++ix) {
          const int sx = px * ratio + ix;
          if (!in_s[1][sx]) continue;
          const float fx = frac_s[1][sx];
          const int xl = lo_s[1][sx];
          const int xh = hi_s[1][sx];
          const float v00 = to_float(feat[(row_lo + xl) * channels]);
          const float v01 = to_float(feat[(row_lo + xh) * channels]);
          const float v10 = to_float(feat[(row_hi + xl) * channels]);
          const float v11 = to_float(feat[(row_hi + xh) * channels]);
          acc += v00 * (1.0f - fy) * (1.0f - fx) + v01 * (1.0f - fy) * fx +
                 v10 * fy * (1.0f - fx) + v11 * fy * fx;
        }
      }
      dst[(py * out_size + px) * channels] = from_float<T>(acc / count);
    }
  }
}

}  // namespace

// levels: host pointer to a LevelTable; boxes [R, 4] float32 (image
// coordinates); level_idx [R] int32; out [R, out, out, C] of the levels'
// type.  R = B * k_per_image.  dtype: 0 float32, 1 bfloat16.  Returns a
// cudaError_t.
extern "C" int podtpu_roi_align_fwd(const void* levels, const void* boxes,
                                    const void* level_idx, void* out,
                                    int rois, int k_per_image, int channels,
                                    int out_size, int ratio, int dtype,
                                    void* stream) {
  if (rois <= 0 || channels <= 0) return 0;
  if (out_size * ratio > kMaxSamples || 2 * out_size * ratio > kThreads ||
      k_per_image <= 0 || rois % k_per_image != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const LevelTable table = *static_cast<const LevelTable*>(levels);
  const dim3 grid(rois, (channels + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(boxes);
  const int* li = static_cast<const int*>(level_idx);
  if (dtype == 1) {
    roi_align_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        table, b, li, static_cast<__nv_bfloat16*>(out), k_per_image,
        channels, out_size, ratio);
  } else if (dtype == 0) {
    roi_align_fwd_kernel<float><<<grid, kThreads, 0, st>>>(
        table, b, li, static_cast<float*>(out), k_per_image, channels,
        out_size, ratio);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
