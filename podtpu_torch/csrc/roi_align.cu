// Multi-level RoIAlign forward and backward (aligned=False, torchvision edge
// rules).
//
// Forward.  Replaces: the Pallas TPU kernel
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
//
// Backward.  Replaces: the Pallas TPU kernel
// podtpu/ops/pallas/roi_align_kernel.py::_bwd_kernel (through _bwd_call and
// _vjp_bwd).  The forward is linear in the features, so the gradient of a
// level cell is the sum, over every sample of every RoI that reads it, of
// the bin's upstream gradient / ratio^2 times the sample's bilinear weight.
// Same grid and the same shared sample table as the forward; each thread
// adds its channel's four weighted values per inside sample with atomicAdd
// into a float32 NHWC gradient buffer per level that the caller zeroed (a
// warp's 32 atomics hit 32 consecutive floats).  At a border where lo ==
// hi both weights land on the one cell, as autograd of the plain version
// gives.  A bin whose upstream gradient is exactly 0 (the padded RoI slots
// of a training batch) adds nothing and is skipped.  The TPU kernel's
// window DMAs and its two parity buffers (they kept consecutive RoIs from
// racing on one window) do not exist here; atomics take their place, so
// the order of the float32 sums changes from run to run.
//
// Bound of the backward on the H100: bytes.  It must read the upstream
// gradient (B*K*out*out*C values) and the boxes, and read and write each
// float32 cell that some inside sample touches; the atomics themselves,
// not the bytes, are what it waits on when many RoIs overlap.

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

// Per-axis sample table of one RoI: neighbour indices, fractions and
// inside flags of the out*ratio sample positions along y (axis 0) and x
// (axis 1).
struct SampleTable {
  int lo[2][kMaxSamples];
  int hi[2][kMaxSamples];
  float frac[2][kMaxSamples];
  bool in[2][kMaxSamples];
};

// Filled by the block's first 2*out_size*ratio threads; the caller
// synchronises.  Explicitly rounded operations keep nvcc from contracting
// them into FMAs, so positions equal the plain version's.
__device__ __forceinline__ void fill_sample_table(
    SampleTable& t, const float* __restrict__ boxes, int roi, int height,
    int width, float scale, int out_size, int ratio) {
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
    t.lo[axis][s] = lo_i;
    t.hi[axis][s] = min(lo_i + 1, size - 1);
    t.frac[axis][s] = __fsub_rn(cc, lo);
    t.in[axis][s] = coord >= -1.0f && coord <= sizef;
  }
}

template <typename T>
__global__ void roi_align_fwd_kernel(LevelTable levels,
                                     const float* __restrict__ boxes,
                                     const int* __restrict__ level_idx,
                                     T* __restrict__ out, int k_per_image,
                                     int channels, int out_size, int ratio) {
  __shared__ SampleTable tab;
  const int roi = blockIdx.x;
  const int b = roi / k_per_image;
  const int lvl = level_idx[roi];
  const int height = levels.height[lvl];
  const int width = levels.width[lvl];
  fill_sample_table(tab, boxes, roi, height, width, levels.scale[lvl],
                    out_size, ratio);
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
        if (!tab.in[0][sy]) continue;
        const float fy = tab.frac[0][sy];
        const size_t row_lo = static_cast<size_t>(tab.lo[0][sy]) * width;
        const size_t row_hi = static_cast<size_t>(tab.hi[0][sy]) * width;
        for (int ix = 0; ix < ratio; ++ix) {
          const int sx = px * ratio + ix;
          if (!tab.in[1][sx]) continue;
          const float fx = tab.frac[1][sx];
          const int xl = tab.lo[1][sx];
          const int xh = tab.hi[1][sx];
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

// grad_levels.data[l]: float32 [B, H, W, C], zeroed by the caller; grad_out
// [R, out, out, C] of type T.
template <typename T>
__global__ void roi_align_bwd_kernel(LevelTable grad_levels,
                                     const float* __restrict__ boxes,
                                     const int* __restrict__ level_idx,
                                     const T* __restrict__ grad_out,
                                     int k_per_image, int channels,
                                     int out_size, int ratio) {
  __shared__ SampleTable tab;
  const int roi = blockIdx.x;
  const int b = roi / k_per_image;
  const int lvl = level_idx[roi];
  const int height = grad_levels.height[lvl];
  const int width = grad_levels.width[lvl];
  fill_sample_table(tab, boxes, roi, height, width, grad_levels.scale[lvl],
                    out_size, ratio);
  __syncthreads();

  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= channels) return;
  float* dst = static_cast<float*>(const_cast<void*>(grad_levels.data[lvl])) +
               static_cast<size_t>(b) * height * width * channels + c;
  const T* g = grad_out +
               static_cast<size_t>(roi) * out_size * out_size * channels + c;
  const float count = static_cast<float>(ratio * ratio);

  for (int py = 0; py < out_size; ++py) {
    for (int px = 0; px < out_size; ++px) {
      const float gv = to_float(g[(py * out_size + px) * channels]) / count;
      if (gv == 0.0f) continue;
      for (int iy = 0; iy < ratio; ++iy) {
        const int sy = py * ratio + iy;
        if (!tab.in[0][sy]) continue;
        const float fy = tab.frac[0][sy];
        const size_t row_lo = static_cast<size_t>(tab.lo[0][sy]) * width;
        const size_t row_hi = static_cast<size_t>(tab.hi[0][sy]) * width;
        const float gy_lo = gv * (1.0f - fy);
        const float gy_hi = gv * fy;
        for (int ix = 0; ix < ratio; ++ix) {
          const int sx = px * ratio + ix;
          if (!tab.in[1][sx]) continue;
          const float fx = tab.frac[1][sx];
          const int xl = tab.lo[1][sx];
          const int xh = tab.hi[1][sx];
          atomicAdd(dst + (row_lo + xl) * channels, gy_lo * (1.0f - fx));
          atomicAdd(dst + (row_lo + xh) * channels, gy_lo * fx);
          atomicAdd(dst + (row_hi + xl) * channels, gy_hi * (1.0f - fx));
          atomicAdd(dst + (row_hi + xh) * channels, gy_hi * fx);
        }
      }
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

// grad_levels: host pointer to a LevelTable of float32 [B, H, W, C]
// gradient buffers, zeroed by the caller, with the levels' sizes and
// scales; boxes [R, 4] float32; level_idx [R] int32; grad_out [R, out, out,
// C] of type dtype (0 float32, 1 bfloat16).  Adds into the buffers.
// Returns a cudaError_t.
extern "C" int podtpu_roi_align_bwd(const void* grad_levels,
                                    const void* boxes, const void* level_idx,
                                    const void* grad_out, int rois,
                                    int k_per_image, int channels,
                                    int out_size, int ratio, int dtype,
                                    void* stream) {
  if (rois <= 0 || channels <= 0) return 0;
  if (out_size * ratio > kMaxSamples || 2 * out_size * ratio > kThreads ||
      k_per_image <= 0 || rois % k_per_image != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const LevelTable table = *static_cast<const LevelTable*>(grad_levels);
  const dim3 grid(rois, (channels + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(boxes);
  const int* li = static_cast<const int*>(level_idx);
  if (dtype == 1) {
    roi_align_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        table, b, li, static_cast<const __nv_bfloat16*>(grad_out),
        k_per_image, channels, out_size, ratio);
  } else if (dtype == 0) {
    roi_align_bwd_kernel<float><<<grid, kThreads, 0, st>>>(
        table, b, li, static_cast<const float*>(grad_out), k_per_image,
        channels, out_size, ratio);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
