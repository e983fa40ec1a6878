// Multi-level RoIAlign forward and backward (aligned=False, torchvision edge
// rules) for one NVIDIA H100.
//
// Both kernels compute the semantics of
// podtpu/ops/roi_align.py::multilevel_roi_align: RoI r of image b lies on
// its assigned level l (computed by the caller, podtpu_torch/ops/
// roi_align.py::assign_levels, long-side bump included); each of the out*out
// bins averages ratio*ratio bilinear samples.  A sample outside [-1, size]
// gives 0; coordinates clamp to [0, size-1]; lo = min(floor(c),
// max(size-2, 0)); hi = min(lo+1, size-1); RoI width and height are floored
// at 1.  Sample positions use explicitly rounded operations (sample_pos), so
// they equal the plain version's; sums are float32 with one rounding to the
// level type.
//
// Forward (roi_align_fwd_kernel).  Replaces the Pallas TPU kernel
// podtpu/ops/pallas/roi_align_kernel.py::_fwd_kernel (entry
// batched_roi_align_pallas through _fwd_call).  Bound on the H100: bytes.
// It must read the feature cells its RoIs touch and the boxes and write
// B*K*out*out*C outputs (100 MB in bf16 at B=4, K=1000, C=256); the
// arithmetic is about 12 float32 operations per sample and channel, far
// below the card's rate for those bytes.  What the design does about it:
//   * Each cell once per RoI.  Sampling and bin averaging are separable:
//     out[py, px] = 1/ratio^2 * sum_y wy[py, y] sum_x wx[px, x] F[y, x] over
//     the RoI's distinct rows and columns (at most 2*out*ratio each, 28 at
//     out 7, ratio 2; a typical RoI of 7 to 14 cells has 9 to 16).  One
//     block owns one RoI (and one chunk of 32 16-byte channel vectors: 256
//     channels in bf16, 128 in float32).  It lists the distinct rows and
//     columns, then takes the rows one by one: only the listed columns of a
//     row are fetched.
//   * 16-byte loads, asynchronous.  A lane owns 8 bf16 (4 float32)
//     consecutive channels, so a warp covers a cell in one 512-byte request.
//     Rows go to shared memory with cp.async (16 bytes, .cg: the cells are
//     read once per block, L1 would gain nothing) into a ring of kFwdStages
//     buffers, so the next rows' loads fly while this row is consumed.
//     (Measured on the H100: a ring of 6, three blocks an SM through a
//     register cap, and rows taken two by two were each slower.)
//   * Warp px owns output column px.  Per row it runs the x pass for its
//     column (ratio samples, two 16-byte shared loads each) and adds the
//     result into its out bins' float32 registers with the row's y weights
//     (a dense [row, py] table in shared memory).  No thread shares a sum.
//   * One store per RoI.  [R, out, out, C]: each warp stores 512 contiguous
//     bytes per bin straight from registers, 16 bytes a lane.  [R, C, out,
//     out] (the box head's order): the bins are staged in the row buffers'
//     shared memory, bin-major with a padded stride, and written as the one
//     contiguous run that order makes of a RoI's chunk.
//   * No TMA: a tensor map fixes its box when it is encoded and a RoI's
//     rows and columns are a list, not a box.  No tensor cores: the work is
//     a few float32 operations per byte against a bytes bound, and bf16
//     weights would not equal the plain version's float32 weights.
//
// Backward (roi_prepare_kernel, roi_align_bwd_kernel,
// roi_align_bwd_sum_kernel).  Replaces the Pallas TPU kernel
// podtpu/ops/pallas/roi_align_kernel.py::_bwd_kernel (through _bwd_call and
// _vjp_bwd).  The forward is linear in the features, so the gradient of a
// level cell is the sum, over every sample of every RoI that reads it, of
// the bin's upstream gradient / ratio^2 times the sample's bilinear weight.
// Bound on the H100: bytes.  It must read the upstream gradient and the
// boxes and write every cell of the level gradients once in the level type
// (89 MB in bf16 at 1024^2, B=2), zeros where no RoI reaches.  What the
// design does about it: a gather by tile, so no level buffer is zeroed
// beforehand or cast afterwards and no atomic add is made.
//   * roi_prepare_kernel writes each RoI's samples (neighbour cells and
//     fractions, from sample_pos) and the rectangle of cells they touch
//     once, 16*out*ratio + 8 bytes a RoI, so that no block divides.
//   * One block of 256 threads owns one (image, level, tile of 8x8 cells,
//     group of 32 16-byte channel vectors: 256 channels in bf16).  A warp
//     owns one row of the tile and a lane 16 bytes of channels, so a thread
//     keeps the sums of eight cells in float32 registers and the loops over
//     a cell's bins do not diverge.  The block scans its image's RoIs,
//     compacts those on its level whose rectangle meets the tile (warp
//     ballots, fixed order), and for each hit stages the RoI's upstream
//     gradient for its channels in shared memory with cp.async (ring of
//     kBwdStages) while 128 threads fold the next hit's samples into
//     per-axis lists of the bins that weigh on each row and column of the
//     tile.  A channels-first hit is transposed once in shared memory.  A
//     cell then adds wy*wx*g over its listed bins, two by two along each
//     axis (a cell outside the RoI costs a few instructions; a bin whose
//     upstream gradient is 0 adds 0).
//   * The coarse levels have few tiles and each meets many RoIs (96 of 512
//     on a P5 tile of the measured case).  A level with fewer than 128
//     tiles splits each tile's RoIs over up to 8 blocks, which write
//     float32 partial tiles; roi_align_bwd_sum_kernel adds them in a fixed
//     order.  Levels with many tiles are written directly.
//   * A tile is written once, 16 bytes a thread, in the level type; no two
//     blocks write one cell.  The TPU kernel's window DMAs and parity
//     buffers have no counterpart.
//   * The sums have a fixed order: two runs give the same bits.
// The upstream gradient is read in [R, out, out, C] or [R, C, out, out]
// order, matching the forward's output.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// One source, two translation units: the build compiles this file twice,
// in parallel, with -DPODTPU_ROI_ALIGN_PART=1 (forward) and =2 (backward);
// with the macro undefined it holds both.
#ifndef PODTPU_ROI_ALIGN_PART
#define PODTPU_ROI_ALIGN_PART 0
#endif
#define PODTPU_ROI_ALIGN_FWD (PODTPU_ROI_ALIGN_PART != 2)
#define PODTPU_ROI_ALIGN_BWD (PODTPU_ROI_ALIGN_PART != 1)

namespace {

constexpr int kMaxLevels = 5;
constexpr int kMaxSamples = 64;  // out_size * ratio per axis
constexpr int kFwdStages = 3;     // cp.async ring depths
constexpr int kBwdStages = 2;
constexpr int kSumParts = 4;      // backward: blocks that sum one split tile
constexpr int kSplitTarget = 128; // backward: units a split level aims at
constexpr int kMaxSplit = 8;      // backward: most units a tile
constexpr int kTile = 8;         // backward: tile side in cells
constexpr int kBwdThreads = 256;
constexpr int kHitChunk = 1024;  // backward: RoIs scanned per pass
constexpr int kMaxSharedBytes = 232448;

struct LevelTable {
  const void* data[kMaxLevels];  // [B, H, W, C] contiguous
  int height[kMaxLevels];
  int width[kMaxLevels];
  float scale[kMaxLevels];  // 1 / stride
};

// Work units of the backward grid.  Level l has tiles_x[l] tiles to a row
// and splits each tile's RoIs over split[l] units (RoI j goes to unit j %
// split[l]); its units are unit_start[l] .. unit_start[l+1]-1, tile-major.
// A level with split[l] > 1 writes float32 partial tiles, the first at
// partial_start[l] (in tiles of kTile*kTile cells), summed by a second
// pass; partial_tiles is their number per image.
struct TileTable {
  int unit_start[kMaxLevels + 1];
  int tiles_x[kMaxLevels];
  int split[kMaxLevels];
  int partial_start[kMaxLevels];
  int partial_tiles;
  int n_levels;
};

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

// 16 bytes of T at p (16-byte aligned) as floats.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // A bf16 is the high half of its float32.
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Floats rounded once to T, 16 bytes at p (16-byte aligned).
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The same 16 bytes as two 8-byte stores, for p only 8-byte aligned.
__device__ __forceinline__ void store_vec_halves(float* p,
                                                 const float (&v)[4]) {
  reinterpret_cast<float2*>(p)[0] = make_float2(v[0], v[1]);
  reinterpret_cast<float2*>(p)[1] = make_float2(v[2], v[3]);
}
__device__ __forceinline__ void store_vec_halves(__nv_bfloat16* p,
                                                 const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  reinterpret_cast<uint2*>(p)[0] = make_uint2(w[0], w[1]);
  reinterpret_cast<uint2*>(p)[1] = make_uint2(w[2], w[3]);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* global) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(global)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One sample position along one axis (0: y, 1: x): bilinear neighbours,
// fraction and inside flag.  Explicitly rounded operations keep nvcc from
// contracting them into FMAs, so positions equal the plain version's.
struct AxisSample {
  int lo, hi;
  float frac;
  bool in;
};

__device__ __forceinline__ AxisSample sample_pos(const float* __restrict__ box,
                                                 int axis, int s, int size,
                                                 float scale, int out_size,
                                                 int ratio) {
  const float c1 = __fmul_rn(box[axis ? 0 : 1], scale);
  const float c2 = __fmul_rn(box[axis ? 2 : 3], scale);
  const float len = fmaxf(__fsub_rn(c2, c1), 1.0f);
  const float bin = __fdiv_rn(len, static_cast<float>(out_size));
  const float grid = __fadd_rn(
      static_cast<float>(s / ratio),
      __fdiv_rn(__fadd_rn(static_cast<float>(s % ratio), 0.5f),
                static_cast<float>(ratio)));
  const float coord = __fadd_rn(c1, __fmul_rn(grid, bin));
  const float sizef = static_cast<float>(size);
  const float cc = fminf(fmaxf(coord, 0.0f), __fsub_rn(sizef, 1.0f));
  const float lo = fminf(floorf(cc), fmaxf(__fsub_rn(sizef, 2.0f), 0.0f));
  AxisSample p;
  p.lo = static_cast<int>(lo);
  p.hi = min(p.lo + 1, size - 1);
  p.frac = __fsub_rn(cc, lo);
  p.in = coord >= -1.0f && coord <= sizef;
  return p;
}

// FPN level of each box, as podtpu_torch/ops/roi_align.py::assign_levels
// computes it on a CUDA tensor, operation for operation (PyTorch divides by
// a Python number as a multiplication by its float32 reciprocal): floor(k0
// + log2(sqrt(area) / s0 + eps)), raised for a box whose long side would
// span more than max_span cells at its level (max_span <= 0: never), then
// clamped to the level range; 0-based.
__global__ void roi_level_kernel(const float* __restrict__ boxes,
                                 int* __restrict__ level, int rois,
                                 int n_levels, float inv_scale, float k0,
                                 float min_level, float eps, float inv_span) {
  const int roi = blockIdx.x * blockDim.x + threadIdx.x;
  if (roi >= rois) return;
  const float4 bx = reinterpret_cast<const float4*>(boxes)[roi];
  const float w = __fsub_rn(bx.z, bx.x);
  const float h = __fsub_rn(bx.w, bx.y);
  const float scale = __fsqrt_rn(fmaxf(__fmul_rn(w, h), 0.0f));
  float lvl = floorf(
      __fadd_rn(log2f(__fadd_rn(__fmul_rn(scale, inv_scale), eps)), k0));
  if (inv_span > 0.0f) {
    const float long_px = fmaxf(fmaxf(w, h), eps);
    const float need =
        ceilf(log2f(__fadd_rn(__fmul_rn(long_px, inv_span), eps)));
    lvl = fmaxf(lvl, __fadd_rn(need, min_level));
  }
  lvl = fminf(fmaxf(lvl, min_level),
              __fadd_rn(min_level, static_cast<float>(n_levels - 1)));
  level[roi] = static_cast<int>(__fsub_rn(lvl, min_level));
}

// Status codes of the entry points beside cudaError_t values: negative,
// one for each argument an entry point refuses.
enum Refusal {
  kBadSizes = -1,      // rois, k_per_image
  kBadChannels = -2,   // channels % 8
  kBadOutSize = -3,    // output_size not instantiated
  kBadRatio = -4,      // sampling_ratio
  kBadDtype = -5,
  kBadAlignment = -6,  // a pointer not 16-byte aligned
  kBadShared = -7,     // shared memory above the card's limit
  kBadLevels = -8,     // number or size of levels
};

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int check_common(int rois, int k_per_image, int channels, int out_size,
                 int ratio, int dtype) {
  if (k_per_image <= 0 || rois % k_per_image != 0) return kBadSizes;
  if (channels % 8 != 0) return kBadChannels;
  if (out_size != 7 && out_size != 14) return kBadOutSize;
  if (ratio <= 0 || out_size * ratio > kMaxSamples) return kBadRatio;
  if (dtype != 0 && dtype != 1) return kBadDtype;
  return 0;
}

// Raises the kernel's dynamic shared-memory limit to `bytes` where its
// static and dynamic shared memory together pass the 48 KB default.
// `*allowed` remembers the limit already set for this kernel.
template <typename K>
int allow_shared(K kernel, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return 0;
  cudaFuncAttributes attr;
  if (cudaError_t err = cudaFuncGetAttributes(&attr, kernel))
    return static_cast<int>(err);
  if (bytes + attr.sharedSizeBytes > static_cast<size_t>(kMaxSharedBytes))
    return kBadShared;
  if (bytes + attr.sharedSizeBytes > 48 * 1024) {
    if (cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes)))
      return static_cast<int>(err);
  }
  *allowed = bytes;
  return 0;
}

}  // namespace

#if PODTPU_ROI_ALIGN_FWD

namespace {

// ---------------------------------------------------------------- forward

// Shared bookkeeping of one RoI in the forward kernel.
template <int OUT> struct FwdTables {
  static constexpr int WY = (OUT + 3) & ~3;  // a row of wy: whole float4s
  float wy[2 * kMaxSamples][WY];  // [row slot][py]; first: 16-byte aligned
  // Per axis and sample: slots of the neighbours in the distinct list,
  // fraction, inside flag; raw neighbour cells while the list is built.
  int lo[2][kMaxSamples];
  int hi[2][kMaxSamples];
  float frac[2][kMaxSamples];
  int in[2][kMaxSamples];
  int cell[2][2 * kMaxSamples];  // distinct rows (0) and columns (1), sorted
  int count[2];
};

// Dynamic shared memory: kFwdStages row buffers of 2*out*ratio cells of 512
// bytes (32 lanes x 16 bytes); reused as the [bin][chunk + pad] staging of
// a channels-first store.
template <typename T, int OUT>
__global__ void __launch_bounds__(OUT * 32, OUT == 7 ? 2 : 1)
    roi_align_fwd_kernel(LevelTable levels, const float* __restrict__ boxes,
                         const int* __restrict__ level_idx,
                         T* __restrict__ out, int k_per_image, int channels,
                         int ratio, int channels_first) {
  constexpr int VEC = Vec<T>::n;
  constexpr int CHUNK = 32 * VEC;            // channels a block covers
  constexpr int STAGE_STRIDE = CHUNK + 8 / static_cast<int>(sizeof(T));
  constexpr int THREADS = OUT * 32;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ __align__(16) FwdTables<OUT> tab;
  T* const ring = reinterpret_cast<T*>(dyn_smem);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int px = tid >> 5;
  const int roi = blockIdx.x;
  const int b = roi / k_per_image;
  const int lvl = level_idx[roi];
  const int height = levels.height[lvl];
  const int width = levels.width[lvl];
  const int ns = OUT * ratio;
  const int chunk0 = blockIdx.y * CHUNK;
  const int c = chunk0 + lane * VEC;
  const bool active = c < channels;
  const float* box = boxes + static_cast<size_t>(roi) * 4;

  if (tid < 2 * ns) {
    const int axis = tid >= ns;
    const int s = axis ? tid - ns : tid;
    const AxisSample p = sample_pos(box, axis, s, axis ? width : height,
                                    levels.scale[lvl], OUT, ratio);
    tab.lo[axis][s] = p.lo;
    tab.hi[axis][s] = p.hi;
    tab.frac[axis][s] = p.frac;
    tab.in[axis][s] = p.in;
  }
  __syncthreads();
  // Distinct cells of each axis, one thread an axis.  lo never decreases
  // with s and hi <= lo + 1, so a cell already listed is one of the last
  // two entries and the list stays sorted.
  if (lane == 0 && px < 2) {
    const int axis = px;
    int n = 0, last = -1, prev = -1;  // cells of slots n-1 and n-2
    for (int s = 0; s < ns; ++s) {
      if (!tab.in[axis][s]) continue;
      const int pair[2] = {tab.lo[axis][s], tab.hi[axis][s]};
      int slot[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int v = pair[j];
        if (n > 0 && v == last) {
          slot[j] = n - 1;
        } else if (n > 1 && v == prev) {
          slot[j] = n - 2;
        } else {
          tab.cell[axis][n] = v;
          slot[j] = n;
          prev = last;
          last = v;
          ++n;
        }
      }
      tab.lo[axis][s] = slot[0];
      tab.hi[axis][s] = slot[1];
    }
    tab.count[axis] = n;
  }
  __syncthreads();
  const int nrows = tab.count[0];
  const int ncols = tab.count[1];
  // Dense y weights of the distinct rows.
  for (int e = tid; e < nrows * OUT; e += THREADS) {
    const int i = e / OUT, py = e % OUT;
    float w = 0.0f;
    for (int k = 0; k < ratio; ++k) {
      const int s = py * ratio + k;
      if (!tab.in[0][s]) continue;
      const float f = tab.frac[0][s];
      if (tab.lo[0][s] == i) w += 1.0f - f;
      if (tab.hi[0][s] == i) w += f;
    }
    tab.wy[i][py] = w;
  }
  // (The first __syncthreads of the row loop orders these writes before
  // their first read.)

  const int row_cells = 2 * ns;  // cells of one ring buffer
  const T* const feat = static_cast<const T*>(levels.data[lvl]) +
                        static_cast<size_t>(b) * height * width * channels +
                        chunk0;
  auto prefetch_row = [&](int i) {
    if (i < nrows && ncols > 0) {
      const T* src_row =
          feat + static_cast<size_t>(tab.cell[0][i]) * width * channels;
      T* dst_row = ring + static_cast<size_t>(i % kFwdStages) * row_cells * CHUNK;
      for (int u = tid; u < ncols * 32; u += THREADS) {
        const int j = u >> 5, l = u & 31;
        if (chunk0 + l * VEC < channels)
          cp_async16(dst_row + j * CHUNK + l * VEC,
                     src_row + static_cast<size_t>(tab.cell[1][j]) * channels +
                         l * VEC);
      }
    }
    cp_async_commit();  // one group a row, empty or not: uniform counting
  };

  float acc[OUT][VEC];
#pragma unroll
  for (int py = 0; py < OUT; ++py)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[py][v] = 0.0f;

  // The x samples of this warp's output column are the same for every row:
  // at ratio 2, the usual one, they stay in registers.
  struct XSample {
    int lo, hi;  // offsets of the neighbours in a row buffer
    float frac;
    bool in;
  };
  auto x_sample = [&](int k) {
    const int s = px * ratio + k;
    return XSample{tab.lo[1][s] * CHUNK, tab.hi[1][s] * CHUNK,
                   tab.frac[1][s], tab.in[1][s] != 0};
  };
  const bool two = ratio == 2;
  const XSample x0 = x_sample(0);
  const XSample x1 = two ? x_sample(1) : x0;

  if (ncols > 0) {
#pragma unroll
    for (int i = 0; i < kFwdStages - 1; ++i) prefetch_row(i);
    for (int i = 0; i < nrows; ++i) {
      cp_async_wait<kFwdStages - 2>();  // row i has landed (this thread's part)
      __syncthreads();               // ... and everyone's; row i-1 is done
      prefetch_row(i + kFwdStages - 1); // into the buffer row i-1 used
      if (active) {
        const T* rowbuf =
            ring + static_cast<size_t>(i % kFwdStages) * row_cells * CHUNK +
            lane * VEC;
        float t[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) t[v] = 0.0f;
        auto x_add = [&](const XSample& x) {
          if (!x.in) return;
          const float g = 1.0f - x.frac;
          float a[VEC], d[VEC];
          load_vec(rowbuf + x.lo, a);
          load_vec(rowbuf + x.hi, d);
#pragma unroll
          for (int v = 0; v < VEC; ++v) t[v] += g * a[v] + x.frac * d[v];
        };
        if (two) {
          x_add(x0);
          x_add(x1);
        } else {
          for (int k = 0; k < ratio; ++k) x_add(x_sample(k));
        }
        float w[FwdTables<OUT>::WY];
#pragma unroll
        for (int q = 0; q < FwdTables<OUT>::WY; q += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(&tab.wy[i][q]);
          w[q] = w4.x; w[q + 1] = w4.y; w[q + 2] = w4.z; w[q + 3] = w4.w;
        }
#pragma unroll
        for (int py = 0; py < OUT; ++py) {
          if (w[py] != 0.0f) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[py][v] += w[py] * t[v];
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const float count = static_cast<float>(ratio * ratio);
#pragma unroll
  for (int py = 0; py < OUT; ++py)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[py][v] = acc[py][v] / count;

  if (!channels_first) {
    if (active) {
      T* dst = out + (static_cast<size_t>(roi) * OUT * OUT + px) * channels + c;
#pragma unroll
      for (int py = 0; py < OUT; ++py)
        store_vec(dst + static_cast<size_t>(py) * OUT * channels, acc[py]);
    }
    return;
  }
  // [R, C, out, out]: this chunk's channels are one contiguous run of
  // n_ch * out * out values.  Stage bin-major, then copy the run out.
  __syncthreads();  // every warp is done with the row buffers
  T* const stage = ring;
#pragma unroll
  for (int py = 0; py < OUT; ++py) {
    store_vec_halves(stage + (py * OUT + px) * STAGE_STRIDE + lane * VEC,
                     acc[py]);
  }
  __syncthreads();
  const int n_ch = min(CHUNK, channels - chunk0);
  const int total = n_ch * OUT * OUT;
  T* run = out + (static_cast<size_t>(roi) * channels + chunk0) * OUT * OUT;
  for (int e = tid; e < total; e += THREADS) {
    const int cl = e / (OUT * OUT), p = e % (OUT * OUT);
    run[e] = stage[p * STAGE_STRIDE + cl];
  }
}

template <typename T, int OUT>
int launch_fwd(const LevelTable& table, const float* boxes,
               const int* level_idx, void* out, int rois, int k_per_image,
               int channels, int ratio, int channels_first,
               cudaStream_t stream) {
  constexpr int chunk = 32 * Vec<T>::n;
  size_t ring = static_cast<size_t>(kFwdStages) * 2 * OUT * ratio * 512;
  size_t stage = static_cast<size_t>(OUT) * OUT * (512 + 8);
  size_t bytes = channels_first && stage > ring ? stage : ring;
  auto kernel = roi_align_fwd_kernel<T, OUT>;
  static size_t allowed = 0;
  if (int status = allow_shared(kernel, bytes, &allowed)) return status;
  const dim3 grid(rois, (channels + chunk - 1) / chunk);
  kernel<<<grid, OUT * 32, bytes, stream>>>(
      table, boxes, level_idx, static_cast<T*>(out), k_per_image, channels,
      ratio, channels_first);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// What a negative status of the entry points below means; nullptr for a
// status that is a cudaError_t.
extern "C" const char* podtpu_roi_align_refusal(int status) {
  switch (status) {
    case kBadSizes:
      return "rois must be a positive multiple of k_per_image";
    case kBadChannels:
      return "channels must be a multiple of 8";
    case kBadOutSize:
      return "output_size must be 7 or 14";
    case kBadRatio:
      return "sampling_ratio must be positive with output_size * "
             "sampling_ratio <= 64";
    case kBadDtype:
      return "dtype must be 0 (float32) or 1 (bfloat16)";
    case kBadAlignment:
      return "levels, out and grad_out must be 16-byte aligned";
    case kBadShared:
      return "output_size and sampling_ratio need more shared memory than "
             "232448 bytes";
    case kBadLevels:
      return "n_levels must be 1..5 and each level at most 8191 cells a "
             "side";
    default:
      return nullptr;
  }
}

// boxes [R, 4] float32, 16-byte aligned -> level [R] int32 (see
// roi_level_kernel); span_px = max_span_cells * base_stride, or <= 0 for
// strict assignment.  Returns 0, a cudaError_t or a negative Refusal.
extern "C" int podtpu_roi_levels(const void* boxes, void* level, int rois,
                                 int n_levels, float canonical_scale,
                                 float canonical_level, float min_level,
                                 float eps, float span_px, void* stream) {
  if (rois <= 0) return rois < 0 ? kBadSizes : 0;
  if (n_levels < 1 || n_levels > kMaxLevels) return kBadLevels;
  if (!aligned16(boxes)) return kBadAlignment;
  roi_level_kernel<<<(rois + 127) / 128, 128, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<int*>(level), rois,
      n_levels, 1.0f / canonical_scale, canonical_level, min_level, eps,
      span_px > 0.0f ? 1.0f / span_px : 0.0f);
  return static_cast<int>(cudaGetLastError());
}

// levels: host pointer to a LevelTable of n_levels levels; boxes [R, 4]
// float32 (image coordinates); level_idx [R] int32; out [R, out, out, C]
// or, with channels_first, [R, C, out, out], of the levels' type.  R = B *
// k_per_image.  dtype: 0 float32, 1 bfloat16.  Returns 0, a cudaError_t, or
// a negative Refusal.
extern "C" int podtpu_roi_align_fwd(const void* levels, int n_levels,
                                    const void* boxes, const void* level_idx,
                                    void* out, int rois, int k_per_image,
                                    int channels, int out_size, int ratio,
                                    int dtype, int channels_first,
                                    void* stream) {
  if (rois <= 0 || channels <= 0) return rois < 0 ? kBadSizes : 0;
  if (int status =
          check_common(rois, k_per_image, channels, out_size, ratio, dtype))
    return status;
  if (n_levels < 1 || n_levels > kMaxLevels) return kBadLevels;
  const LevelTable table = *static_cast<const LevelTable*>(levels);
  for (int l = 0; l < n_levels; ++l)
    if (!aligned16(table.data[l])) return kBadAlignment;
  if (!aligned16(out)) return kBadAlignment;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bx = static_cast<const float*>(boxes);
  const int* li = static_cast<const int*>(level_idx);
#define PODTPU_FWD(T, OUT)                                                  \
  return launch_fwd<T, OUT>(table, bx, li, out, rois, k_per_image, channels, \
                            ratio, channels_first, st)
  if (dtype == 1) {
    if (out_size == 7) PODTPU_FWD(__nv_bfloat16, 7);
    PODTPU_FWD(__nv_bfloat16, 14);
  }
  if (out_size == 7) PODTPU_FWD(float, 7);
  PODTPU_FWD(float, 14);
#undef PODTPU_FWD
}

#endif  // PODTPU_ROI_ALIGN_FWD

#if PODTPU_ROI_ALIGN_BWD

namespace {

// --------------------------------------------------------------- backward

// One sample of one axis of one RoI as roi_prepare_kernel leaves it for the
// gather: neighbour cells and fraction; lo < 0 for a sample outside.
struct SampleEntry {
  short lo, hi;
  float frac;
};
static_assert(sizeof(SampleEntry) == 8, "SampleEntry is 8 bytes");

constexpr int kLevelShift = 13;  // rect.x = first row | level << 13
constexpr int kMaxSide = (1 << kLevelShift) - 1;

// samples [R, 2, out*ratio]: every sample of RoI r on its level, y then x.
// rects [R]: the cells (y0, y1, x0, x1, inclusive) its inside samples
// touch, the level in the top bits of y0; y0 > y1 where none is inside.
__global__ void roi_prepare_kernel(LevelTable levels,
                                   const float* __restrict__ boxes,
                                   const int* __restrict__ level_idx,
                                   SampleEntry* __restrict__ samples,
                                   ushort4* __restrict__ rects, int rois,
                                   int out_size, int ratio) {
  const int roi = blockIdx.x * blockDim.x + threadIdx.x;
  if (roi >= rois) return;
  const int lvl = level_idx[roi];
  const float* box = boxes + static_cast<size_t>(roi) * 4;
  const int ns = out_size * ratio;
  SampleEntry* mine = samples + static_cast<size_t>(roi) * 2 * ns;
  int first[2] = {1, 1}, last[2] = {0, 0};
  bool any[2] = {false, false};
#pragma unroll
  for (int axis = 0; axis < 2; ++axis) {
    const int size = axis ? levels.width[lvl] : levels.height[lvl];
    // Coordinates grow with s, so the inside samples are one run: its
    // first lo and its last hi bound the touched cells.
    for (int s = 0; s < ns; ++s) {
      const AxisSample p =
          sample_pos(box, axis, s, size, levels.scale[lvl], out_size, ratio);
      SampleEntry e;
      e.lo = p.in ? static_cast<short>(p.lo) : static_cast<short>(-1);
      e.hi = static_cast<short>(p.hi);
      e.frac = p.frac;
      mine[axis * ns + s] = e;
      if (!p.in) continue;
      if (!any[axis]) first[axis] = p.lo;
      any[axis] = true;
      last[axis] = p.hi;
    }
  }
  ushort4 r;
  if (any[0] && any[1]) {
    r = make_ushort4(first[0], last[0], first[1], last[1]);
  } else {
    r = make_ushort4(1, 0, 1, 0);
  }
  r.x |= lvl << kLevelShift;
  rects[roi] = r;
}

// Whether the ring of an output size leaves room for the transposed copy
// of a channels-first hit (static tables and samples counted generously).
__host__ __device__ constexpr bool bwd_transposes(int out) {
  return kBwdStages * (out * out * 512 + 2 * kMaxSamples * 8) +
             out * out * (512 + 16) + 16 * 1024 <=
         kMaxSharedBytes;
}

// Dynamic shared memory: a ring of kBwdStages stages, each the upstream
// gradient of one hit for the block's channels (out*out bins x 512 bytes:
// [bin][channel] for channels-last input, [channel][bin] for
// channels-first) followed by that RoI's 2*out*ratio sample entries; then
// the transposed copy of a channels-first hit.
//
// blockIdx.x = (unit * B + image) * groups + group, the finest level's
// units first: its many tiles, a few of them crowded (padded RoI slots pile
// up on tile 0), then overlap the split units of the coarse levels, which
// are all about equally long.  Measured on the H100 at the training shape:
// coarsest first 0.475 ms, finest first 0.299 ms.
template <typename T, int OUT>
__global__ void __launch_bounds__(kBwdThreads, 2)
    roi_align_bwd_kernel(LevelTable grad_levels, TileTable tiles,
                         const SampleEntry* __restrict__ samples,
                         const ushort4* __restrict__ rects,
                         const T* __restrict__ grad_out,
                         float* __restrict__ partial, int batch,
                         int k_per_image, int channels, int ratio,
                         int channels_first) {
  constexpr int VEC = Vec<T>::n;
  constexpr int GROUP = 32 * VEC;  // channels a block covers: 512 bytes
  constexpr int BINS = OUT * OUT;
  constexpr int WARPS = kBwdThreads / 32;
  constexpr int SCAN = kHitChunk / kBwdThreads;  // rectangles a thread tests
  // Lanes that fold one (axis, cell): a power of two >= OUT, one a bin.
  constexpr int FOLD = OUT <= 8 ? 8 : OUT <= 16 ? 16 : 32;
  constexpr int LIST = (OUT + 2) & ~1;  // list length: even, >= OUT + 1
  // A channels-first hit transposed to [bin][channel], rows padded by 16
  // bytes: 16-byte reads of a lane's channels.  Where the ring and the
  // transposed copy together pass the shared memory of an SM (out 14), the
  // lanes read the staged [channel][bin] values one by one instead.
  constexpr int CONV_STRIDE = GROUP + 16 / static_cast<int>(sizeof(T));
  constexpr bool TRANSPOSE = bwd_transposes(OUT);
  static_assert(OUT <= 32 && 2 * kTile * FOLD <= kBwdThreads, "fold lanes");
  static_assert(WARPS == kTile, "one warp a tile row");
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ int hits[kHitChunk];
  __shared__ int warp_count[SCAN * WARPS];
  // Per hit parity, axis and tile cell: the bins whose weight on the cell
  // is not 0, compacted, padded with weight 0 on the first listed bin.
  __shared__ float list_w[2][2][kTile][LIST];
  __shared__ int list_bin[2][2][kTile][LIST];
  __shared__ int list_n[2][2][kTile];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ns = OUT * ratio;
  const int stage_bytes = BINS * 512 + 2 * ns * 8;
  T* const conv = reinterpret_cast<T*>(dyn_smem + kBwdStages * stage_bytes);
  auto stage_grad = [&](int h) {
    return reinterpret_cast<T*>(dyn_smem + (h % kBwdStages) * stage_bytes);
  };
  auto stage_samples = [&](int h) {
    return reinterpret_cast<SampleEntry*>(
        dyn_smem + (h % kBwdStages) * stage_bytes + BINS * 512);
  };

  const int groups = (channels + GROUP - 1) / GROUP;
  const int group0 = (blockIdx.x % groups) * GROUP;
  const int b = (blockIdx.x / groups) % batch;
  const int unit = blockIdx.x / groups / batch;
  int lvl = 0;
  while (lvl + 1 < tiles.n_levels && unit >= tiles.unit_start[lvl + 1])
    ++lvl;
  const int split = tiles.split[lvl];
  const int tile = (unit - tiles.unit_start[lvl]) / split;
  const int part = (unit - tiles.unit_start[lvl]) % split;
  const int y0 = (tile / tiles.tiles_x[lvl]) * kTile;
  const int x0 = (tile % tiles.tiles_x[lvl]) * kTile;
  const int height = grad_levels.height[lvl];
  const int width = grad_levels.width[lvl];
  const int n_ch = min(GROUP, channels - group0);

  // Warp -> tile row; lane -> 16 bytes of channels.  A warp's lanes share
  // their cell, so the loops over a cell's bins do not diverge.
  const int cy = warp;
  const bool active = lane * VEC < n_ch;

  float acc[kTile][VEC];
#pragma unroll
  for (int cx = 0; cx < kTile; ++cx)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[cx][v] = 0.0f;

  auto fetch_samples = [&](int h) {
    const SampleEntry* src =
        samples + static_cast<size_t>(b * k_per_image + hits[h]) * 2 * ns;
    SampleEntry* dst = stage_samples(h);
    for (int u = tid; u < ns; u += kBwdThreads)  // 16 bytes: two entries
      cp_async16(dst + 2 * u, src + 2 * u);
  };
  // Group h of the ring: hit h's gradient and hit h+1's samples, so that
  // hit h+1's weights are folded while hit h is gathered.
  auto fetch_hit = [&](int h, int n_hits) {
    if (h < n_hits) {
      const int roi = b * k_per_image + hits[h];
      T* dst = stage_grad(h);
      if (channels_first) {
        // One contiguous run: n_ch channels x BINS values.
        const T* src =
            grad_out + (static_cast<size_t>(roi) * channels + group0) * BINS;
        const int pieces = n_ch * BINS / VEC;
        for (int u = tid; u < pieces; u += kBwdThreads)
          cp_async16(dst + u * VEC, src + u * VEC);
      } else {
        const T* src =
            grad_out + static_cast<size_t>(roi) * BINS * channels + group0;
        for (int u = tid; u < BINS * 32; u += kBwdThreads) {
          const int p = u >> 5, l = u & 31;
          if (l * VEC < n_ch)
            cp_async16(dst + p * GROUP + l * VEC,
                       src + static_cast<size_t>(p) * channels + l * VEC);
        }
      }
      if (h + 1 < n_hits) fetch_samples(h + 1);
    }
    cp_async_commit();  // one group a hit, empty or not
  };
  // Per-axis bin lists of the tile's rows and columns for hit h, from its
  // staged samples.  FOLD lanes share one (axis, cell); lane `bin` sums the
  // bilinear weights of its bin's samples that land on the cell, and a
  // ballot compacts the bins whose weight is not 0.
  auto fold_weights = [&](int h) {
    if (tid < 2 * kTile * FOLD) {
      const int axis = tid / (kTile * FOLD);
      const int ci = (tid / FOLD) % kTile;
      const int bin = tid % FOLD;
      const int cell = (axis ? x0 : y0) + ci;
      float w = 0.0f;
      if (bin < OUT) {
        const SampleEntry* e = stage_samples(h) + axis * ns + bin * ratio;
        for (int i = 0; i < ratio; ++i) {
          const SampleEntry s = e[i];
          if (s.lo < 0) continue;
          if (s.lo == cell) w += 1.0f - s.frac;
          if (s.hi == cell) w += s.frac;
        }
      }
      const unsigned all = __ballot_sync(0xffffffffu, w != 0.0f);
      const unsigned mine = (all >> (lane & ~(FOLD - 1))) &
                            (FOLD == 32 ? 0xffffffffu : (1u << FOLD) - 1u);
      const int n = __popc(mine);
      float* lw = list_w[h & 1][axis][ci];
      int* lb = list_bin[h & 1][axis][ci];
      if (w != 0.0f) {
        const int at = __popc(mine & ((1u << bin) - 1u));
        lw[at] = w;
        lb[at] = bin;
      }
      if (bin == 0) {
        list_n[h & 1][axis][ci] = n;
        const int first = n ? __ffs(mine) - 1 : 0;
        lw[n] = 0.0f;
        lb[n] = first;
        if (n + 1 < LIST) {
          lw[n + 1] = 0.0f;
          lb[n + 1] = first;
        }
      }
    }
  };
  // A channels-first hit, staged [channel][bin], to [bin][channel]: an
  // item is one bin of VEC channels, gathered value by value (a warp's
  // lanes read neighbouring bins) and stored as 16 bytes.
  auto transpose = [&](int h) {
    const T* g = stage_grad(h);
    const int vecs = n_ch / VEC;
    for (int u = tid; u < vecs * BINS; u += kBwdThreads) {
      const int cv = u / BINS, p = u % BINS;
      T tmp[VEC];
#pragma unroll
      for (int v = 0; v < VEC; ++v) tmp[v] = g[(cv * VEC + v) * BINS + p];
      uint4 packed;
      memcpy(&packed, tmp, sizeof(packed));
      *reinterpret_cast<uint4*>(conv + p * CONV_STRIDE + cv * VEC) = packed;
    }
  };

  for (int base = 0; base < k_per_image; base += kHitChunk) {
    const int chunk_n = min(kHitChunk, k_per_image - base);
    // Compact this chunk's hits in a fixed order (test, warp, lane).  The
    // SCAN loads of a thread are independent: one memory latency a chunk.
    ushort4 r[SCAN];
#pragma unroll
    for (int u = 0; u < SCAN; ++u) {
      const int j = u * kBwdThreads + tid;
      r[u] = j < chunk_n ? rects[b * k_per_image + base + j]
                         : make_ushort4(1, 0, 1, 0);
    }
    unsigned ballot[SCAN];
    bool hit[SCAN];
#pragma unroll
    for (int u = 0; u < SCAN; ++u) {
      const int ry0 = r[u].x & kMaxSide;
      hit[u] = (u * kBwdThreads + tid) % split == part &&
               (r[u].x >> kLevelShift) == lvl && ry0 <= r[u].y &&
               ry0 < y0 + kTile && static_cast<int>(r[u].y) >= y0 &&
               static_cast<int>(r[u].z) < x0 + kTile &&
               static_cast<int>(r[u].w) >= x0;
      ballot[u] = __ballot_sync(0xffffffffu, hit[u]);
      if (lane == 0) warp_count[u * WARPS + warp] = __popc(ballot[u]);
    }
    __syncthreads();
    int n_hits = 0;
    int before[SCAN];
#pragma unroll
    for (int e = 0; e < SCAN * WARPS; ++e) {
      if (e % WARPS == warp) before[e / WARPS] = n_hits;  // e / WARPS static
      n_hits += warp_count[e];
    }
#pragma unroll
    for (int u = 0; u < SCAN; ++u)
      if (hit[u])
        hits[before[u] + __popc(ballot[u] & ((1u << lane) - 1u))] =
            base + u * kBwdThreads + tid;
    __syncthreads();
    if (n_hits == 0) continue;

    fetch_samples(0);
    cp_async_commit();
#pragma unroll
    for (int h = 0; h < kBwdStages - 1; ++h) fetch_hit(h, n_hits);
    cp_async_wait<kBwdStages - 1>();  // hit 0's samples
    __syncthreads();
    fold_weights(0);
    for (int h = 0; h < n_hits; ++h) {
      cp_async_wait<kBwdStages - 2>();
      __syncthreads();  // group h has landed for everyone; hit h-1 is done
      fetch_hit(h + kBwdStages - 1, n_hits);
      if (h + 1 < n_hits) fold_weights(h + 1);
      if (TRANSPOSE && channels_first) {
        transpose(h);
        __syncthreads();
      }
      const int ny = list_n[h & 1][0][cy];
      if (!active || ny == 0) continue;
      const float* wy = list_w[h & 1][0][cy];
      const int* by = list_bin[h & 1][0][cy];
      const bool strided = channels_first && !TRANSPOSE;
      const T* g = strided          ? stage_grad(h) + lane * VEC * BINS
                   : channels_first ? conv + lane * VEC
                                    : stage_grad(h) + lane * VEC;
      const int stride = channels_first ? CONV_STRIDE : GROUP;
      auto add = [&](float (&sum)[VEC], float w, int bin) {
        float gv[VEC];
        if (strided) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) gv[v] = to_float(g[v * BINS + bin]);
        } else {
          load_vec(g + bin * stride, gv);
        }
#pragma unroll
        for (int v = 0; v < VEC; ++v) sum[v] += w * gv[v];
      };
      // Bins two by two along each axis: four independent loads a step;
      // the padding entries carry weight 0.
#pragma unroll
      for (int cx = 0; cx < kTile; ++cx) {
        const int nx = list_n[h & 1][1][cx];
        const float* wx = list_w[h & 1][1][cx];
        const int* bx = list_bin[h & 1][1][cx];
        for (int i = 0; i < ny; i += 2) {
          const float a0 = wy[i], a1 = wy[i + 1];
          const int p0 = by[i] * OUT, p1 = by[i + 1] * OUT;
          for (int j = 0; j < nx; j += 2) {
            const float d0 = wx[j], d1 = wx[j + 1];
            const int q0 = bx[j], q1 = bx[j + 1];
            add(acc[cx], a0 * d0, p0 + q0);
            add(acc[cx], a0 * d1, p0 + q1);
            add(acc[cx], a1 * d0, p1 + q0);
            add(acc[cx], a1 * d1, p1 + q1);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the hit list and the ring are free for the next chunk
  }

  if (!active) return;
  if (split > 1) {
    // This unit's share of the tile, float32, for roi_align_bwd_sum_kernel.
    float* dst = partial +
                 ((static_cast<size_t>(b) * tiles.partial_tiles +
                   tiles.partial_start[lvl] + tile * split + part) *
                      (kTile * kTile) +
                  cy * kTile) *
                     channels +
                 group0 + lane * VEC;
#pragma unroll
    for (int cx = 0; cx < kTile; ++cx) {
#pragma unroll
      for (int v4 = 0; v4 < VEC; v4 += 4)
        *reinterpret_cast<float4*>(dst + static_cast<size_t>(cx) * channels +
                                   v4) =
            make_float4(acc[cx][v4], acc[cx][v4 + 1], acc[cx][v4 + 2],
                        acc[cx][v4 + 3]);
    }
    return;
  }
  const int y = y0 + cy;
  if (y >= height) return;
  const float count = static_cast<float>(ratio * ratio);
  T* dst = static_cast<T*>(const_cast<void*>(grad_levels.data[lvl])) +
           ((static_cast<size_t>(b) * height + y) * width + x0) * channels +
           group0 + lane * VEC;
#pragma unroll
  for (int cx = 0; cx < kTile; ++cx) {
    if (x0 + cx >= width) break;
    float v_out[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) v_out[v] = acc[cx][v] / count;
    store_vec(dst + static_cast<size_t>(cx) * channels, v_out);
  }
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                 *reinterpret_cast<const unsigned*>(&hi));
}

// Second pass over the levels whose tiles were split: one block a (tile,
// image) sums the tile's float32 partials in unit order, divides by the
// samples a bin and writes the level type.  blockIdx.x counts those tiles
// level after level; blockIdx.y is the image, blockIdx.z a quarter of the
// tile's cells.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    roi_align_bwd_sum_kernel(LevelTable grad_levels, TileTable tiles,
                             const float* __restrict__ partial, int channels,
                             int ratio) {
  int lvl = 0, first = 0;  // first: split tiles of the levels before lvl
  for (;; ++lvl) {
    const int n = tiles.split[lvl] > 1
                      ? (tiles.unit_start[lvl + 1] - tiles.unit_start[lvl]) /
                            tiles.split[lvl]
                      : 0;
    if (static_cast<int>(blockIdx.x) < first + n) break;
    first += n;
  }
  const int split = tiles.split[lvl];
  const int tile = blockIdx.x - first;
  const int b = blockIdx.y;
  const int y0 = (tile / tiles.tiles_x[lvl]) * kTile;
  const int x0 = (tile % tiles.tiles_x[lvl]) * kTile;
  const int height = grad_levels.height[lvl];
  const int width = grad_levels.width[lvl];
  const float count = static_cast<float>(ratio * ratio);
  const size_t cell_floats = static_cast<size_t>(kTile * kTile) * channels;
  const float* src = partial + (static_cast<size_t>(b) * tiles.partial_tiles +
                                tiles.partial_start[lvl] + tile * split) *
                                   cell_floats;
  T* dst = static_cast<T*>(const_cast<void*>(grad_levels.data[lvl])) +
           static_cast<size_t>(b) * height * width * channels;
  const int vecs = channels / 4;
  constexpr int kCells = kTile * kTile / kSumParts;  // cells a block sums
  for (int e = threadIdx.x; e < kCells * vecs; e += kBwdThreads) {
    const int cell = blockIdx.z * kCells + e / vecs, c = (e % vecs) * 4;
    const int y = y0 + cell / kTile, x = x0 + cell % kTile;
    if (y >= height || x >= width) continue;
    // All loads first (split <= kMaxSplit), then the sum in unit order.
    float4 v[kMaxSplit];
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s)
      if (s < split)
        v[s] = *reinterpret_cast<const float4*>(
            src + s * cell_floats + static_cast<size_t>(cell) * channels + c);
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s)
      if (s < split) {
        sum.x += v[s].x; sum.y += v[s].y; sum.z += v[s].z; sum.w += v[s].w;
      }
    sum.x = sum.x / count; sum.y = sum.y / count;
    sum.z = sum.z / count; sum.w = sum.w / count;
    store4(dst + (static_cast<size_t>(y) * width + x) * channels + c, sum);
  }
}

// Tiles, splits and partial-sum layout of the backward pass for these
// levels.  A level with fewer than kSplitTarget tiles an image splits each
// tile's RoIs over up to kMaxSplit units: its tiles meet the most RoIs,
// and one block a tile would leave the card waiting on a few long blocks.
int plan_tiles(const LevelTable& table, int n_levels, TileTable* tiles) {
  tiles->n_levels = n_levels;
  tiles->unit_start[0] = 0;
  tiles->partial_tiles = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (table.height[l] <= 0 || table.width[l] <= 0 ||
        table.height[l] > kMaxSide || table.width[l] > kMaxSide)
      return kBadLevels;
    tiles->tiles_x[l] = (table.width[l] + kTile - 1) / kTile;
    const int n = tiles->tiles_x[l] * ((table.height[l] + kTile - 1) / kTile);
    int split = kSplitTarget / n;
    split = split < 1 ? 1 : split > kMaxSplit ? kMaxSplit : split;
    tiles->split[l] = split;
    tiles->unit_start[l + 1] = tiles->unit_start[l] + n * split;
    tiles->partial_start[l] = tiles->partial_tiles;
    if (split > 1) tiles->partial_tiles += n * split;
  }
  return 0;
}

template <typename T, int OUT>
int launch_bwd(const LevelTable& table, const TileTable& tiles, int batch,
               const SampleEntry* samples, const ushort4* rects,
               const void* grad_out, float* partial, int k_per_image,
               int channels, int ratio, int channels_first,
               cudaStream_t stream) {
  constexpr int group = 32 * Vec<T>::n;
  // The ring, and the transposed copy of a channels-first hit.
  size_t bytes =
      static_cast<size_t>(kBwdStages) * (OUT * OUT * 512 + 2 * OUT * ratio * 8) +
      (channels_first && bwd_transposes(OUT)
           ? static_cast<size_t>(OUT) * OUT * (512 + 16)
           : 0);
  auto kernel = roi_align_bwd_kernel<T, OUT>;
  static size_t allowed = 0;
  if (int status = allow_shared(kernel, bytes, &allowed)) return status;
  const long long blocks = static_cast<long long>(
                               tiles.unit_start[tiles.n_levels]) *
                           batch * ((channels + group - 1) / group);
  if (blocks > 0x7fffffffLL || batch > 65535) return kBadLevels;
  kernel<<<static_cast<unsigned>(blocks), kBwdThreads, bytes, stream>>>(
      table, tiles, samples, rects, static_cast<const T*>(grad_out), partial,
      batch, k_per_image, channels, ratio, channels_first);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
  int split_tiles = 0;
  for (int l = 0; l < tiles.n_levels; ++l)
    if (tiles.split[l] > 1)
      split_tiles += (tiles.unit_start[l + 1] - tiles.unit_start[l]) /
                     tiles.split[l];
  if (split_tiles > 0)
    roi_align_bwd_sum_kernel<T>
        <<<dim3(split_tiles, batch, kSumParts), kBwdThreads, 0, stream>>>(
            table, tiles, partial, channels, ratio);
  return static_cast<int>(cudaGetLastError());
}

// Scratch layout: float32 partial tiles, then the sample entries, then the
// rectangles; every part a multiple of 16 bytes but the last.
size_t partial_bytes(const TileTable& tiles, int batch, int channels) {
  return static_cast<size_t>(batch) * tiles.partial_tiles * kTile * kTile *
         channels * sizeof(float);
}

}  // namespace

// Bytes of scratch podtpu_roi_align_bwd needs for these levels (a host
// pointer to a LevelTable, as passed there); negative: a Refusal.
extern "C" long long podtpu_roi_align_bwd_scratch_bytes(
    const void* grad_levels, int n_levels, int rois, int k_per_image,
    int channels, int out_size, int ratio) {
  if (n_levels < 1 || n_levels > kMaxLevels) return kBadLevels;
  if (rois <= 0 || k_per_image <= 0 || rois % k_per_image != 0)
    return kBadSizes;
  TileTable tiles;
  if (int status = plan_tiles(*static_cast<const LevelTable*>(grad_levels),
                              n_levels, &tiles))
    return status;
  return static_cast<long long>(
      partial_bytes(tiles, rois / k_per_image, channels) +
      static_cast<size_t>(rois) * (2 * out_size * ratio * 8 + 8));
}

// grad_levels: host pointer to a LevelTable of n_levels gradient buffers
// [B, H, W, C] of type dtype, uninitialised: every cell is written once.
// boxes [R, 4] float32; level_idx [R] int32; scratch: 16-byte aligned,
// podtpu_roi_align_bwd_scratch_bytes long, uninitialised; grad_out [R, out,
// out, C] or, with channels_first, [R, C, out, out], of type dtype (0
// float32, 1 bfloat16).  Returns 0, a cudaError_t, or a negative Refusal.
extern "C" int podtpu_roi_align_bwd(const void* grad_levels, int n_levels,
                                    const void* boxes, const void* level_idx,
                                    void* scratch, const void* grad_out,
                                    int rois, int k_per_image, int channels,
                                    int out_size, int ratio, int dtype,
                                    int channels_first, void* stream) {
  if (rois <= 0 || channels <= 0) return kBadSizes;
  if (int status =
          check_common(rois, k_per_image, channels, out_size, ratio, dtype))
    return status;
  const int batch = rois / k_per_image;
  if (n_levels < 1 || n_levels > kMaxLevels) return kBadLevels;
  const LevelTable table = *static_cast<const LevelTable*>(grad_levels);
  TileTable tiles;
  if (int status = plan_tiles(table, n_levels, &tiles)) return status;
  for (int l = 0; l < n_levels; ++l)
    if (!aligned16(table.data[l])) return kBadAlignment;
  if (!aligned16(grad_out) || !aligned16(scratch)) return kBadAlignment;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* partial = static_cast<float*>(scratch);
  SampleEntry* samples = reinterpret_cast<SampleEntry*>(
      static_cast<unsigned char*>(scratch) +
      partial_bytes(tiles, batch, channels));
  ushort4* rects = reinterpret_cast<ushort4*>(
      samples + static_cast<size_t>(rois) * 2 * out_size * ratio);
  roi_prepare_kernel<<<(rois + 127) / 128, 128, 0, st>>>(
      table, static_cast<const float*>(boxes),
      static_cast<const int*>(level_idx), samples, rects, rois, out_size,
      ratio);
  if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
#define PODTPU_BWD(T, OUT)                                                   \
  return launch_bwd<T, OUT>(table, tiles, batch, samples, rects, grad_out,   \
                            partial, k_per_image, channels, ratio,           \
                            channels_first, st)
  if (dtype == 1) {
    if (out_size == 7) PODTPU_BWD(__nv_bfloat16, 7);
    PODTPU_BWD(__nv_bfloat16, 14);
  }
  if (out_size == 7) PODTPU_BWD(float, 7);
  PODTPU_BWD(float, 14);
#undef PODTPU_BWD
}

#endif  // PODTPU_ROI_ALIGN_BWD
