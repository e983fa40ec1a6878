// Greedy NMS keep mask over score-sorted boxes, many segments per launch.
//
// Replaces: the Pallas TPU kernel podtpu/ops/pallas/nms_kernel.py::_nms_kernel
// (entry nms_fixpoint_pallas, dispatched by podtpu/ops/nms.py:66-77).  Same
// function: for each segment s and each sorted index i,
//   keep[s, i] = valid[s, i] and no j < i has keep[s, j] and IoU(j, i) > t,
// where invalid boxes are neither kept nor suppress.  The TPU limits (the
// 128-box tile, the 8192-box cap, the 256 <= n dispatch window) do not apply.
//
// Bound on the H100: the work is tiny in bytes (S*N*(16+1+1) bytes: boxes,
// valid flags, keep flags) and in operations (13 float32 operations per IoU,
// over the pairs (kept j, later valid i) that greedy NMS must look at).  At
// the serving shapes (S=20 or 12 segments of N=1000) both bounds are a few
// microseconds; what limits this kernel is the greedy recurrence itself, a
// chain of N dependent decisions per segment.
//
// Design:
//   pass 1 (nms_mask_kernel): one 64-thread block per (segment, 64-row tile,
//     64-column tile at or right of the diagonal).  Thread i writes the 64-bit
//     word mask[s, i, tile] whose bit j is set when j > i, both boxes are
//     valid and IoU > t.  All pairs of a segment are computed in parallel.
//   pass 2 (nms_scan_kernel): one warp per segment walks the rows in order.
//     For each 64-row word it loads the rows' validity bits and diagonal mask
//     words in one parallel step, resolves the 64 decisions in registers
//     (a shuffle per row, no memory on the dependent chain), then ORs the
//     kept rows' masks into a `removed` bitset in shared memory (N/64 words).
// The IoU is computed with explicitly rounded float32 operations in the order
// of the plain version (podtpu_torch/ops/nms.py::nms_keep_plain), so nvcc
// cannot contract a multiply and an add into one FMA, and the division is
// IEEE: the keep masks are equal bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ float box_area(const float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__device__ __forceinline__ float box_iou(const float4 a, float area_a,
                                         const float4 b, float area_b) {
  const float ix = __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x));
  const float iy = __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y));
  const float inter = __fmul_rn(fmaxf(ix, 0.0f), fmaxf(iy, 0.0f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
}

__global__ void nms_mask_kernel(const float4* __restrict__ boxes,
                                const uint8_t* __restrict__ valid,
                                unsigned long long* __restrict__ mask,
                                int n, int col_blocks, float threshold) {
  const int row_block = blockIdx.y;
  const int col_block = blockIdx.x;
  if (col_block < row_block) return;  // below the diagonal: never read
  const int s = blockIdx.z;
  const int row_start = row_block * kTile;
  const int col_start = col_block * kTile;
  const int rows = min(n - row_start, kTile);
  const int cols = min(n - col_start, kTile);
  const float4* sb = boxes + static_cast<size_t>(s) * n;
  const uint8_t* sv = valid + static_cast<size_t>(s) * n;

  __shared__ float4 cbox[kTile];
  __shared__ float carea[kTile];
  __shared__ bool cvalid[kTile];
  if (threadIdx.x < cols) {
    const float4 b = sb[col_start + threadIdx.x];
    cbox[threadIdx.x] = b;
    carea[threadIdx.x] = box_area(b);
    cvalid[threadIdx.x] = sv[col_start + threadIdx.x] != 0;
  }
  __syncthreads();
  if (threadIdx.x >= rows) return;

  const int i = row_start + threadIdx.x;
  unsigned long long bits = 0;
  if (sv[i]) {
    const float4 b = sb[i];
    const float area = box_area(b);
    const int start = col_block == row_block ? threadIdx.x + 1 : 0;
    for (int j = start; j < cols; ++j) {
      if (cvalid[j] && box_iou(b, area, cbox[j], carea[j]) > threshold) {
        bits |= 1ull << j;
      }
    }
  }
  mask[(static_cast<size_t>(s) * n + i) * col_blocks + col_block] = bits;
}

__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const uint8_t* __restrict__ valid,
                                uint8_t* __restrict__ keep, int n,
                                int col_blocks) {
  extern __shared__ unsigned long long removed[];
  const int s = blockIdx.x;
  const int lane = threadIdx.x;
  const unsigned long long* smask =
      mask + static_cast<size_t>(s) * n * col_blocks;
  const uint8_t* sv = valid + static_cast<size_t>(s) * n;
  uint8_t* sk = keep + static_cast<size_t>(s) * n;

  for (int c = lane; c < col_blocks; c += 32) removed[c] = 0;
  __syncwarp();

  for (int w = 0; w < col_blocks; ++w) {
    const int base = w * kTile;
    const int r0 = base + lane;
    const int r1 = base + 32 + lane;
    const bool v0 = r0 < n && sv[r0];
    const bool v1 = r1 < n && sv[r1];
    const unsigned long long d0 =
        r0 < n ? smask[static_cast<size_t>(r0) * col_blocks + w] : 0ull;
    const unsigned long long d1 =
        r1 < n ? smask[static_cast<size_t>(r1) * col_blocks + w] : 0ull;
    const unsigned long long vbits =
        static_cast<unsigned long long>(__ballot_sync(kFullWarp, v0)) |
        (static_cast<unsigned long long>(__ballot_sync(kFullWarp, v1)) << 32);

    // Resolve the 64 rows of this word in order; every lane holds the same
    // `cur` and `kept`, so the branch is uniform.
    unsigned long long cur = removed[w];
    unsigned long long kept = 0;
    const int rows = min(kTile, n - base);
    for (int b = 0; b < rows; ++b) {
      const unsigned long long diag =
          __shfl_sync(kFullWarp, b < 32 ? d0 : d1, b & 31);
      if (((vbits >> b) & 1ull) && !((cur >> b) & 1ull)) {
        kept |= 1ull << b;
        cur |= diag;
      }
    }
    if (r0 < n) sk[r0] = static_cast<uint8_t>((kept >> lane) & 1ull);
    if (r1 < n) sk[r1] = static_cast<uint8_t>((kept >> (32 + lane)) & 1ull);

    // Suppress later words with the rows kept in this one.
    for (int c = w + 1 + lane; c < col_blocks; c += 32) {
      unsigned long long acc = removed[c];
      unsigned long long kb = kept;
      while (kb) {
        const int b = __ffsll(static_cast<long long>(kb)) - 1;
        kb &= kb - 1;
        acc |= smask[static_cast<size_t>(base + b) * col_blocks + c];
      }
      removed[c] = acc;
    }
    __syncwarp();
  }
}

}  // namespace

// boxes [S, N, 4] float32 (16-byte aligned), valid [S, N] uint8, mask scratch
// [S, N, ceil(N/64)] uint64, keep [S, N] uint8 (out).  Returns a cudaError_t.
extern "C" int podtpu_nms_keep(const void* boxes, const void* valid,
                               void* mask, void* keep, int segments, int n,
                               float threshold, void* stream) {
  if (segments <= 0 || n <= 0) return 0;
  const int col_blocks = (n + kTile - 1) / kTile;
  const size_t scan_smem = static_cast<size_t>(col_blocks) * 8;
  if (scan_smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(col_blocks, col_blocks, segments);
  nms_mask_kernel<<<grid, kTile, 0, st>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<unsigned long long*>(mask), n, col_blocks, threshold);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan_kernel<<<segments, 32, scan_smem, st>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), n,
      col_blocks);
  return static_cast<int>(cudaGetLastError());
}

// Shared by every entry point of the library.
extern "C" const char* podtpu_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
