// Greedy NMS keep mask, many segments per launch, sorted in the kernel.
//
// Replaces: the Pallas TPU kernel podtpu/ops/pallas/nms_kernel.py::_nms_kernel
// (entry nms_fixpoint_pallas, dispatched by podtpu/ops/nms.py:66-77).  Same
// function: for each segment s and each index i in score order,
//   keep[s, i] = valid[s, i] and no j < i has keep[s, j] and IoU(j, i) > t,
// where invalid boxes are neither kept nor suppress.  The TPU limits (the
// 128-box tile, the 8192-box cap, the 256 <= n dispatch window) do not apply;
// this design holds N <= kMaxColBlocks * 64 boxes a segment.
//
// Score order: box i of a segment in score order is boxes[s, order[s, i]],
// with validity valid[s, order[s, i]], and its flag is written to
// keep[s, order[s, i]].  Without `order` the boxes are in score order
// already.  `order` must hold a permutation of 0..N-1 in each segment, so
// every slot of `keep` is written once.
//
// Bound on the H100: the work is tiny in bytes (S*N*(16+1+1) bytes: boxes,
// valid flags, keep flags) and in operations (13 float32 operations per IoU,
// over the pairs (kept j, later valid i) that greedy NMS must look at).  At
// the serving shapes both bounds are a few microseconds.  What limits this
// kernel is the recurrence itself: ceil(N/64) dependent word steps per
// segment, each at least a shared-memory round trip and a barrier.
//
// Design.  Boxes go in words of 64 in score order; a segment's scratch holds
// the suppression mask tile by tile (tile (w, c), c >= w, holds for each row
// i of word w the 64-bit word whose bit j is set when box 64c+j comes after
// box i and IoU > t), the in-word column of every row (bit j set when box j
// of the row's own word comes before it and IoU > t) and the validity bits
// of every word.
//   pass 1 (nms_mask_kernel): the 64x64 tiles at or right of the diagonal,
//     numbered row by row, four to a block of 256 threads (no block of the
//     grid lies below the diagonal).  A block stages its column boxes and
//     their areas in shared memory; thread i computes row i's IoUs against
//     them, with no division where the IoU is far from the threshold.  A
//     diagonal tile also writes the in-word columns (IoU is symmetric) and
//     the word's validity bits.  A row whose box is invalid is never kept,
//     so the scan never reads its words: its IoUs are skipped and its words
//     written as zeros.  Column validity is not looked at: a bit on an
//     invalid column only removes a box that is not kept anyway.
//   pass 2 (nms_scan_kernel): one block of 256 threads per segment and a
//     ring of 3 to 6 shared-memory buffers, each holding one word's tiles
//     right of the diagonal (one contiguous run), in-word columns and keep
//     slots, which warps 1-7 copy in with 16-byte cp.async up to four words
//     ahead.  Warp 0 resolves word w: each lane holds the in-word columns of
//     two rows, and keep <- candidates & ~(rows whose column meets keep),
//     one ballot per half word, repeats until it stands still (the longest
//     suppression chain inside the word, plus one, at most 65 rounds).  It
//     ORs the kept rows' words of column w+1 across the warp (the only
//     column the next word waits for), writes the keep flags and the kept
//     word.  Meanwhile warps 1-7 fold the previous word's kept rows into the
//     columns after w, a warp a column, lanes over rows, one OR across the
//     warp.  One barrier per word; no device-memory load on the chain.
// The IoU is computed with explicitly rounded float32 operations in the order
// of the plain version (podtpu_torch/ops/nms.py::nms_keep_plain), so nvcc
// cannot contract a multiply and an add into one FMA, and the division is
// IEEE: the keep masks are equal bit for bit.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kMaskThreads = 256;                 // four tiles a block
constexpr int kTilesPerBlock = kMaskThreads / kTile;
constexpr int kScanThreads = 256;
constexpr int kFoldWarps = kScanThreads / 32 - 1;  // warps 1..7
constexpr int kMaxColBlocks = 144;                // N <= 9216
constexpr unsigned kFullWarp = 0xffffffffu;
using u64 = unsigned long long;

__device__ __forceinline__ float box_area(const float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IoU(a, b) > t, where IoU is RN(inter / uni) with the plain version's
// rounding (0 where the union is empty).  With `fast` (t in [2^-100,
// 2^100)) the division is skipped far from the threshold: with
// s = RN(t * uni), inter > RN(s * (1 + 2^-19)) puts inter / uni above t by
// more than 4 ulp of t, so its rounding is above t too, and
// inter < RN(s * (1 - 2^-19)) puts it below t.  Each rounding errs by at
// most 2^-24 relative while s lies in [2^-100, 2^100); otherwise, and near
// the threshold, the IEEE division decides.  IoU(a, b) == IoU(b, a): every
// operation below is symmetric in a and b.
__device__ __forceinline__ bool iou_above(const float4 a, float area_a,
                                          const float4 b, float area_b,
                                          float t, bool fast) {
  const float ix = __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x));
  const float iy = __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y));
  const float inter = __fmul_rn(fmaxf(ix, 0.0f), fmaxf(iy, 0.0f));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  if (fast) {
    const float scaled = __fmul_rn(t, uni);
    const bool above = inter > __fmul_rn(scaled, 1.0f + 0x1p-19f);
    const bool below = inter < __fmul_rn(scaled, 1.0f - 0x1p-19f);
    if ((above || below) && scaled >= 0x1p-100f && scaled < 0x1p100f) {
      return above;
    }
  }
  return (uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f) > t;
}

// Slot of score-order index i of segment s.
__device__ __forceinline__ int64_t slot(const int64_t* __restrict__ order,
                                        int s, int n, int i) {
  const int64_t at = static_cast<int64_t>(s) * n + i;
  return order ? static_cast<int64_t>(s) * n + order[at] : at;
}

// Where each part of a segment's scratch starts, in 64-bit words.  Every
// part starts 16-byte aligned.
struct Scratch {
  long long colm;     // in-word columns, one word per row
  long long vbits;    // validity bits, one word per 64 rows
  long long words;    // the segment's whole scratch
};

__host__ __device__ __forceinline__ Scratch scratch_layout(int n) {
  const long long col_blocks = (n + kTile - 1) / kTile;
  Scratch sc;
  sc.colm = col_blocks * col_blocks * kTile;   // the mask, tile by tile
  sc.vbits = sc.colm + col_blocks * kTile;
  sc.words = (sc.vbits + col_blocks + 1) / 2 * 2;
  return sc;
}

// Pairs (row tile, column tile >= row tile) before row tile r.
__device__ __forceinline__ int pairs_before(int r, int col_blocks) {
  return r * col_blocks - r * (r - 1) / 2;
}

__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float4* __restrict__ boxes,
                const uint8_t* __restrict__ valid,
                const int64_t* __restrict__ order, u64* __restrict__ scratch,
                int n, int col_blocks, int pairs, Scratch sc,
                float threshold) {
  __shared__ float4 cbox[kTilesPerBlock][kTile];
  __shared__ float carea[kTilesPerBlock][kTile];
  const int s = blockIdx.y;
  const int t = threadIdx.x / kTile;
  const int lane = threadIdx.x % kTile;
  const int p = blockIdx.x * kTilesPerBlock + t;
  const bool active = p < pairs;
  int row_block = 0, col_block = 0;
  if (active) {
    // Invert pairs_before: the row tile r with
    // pairs_before(r) <= p < pairs_before(r + 1).
    const float b2 = 2.0f * col_blocks + 1.0f;
    int r = static_cast<int>((b2 - sqrtf(b2 * b2 - 8.0f * p)) * 0.5f);
    r = max(0, min(r, col_blocks - 1));
    while (r > 0 && pairs_before(r, col_blocks) > p) --r;
    while (r + 1 < col_blocks && pairs_before(r + 1, col_blocks) <= p) ++r;
    row_block = r;
    col_block = r + p - pairs_before(r, col_blocks);
    const int j = col_block * kTile + lane;
    if (j < n) {
      const float4 b = boxes[slot(order, s, n, j)];
      cbox[t][lane] = b;
      carea[t][lane] = box_area(b);
    }
  }
  __syncthreads();
  const int i = row_block * kTile + lane;
  const bool row_ok = active && i < n;
  const int64_t at = row_ok ? slot(order, s, n, i) : 0;
  const bool v = row_ok && valid[at];
  u64* seg = scratch + s * sc.words;
  // Both warps of a tile agree on `diag`.
  const bool diag = active && col_block == row_block;
  if (diag) {
    const unsigned vb = __ballot_sync(kFullWarp, v);
    if (lane % 32 == 0) {
      reinterpret_cast<unsigned*>(seg + sc.vbits)[2 * row_block + lane / 32] =
          vb;
    }
  }
  if (!row_ok) return;
  const int cols = min(n - col_block * kTile, kTile);
  u64 bits = 0;
  if (v) {
    const float4 b = boxes[at];
    const float area = box_area(b);
    const bool fast = threshold >= 0x1p-100f && threshold < 0x1p100f;
    if (cols == kTile) {
#pragma unroll 16
      for (int j = 0; j < kTile; ++j) {
        bits |= static_cast<u64>(iou_above(b, area, cbox[t][j], carea[t][j],
                                           threshold, fast)) << j;
      }
    } else {
      for (int j = 0; j < cols; ++j) {
        bits |= static_cast<u64>(iou_above(b, area, cbox[t][j], carea[t][j],
                                           threshold, fast)) << j;
      }
    }
    if (diag) bits &= ~(1ull << lane);   // the box itself
  }
  if (diag) {
    seg[sc.colm + i] = bits & ((1ull << lane) - 1);    // earlier boxes
    bits &= ~((2ull << lane) - 1);                      // later boxes
  }
  seg[(static_cast<long long>(row_block) * col_blocks + col_block) * kTile +
      lane] = bits;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* global) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(global)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* global) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(global)
               : "memory");
}

// Wait until at most `pending` of this thread's newest copy groups are in
// flight (the instruction takes a constant).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Words of one scan buffer: a word's stripe (column by column, a word a
// row), then per row its in-word column and its keep slot.
__host__ __device__ __forceinline__ int buffer_words(int col_blocks) {
  return kTile * col_blocks + 2 * kTile;
}

// Scan buffers a block takes: the previous word's (being folded), the
// current word's and up to four words in flight, as many as fit.
constexpr int kMaxBuffers = 6;
constexpr size_t kSmemLimit = 227 * 1024;
constexpr int kMaxDevices = 64;

int scan_buffers(int col_blocks) {
  const size_t fixed = 3 * static_cast<size_t>(col_blocks) * 8;
  const size_t per = static_cast<size_t>(buffer_words(col_blocks)) * 8;
  return static_cast<int>(
      std::min<size_t>(kMaxBuffers, (kSmemLimit - fixed) / per));
}

size_t scan_smem_bytes(int col_blocks, int buffers) {
  return (static_cast<size_t>(buffers) * buffer_words(col_blocks) +
          3 * static_cast<size_t>(col_blocks)) * 8;
}

// Start copying what word w needs into `dst` with 16-byte copies: the mask
// words of its rows in the columns after w (the only ones the scan reads),
// their in-word columns and, with an order, their keep slots.  Warps 1-7
// copy; each of their threads commits one group a call, empty past the last
// word, so that they all count the same groups.
__device__ __forceinline__ void stage_word(u64* dst, const u64* seg,
                                           const Scratch& sc,
                                           const int64_t* __restrict__ order,
                                           int s, int w, int n,
                                           int col_blocks) {
  const int tid = static_cast<int>(threadIdx.x) - 32;
  constexpr int kThreads = kScanThreads - 32;
  if (tid < 0) return;
  if (w < col_blocks) {
    const int rows = min(kTile, n - w * kTile);
    // Columns w+1 on: one contiguous run of whole 64-word columns.
    const long long first = (static_cast<long long>(w) * col_blocks + w + 1) *
                            kTile;
    const int words = (col_blocks - w - 1) * kTile;
    u64* stripe = dst + (w + 1) * kTile;
    for (int k = 2 * tid; k < words; k += 2 * kThreads) {
      cp_async16(stripe + k, seg + first + k);
    }
    u64* colm = dst + kTile * col_blocks;
    if (tid < kTile / 2) {
      cp_async16(colm + 2 * tid, seg + sc.colm + w * kTile + 2 * tid);
    } else if (order && tid >= kTile && tid < kTile + rows) {
      const int r = tid - kTile;
      cp_async8(colm + kTile + r,
                order + static_cast<int64_t>(s) * n + w * kTile + r);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const u64* __restrict__ scratch,
                const int64_t* __restrict__ order, uint8_t* __restrict__ keep,
                int n, int col_blocks, Scratch sc, int buffers) {
  extern __shared__ u64 smem[];
  const int bw = buffer_words(col_blocks);
  const int ahead = buffers - 2;             // words in flight
  u64* removed = smem + buffers * bw;        // col_blocks words
  u64* kept_words = removed + col_blocks;    // col_blocks words
  u64* vwords = kept_words + col_blocks;     // col_blocks words
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const u64* seg = scratch + s * sc.words;

  for (int w = 0; w < ahead; ++w) {
    stage_word(smem + w * bw, seg, sc, order, s, w, n, col_blocks);
  }
  for (int c = tid; c < col_blocks; c += kScanThreads) {
    removed[c] = 0;
    vwords[c] = seg[sc.vbits + c];
  }
  u64 carry = 0;   // warp 0: column w's bits from word w-1's kept rows
  cp_async_wait(ahead - 1);   // word 0 has landed
  __syncthreads();

  int cur_buf = 0;
  for (int w = 0; w < col_blocks; ++w) {
    const u64* cur = smem + cur_buf * bw;
    const int prev_buf = cur_buf == 0 ? buffers - 1 : cur_buf - 1;
    // Word w + ahead goes where word w-2 was; its fold ended at the last
    // barrier.
    const int next_buf = (cur_buf + ahead) % buffers;
    stage_word(smem + next_buf * bw, seg, sc, order, s, w + ahead, n,
               col_blocks);
    if (warp == 0) {
      const u64* colm = cur + kTile * col_blocks;
      const u64 c_lo = colm[lane];
      const u64 c_hi = colm[lane + 32];
      // The rows' words of column w+1 (none after the last word).
      const u64* next_col = cur + (w + 1) * kTile;
      const u64 d_lo = w + 1 < col_blocks ? next_col[lane] : 0;
      const u64 d_hi = w + 1 < col_blocks ? next_col[lane + 32] : 0;
      const u64 cand = vwords[w] & ~(removed[w] | carry);
      const bool cand_lo = (cand >> lane) & 1ull;
      const bool cand_hi = (cand >> (lane + 32)) & 1ull;
      u64 kept = cand;
      while (true) {
        const unsigned lo = __ballot_sync(kFullWarp, cand_lo && !(c_lo & kept));
        const unsigned hi = __ballot_sync(kFullWarp, cand_hi && !(c_hi & kept));
        const u64 next = (static_cast<u64>(hi) << 32) | lo;
        if (next == kept) break;
        kept = next;
      }
      const bool k_lo = (kept >> lane) & 1ull;
      const bool k_hi = (kept >> (lane + 32)) & 1ull;
      const u64 x = (k_lo ? d_lo : 0) | (k_hi ? d_hi : 0);
      carry = (static_cast<u64>(__reduce_or_sync(
                   kFullWarp, static_cast<unsigned>(x >> 32))) << 32) |
              __reduce_or_sync(kFullWarp, static_cast<unsigned>(x));
      if (lane == 0) kept_words[w] = kept;
      const int64_t* slots = reinterpret_cast<const int64_t*>(colm + kTile);
      const int64_t base = static_cast<int64_t>(s) * n;
      const int i = w * kTile + lane;
      if (i < n) {
        keep[base + (order ? slots[lane] : i)] = k_lo;
      }
      if (i + 32 < n) {
        keep[base + (order ? slots[lane + 32] : i + 32)] = k_hi;
      }
    } else if (w > 0 && kept_words[w - 1]) {
      // Fold word w-1's kept rows into the columns after w: a warp a
      // column, lanes over rows, one OR across the warp.
      const u64* prev = smem + prev_buf * bw;
      const u64 kp = kept_words[w - 1];
      const bool k_lo = (kp >> lane) & 1ull;
      const bool k_hi = (kp >> (lane + 32)) & 1ull;
      for (int c = w + warp; c < col_blocks; c += kFoldWarps) {
        const u64 x = (k_lo ? prev[c * kTile + lane] : 0) |
                      (k_hi ? prev[c * kTile + lane + 32] : 0);
        const unsigned lo = __reduce_or_sync(kFullWarp,
                                             static_cast<unsigned>(x));
        const unsigned hi = __reduce_or_sync(kFullWarp,
                                             static_cast<unsigned>(x >> 32));
        if (lane == 0) removed[c] |= (static_cast<u64>(hi) << 32) | lo;
      }
    }
    cp_async_wait(ahead - 1);   // word w+1 has landed
    __syncthreads();
    cur_buf = cur_buf + 1 == buffers ? 0 : cur_buf + 1;
  }
  cp_async_wait(0);
}

}  // namespace

// Words of scratch a segment takes.
extern "C" long long podtpu_nms_scratch_words(int n) {
  return scratch_layout(n).words;
}

// boxes [S, N, 4] float32 (16-byte aligned), valid [S, N] uint8, order
// [S, N] int64 or null, scratch of S * podtpu_nms_scratch_words(N) words
// (16-byte aligned), keep [S, N] uint8 (out, every slot written), all on
// `device`; launched on `stream`.  Returns a cudaError_t.
extern "C" int podtpu_nms_keep(const void* boxes, const void* valid,
                               const void* order, void* scratch, void* keep,
                               int segments, int n, float threshold,
                               int device, void* stream) {
  if (segments <= 0 || n <= 0) return 0;
  const int col_blocks = (n + kTile - 1) / kTile;
  if (col_blocks > kMaxColBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = device;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Scratch sc = scratch_layout(n);
  const int pairs = col_blocks * (col_blocks + 1) / 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((pairs + kTilesPerBlock - 1) / kTilesPerBlock, segments);
  nms_mask_kernel<<<grid, kMaskThreads, 0, st>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<const int64_t*>(order), static_cast<u64*>(scratch), n,
      col_blocks, pairs, sc, threshold);
  err = cudaGetLastError();
  const int buffers = scan_buffers(col_blocks);
  const size_t smem_bytes = scan_smem_bytes(col_blocks, buffers);
  // Dynamic shared memory above 48 KB needs the kernel's attribute, set
  // once a device to the most a block may have (the attribute is a cap;
  // each launch still takes only what it asks for).
  static std::atomic<bool> granted[kMaxDevices];
  if (err == cudaSuccess && smem_bytes > 48 * 1024 &&
      !(device < kMaxDevices && granted[device].load())) {
    err = cudaFuncSetAttribute(nms_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemLimit));
    if (err == cudaSuccess && device < kMaxDevices) granted[device] = true;
  }
  if (err == cudaSuccess) {
    nms_scan_kernel<<<segments, kScanThreads, smem_bytes, st>>>(
        static_cast<const u64*>(scratch), static_cast<const int64_t*>(order),
        static_cast<uint8_t*>(keep), n, col_blocks, sc, buffers);
    err = cudaGetLastError();
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

// Shared by every entry point of the library.
extern "C" const char* podtpu_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
