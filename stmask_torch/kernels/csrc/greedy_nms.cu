// B5: exact greedy NMS over score-sorted candidates, one group (a class) a
// block, G groups in one launch.
//
// Replaces: stmask_tpu/ops/nms.py::greedy_nms_mask (an XLA fori_loop, not a
// Pallas kernel), which greedy_nms_per_class vmaps over the classes (the
// reference's Cython traditional_nms, the exact mAP* parity path).
//
//   suppressed = ~valid
//   for i in 0 .. K-1:
//     if not suppressed[i]: suppressed[j] |= iou[i, j] > thr   for all j > i
//   keep = ~suppressed & valid
//
// The kernel takes the IoU matrix [G, K, K] (fp32) that the caller computed,
// so it compares the same fp32 values as the JAX function: the result is
// exact, bit for bit the plain version's.
//
// What bounds it on an H100: the IoU matrix's strict upper triangle, the only
// entries read, is read once (at G 40, K 200: 3.18 MB, 0.00096 ms of HBM
// time) and the comparisons are ~0.8 M fp32 ops.
// What really sets its time is the chain: K dependent steps, each needing
// the verdict of every earlier row.
//
// Design: all 512 threads first turn the block's rows into a suppression
// bitmask in shared memory, K rows x W = ceil(K / 64) 64-bit words (bit j
// of row i: j > i and iou[i, j] > thr).  A warp builds each (row, word) pair
// from two coalesced 128-byte reads and two ballots, four pairs at a time so
// that their reads are in flight together; words left of the diagonal are
// zero and not read.  Then warp 0 runs the scan: lane w holds word w of the
// removed set, a __shfl_sync broadcasts row i's verdict from the lane that
// holds bit i, and every lane ORs its word of row i in when i survives.
// K <= 1024 (16 words a row; 128 KB of dynamic shared memory at K 1024,
// 6.4 KB at K 200).  No atomics: deterministic.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 1024;
constexpr int UNROLL = 4;
constexpr unsigned FULL = 0xffffffffu;

using u64 = unsigned long long;

__device__ __forceinline__ u64 join(unsigned lo, unsigned hi) {
  return (static_cast<u64>(hi) << 32) | lo;
}

__global__ void __launch_bounds__(THREADS)
    greedy_nms_kernel(const float* __restrict__ iou,
                      const bool* __restrict__ valid, bool* __restrict__ keep,
                      int K, float thr) {
  extern __shared__ u64 smem[];
  const int words = (K + 63) >> 6;
  u64* rows = smem;                                   // [K][words]
  u64* removed = smem + static_cast<size_t>(K) * words;   // [words]
  const size_t g = blockIdx.x;
  const float* m = iou + g * K * K;
  const bool* v = valid + g * K;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // the removed set starts as the invalid slots (bits past K never read)
  for (int w = warp; w < words; w += WARPS) {
    const int j0 = w * 64 + lane, j1 = j0 + 32;
    const unsigned lo = __ballot_sync(FULL, j0 < K && v[j0]);
    const unsigned hi = __ballot_sync(FULL, j1 < K && v[j1]);
    if (lane == 0) removed[w] = ~join(lo, hi);
  }
  // suppression rows, UNROLL (row, word) pairs a warp at a time: all their
  // loads are issued before the ballots.  p, i and w are the same for the
  // whole warp; a lane left of the diagonal or past K loads nothing.
  const int pairs = K * words;
  for (int base = warp * UNROLL; base < pairs; base += WARPS * UNROLL) {
    bool above[UNROLL][2];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p = base + u;
      const int i = p / words, w = p - i * words;
      const int j0 = w * 64 + lane, j1 = j0 + 32;
      const float* r = m + static_cast<size_t>(i) * K;
      const bool live = p < pairs;
      above[u][0] = live && j0 > i && j0 < K && r[j0] > thr;
      above[u][1] = live && j1 > i && j1 < K && r[j1] > thr;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const unsigned lo = __ballot_sync(FULL, above[u][0]);
      const unsigned hi = __ballot_sync(FULL, above[u][1]);
      if (lane == 0 && base + u < pairs) rows[base + u] = join(lo, hi);
    }
  }
  __syncthreads();

  // the sequential scan in one warp
  if (warp == 0) {
    u64 mine = lane < words ? removed[lane] : 0ull;
    for (int i = 0; i < K; ++i) {
      const u64 row = lane < words ? rows[i * words + lane] : 0ull;
      const unsigned out = __shfl_sync(
          FULL, static_cast<unsigned>(mine >> (i & 63)) & 1u, i >> 6);
      if (!out) mine |= row;
    }
    if (lane < words) removed[lane] = mine;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < K; j += THREADS)
    keep[g * K + j] = v[j] && !((removed[j >> 6] >> (j & 63)) & 1ull);
}

}  // namespace

// iou [G, K, K] fp32, valid [G, K] bool, keep [G, K] bool, all contiguous
// on one device; 1 <= K <= 1024.  Enqueues on ``stream``, returns
// cudaGetLastError().
extern "C" int stmask_greedy_nms(const float* iou, const bool* valid,
                                 bool* keep, int G, int K, float thr,
                                 void* stream) {
  if (G < 1 || K < 1 || K > MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = (K + 63) / 64;
  const size_t smem = (static_cast<size_t>(K) * words + words) * sizeof(u64);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  greedy_nms_kernel<<<G, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      iou, valid, keep, K, thr);
  return static_cast<int>(cudaGetLastError());
}
