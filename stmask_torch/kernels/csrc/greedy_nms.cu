// B5: exact greedy NMS over score-sorted candidates, G groups (classes) in
// one launch.  Two entries: one takes the IoU matrix the caller computed,
// the other the boxes, forming the Cython +1-pixel IoUs itself.
//
// Replaces: stmask_tpu/ops/nms.py::greedy_nms_mask (an XLA fori_loop, not a
// Pallas kernel), which greedy_nms_per_class vmaps over the classes (the
// reference's Cython traditional_nms, the exact mAP* parity path), and, in
// the boxes entry, the IoU matrix it is handed there, _plus_one_iou
// (stmask_tpu/ops/nms.py:140).
//
//   suppressed = ~valid
//   for i in 0 .. K-1:
//     if not suppressed[i]: suppressed[j] |= iou[i, j] > thr   for all j > i
//   keep = ~suppressed & valid
//
// Both compare the same fp32 values as the JAX function: the result is
// exact, bit for bit the plain version's.  The boxes entry forms each IoU
// in _plus_one_iou's order of operations with the _rn intrinsics, which
// nvcc never contracts into an FMA:
//   area = (x2 - x1 + 1) * (y2 - y1 + 1)
//   iw = max(min(x2_i, x2_j) - max(x1_i, x1_j) + 1, 0), ih alike
//   iou = iw * ih / ((area_i + area_j) - iw * ih)
// (fmaxf / fminf drop a NaN where max / min keep it; a NaN coordinate makes
// its box's area NaN, so that IoU is NaN on both sides and suppresses
// nothing either way).
//
// What bounds it on an H100.  The matrix entry reads the IoU matrix's strict
// upper triangle once (at G 40, K 200: 3.18 MB, 0.00096 ms of HBM time).
// The boxes entry reads each group's K boxes, indices and valid flags and
// writes keep (~13 KB at G 40, K 200) and does ~15 fp32 operations and one
// division for each IoU above the diagonal (0.8 M IoUs): ~0.0002 ms at the
// fp32 peak.  What really sets the time is the chain: K dependent steps,
// each needing the verdict of every earlier row.
//
// Design: the suppression bitmask, K rows x W = ceil(K / 64) 64-bit words
// (bit j of row i: j > i and iou[i, j] > thr), then warp 0 runs the scan
// over it, lane w holding word w of the removed set, 64 rows at a time:
// one lane resolves the block's rows against its diagonal words in
// registers (the words loaded first, then a constant bit tested and a
// select a row: no shuffle on the chain), then the block's survivors are
// ORed into the later words in parallel.  No atomics: deterministic.
//
// - Matrix entry: one block of 512 threads a group builds the rows, a warp
//   each (row, word) pair from two coalesced 128-byte reads and two
//   ballots, four pairs at a time so that their reads are in flight
//   together; words left of the diagonal are zero and not read.
// - Boxes entry: a thread-block cluster of up to 4 blocks a group (fewer
//   when the groups alone fill the card).  Every block gathers the group's
//   boxes (boxes[idx] * scale) and their areas into its shared memory; the
//   cluster's warps share the half words (32 bits, 32 columns j) of the
//   rows, in chunks of 8 rows of one half: a lane keeps its box j in
//   registers, forms one IoU a row, and a ballot makes the half word,
//   written into the leading block's bitmask through distributed shared
//   memory.  Halves that the scan never reads (zero, or past K) are not
//   formed, and a pair that does not overlap skips the IEEE division (0 /
//   union is a signed zero).  No block writes into the leading block's
//   shared memory before a cluster barrier says that every block of the
//   cluster has started (its arrival is made on entry and waited for after
//   the staging); after a second one the leading block scans.
//
// K <= 1024 (16 words a row: 128 KB of dynamic shared memory at K 1024 for
// the bitmask, 6.4 KB at K 200; the boxes entry adds 20 bytes a box).

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

// Measurement builds only (stmask_torch/kernels/split.py; the library's own
// build leaves it 0): STMASK_NMS_DROP leaves parts of the work out, bit 1
// the suppression rows (the bitmask the scan reads is then left as it
// was; in the boxes entry also the IoUs), 2 the scan, 4 (boxes entry) the
// reads of boxes and indices (each box then made from its slot number).
#ifndef STMASK_NMS_DROP
#define STMASK_NMS_DROP 0
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int DROP = STMASK_NMS_DROP;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 1024;
constexpr int MAX_CLUSTER = 4;
constexpr int UNROLL = 4;
constexpr int CHUNK_ROWS = 8;   // rows of one half word a warp takes at once
constexpr unsigned FULL = 0xffffffffu;

using u64 = unsigned long long;

__device__ __forceinline__ u64 join(unsigned lo, unsigned hi) {
  return (static_cast<u64>(hi) << 32) | lo;
}

// the removed set starts as the invalid slots (bits past K never read)
__device__ __forceinline__ void init_removed(const bool* v, u64* removed,
                                             int K, int words) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int w = warp; w < words; w += WARPS) {
    const int j0 = w * 64 + lane, j1 = j0 + 32;
    const unsigned lo = __ballot_sync(FULL, j0 < K && v[j0]);
    const unsigned hi = __ballot_sync(FULL, j1 < K && v[j1]);
    if (lane == 0) removed[w] = ~join(lo, hi);
  }
}

// The scan in warp 0 over the bitmask rows [K][words], then keep = valid
// and not removed.  Called by every thread of the block.  Lane w holds word
// w of the removed set.  Lane b resolves block b's 64 rows in order against
// the diagonal words alone (the rows of earlier blocks are already ORed
// in): a row survives unless its bit is set, and then ORs its diagonal
// word in.  The block's survivors, broadcast, then OR their words right of
// the diagonal into the later lanes, all rows at once.  It reads, of a row
// i in block b, the diagonal word (only its high half when i >= 64 b + 32,
// as the low half then lies left of i) and the words right of it; bits
// past K may hold anything.
__device__ __forceinline__ void scan_and_keep(const u64* rows, u64* removed,
                                              const bool* v, bool* keep,
                                              int K, int words) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (!(DROP & 2) && warp == 0) {
    u64 mine = lane < words ? removed[lane] : 0ull;
    for (int blk = 0; blk < words; ++blk) {
      const int i0 = 64 * blk, n = min(64, K - i0);
      const u64* at = rows + static_cast<size_t>(i0) * words;
      if (lane == blk) {
        // rows t < 32 set bits in both halves, rows t >= 32 in the high
        // half only (j > i).  The diagonal words are loaded first; the
        // chain then tests one constant bit a row and selects.
        unsigned lo = static_cast<unsigned>(mine);
        unsigned hi = static_cast<unsigned>(mine >> 32);
        unsigned dlo[32], dhi[32];
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          const u64 row = t < n ? at[t * words + blk] : 0ull;
          dlo[t] = static_cast<unsigned>(row);
          dhi[t] = static_cast<unsigned>(row >> 32);
        }
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          const bool out = lo & (1u << t);
          lo = out ? lo : lo | dlo[t];
          hi = out ? hi : hi | dhi[t];
        }
#pragma unroll
        for (int t = 0; t < 32; ++t)
          dhi[t] = t + 32 < n ? static_cast<unsigned>(
              at[(t + 32) * words + blk] >> 32) : 0u;
#pragma unroll
        for (int t = 0; t < 32; ++t)
          hi = (hi & (1u << t)) ? hi : hi | dhi[t];
        mine = join(lo, hi);
      }
      const u64 kept = ~__shfl_sync(FULL, mine, blk) &
                       (n == 64 ? ~0ull : (1ull << n) - 1);
      if (lane > blk && lane < words) {
        u64 acc = 0;
#pragma unroll
        for (int t = 0; t < 64; ++t)
          acc |= (t < n ? at[t * words + lane] : 0ull) &
                 (0ull - ((kept >> t) & 1ull));
        mine |= acc;
      }
    }
    if (lane < words) removed[lane] = mine;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < K; j += THREADS)
    keep[j] = v[j] && !((removed[j >> 6] >> (j & 63)) & 1ull);
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

  init_removed(v, removed, K, words);
  // suppression rows, UNROLL (row, word) pairs a warp at a time: all their
  // loads are issued before the ballots.  p, i and w are the same for the
  // whole warp; a lane left of the diagonal or past K loads nothing.
  const int pairs = (DROP & 1) ? 0 : K * words;
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
  scan_and_keep(rows, removed, v, keep + g * K, K, words);
}

// Shared memory of the boxes entry: the bitmask and the removed set (read
// in the leading block only), then, 16-byte aligned, the boxes and their
// areas.
__host__ __device__ constexpr size_t boxes_at(int K, int words) {
  return (static_cast<size_t>(K) * words + words + 1) / 2 * 2;   // u64s
}
__host__ __device__ constexpr size_t boxes_smem(int K, int words) {
  return boxes_at(K, words) * sizeof(u64) +
         static_cast<size_t>(K) * (sizeof(float4) + sizeof(float));
}

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.f),
                   __fadd_rn(__fsub_rn(b.w, b.y), 1.f));
}

// iou(i, j) > thr, _plus_one_iou's operations in its order
__device__ __forceinline__ bool iou_above(float4 bi, float ai, float4 bj,
                                          float aj, float thr) {
  const float iw = fmaxf(
      __fadd_rn(__fsub_rn(fminf(bi.z, bj.z), fmaxf(bi.x, bj.x)), 1.f), 0.f);
  const float ih = fmaxf(
      __fadd_rn(__fsub_rn(fminf(bi.w, bj.w), fmaxf(bi.y, bj.y)), 1.f), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(ai, aj), inter);
  // a zero dividend gives a signed zero (NaN over a zero or NaN union):
  // no division for the pairs that do not overlap
  if (inter == 0.f) return uni == uni && uni != 0.f && 0.f > thr;
  return __fdiv_rn(inter, uni) > thr;
}

struct BoxesArgs {
  const float* boxes;      // [P, 4]
  const int64_t* idx;      // [G, K] rows of boxes
  const bool* valid;       // [G, K]
  bool* keep;              // [G, K]
  int P, K;
  float scale, thr;
};

__global__ void __launch_bounds__(THREADS)
    greedy_nms_boxes_kernel(const BoxesArgs a) {
  extern __shared__ u64 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int K = a.K;
  const int words = (K + 63) >> 6, halves = 2 * words;
  u64* rows = smem;                                   // [K][words]
  u64* removed = smem + static_cast<size_t>(K) * words;   // [words]
  float4* bx = reinterpret_cast<float4*>(smem + boxes_at(K, words));
  float* area = reinterpret_cast<float*>(bx + K);
  const size_t g = blockIdx.x / cs;
  const int64_t* idx = a.idx + g * K;
  const bool* v = a.valid + g * K;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // the leading block's shared memory may be written only once every block
  // of the cluster has started: arrive now, wait after the staging
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // the group's boxes, scaled as the caller's boxes[idx] * scale
  for (int k = threadIdx.x; k < K; k += THREADS) {
    float4 b;
    if (DROP & 4) {
      b = make_float4(k, k, k + 20.f, k + 30.f);
    } else {
      const int64_t r = idx[k];
      if (r < 0 || r >= a.P) __trap();               // an index off boxes
      const float* s = a.boxes + 4 * r;
      b = make_float4(__fmul_rn(s[0], a.scale), __fmul_rn(s[1], a.scale),
                      __fmul_rn(s[2], a.scale), __fmul_rn(s[3], a.scale));
    }
    bx[k] = b;
    area[k] = area_of(b);
  }
  if (rank == 0) init_removed(v, removed, K, words);
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");

  // The half words of the bitmask that the scan reads: half h (the bits of
  // j = 32 h + lane, 32 h < K) of each row i < min(32 h + 32, K) (the rows
  // that can hold a bit j > i, and row 32 h + 31, whose zero half lies in
  // a diagonal word the scan reads whole).  They are cut into chunks of
  // CHUNK_ROWS rows of one half and dealt round robin to the cluster's
  // warps; a lane keeps its box j in registers and takes the chunk's rows
  // UNROLL at a time, their IoUs before their ballots.  The other halves
  // (zero, or bits past K) are never read, so never written.
  unsigned* lead = reinterpret_cast<unsigned*>(
      cluster.map_shared_rank(rows, 0));
  const int nh = (K + 31) >> 5;
  int chunks = 0;
  for (int h = 0; h < nh; ++h)
    chunks += (min(32 * h + 32, K) + CHUNK_ROWS - 1) / CHUNK_ROWS;
  if (DROP & 1) chunks = 0;
  for (int c = rank * WARPS + warp; c < chunks; c += cs * WARPS) {
    int h = 0, r0 = c;                    // c's half and first row
    for (;; ++h) {
      const int n_h = (min(32 * h + 32, K) + CHUNK_ROWS - 1) / CHUNK_ROWS;
      if (r0 < n_h) break;
      r0 -= n_h;
    }
    r0 *= CHUNK_ROWS;
    const int r1 = min(r0 + CHUNK_ROWS, min(32 * h + 32, K));
    const int j = 32 * h + lane;
    const float4 bj = j < K ? bx[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float aj = j < K ? area[j] : 0.f;
    for (int i0 = r0; i0 < r1; i0 += UNROLL) {
      bool above[UNROLL];
#pragma unroll
      for (int q = 0; q < UNROLL; ++q) {
        const int i = i0 + q;
        above[q] = i < r1 && j > i && j < K &&
                   iou_above(bx[i], area[i], bj, aj, a.thr);
      }
#pragma unroll
      for (int q = 0; q < UNROLL; ++q) {
        const unsigned bits = __ballot_sync(FULL, above[q]);
        if (lane == 0 && i0 + q < r1) lead[(i0 + q) * halves + h] = bits;
      }
    }
  }
  cluster.sync();          // every half word is in the leading block
  if (rank == 0) scan_and_keep(rows, removed, v, a.keep + g * K, K, words);
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

// boxes [P, 4] fp32, idx [G, K] int64 (rows of boxes, each in [0, P): an
// index off boxes traps), valid [G, K] bool, keep [G, K] bool, all
// contiguous on one device; 1 <= K <= 1024.  Group g's boxes are
// boxes[idx[g]] * scale, score-sorted.  Enqueues on ``stream``, returns
// cudaGetLastError().
extern "C" int stmask_greedy_nms_boxes(const float* boxes, const void* idx,
                                       const bool* valid, bool* keep, int P,
                                       int G, int K, float scale, float thr,
                                       void* stream) {
  if (G < 1 || K < 1 || K > MAX_K || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = (K + 63) / 64;
  const size_t smem = boxes_smem(K, words);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        greedy_nms_boxes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // up to MAX_CLUSTER blocks a group while the grid stays within two
  // blocks an SM
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int cs = 1;
  while (cs < MAX_CLUSTER && static_cast<int64_t>(G) * cs * 2 <= 2 * sms)
    cs *= 2;
  const BoxesArgs a{boxes, static_cast<const int64_t*>(idx), valid, keep,
                    P, K, scale, thr};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(G) * cs, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, greedy_nms_boxes_kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
