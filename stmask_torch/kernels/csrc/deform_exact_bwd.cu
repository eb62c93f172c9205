// K5: backward of the exact (unclamped) modulated deformable gather, NHWC.
// Entries: fp32; bf16 (dcols, x, mask, dx and d_mask bf16; the offsets and
// d_offset bf16, or fp32 beside bf16 data).
//
// Replaces: the autodiff of stmask_tpu/ops/deform_conv.py::deform_conv2d's
// gather (deform_conv.py:31-89) through ops/sampling.py::
// bilinear_sample_block (sampling.py:48-85), the path the JAX package
// trains its DCN sites and FCB through at window radius 0.  The weight and
// column gradients stay with the caller (deform_wgrad and one matmul).
//
// For each output site s = (b, oy, ox) and tap k, with the raw offset
// (dy, dx) and the modulation m, the forward sampled at
// p = (by + dy, bx + dx) (by, bx: the tap's grid position) from the block
// of rows y0 + r, r < min(2, H), y0 = clip(floor(py), 0, H - min(2, H)),
// and columns likewise:
//
//   v[c] = sum_{r, q} wy_r * wx_q * x[b, y0 + r, x0 + q, c]
//   wy_r = clip(1 - |py - (y0 + r)|, 0, 1)
//
// and wrote cols[s, k * Cin + c] = m * v[c].  Given dcols = dL/dcols:
//
//   dx[b, y0 + r, x0 + q, c] += m * wy_r * wx_q * dcols[s, k, c]
//   d_mask[s, k]      = sum_{r,q} wy_r wx_q S_rq
//   d_offset[s, k, 0] = m * sum_{r,q} dwy_r wx_q S_rq
//   d_offset[s, k, 1] = m * sum_{r,q} wy_r dwx_q S_rq
//   S_rq = sum_c dcols[s, k, c] * x[b, y0 + r, x0 + q, c]
//
// dwy_r is JAX's derivative of the weight at d = py - (y0 + r), z = 1 - |d|:
// -sign(d) (with sign 1 at d == 0: JAX's d|x|/dx is 1 at 0), halved where
// z == 0 (jnp.maximum's tie) and where z == 1 (jnp.minimum's), 0 where
// z < 0.  The block is always inside the image, so a sample far outside it
// has zero weights and, at most, a tie's derivative.
//
// Two routes; the wrapper names one (deform_exact_bwd.py: exact_bwd_fast,
// exact_bwd_plan) and the entry launches it, or refuses a fast call that
// the fast route cannot take.
//
// General route (the first design, for ragged Cin, unaligned pointers and
// 1-pixel maps): one warp a (site, tap) item, lanes over the channels (VEC
// = 4 channels a lane where Cin is a multiple of 4 and the pointers are
// aligned for it, else 1).  Each lane computes the item's block, weights
// and derivatives, reads dcols and the up to four corners' channels, folds
// its part of S into three sums and adds the weighted dcols to dx with
// fp32 reductions in device memory (float4 ones, sm_90, at VEC 4).  A
// fixed butterfly reduces the three sums.  The bf16 entries sum dx into an
// fp32 buffer that the entry zeroes and then rounds to bf16 (a second small
// kernel).
//
// What bounds it on an H100: bytes (dcols read once, x read once, dx
// written once: 0.26 ms at the flagship's 7 DCN sites x 8 frames in fp32).
// The general route instead issues a float4 reduction into device memory
// for every weighted corner of every item and 4 channels (~141 M at those
// sites and N(0, 1.5) offsets, ~4x the bytes of the bound through L2).
//
// Fast route (fp32: Cin a multiple of 4; bf16: of 8; dcols, x and dx's
// sums 16-byte aligned; H, W >= 2; every DCN and FCB training site):
// deform_exact_bwd_fast_kernel below, K4's tiled design (deform_col2im.cu)
// with an overflow path.  One block takes a tile of TY x TX output sites of
// one image with all K taps ("items") and walks Cin in chunks of 32
// channels (a row of 128 bytes in fp32, 64 in bf16; blockIdx.z may take a
// share of the chunks).  The footprint is the tile's tap grid with a halo
// of R pixels.  Each item is classified by its clipped 2 x 2 block: inside
// (all four corners in the footprint) or overflow.  Inside items are
// bucketed by their block's origin (the anchor) with a counting sort.  Per
// chunk, cp.async brings x over the footprint and every item's dcols row,
// as stored (bf16 widened only in registers), into a ring of two chunks,
// and two passes read shared memory: the items' S (an inside item's from
// x in shared memory), then each footprint pixel's dx, gathered from the
// buckets of its own, left, upper and upper-left anchors and added to
// device memory once per tile and chunk.  Overflow items take the general
// route's per-item work inside the first pass (their dcols rows from
// shared memory, x and dx in device memory), so the route is exact for any
// offsets and the wrapper never reads them.  The bf16 entries zero and
// round dx's fp32 sums by one memset and a vectorised kernel.  A split of
// the general route (kernels/split.py) put 37% of its fp32 time and 22% of
// its bf16 time in the dx reductions and most of the rest in a warp an
// item; on the fast route the two passes take most of the time (PERF.md).
//
// On both routes d_offset and d_mask are summed in a fixed order (the fast
// route: per corner over the chunks, then the corners, and under a channel
// split the splits' partials by a small kernel in split order), so they are
// the same bit for bit over two launches; dx adds in device memory with
// atomics, so its low bits depend on the order of the adds.  The bf16
// entries read bf16 values as they are, compute in fp32 and round d_offset
// and d_mask once.

#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

// Measurement builds only (stmask_torch/kernels/split.py; the library's own
// build leaves it 0): STMASK_EXACTBWD_DROP leaves parts of every entry's
// work out, on both routes: bit 1 the corner reads of x and the dot
// products S (d_offset and d_mask), 2 the dx reductions into device memory
// (kept behind a test that never holds, so that the sums stay), 4 the
// reads of dcols (the fast route's copies of the items' rows), 8 (bf16
// entries) the zeroing and rounding of dx's fp32 sums, 16 (fast route) the
// footprint pass (the inside items' dx and dot products).
#ifndef STMASK_EXACTBWD_DROP
#define STMASK_EXACTBWD_DROP 0
#endif

namespace {

using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;

constexpr int DROP = STMASK_EXACTBWD_DROP;
// A value no sum takes: a dropped reduction is kept behind v == NEVER.
constexpr float NEVER = -1.2345e-38f;

constexpr int THREADS = 256;      // 8 items a block
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// VEC channels at p as fp32 (VEC 4: p aligned to 4 channels)
template <int VEC>
__device__ __forceinline__ void ld(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = *p;
  }
}
template <int VEC>
__device__ __forceinline__ void ld(const bf16* p, float* v) {
  if constexpr (VEC == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(raw.x << 16);
    v[1] = __uint_as_float(raw.x & 0xffff0000u);
    v[2] = __uint_as_float(raw.y << 16);
    v[3] = __uint_as_float(raw.y & 0xffff0000u);
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// dx[p + i] += a * d[i]
template <int VEC>
__device__ __forceinline__ void red(float* p, float a, const float* d) {
  if constexpr (VEC == 4)
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(a * d[0], a * d[1], a * d[2], a * d[3]));
  else
    atomicAdd(p, a * d[0]);
}

// The weight clip(1 - |p - u|, 0, 1) of block row (or column) u and JAX's
// derivative of it with respect to p (see the top).
__device__ __forceinline__ void block_weight(float p, float u, float* w,
                                             float* dw) {
  const float d = p - u;
  const float z = 1.f - fabsf(d);
  const float lo = z > 0.f ? 1.f : (z == 0.f ? 0.5f : 0.f);
  const float hi = z == 1.f ? 0.5f : 1.f;
  *w = fminf(fmaxf(z, 0.f), 1.f);
  *dw = (d >= 0.f ? -lo : lo) * hi;
}

struct Shape {
  int H, W, Cin, Ho, Wo, kh, kw, stride, dilation, items;
};

template <int VEC, typename T, typename TO>
__global__ void __launch_bounds__(THREADS)
    deform_exact_bwd_kernel(const T* __restrict__ dcols,
                            const T* __restrict__ x,
                            const TO* __restrict__ offset,
                            const T* __restrict__ mask,
                            float* __restrict__ dx, TO* __restrict__ doffset,
                            T* __restrict__ dmask, Shape g) {
  const int item = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= g.items) return;              // the whole warp leaves
  const int K = g.kh * g.kw;
  const int tap = item % K;
  const int site = item / K;
  const int ox = site % g.Wo;
  const int oy = (site / g.Wo) % g.Ho;
  const int b = site / (g.Wo * g.Ho);
  const int by = oy * g.stride - (g.kh - 1) / 2 * g.dilation +
                 tap / g.kw * g.dilation;
  const int bx = ox * g.stride - (g.kw - 1) / 2 * g.dilation +
                 tap % g.kw * g.dilation;
  const float py = static_cast<float>(by) + f32(offset[2 * item]);
  const float px = static_cast<float>(bx) + f32(offset[2 * item + 1]);
  const float m = mask != nullptr ? f32(mask[item]) : 1.f;
  const int sh = min(2, g.H), sw = min(2, g.W);
  // the block's origin, clipped to the image (a NaN coordinate gives 0)
  const float fy =
      fminf(fmaxf(floorf(py), 0.f), static_cast<float>(g.H - sh));
  const float fx =
      fminf(fmaxf(floorf(px), 0.f), static_cast<float>(g.W - sw));
  float wy[2] = {0.f, 0.f}, dwy[2] = {0.f, 0.f};
  float wx[2] = {0.f, 0.f}, dwx[2] = {0.f, 0.f};
  for (int r = 0; r < sh; ++r) block_weight(py, fy + r, &wy[r], &dwy[r]);
  for (int q = 0; q < sw; ++q) block_weight(px, fx + q, &wx[q], &dwx[q]);
  // the four corners: weight, its two derivatives, and the pixel's first
  // channel in this image (-1: no corner, or one that passes nothing)
  float cw[4], cy[4], cx[4];
  int64_t at[4];
  const int y0 = static_cast<int>(fy), x0 = static_cast<int>(fx);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = j >> 1, q = j & 1;
    cw[j] = wy[r] * wx[q];
    cy[j] = dwy[r] * wx[q];
    cx[j] = wy[r] * dwx[q];
    const bool live = r < sh && q < sw &&
                      (cw[j] != 0.f || cy[j] != 0.f || cx[j] != 0.f);
    at[j] = live ? (static_cast<int64_t>(b) * g.H * g.W +
                    static_cast<int64_t>(y0 + r) * g.W + (x0 + q)) *
                       g.Cin
                 : -1;
  }
  const T* dc = dcols + static_cast<int64_t>(item) * g.Cin;
  float s_m = 0.f, s_y = 0.f, s_x = 0.f;
  for (int c = lane * VEC; c < g.Cin; c += 32 * VEC) {
    float d[VEC];
    if constexpr (DROP & 4) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) d[i] = static_cast<float>(c + i);
    } else {
      ld<VEC>(dc + c, d);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (at[j] < 0) continue;
      if constexpr (!(DROP & 1)) {
        float v[VEC];
        ld<VEC>(x + at[j] + c, v);
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) s += d[i] * v[i];
        s_m += cw[j] * s;
        s_y += cy[j] * s;
        s_x += cx[j] * s;
      }
      if ((DROP & 2) && d[0] != NEVER) continue;
      if (cw[j] != 0.f) red<VEC>(dx + at[j] + c, m * cw[j], d);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s_m += __shfl_xor_sync(0xffffffffu, s_m, o);
    s_y += __shfl_xor_sync(0xffffffffu, s_y, o);
    s_x += __shfl_xor_sync(0xffffffffu, s_x, o);
  }
  if (lane == 0) {
    st(doffset + 2 * item, m * s_y);
    st(doffset + 2 * item + 1, m * s_x);
    if (dmask != nullptr) st(dmask + item, s_m);
  }
}

// dx's fp32 sums rounded to bf16
__global__ void deform_exact_bwd_round_kernel(const float* __restrict__ dx32,
                                              bf16* __restrict__ dx,
                                              int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    dx[i] = __float2bfloat16_rn(dx32[i]);
}

// ---- The fast route ------------------------------------------------------
// Blocks of F_THREADS threads, two an SM where the plan's shared memory
// allows (deform_exact_bwd.py: exact_bwd_plan); groups of 4 lanes, each
// lane 8 channels of a row's chunk (two 16-byte runs in fp32, one in
// bf16).  Items are
// site-major in a tile (it = site * K + tap); slots are the items in bucket
// order: the inside items by anchor, then the overflow items (bucket npix).
// The sort is a counting sort by all threads, each item's rank in its
// bucket the return of the count's shared-memory atomic: the order within
// a bucket varies between launches, which moves only dx's order of adds
// (a slot's sums S do not depend on its place).  Per slot the block keeps
// its dx weights (m times the corner weights), the 4 corner sums S over
// the chunks, a packed word (the anchor's footprint index, or for an
// overflow item its block's origin in the image, above the 4 live-corner
// bits), the item and its dcols row's source; the weights' derivatives are
// computed again from the offsets at the end.  The footprint pass walks
// only the footprint pixels in the image that some inside item reaches (a
// list made once per block).

constexpr int F_THREADS = 512;
constexpr int LANES = 4;
constexpr int F_GROUPS = F_THREADS / LANES;
constexpr int F_STAGES = 2;
constexpr int SMEM_MAX = 232448;  // shared memory a block may take (sm_90)

// A chunk is 32 channels: a row of it is 128 bytes in fp32, 64 in bf16, a
// lane's share kV 16-byte runs (runs l and l + LANES of the row) of kNV
// channels each, kLV channels in all
template <typename T>
constexpr int kNV = 16 / static_cast<int>(sizeof(T));    // channels a run
template <typename T>
constexpr int kV = kF32<T> ? 2 : 1;                      // runs a lane
template <typename T>
constexpr int kLV = kV<T> * kNV<T>;                      // channels a lane
template <typename T>
constexpr int kCC = LANES * kLV<T>;                      // channels a chunk
template <typename T>
constexpr int kRow = kCC<T> * static_cast<int>(sizeof(T));  // bytes a row

struct FastShape {
  int H, W, Cin, Ho, Wo, kh, kw, stride, dilation;
  int ty, tx, fh, fw, halo, tiles_x, chunks_per_split, n_chunks;
};

// Dynamic shared memory of the fast kernel for rows of `row` bytes
// (deform_exact_bwd.py: fast_smem): the ring of rows (the footprint's
// pixels, then the slots), per slot its weights, 4 sums, packed word and
// item, per row its source, the buckets' starts (npix + 2) and the list of
// the footprint pass's pixels with its length (npix + 1).
int64_t fast_smem(int npix, int n_items, int row) {
  const int64_t rows = static_cast<int64_t>(npix) + n_items;
  return F_STAGES * rows * row +
         static_cast<int64_t>(n_items) * (16 + 16 + 4 + 4) + rows * 4 +
         (2 * static_cast<int64_t>(npix) + 3) * 4;
}

// One item's 2 x 2 block (H, W >= 2): its origin in the image, clipped as
// the general kernel clips it, and per corner j = 2 * r + q the weight
// and its two derivatives.
struct Block {
  int y0, x0;
  float cw[4], cy[4], cx[4];
};

__device__ __forceinline__ Block block_of(float py, float px, int H, int W) {
  const float fy = fminf(fmaxf(floorf(py), 0.f), static_cast<float>(H - 2));
  const float fx = fminf(fmaxf(floorf(px), 0.f), static_cast<float>(W - 2));
  float wy[2], dwy[2], wx[2], dwx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    block_weight(py, fy + r, &wy[r], &dwy[r]);
    block_weight(px, fx + r, &wx[r], &dwx[r]);
  }
  Block k;
  k.y0 = static_cast<int>(fy);
  k.x0 = static_cast<int>(fx);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = j >> 1, q = j & 1;
    k.cw[j] = wy[r] * wx[q];
    k.cy[j] = dwy[r] * wx[q];
    k.cx[j] = wy[r] * dwx[q];
  }
  return k;
}

// Item it of the tile at (oy0, ox0): its index in d_offset's items and its
// sample's coordinate (py, px); -1 past the map's last row or column.
template <typename TO>
__device__ __forceinline__ int64_t tile_item(const FastShape& g,
                                             const TO* __restrict__ offset,
                                             int b, int oy0, int ox0, int it,
                                             float* py, float* px) {
  const int K = g.kh * g.kw;
  const int st = it / K, k = it - st * K;
  const int oy = oy0 + st / g.tx, ox = ox0 + st % g.tx;
  if (oy >= g.Ho || ox >= g.Wo) return -1;
  const int64_t item = ((static_cast<int64_t>(b) * g.Ho + oy) * g.Wo + ox) *
                           K + k;
  const int by = oy * g.stride - (g.kh - 1) / 2 * g.dilation +
                 k / g.kw * g.dilation;
  const int bx = ox * g.stride - (g.kw - 1) / 2 * g.dilation +
                 k % g.kw * g.dilation;
  *py = static_cast<float>(by) + f32(offset[2 * item]);
  *px = static_cast<float>(bx) + f32(offset[2 * item + 1]);
  return item;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Rows [r0, r1) of one chunk (the footprint's pixels, then the slots) into
// a ring stage by cp.async, 16 bytes a copy, left in flight; src[row] is the
// row's first element in x (of this image) or dcols, or -1 (zeros); zeros
// past Cin (a multiple of a lane's channels: a copy is all in or all out).
template <typename T>
__device__ __forceinline__ void fast_copy(char* stage, const T* img,
                                          const T* dcols, const int* src,
                                          int npix, int r0, int r1, int cin,
                                          int c0) {
  constexpr int PER = kRow<T> / 16;
  for (int q = threadIdx.x + r0 * PER; q < r1 * PER; q += F_THREADS) {
    const int row = q / PER;
    const int c = c0 + (q % PER) * kNV<T>;
    const int off = src[row];
    const bool in = off >= 0 && c < cin;
    const T* from = in ? (row < npix ? img : dcols) + off + c : img;
    cp_async16(stage + q * 16, from, in ? 16 : 0);
  }
}

// The buckets' starts from their counts (bstart[1 + bucket]): a prefix sum
// over bstart[0 .. n] by one warp.
__device__ __forceinline__ void bucket_starts(int* bstart, int n) {
  const int lane = threadIdx.x;
  int carry = 0;
  for (int base = 0; base <= n; base += 32) {
    int v = base + lane <= n ? bstart[base + lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (base + lane <= n) bstart[base + lane] = v + carry;
    carry += __shfl_sync(0xffffffffu, v, 31);
  }
}

// 16 bytes (a run's channels) as fp32
__device__ __forceinline__ void widen(const uint4& r, float* f, float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void widen(const uint4& r, float* f, bf16) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The run of a row that lane l reads v-th: l + LANES * (v ^ sw), sw 0 or
// (fp32) 1 on odd groups, so that the two groups of a quarter warp read the
// two halves of their 128-byte rows (distinct banks) at once
__device__ __forceinline__ int lane_run(int l, int v, int sw) {
  return l + LANES * (v ^ sw);
}

// A lane's channels of a row in shared memory, as fp32
template <typename T>
__device__ __forceinline__ void lane_row(const char* row, int l, int sw,
                                         float* f) {
#pragma unroll
  for (int v = 0; v < kV<T>; ++v)
    widen(*reinterpret_cast<const uint4*>(row + lane_run(l, v, sw) * 16),
          f + v * kNV<T>, T());
}

// A lane's channels of chunk c0 of a pixel of x in device memory (px: its
// first channel), zeros past Cin
template <typename T>
__device__ __forceinline__ void lane_img(const T* px, int c0, int cin, int l,
                                         int sw, float* f) {
#pragma unroll
  for (int v = 0; v < kV<T>; ++v) {
    const int c = c0 + lane_run(l, v, sw) * kNV<T>;
    const uint4 raw = c < cin ? __ldg(reinterpret_cast<const uint4*>(px + c))
                              : make_uint4(0u, 0u, 0u, 0u);
    widen(raw, f + v * kNV<T>, T());
  }
}

// The dot product of a lane's channels, in two chains
template <int LV>
__device__ __forceinline__ float dot_lane(const float* d, const float* v) {
  float sa = d[0] * v[0], sb = d[LV / 2] * v[LV / 2];
#pragma unroll
  for (int j = 1; j < LV / 2; ++j) {
    sa = fmaf(d[j], v[j], sa);
    sb = fmaf(d[LV / 2 + j], v[LV / 2 + j], sb);
  }
  return sa + sb;
}

// A pixel's dx (px: its first channel) += a * v over a lane's channels of
// chunk c0, by float4 reductions, each unless all 4 are zero or past Cin
template <typename T>
__device__ __forceinline__ void red_lane(float* px, int c0, int cin, int l,
                                         int sw, float a, const float* v) {
#pragma unroll
  for (int u = 0; u < kLV<T>; u += 4) {
    const int c =
        c0 + lane_run(l, u / kNV<T>, sw) * kNV<T> + u % kNV<T>;
    const float4 q = make_float4(a * v[u], a * v[u + 1], a * v[u + 2],
                                 a * v[u + 3]);
    if (c < cin && (q.x != 0.f || q.y != 0.f || q.z != 0.f || q.w != 0.f))
      atomicAdd(reinterpret_cast<float4*>(px + c), q);
  }
}

template <typename T, typename TO>
__global__ void __launch_bounds__(F_THREADS, 2) deform_exact_bwd_fast_kernel(
    const T* __restrict__ dcols, const T* __restrict__ x,
    const TO* __restrict__ offset, const T* __restrict__ mask,
    float* __restrict__ dx, TO* __restrict__ doffset,
    T* __restrict__ dmask, float* __restrict__ part, FastShape g) {
  constexpr int CC = kCC<T>, LV = kLV<T>, ROW = kRow<T>;
  extern __shared__ float4 smem4[];
  const int K = g.kh * g.kw;
  const int n_items = g.ty * g.tx * K;
  const int npix = g.fh * g.fw;
  const int rows = npix + n_items;
  char* ring = reinterpret_cast<char*>(smem4);   // [F_STAGES][rows][ROW]
  float4* sw = reinterpret_cast<float4*>(ring + F_STAGES * rows * ROW);
  float* ssum = reinterpret_cast<float*>(sw + n_items);    // [slot][4]
  int* spk = reinterpret_cast<int*>(ssum + 4 * n_items);
  int* sorted = spk + n_items;                    // the slot's item
  int* src = sorted + n_items;                    // [rows]
  int* bstart = src + rows;                       // [npix + 2]
  int* active = bstart + npix + 2;                // [npix], then its length
  int* n_active = active + npix;
  // before the sort, in item order, each item's weights, bucket, rank in
  // it, packed word and dcols row wait in the ring's second stage
  float4* tw = reinterpret_cast<float4*>(ring + rows * ROW);
  int* tbucket = reinterpret_cast<int*>(tw + n_items);
  int* trank = tbucket + n_items;
  int* tpk = trank + n_items;
  int* tsrc = tpk + n_items;

  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / g.tiles_x) * g.ty;
  const int ox0 = (blockIdx.x % g.tiles_x) * g.tx;
  // the footprint's origin: the tile's first tap row and column, less R
  const int y0 = oy0 * g.stride - (g.kh - 1) / 2 * g.dilation - g.halo;
  const int x0 = ox0 * g.stride - (g.kw - 1) / 2 * g.dilation - g.halo;
  const int ch_begin = blockIdx.z * g.chunks_per_split;
  const int n = min(ch_begin + g.chunks_per_split, g.n_chunks) - ch_begin;
  const int64_t img0 = static_cast<int64_t>(b) * g.H * g.W * g.Cin;
  const T* img = x + img0;
  float* dimg = dx + img0;

  for (int row = threadIdx.x; row < npix; row += F_THREADS) {
    const int gy = y0 + row / g.fw, gx = x0 + row % g.fw;
    src[row] = gy >= 0 && gy < g.H && gx >= 0 && gx < g.W
                   ? (gy * g.W + gx) * g.Cin
                   : -1;
  }
  for (int i = threadIdx.x; i < npix + 2; i += F_THREADS) bstart[i] = 0;
  if (threadIdx.x == 0) *n_active = 0;
  __syncthreads();
  if (!(DROP & 1) && n > 0)                  // chunk 0's x, in flight
    fast_copy(ring, img, dcols, src, npix, 0, npix, g.Cin, ch_begin * CC);
  // each item's block, weights, packed word and dcols row; items are
  // counted by their bucket (the anchor, or npix for an overflow item),
  // the count's return their rank in it
  for (int it = threadIdx.x; it < n_items; it += F_THREADS) {
    float py, px;
    const int64_t item = tile_item(g, offset, b, oy0, ox0, it, &py, &px);
    int bucket = -1;
    if (item >= 0) {
      const Block c = block_of(py, px, g.H, g.W);
      const float m = mask != nullptr ? f32(mask[item]) : 1.f;
      int bits = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c.cw[j] != 0.f || c.cy[j] != 0.f || c.cx[j] != 0.f)
          bits |= 1 << j;
      const int ay = c.y0 - y0, ax = c.x0 - x0;
      const bool inside = ay >= 0 && ay <= g.fh - 2 && ax >= 0 &&
                          ax <= g.fw - 2;
      bucket = inside ? ay * g.fw + ax : npix;
      tpk[it] = (inside ? bucket : c.y0 * g.W + c.x0) << 4 | bits;
      tw[it] = make_float4(m * c.cw[0], m * c.cw[1], m * c.cw[2],
                           m * c.cw[3]);
      tsrc[it] = static_cast<int>(item * g.Cin);
      trank[it] = atomicAdd(bstart + bucket + 1, 1);
    }
    tbucket[it] = bucket;
  }
  __syncthreads();
  if (threadIdx.x < 32) bucket_starts(bstart, npix + 1);
  __syncthreads();
  // each item into its slot; each footprint pixel in the image that an
  // inside item reaches (anchored at it or at its left, upper or
  // upper-left neighbour) onto the footprint pass's list
  for (int it = threadIdx.x; it < n_items; it += F_THREADS) {
    const int bucket = tbucket[it];
    if (bucket < 0) continue;
    const int pos = bstart[bucket] + trank[it];
    sorted[pos] = it;
    sw[pos] = tw[it];
    spk[pos] = tpk[it];
    src[npix + pos] = tsrc[it];
  }
  for (int pix = threadIdx.x; pix < npix; pix += F_THREADS) {
    const int py = pix / g.fw, px = pix - py * g.fw;
    const int gy = y0 + py, gx = x0 + px;
    if (gy < 0 || gy >= g.H || gx < 0 || gx >= g.W) continue;
    int reach = bstart[pix + 1] - bstart[px > 0 ? pix - 1 : pix];
    if (py > 0)
      reach += bstart[pix - g.fw + 1] -
               bstart[px > 0 ? pix - g.fw - 1 : pix - g.fw];
    if (reach > 0) active[atomicAdd(n_active, 1)] = pix;
  }
  __syncthreads();
  const int n_inside = bstart[npix];
  const int n_valid = bstart[npix + 1];
  const int n_rows = npix + n_valid;
  const int n_dx = *n_active;
  if (!(DROP & 4) && n > 0)                  // chunk 0's dcols, in flight
    fast_copy(ring, img, dcols, src, npix, npix, n_rows, g.Cin,
              ch_begin * CC);
  for (int i = threadIdx.x; i < 4 * n_valid; i += F_THREADS) ssum[i] = 0.f;

  const int lane = threadIdx.x & 31;
  const int l = lane & (LANES - 1);           // lane within the group
  const int group = threadIdx.x / LANES;
  const int swz = kV<T> > 1 ? group & 1 : 0;
  const unsigned gmask = ((1u << LANES) - 1) << (lane & ~(LANES - 1));
  for (int i = 0; i < n; ++i) {
    const int c0 = (ch_begin + i) * CC;
    const char* sx = ring + (i % F_STAGES) * rows * ROW;
    const char* sdc = sx + npix * ROW;
    cp_async_wait_all();
    __syncthreads();                 // chunk i landed; chunk i - 1 read
    if (i + 1 < n) {
      char* next = ring + ((i + 1) % F_STAGES) * rows * ROW;
      if (!(DROP & 1))
        fast_copy(next, img, dcols, src, npix, 0, npix, g.Cin, c0 + CC);
      if (!(DROP & 4))
        fast_copy(next, img, dcols, src, npix, npix, n_rows, g.Cin,
                  c0 + CC);
    }
    // the dot products S, one slot per group: per live corner the lane's
    // channels, the lanes' parts summed in a fixed order, added to the
    // slot's sums in chunk order; an overflow slot reads x and adds its dx
    // in device memory
    for (int s = group; s < n_valid; s += F_GROUPS) {
      const int pk = spk[s];
      const int bits = pk & 15;
      const bool over = s >= n_inside;
      float d[LV];
      lane_row<T>(sdc + s * ROW, l, swz, d);
      // the corners' channels: in shared memory, or in device memory
      const int at = pk >> 4;
      const int pitch = over ? g.W : g.fw;
      if (!(DROP & 1)) {
        float sp[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sp[j] = 0.f;
          if (!(bits & (1 << j))) continue;             // group-uniform
          const int p = at + (j >> 1) * pitch + (j & 1);
          float v[LV];
          if (!over)
            lane_row<T>(sx + p * ROW, l, swz, v);
          else
            lane_img<T>(img + p * g.Cin, c0, g.Cin, l, swz, v);
          sp[j] = dot_lane<LV>(d, v);
        }
        // the lanes' parts summed as (l0 + l1) + (l2 + l3), scattered so
        // that lane l ends with corner l's sum: pairs over lanes l, l ^ 1
        // for the corners of l's parity, then over lanes l, l ^ 2
        const int odd = l & 1;
        const float p0 = (odd ? sp[1] : sp[0]) +
                         __shfl_xor_sync(gmask, odd ? sp[0] : sp[1], 1,
                                         LANES);
        const float p1 = (odd ? sp[3] : sp[2]) +
                         __shfl_xor_sync(gmask, odd ? sp[2] : sp[3], 1,
                                         LANES);
        const float sum = (l & 2 ? p1 : p0) +
                          __shfl_xor_sync(gmask, l & 2 ? p0 : p1, 2, LANES);
        if (bits & (1 << l)) ssum[4 * s + l] += sum;
      }
      if (over) {
        const float4 w4 = sw[s];
        const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (w[j] == 0.f || ((DROP & 2) && d[0] != NEVER)) continue;
          red_lane<T>(dimg + (at + (j >> 1) * g.W + (j & 1)) * g.Cin, c0,
                      g.Cin, l, swz, w[j], d);
        }
      }
    }
    // dx, one listed footprint pixel a group: the sum over the inside
    // slots anchored at the pixel and at its left, upper and upper-left
    // neighbours (per row, two adjacent buckets: one contiguous run), two
    // slots at a time, then one reduction into device memory for each 4
    // channels
    for (int q = group; !(DROP & 16) && q < n_dx; q += F_GROUPS) {
      const int pix = active[q];
      const int py = pix / g.fw, px = pix - py * g.fw;
      float acc[LV];
#pragma unroll
      for (int j = 0; j < LV; ++j) acc[j] = 0.f;
#pragma unroll
      for (int a = 0; a < 2; ++a) {      // the anchor's row: pixel - a rows
        if (py < a) continue;
        const int own = pix - a * g.fw;
        const int mid = bstart[own];
        const int lo = px > 0 ? bstart[own - 1] : mid;
        const int hi = bstart[own + 1];
        for (int t0 = lo; t0 < hi; t0 += 2) {
          float w[2], v[2][LV];
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // before mid: the left neighbour's
            const int t = min(t0 + h, hi - 1);
            const float4 w4 = sw[t];
            w[h] = t0 + h >= hi ? 0.f
                   : t < mid    ? (a ? w4.w : w4.y)
                                : (a ? w4.z : w4.x);
            lane_row<T>(sdc + t * ROW, l, swz, v[h]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < LV; ++j) acc[j] = fmaf(w[h], v[h][j], acc[j]);
        }
      }
      if ((DROP & 2) && acc[0] != NEVER) continue;
      red_lane<T>(dimg + ((y0 + py) * g.W + x0 + px) * g.Cin, c0, g.Cin, l,
                  swz, 1.f, acc);
    }
  }
  __syncthreads();

  // d_mask and d_offset: the sums weighted by the corners' weights and
  // derivatives, computed again from the offsets, in corner order; under a
  // channel split, partials
  for (int s = threadIdx.x; s < n_valid; s += F_THREADS) {
    float py, px;
    const int64_t item =
        tile_item(g, offset, b, oy0, ox0, sorted[s], &py, &px);
    const Block c = block_of(py, px, g.H, g.W);
    const int bits = spk[s] & 15;
    float s_m = 0.f, s_y = 0.f, s_x = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!(bits & (1 << j))) continue;
      const float sp = ssum[4 * s + j];
      s_m += c.cw[j] * sp;
      s_y += c.cy[j] * sp;
      s_x += c.cx[j] * sp;
    }
    if (part != nullptr) {                    // channel split: partials
      float* dst = part + (static_cast<int64_t>(blockIdx.z) * gridDim.y *
                               g.Ho * g.Wo * K + item) * 3;
      dst[0] = s_m;
      dst[1] = s_y;
      dst[2] = s_x;
    } else {
      const float m = mask != nullptr ? f32(mask[item]) : 1.f;
      if (dmask != nullptr) st(dmask + item, s_m);
      st(doffset + 2 * item, m * s_y);
      st(doffset + 2 * item + 1, m * s_x);
    }
  }
}

// the splits' partials summed in split order: d_mask, d_offset
template <typename T, typename TO>
__global__ void deform_exact_bwd_finish_kernel(const float* __restrict__ part,
                                               const T* __restrict__ mask,
                                               TO* __restrict__ doffset,
                                               T* __restrict__ dmask,
                                               int64_t items, int n_split) {
  const int64_t item = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
  if (item >= items) return;
  float s_m = 0.f, s_y = 0.f, s_x = 0.f;
  for (int z = 0; z < n_split; ++z) {
    const float* p = part + (z * items + item) * 3;
    s_m += p[0];
    s_y += p[1];
    s_x += p[2];
  }
  const float m = mask != nullptr ? f32(mask[item]) : 1.f;
  if (dmask != nullptr) st(dmask + item, s_m);
  st(doffset + 2 * item, m * s_y);
  st(doffset + 2 * item + 1, m * s_x);
}

// dx's fp32 sums rounded to bf16, 8 a thread (the fast route: n a multiple
// of 8, both 16-byte aligned)
__global__ void deform_exact_bwd_round8_kernel(const float4* __restrict__ dx32,
                                               uint4* __restrict__ dx,
                                               int64_t n8) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n8; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float4 a = dx32[2 * i], b = dx32[2 * i + 1];
    const __nv_bfloat162 h[4] = {__floats2bfloat162_rn(a.x, a.y),
                                 __floats2bfloat162_rn(a.z, a.w),
                                 __floats2bfloat162_rn(b.x, b.y),
                                 __floats2bfloat162_rn(b.z, b.w)};
    dx[i] = *reinterpret_cast<const uint4*>(h);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Whether the fast route can take a call (deform_exact_bwd.py:
// exact_bwd_fast): H and W at least 2, Cin a multiple of a lane's channels
// (4 fp32, 8 bf16), dcols, x, dx's sums and (bf16) dx 16-byte aligned, x
// and dcols indexed by 32-bit offsets and an image's pixels by 27 bits.
template <typename T>
bool fast_fits(const T* dcols, const T* x, const float* dx, const bf16* dxh,
               int B, int H, int W, int Cin, int Ho, int Wo, int K) {
  return H >= 2 && W >= 2 && Cin % kNV<T> == 0 && aligned(dcols, 16) &&
         aligned(x, 16) && aligned(dx, 16) &&
         (dxh == nullptr || aligned(dxh, 16)) &&
         static_cast<int64_t>(H) * W < (int64_t{1} << 27) &&
         static_cast<int64_t>(B) * H * W * Cin < (int64_t{1} << 31) &&
         static_cast<int64_t>(B) * Ho * Wo * K * Cin < (int64_t{1} << 31);
}

// dx: the fp32 sums (the bf16 entries' scratch), zeroed here; dxh: the bf16
// dx they are rounded into (bf16 only).  route: 0 the general kernel, 1 the
// fast route with the plan ty .. smem (refused where fast_fits does not
// hold or the plan does not fit; part: [n_split, items, 3] scratch where
// n_split > 1, else null).
template <typename T, typename TO>
int run(const T* dcols, const T* x, const TO* offset, const T* mask,
        float* dx, bf16* dxh, TO* doffset, T* dmask, float* part, int B,
        int H, int W, int Cin, int Ho, int Wo, int kh, int kw, int stride,
        int dilation, int route, int ty, int tx, int fh, int fw, int halo,
        int n_split, int smem, void* stream_) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (B < 0 || H < 1 || W < 1 || Cin < 1 || Ho < 0 || Wo < 0 || kh < 1 ||
      kw < 1 || stride < 1 || dilation < 1 || route < 0 || route > 1)
    return cudaErrorInvalidValue;
  const int64_t items64 = static_cast<int64_t>(B) * Ho * Wo * kh * kw;
  const int64_t n_dx = static_cast<int64_t>(B) * H * W * Cin;
  if (items64 * Cin >= (int64_t{1} << 31) || n_dx >= (int64_t{1} << 31))
    return cudaErrorInvalidValue;
  const bool fast = route == 1;
  if (fast &&
      (!fast_fits(dcols, x, dx, dxh, B, H, W, Cin, Ho, Wo, kh * kw) ||
       ty < 1 || tx < 1 || halo < 0 || n_split < 1 ||
       (n_split > 1) != (part != nullptr) ||
       fh < (ty - 1) * stride + (kh - 1) * dilation + 2 * halo + 2 ||
       fw < (tx - 1) * stride + (kw - 1) * dilation + 2 * halo + 2 ||
       smem < fast_smem(fh * fw, ty * tx * kh * kw, kRow<T>) ||
       smem > SMEM_MAX))
    return cudaErrorInvalidValue;
  constexpr bool keep_dx = kF32<T> || !(DROP & 8);
  cudaError_t e = cudaSuccess;
  if (keep_dx) {
    e = cudaMemsetAsync(dx, 0, n_dx * sizeof(float), stream);
    if (e != cudaSuccess) return e;
  }
  if (items64 > 0 && fast) {
    auto* kern = deform_exact_bwd_fast_kernel<T, TO>;
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    const int n_chunks = (Cin + kCC<T> - 1) / kCC<T>;
    const FastShape g{H,  W,  Cin, Ho,   Wo,
                      kh, kw, stride, dilation,
                      ty, tx, fh, fw, halo,
                      (Wo + tx - 1) / tx, (n_chunks + n_split - 1) / n_split,
                      n_chunks};
    const dim3 grid(((Ho + ty - 1) / ty) * g.tiles_x, B, n_split);
    kern<<<grid, F_THREADS, smem, stream>>>(dcols, x, offset, mask, dx,
                                            doffset, dmask, part, g);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    if (part != nullptr) {
      deform_exact_bwd_finish_kernel<T, TO>
          <<<static_cast<unsigned>((items64 + 255) / 256), 256, 0, stream>>>(
              part, mask, doffset, dmask, items64, n_split);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
  } else if (items64 > 0) {
    const Shape g{H, W, Cin, Ho, Wo, kh, kw, stride, dilation,
                  static_cast<int>(items64)};
    const unsigned blocks =
        static_cast<unsigned>((items64 + WARPS - 1) / WARPS);
    const bool vec4 = Cin % 4 == 0 && aligned(dcols, 4 * sizeof(T)) &&
                      aligned(x, 4 * sizeof(T)) && aligned(dx, 16);
    if (vec4)
      deform_exact_bwd_kernel<4, T, TO><<<blocks, THREADS, 0, stream>>>(
          dcols, x, offset, mask, dx, doffset, dmask, g);
    else
      deform_exact_bwd_kernel<1, T, TO><<<blocks, THREADS, 0, stream>>>(
          dcols, x, offset, mask, dx, doffset, dmask, g);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if constexpr (!kF32<T>) {
    if (keep_dx && n_dx > 0) {
      const unsigned grid = static_cast<unsigned>(
          std::min<int64_t>(((fast ? n_dx / 8 : n_dx) + 255) / 256, 4096));
      if (fast)
        deform_exact_bwd_round8_kernel<<<grid, 256, 0, stream>>>(
            reinterpret_cast<const float4*>(dx), reinterpret_cast<uint4*>(dxh),
            n_dx / 8);
      else
        deform_exact_bwd_round_kernel<<<grid, 256, 0, stream>>>(dx, dxh,
                                                                n_dx);
      e = cudaGetLastError();
    }
  }
  return e;
}

}  // namespace

// dcols [B*Ho*Wo, K*Cin], x [B, H, W, Cin], offset [B, Ho, Wo, 2K] (raw),
// mask [B, Ho, Wo, K] or null -> dx (zeroed here), d_offset, d_mask (null
// without the mask); every tensor contiguous.  route: the wrapper's
// (exact_bwd_fast), 1 the fast route with its plan (exact_bwd_plan: tiles
// of ty x tx sites, footprints of fh x fw pixels with a halo of halo
// pixels, n_split channel splits with part [n_split, B*Ho*Wo*K, 3] scratch
// where n_split > 1, smem bytes of dynamic shared memory), 0 the general
// kernel (the plan ignored); a fast call that the fast route cannot take
// returns cudaErrorInvalidValue and launches nothing.
extern "C" int stmask_deform_exact_bwd(const float* dcols, const float* x,
                                       const float* offset, const float* mask,
                                       float* dx, float* doffset, float* dmask,
                                       float* part, int B, int H, int W,
                                       int Cin, int Ho, int Wo, int kh,
                                       int kw, int stride, int dilation,
                                       int route, int ty, int tx, int fh,
                                       int fw, int halo, int n_split,
                                       int smem, void* stream) {
  return run<float, float>(dcols, x, offset, mask, dx, nullptr, doffset,
                           dmask, part, B, H, W, Cin, Ho, Wo, kh, kw, stride,
                           dilation, route, ty, tx, fh, fw, halo, n_split,
                           smem, stream);
}

// As stmask_deform_exact_bwd with dcols, x, mask, offset, dx, d_offset and
// d_mask bf16; dx32: [B, H, W, Cin] fp32 scratch, zeroed here, where dx
// sums before it is rounded into dx.
extern "C" int stmask_deform_exact_bwd_bf16(
    const __nv_bfloat16* dcols, const __nv_bfloat16* x,
    const __nv_bfloat16* offset, const __nv_bfloat16* mask, float* dx32,
    __nv_bfloat16* dx, __nv_bfloat16* doffset, __nv_bfloat16* dmask,
    float* part, int B, int H, int W, int Cin, int Ho, int Wo, int kh,
    int kw, int stride, int dilation, int route, int ty, int tx, int fh,
    int fw, int halo, int n_split, int smem, void* stream) {
  return run(dcols, x, offset, mask, dx32, dx, doffset, dmask, part, B, H, W,
             Cin, Ho, Wo, kh, kw, stride, dilation, route, ty, tx, fh, fw,
             halo, n_split, smem, stream);
}

// As stmask_deform_exact_bwd_bf16 with fp32 offsets and d_offset (FCB's
// analytic offsets).
extern "C" int stmask_deform_exact_bwd_bf16_f32off(
    const __nv_bfloat16* dcols, const __nv_bfloat16* x, const float* offset,
    const __nv_bfloat16* mask, float* dx32, __nv_bfloat16* dx,
    float* doffset, __nv_bfloat16* dmask, float* part, int B, int H, int W,
    int Cin, int Ho, int Wo, int kh, int kw, int stride, int dilation,
    int route, int ty, int tx, int fh, int fw, int halo, int n_split,
    int smem, void* stream) {
  return run(dcols, x, offset, mask, dx32, dx, doffset, dmask, part, B, H, W,
             Cin, Ho, Wo, kh, kw, stride, dilation, route, ty, tx, fh, fw,
             halo, n_split, smem, stream);
}
