// K4: backward of the window-clamped modulated deformable gather (col2im),
// NHWC.  Entries: fp32; bf16 (dcols, x, mask, dx and d_mask bf16; the
// offsets and d_offset bf16, or fp32 beside bf16 data).
//
// Replaces: the custom VJP of stmask_tpu/ops/deform_conv.py::
// _make_window_gather (deform_conv.py:152-267) together with the autodiff
// of the hat weights and the modulation in deform_conv2d_window
// (deform_conv.py:270-351), the path the JAX package trains its 7 backbone
// DCN sites through.  The weight and column gradients (the transpose of the
// jnp.dot at deform_conv.py:347) stay two torch.matmul calls in the caller.
//
// For each output site s = (b, oy, ox) and tap k, with the offset (dy, dx)
// already clamped to [-r, r] and the modulation m, the forward sampled
//
//   v[c] = sum_{u, w} hy_u * hx_w * x[b, by + u, bx + w, c]
//   hy_u = max(0, 1 - |dy - u|) for the window corners u in [-r, r + 1]
//
// (by, bx: the tap's grid position; pixels outside the image are zero),
// and wrote cols[s, k * Cin + c] = m * v[c].  Given dcols = dL/dcols:
//
//   dx[b, by + u, bx + w, c] += m * hy_u * hx_w * dcols[s, k, c]
//   d_mask[s, k]     = sum_c dcols * v            = sum_{u,w} hy hx S_uw
//   d_offset[s, k, 0] = m * sum_{u,w} dhy_u hx_w S_uw
//   d_offset[s, k, 1] = m * sum_{u,w} hy_u dhx_w S_uw
//   S_uw = sum_c dcols[s, k, c] * x[b, by + u, bx + w, c]
//
// dhy_u is JAX's derivative of the hat at d = dy - u: -sign(d) for
// 0 < |d| < 1, -1 at d == 0 (JAX's d|x|/dx is 1 at 0), -0.5 * sign(d) at
// |d| == 1 (jnp.maximum splits a tie), 0 beyond, and 0 for a corner outside
// the window.  Only u in {floor(dy) - 1, floor(dy), floor(dy) + 1} can have
// |d| <= 1, so a tap has at most 3 x 3 corner pairs; at a non-integer
// offset 2 x 2 of them carry weight.  The clip's own factor (1, 0.5 at
// +-r, 0 beyond) is applied by the caller.
//
// What bounds it on an H100: bytes.  dcols ([B*Ho*Wo, K*Cin]) is read once:
// 17.7 M floats a frame over the 7 sites, 566 MB a step at 8 frames
// (0.17 ms at 3.35 TB/s).  A scatter with one fp32 atomic in device memory
// per (site, tap, corner, channel) cannot get near that (~0.57 G atomics a
// step ran at ~0.2 G/ms), and neither can atomics in shared memory: sm_90
// has no fp32 add there, so each is a compare-and-swap loop.
//
// Design: one block per output tile of TY x TX sites of one image, all K
// taps ("items": (site, tap) pairs), walking Cin in chunks of CC = 32
// channels (blockIdx.z may take a share of the chunks: the channel split
// that fills the card at the small sites).  Every corner of the tile's
// windows lies in the footprint, the FH x FW input pixels from
// (oy0 * stride - pad_h - r, ox0 * stride - pad_w - r); the wrapper
// computes the tile and the footprint (deform_col2im.py: col2im_plan) and
// this file only checks them.  256 threads and at most 64 registers, so
// that 4 blocks share an SM and one block's loads overlap another's work.
//
// Once per block, each item's corner weights are computed and the items
// are sorted by their anchor, the corner (fy, fx): an item's weighted
// corners are the anchor and its right, lower and lower-right neighbours.
// The sort is a counting sort, stable (one warp ranks 32 items at a time),
// so every launch takes the same order.  Per chunk, cp.async brings x over
// the footprint and the items' dcols rows (read once, coalesced, in bucket
// order) into shared memory, and two passes read only shared memory:
//   items:  4 lanes an item, 8 channels a lane: per corner the lane's part
//           of S, folded into the three sums by the corner's weights; a
//           fixed butterfly reduces them and the leader adds them to the
//           item's sums, in chunk order;
//   pixels: 4 lanes a footprint pixel gather its dx from two contiguous
//           runs of buckets (its own and its left neighbour's, then the row
//           above's), and add it to device memory with two float4
//           reductions (atomicAdd on float4, sm_90).
// Each pixel has one owner, so dx needs no atomic in shared memory; tiles
// overlap by their halo, so its reduction into device memory stays atomic
// and dx's low bits depend on the order of the adds.  d_mask and d_offset
// are written once at the end (under a channel split, the splits' partials
// are summed in split order by a second small kernel), so they are
// bit-identical across launches.
//
// The bf16 entries (the JAX package's VJP gives their types: bf16 dx and
// d_mask; d_offset in the offsets' type) keep every sum in fp32: dx into an
// fp32 buffer that the entry zeroes and then rounds to bf16 (a third small
// kernel; tiles overlap by their halo, so no block can round its pixels),
// d_offset and d_mask rounded once, when they are written.  The wrapper
// names one of two routes (deform_col2im.py: col2im_fast, col2im_plan):
//   general: the kernel above on values converted to fp32 as they are read
//            (dcols and x by plain loads of 4 channels into the same fp32
//            shared memory), for ragged Cin and unaligned pointers;
//   fast:    Cin a multiple of 8, dcols, x, dx32 and dx 16-byte aligned
//            (every R50, R101 and FCB training site):
//            deform_col2im_bf16_fast_kernel below.  The general route's
//            synchronous loads and its dx pass set its time (a split of it
//            by builds with parts left out: kernels/split.py, PERF.md); its
//            fp32 rows also double the shared memory that bounds its tile.
//            The fast route stages the bf16 rows as they are, by cp.async
//            in a ring of two chunks that overlaps the next chunk's copies
//            with both passes, widens them only in registers, and keeps 16
//            words an item instead of 26, so that two blocks of 512 threads
//            share an SM at tiles of 30 to 48 sites (4 x 4 in the general
//            route).  dx's zeroing and rounding stay two launches beside
//            it, vectorised.

#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

// Measurement builds only (stmask_torch/kernels/split.py; the library's own
// build leaves it 0): STMASK_COL2IM_DROP leaves parts of the bf16 entries'
// work out, bit 1 the copies into shared memory, 2 the dot-product pass, 4
// the dx pass, 8 the dx reductions into device memory (kept behind a test
// that never holds, so that the sums stay), 16 the zeroing and rounding of
// dx's fp32 sums.  The fp32 entry ignores it.
#ifndef STMASK_COL2IM_DROP
#define STMASK_COL2IM_DROP 0
#endif

namespace {

using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;
// the parts a measurement build leaves out of the entries of type T
template <typename T>
constexpr int kDrop = kF32<T> ? 0 : STMASK_COL2IM_DROP;
// A value no sum takes: a dropped reduction is kept behind v == NEVER.
constexpr float NEVER = -1.2345e-38f;

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four bf16 channels at p (8-byte aligned) as fp32.
__device__ __forceinline__ float4 ld_bf16x4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

constexpr int CC = 32;            // channels per chunk
constexpr int LANES = 4;          // lanes an item or a pixel, 8 channels each
constexpr int THREADS = 256;      // 4 blocks an SM: at most 64 registers
constexpr int GROUPS = THREADS / LANES;
constexpr int GEO = 4;            // float4s of geometry per item
constexpr int VALID = 1 << 20;    // item flag beside the 9 corner bits

// hat weight and JAX's derivative of it for the corner u of the coordinate
// offset d (see above); ``in_win`` false zeroes both.
__device__ __forceinline__ void hat(float d_off, int u, bool in_win,
                                    float* h, float* dh) {
  const float d = d_off - static_cast<float>(u);
  const float z = 1.f - fabsf(d);
  const float fac = z > 0.f ? 1.f : (z == 0.f ? 0.5f : 0.f);
  *h = in_win ? fmaxf(0.f, z) : 0.f;
  *dh = in_win ? (d >= 0.f ? -fac : fac) : 0.f;
}

__device__ __forceinline__ float dot(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& v) {
  acc.x += a * v.x;
  acc.y += a * v.y;
  acc.z += a * v.z;
  acc.w += a * v.w;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
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

struct Shape {
  int H, W, Cin, Ho, Wo, kh, kw, stride, dilation, radius;
  int ty, tx, fh, fw, tiles_x, chunks_per_split, n_chunks;
};

// item it (tap-major: it = k * ts + site of the tile) -> its output site
// (b, oy, ox), or -1 past the image's last row or column
__device__ __forceinline__ int64_t item_site(const Shape& g, int b, int oy0,
                                             int ox0, int it, int* k) {
  const int ts = g.ty * g.tx;
  *k = it / ts;
  const int st = it - *k * ts;
  const int oy = oy0 + st / g.tx, ox = ox0 + st % g.tx;
  if (oy >= g.Ho || ox >= g.Wo) return -1;
  return (static_cast<int64_t>(b) * g.Ho + oy) * g.Wo + ox;
}

// One item's corners (the general kernel computes the same inline), from
// its site's offset and mask: the footprint row and column (ry, rx) of its
// corner (fy - 1, fx - 1), m, the hats and
// their derivatives at the rows fy - 1 .. fy + 1 (hy, dhy) and the columns
// fx - 1 .. fx + 1 (hx, dhx), the corners with a weight or a derivative
// (bits 0-8, beside VALID), and the anchor (ay, ax), the corner (fy, fx)
// clamped into the footprint, with w, m * hy * hx at the four corners
// anchor + (a, e) that can carry a weight.
struct ItemCorners {
  int ry, rx, bits, ay, ax;
  float m, hy[3], dhy[3], hx[3], dhx[3], w[2][2];
};

template <typename T, typename TO>
__device__ __forceinline__ ItemCorners item_corners(
    const Shape& g, const TO* __restrict__ offset, const T* __restrict__ mask,
    int64_t site, int k, int it, int oy0, int ox0, int y0, int x0) {
  ItemCorners c;
  const int K = g.kh * g.kw;
  const int pad_h = (g.kh - 1) / 2 * g.dilation;
  const int pad_w = (g.kw - 1) / 2 * g.dilation;
  const int st = it - k * g.ty * g.tx;
  const int oy = oy0 + st / g.tx, ox = ox0 + st % g.tx;
  const float oyf = f32(offset[site * 2 * K + 2 * k]);
  const float oxf = f32(offset[site * 2 * K + 2 * k + 1]);
  const float m = mask != nullptr ? f32(mask[site * K + k]) : 1.f;
  c.m = m;
  const int fy = static_cast<int>(floorf(oyf));
  const int fx = static_cast<int>(floorf(oxf));
  const int ry = oy * g.stride - pad_h + (k / g.kw) * g.dilation + fy - 1 -
                 y0;
  const int rx = ox * g.stride - pad_w + (k % g.kw) * g.dilation + fx - 1 -
                 x0;
  c.ry = ry;
  c.rx = rx;
  float* hy = c.hy;
  float* dhy = c.dhy;
  float* hx = c.hx;
  float* dhx = c.dhx;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int u = fy - 1 + j;
    hat(oyf, u, u >= -g.radius && u <= g.radius + 1, &hy[j], &dhy[j]);
    const int v = fx - 1 + j;
    hat(oxf, v, v >= -g.radius && v <= g.radius + 1, &hx[j], &dhx[j]);
  }
  int bits = VALID;
#pragma unroll
  for (int p = 0; p < 9; ++p) {
    const int j = p / 3, i = p % 3;
    if (hy[j] * hx[i] != 0.f || dhy[j] * hx[i] != 0.f ||
        hy[j] * dhx[i] != 0.f)
      bits |= 1 << p;
  }
  // the anchor and the weights of the corners anchor + (a, e); a corner
  // row or column before the footprint lies outside the window (weight
  // 0), so the anchor moves onto the next one
  float(*w)[2] = c.w;
  w[0][0] = m * (hy[1] * hx[1]);
  w[0][1] = m * (hy[1] * hx[2]);
  w[1][0] = m * (hy[2] * hx[1]);
  w[1][1] = m * (hy[2] * hx[2]);
  int ay = ry + 1, ax = rx + 1;
  if (ay < 0) {
    for (int e = 0; e < 2; ++e) {
      w[0][e] = ay == -1 ? w[1][e] : 0.f;
      w[1][e] = 0.f;
    }
  }
  if (ax < 0) {
    for (int a = 0; a < 2; ++a) {
      w[a][0] = ax == -1 ? w[a][1] : 0.f;
      w[a][1] = 0.f;
    }
  }
  c.ay = min(max(ay, 0), g.fh - 1);    // past the end: all weights 0
  c.ax = min(max(ax, 0), g.fw - 1);
  c.bits = bits;
  return c;
}

// The buckets' starts from their counts (bstart[1 + anchor]): a prefix sum
// over bstart[0 .. npix] by one warp.
__device__ __forceinline__ void bucket_starts(int* bstart, int npix) {
  const int lane = threadIdx.x;
  int carry = 0;
  for (int base = 0; base <= npix; base += 32) {
    int v = base + lane <= npix ? bstart[base + lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (base + lane <= npix) bstart[base + lane] = v + carry;
    carry += __shfl_sync(0xffffffffu, v, 31);
  }
}

// One channel chunk [c0, c0 + CC) into shared memory, rows [r0, r1) of
// the rows that are first the footprint's pixels (x) and then the tile's
// items (dcols).  src[row] is the row's first element in x or dcols, or -1
// (zeros: outside the image, or past its last output site); zeros past
// Cin.  VEC 4: fp32 by cp.async, left in flight, bf16 by plain loads of 4
// channels; VEC 1: plain loads.  Shared memory holds fp32 either way.
template <int VEC, typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ img,
                                           const T* __restrict__ dcols,
                                           float* sx, const int64_t* src,
                                           int npix, int cin, int c0, int r0,
                                           int r1) {
  constexpr int PER = CC / VEC;
  for (int q = threadIdx.x + r0 * PER; q < r1 * PER; q += THREADS) {
    const int row = q / PER;
    const int c = c0 + (q % PER) * VEC;
    const int64_t off = src[row];
    const bool in = off >= 0 && c < cin;
    const T* from = in ? (row < npix ? img : dcols) + off + c : img;
    float* dst = sx + q * VEC;          // sdc follows sx: rows are contiguous
    if constexpr (VEC == 4 && kF32<T>) {
      cp_async16(dst, from, in ? 16 : 0);
    } else if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(dst) =
          in ? ld_bf16x4(from) : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      *dst = in ? f32(*from) : 0.f;
    }
  }
}

// 4 channels of dx at dst[c, c + 4) (n: the channels left in Cin), one
// reduction into device memory unless all 4 are zero
template <int VEC>
__device__ __forceinline__ void add_dx(float* dst, int c, int n,
                                       const float4& v) {
  if (c >= n || (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f))
    return;
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(dst + c), v);
  } else {
    for (int i = 0; i < 4 && c + i < n; ++i) atomicAdd(dst + c + i,
                                                      comp(v, i));
  }
}

// T: the type of dcols, x and the mask (and of d_mask); TO: the offsets'
// (and d_offset's).  dx: fp32 sums (the output itself in fp32).
template <int VEC, typename T = float, typename TO = T>
__global__ void __launch_bounds__(THREADS, 4) deform_col2im_tile_kernel(
    const T* __restrict__ dcols, const T* __restrict__ x,
    const TO* __restrict__ offset, const T* __restrict__ mask,
    float* __restrict__ dx, TO* __restrict__ doffset,
    T* __restrict__ dmask, float* __restrict__ part, Shape g) {
  extern __shared__ float4 smem4[];
  const int K = g.kh * g.kw;
  const int n_items = g.ty * g.tx * K;
  const int npix = g.fh * g.fw;
  // in bucket order (sorted by anchor): everything but the counts
  float* sx = reinterpret_cast<float*>(smem4);        // [npix][CC]
  float* sdc = sx + npix * CC;                        // [n_items][CC]
  float4* sgeo = reinterpret_cast<float4*>(sdc + n_items * CC);
  float4* sw = sgeo + n_items * GEO;                  // corner weights
  float* ss = reinterpret_cast<float*>(sw + n_items);  // 3 sums an item
  int* sorted = reinterpret_cast<int*>(ss + n_items * 3);  // the item
  // before the sort, each item's geometry and weights wait in sdc
  float4* tmp = reinterpret_cast<float4*>(sdc);
  int* bstart = sorted + n_items;                     // [npix + 1]
  int* cursor = bstart + npix + 1;                    // [npix]
  // the rows' sources: after 4 * n_items + 2 * npix + 1 words and one of
  // padding, 8-byte aligned
  int64_t* src = reinterpret_cast<int64_t*>(cursor + npix + 1);

  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / g.tiles_x) * g.ty;
  const int ox0 = (blockIdx.x % g.tiles_x) * g.tx;
  const int pad_h = (g.kh - 1) / 2 * g.dilation;
  const int pad_w = (g.kw - 1) / 2 * g.dilation;
  const int y0 = oy0 * g.stride - pad_h - g.radius;   // footprint origin
  const int x0 = ox0 * g.stride - pad_w - g.radius;
  const int ch_begin = blockIdx.z * g.chunks_per_split;
  const int ch_end = min(ch_begin + g.chunks_per_split, g.n_chunks);
  const T* img = x + static_cast<int64_t>(b) * g.H * g.W * g.Cin;
  float* dimg = dx + static_cast<int64_t>(b) * g.H * g.W * g.Cin;

  for (int row = threadIdx.x; row < npix; row += THREADS) {
    const int gy = y0 + row / g.fw, gx = x0 + row % g.fw;
    src[row] = gy >= 0 && gy < g.H && gx >= 0 && gx < g.W
                   ? (static_cast<int64_t>(gy) * g.W + gx) * g.Cin
                   : -1;
  }
  for (int i = threadIdx.x; i <= npix; i += THREADS) bstart[i] = 0;
  __syncthreads();
  if (!(kDrop<T> & 1) && ch_begin < ch_end)
    load_chunk<VEC, T>(img, dcols, sx, src, npix, g.Cin, ch_begin * CC, 0,
                       npix);
  // Each item's corner weights, once per block: the footprint index of its
  // corner (fy - 1, fx - 1), the corners with a weight or a derivative
  // (bits 0-8), m, hy, dhy, hx, dhx, and m * hy * hx at the four corners
  // (fy, fx) .. (fy + 1, fx + 1) that can carry a weight.  Items are
  // counted by their anchor, the corner (fy, fx) (clamped into the
  // footprint), for the scatter's buckets.
  for (int it = threadIdx.x; it < n_items; it += THREADS) {
    int k;
    const int64_t site = item_site(g, b, oy0, ox0, it, &k);
    float4 g0 = make_float4(0.f, 0.f, 0.f, 0.f), g1 = g0, g2 = g0, g3 = g0;
    if (site >= 0) {
      const int st = it - k * g.ty * g.tx;
      const int oy = oy0 + st / g.tx, ox = ox0 + st % g.tx;
      const float oyf = f32(offset[site * 2 * K + 2 * k]);
      const float oxf = f32(offset[site * 2 * K + 2 * k + 1]);
      const float m = mask != nullptr ? f32(mask[site * K + k]) : 1.f;
      const int fy = static_cast<int>(floorf(oyf));
      const int fx = static_cast<int>(floorf(oxf));
      const int ry = oy * g.stride - pad_h + (k / g.kw) * g.dilation + fy -
                     1 - y0;
      const int rx = ox * g.stride - pad_w + (k % g.kw) * g.dilation + fx -
                     1 - x0;
      float hy[3], dhy[3], hx[3], dhx[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int u = fy - 1 + j;
        hat(oyf, u, u >= -g.radius && u <= g.radius + 1, &hy[j], &dhy[j]);
        const int v = fx - 1 + j;
        hat(oxf, v, v >= -g.radius && v <= g.radius + 1, &hx[j], &dhx[j]);
      }
      int bits = VALID;
#pragma unroll
      for (int p = 0; p < 9; ++p) {
        const int j = p / 3, i = p % 3;
        if (hy[j] * hx[i] != 0.f || dhy[j] * hx[i] != 0.f ||
            hy[j] * dhx[i] != 0.f)
          bits |= 1 << p;
      }
      // the anchor and the weights of the corners anchor + (a, e); a
      // corner row or column before the footprint lies outside the window
      // (weight 0), so the anchor moves onto the next one
      float w[2][2] = {{m * (hy[1] * hx[1]), m * (hy[1] * hx[2])},
                       {m * (hy[2] * hx[1]), m * (hy[2] * hx[2])}};
      int ay = ry + 1, ax = rx + 1;
      if (ay < 0) {
        for (int e = 0; e < 2; ++e) {
          w[0][e] = ay == -1 ? w[1][e] : 0.f;
          w[1][e] = 0.f;
        }
      }
      if (ax < 0) {
        for (int a = 0; a < 2; ++a) {
          w[a][0] = ax == -1 ? w[a][1] : 0.f;
          w[a][1] = 0.f;
        }
      }
      ay = min(max(ay, 0), g.fh - 1);      // past the end: all weights 0
      ax = min(max(ax, 0), g.fw - 1);
      g0 = make_float4(__int_as_float(ry * g.fw + rx), __int_as_float(bits),
                       __int_as_float(ay * g.fw + ax), hy[0]);
      g1 = make_float4(hy[1], hy[2], dhy[0], dhy[1]);
      g2 = make_float4(dhy[2], hx[0], hx[1], hx[2]);
      g3 = make_float4(dhx[0], dhx[1], dhx[2], m);
      tmp[it * (GEO + 1) + GEO] =
          make_float4(w[0][0], w[0][1], w[1][0], w[1][1]);
      atomicAdd(bstart + ay * g.fw + ax + 1, 1);
    }
    tmp[it * (GEO + 1)] = g0;
    tmp[it * (GEO + 1) + 1] = g1;
    tmp[it * (GEO + 1) + 2] = g2;
    tmp[it * (GEO + 1) + 3] = g3;
    ss[it * 3] = ss[it * 3 + 1] = ss[it * 3 + 2] = 0.f;
  }
  __syncthreads();
  if (threadIdx.x < 32) {                  // bucket starts: a prefix sum
    const int lane = threadIdx.x;
    int carry = 0;
    for (int base = 0; base <= npix; base += 32) {
      int v = base + lane <= npix ? bstart[base + lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (base + lane <= npix) bstart[base + lane] = v + carry;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < npix; i += THREADS) cursor[i] = bstart[i];
  __syncthreads();
  // the sort, stable so that every launch takes the same order: one warp
  // walks the items 32 at a time; lanes with one anchor rank by lane.
  // Each item's slot receives the item, its weights and its dcols row.
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    for (int base = 0; base < n_items; base += 32) {
      const int it = base + lane;
      int anchor = -1;
      if (it < n_items) {
        const float4 g0 = tmp[it * (GEO + 1)];
        if (__float_as_int(g0.y) & VALID) anchor = __float_as_int(g0.z);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, anchor);
      const int rank = __popc(peers & ((1u << lane) - 1));
      const int pos = anchor >= 0 ? cursor[anchor] + rank : 0;
      __syncwarp();
      if (anchor >= 0 && rank == 0) cursor[anchor] += __popc(peers);
      __syncwarp();
      if (anchor < 0) continue;
      sorted[pos] = it;
      for (int i = 0; i < GEO; ++i)
        sgeo[pos * GEO + i] = tmp[it * (GEO + 1) + i];
      sw[pos] = tmp[it * (GEO + 1) + GEO];
      int k;
      src[npix + pos] = (item_site(g, b, oy0, ox0, it, &k) * K + k) * g.Cin;
    }
  }
  __syncthreads();
  const int n_valid = bstart[npix];
  if (!(kDrop<T> & 1) && ch_begin < ch_end)
    load_chunk<VEC, T>(img, dcols, sx, src, npix, g.Cin, ch_begin * CC,
                       npix, npix + n_valid);

  const int lane = threadIdx.x & 31;
  const int l = lane & (LANES - 1);           // lane within the group
  const int gi = lane / LANES;                // group within the warp
  const int group = threadIdx.x / LANES;      // a warp's groups: in a row
  const unsigned gmask = ((1u << LANES) - 1) << (LANES * gi);
  // a lane's 8 channels as two float4s, at ca and cb of the chunk: odd
  // groups take them in the other order, so that the two groups of a
  // quarter warp read 32 distinct banks
  const int ca = l * 8 + 4 * (gi & 1), cb = l * 8 + 4 * (1 - (gi & 1));

  for (int ch = ch_begin; ch < ch_end; ++ch) {
    const int c0 = ch * CC;
    if constexpr (VEC == 4) cp_async_wait_all();
    __syncthreads();                 // the chunk, the geometry, the buckets
    // the dot products S, one item per group: d_mask and d_offset's sums
    for (int pos = group; !(kDrop<T> & 2) && pos < n_valid; pos += GROUPS) {
      const float4 g0 = sgeo[pos * GEO], g1 = sgeo[pos * GEO + 1],
                   g2 = sgeo[pos * GEO + 2], g3 = sgeo[pos * GEO + 3];
      const int bits = __float_as_int(g0.y);
      const float hy[3] = {g0.w, g1.x, g1.y}, dhy[3] = {g1.z, g1.w, g2.x};
      const float hx[3] = {g2.y, g2.z, g2.w}, dhx[3] = {g3.x, g3.y, g3.z};
      const int q0 = __float_as_int(g0.x);
      const float* dci = sdc + pos * CC;
      const float4 da = *reinterpret_cast<const float4*>(dci + ca);
      const float4 db = *reinterpret_cast<const float4*>(dci + cb);
      // per corner the lane's part of S, then its three weights
      float s_m = 0.f, s_y = 0.f, s_x = 0.f;
#pragma unroll
      for (int p = 0; p < 9; ++p) {
        if (!(bits & (1 << p))) continue;               // group-uniform
        const int j = p / 3, i = p % 3;
        const float* xp = sx + (q0 + j * g.fw + i) * CC;
        // lo channels first in every group, so the sum's order is fixed
        const float4 xa = *reinterpret_cast<const float4*>(xp + ca);
        const float4 xb = *reinterpret_cast<const float4*>(xp + cb);
        const float sa = dot(da, xa), sb = dot(db, xb);
        const float sp = (gi & 1) ? sb + sa : sa + sb;
        s_m += hy[j] * hx[i] * sp;
        s_y += dhy[j] * hx[i] * sp;
        s_x += hy[j] * dhx[i] * sp;
      }
#pragma unroll
      for (int o = LANES / 2; o > 0; o >>= 1) {
        s_m += __shfl_xor_sync(gmask, s_m, o, LANES);
        s_y += __shfl_xor_sync(gmask, s_y, o, LANES);
        s_x += __shfl_xor_sync(gmask, s_x, o, LANES);
      }
      if (l == 0) {
        ss[pos * 3] += s_m;
        ss[pos * 3 + 1] += s_y;
        ss[pos * 3 + 2] += s_x;
      }
    }
    __syncthreads();                 // sx read: the next chunk's x may come
    if (!(kDrop<T> & 1) && ch + 1 < ch_end)
      load_chunk<VEC, T>(img, dcols, sx, src, npix, g.Cin, c0 + CC, 0,
                         npix);
    // dx, one footprint pixel per group: the sum over the items anchored
    // at the pixel and at its left, upper and upper-left neighbours (per
    // row, two adjacent buckets: one contiguous run), then one reduction
    // into device memory
    for (int pix = group; !(kDrop<T> & 4) && pix < npix; pix += GROUPS) {
      const int py = pix / g.fw, px = pix - py * g.fw;
      const int gy = y0 + py, gx = x0 + px;
      if (gy < 0 || gy >= g.H || gx < 0 || gx >= g.W) continue;
      float4 acca = make_float4(0.f, 0.f, 0.f, 0.f), accb = acca;
#pragma unroll
      for (int a = 0; a < 2; ++a) {      // the anchor's row: pixel - a rows
        if (py < a) continue;
        const int own = pix - a * g.fw;
        const int mid = bstart[own];
        const int lo = px > 0 ? bstart[own - 1] : mid;
        const int hi = bstart[own + 1];
        for (int s = lo; s < hi; ++s) {  // before mid: the left neighbour's
          const float4 w4 = sw[s];
          const float w = s < mid ? (a ? w4.w : w4.y) : (a ? w4.z : w4.x);
          if (w == 0.f) continue;
          fma4(acca, w, *reinterpret_cast<const float4*>(sdc + s * CC + ca));
          fma4(accb, w, *reinterpret_cast<const float4*>(sdc + s * CC + cb));
        }
      }
      float* dst = dimg + (static_cast<int64_t>(gy) * g.W + gx) * g.Cin + c0;
      if ((kDrop<T> & 8) && acca.x != NEVER && accb.x != NEVER) continue;
      add_dx<VEC>(dst, ca, g.Cin - c0, acca);
      add_dx<VEC>(dst, cb, g.Cin - c0, accb);
    }
    __syncthreads();                 // sdc read
    if (!(kDrop<T> & 1) && ch + 1 < ch_end)
      load_chunk<VEC, T>(img, dcols, sx, src, npix, g.Cin, c0 + CC, npix,
                         npix + n_valid);
  }
  __syncthreads();

  for (int pos = threadIdx.x; pos < n_valid; pos += THREADS) {
    int k;
    const int64_t item = item_site(g, b, oy0, ox0, sorted[pos], &k) * K + k;
    if (part != nullptr) {                    // channel split: partials
      float* dst = part + (static_cast<int64_t>(blockIdx.z) * gridDim.y *
                               g.Ho * g.Wo * K + item) * 3;
      dst[0] = ss[pos * 3];
      dst[1] = ss[pos * 3 + 1];
      dst[2] = ss[pos * 3 + 2];
    } else {
      const float m = sgeo[pos * GEO + 3].w;
      if (dmask != nullptr) st(dmask + item, ss[pos * 3]);
      st(doffset + 2 * item, m * ss[pos * 3 + 1]);
      st(doffset + 2 * item + 1, m * ss[pos * 3 + 2]);
    }
  }
}

// the splits' partials summed in split order: d_mask, d_offset
template <typename T, typename TO>
__global__ void deform_col2im_finish_kernel(const float* __restrict__ part,
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

// dx's fp32 sums rounded to bf16
__global__ void deform_col2im_round_kernel(const float* __restrict__ dx32,
                                           bf16* __restrict__ dx, int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    dx[i] = __float2bfloat16_rn(dx32[i]);
}

// ---- The bf16 fast route ------------------------------------------------
// x over the footprint and the items' dcols rows stay bf16 in shared
// memory, CC channels a row (64 bytes), copied by cp.async in 16-byte runs
// (8 channels) into a ring of F_STAGES chunks: chunk c + 1's copies are in
// flight while chunk c's two passes run, one barrier a chunk.  Values are
// widened to fp32 in registers only.  The items take slots in bucket order
// (the sort above), and their dcols rows are staged in that order.  Per
// slot the block keeps 16 words: the anchor weights for the dx pass, a
// packed word (the footprint index of the corner (fy - 1, fx - 1) and the
// corner bits) for the dot pass, the 9 corner sums S_p over the chunks, the
// item and its row's source; the hats and their derivatives are computed
// again from the offsets where the sums are weighted, once, at the end.
// Blocks of 512 threads, two an SM (what hides the passes' latency: one
// block an SM with larger tiles was slower): the wrapper's plan takes the
// tile, up to 8 x 8 sites, with the fewest tiles whose shared memory lets
// two blocks share an SM.  The dx pass takes one footprint pixel a group of
// 4 lanes (splitting it by anchor row, or by bucket, was slower).

constexpr int F_THREADS = 512;
constexpr int F_GROUPS = F_THREADS / LANES;
constexpr int F_STAGES = 2;
constexpr int F_CORNERS = 9;
constexpr int F_SHIFT = 12;   // packed word: bits 0-8 the corners, 12-31
                              // the footprint index of corner (fy-1, fx-1)

// Dynamic shared memory of the fast kernel (deform_col2im.py: fast_smem).
int64_t fast_smem(int npix, int n_items) {
  const int64_t rows = static_cast<int64_t>(npix) + n_items;
  return F_STAGES * rows * CC * 2 +
         static_cast<int64_t>(n_items) * (16 + 4 * F_CORNERS + 4 + 4) +
         rows * 4 + (2 * static_cast<int64_t>(npix) + 1) * 4;
}

// 8 bf16 channels (16 bytes of shared memory) as fp32
__device__ __forceinline__ void widen8(const bf16* p, float* f) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 4 channels of dx, one reduction into device memory unless all are zero
__device__ __forceinline__ void red4(float* dst, const float* v) {
  if (v[0] != 0.f || v[1] != 0.f || v[2] != 0.f || v[3] != 0.f)
    atomicAdd(reinterpret_cast<float4*>(dst),
              make_float4(v[0], v[1], v[2], v[3]));
}

// Chunk [c0, c0 + CC) of rows [r0, r1) (the footprint's pixels, then the
// slots) into one ring stage by cp.async, 16 bytes a copy, left in flight;
// src[row] is the row's first element in x (of this image) or dcols, or -1
// (zeros); zeros past Cin (a multiple of 8: a run is all in or all out).
__device__ __forceinline__ void fast_copy(bf16* stage, const bf16* img,
                                          const bf16* dcols, const int* src,
                                          int npix, int r0, int r1, int cin,
                                          int c0) {
  for (int q = threadIdx.x + r0 * (CC / 8); q < r1 * (CC / 8);
       q += F_THREADS) {
    const int row = q / (CC / 8);
    const int c = c0 + (q % (CC / 8)) * 8;
    const int off = src[row];
    const bool in = off >= 0 && c < cin;
    const bf16* from = in ? (row < npix ? img : dcols) + off + c : img;
    cp_async16(stage + q * 8, from, in ? 16 : 0);
  }
}

template <typename TO>
__global__ void __launch_bounds__(F_THREADS, 2) deform_col2im_bf16_fast_kernel(
    const bf16* __restrict__ dcols, const bf16* __restrict__ x,
    const TO* __restrict__ offset, const bf16* __restrict__ mask,
    float* __restrict__ dx, TO* __restrict__ doffset,
    bf16* __restrict__ dmask, float* __restrict__ part, Shape g) {
  constexpr int DROP = STMASK_COL2IM_DROP;
  extern __shared__ float4 smem4[];
  const int K = g.kh * g.kw;
  const int n_items = g.ty * g.tx * K;
  const int npix = g.fh * g.fw;
  const int rows = npix + n_items;
  // in slot (bucket) order: the items' dcols rows, weights, sums and words
  bf16* ring = reinterpret_cast<bf16*>(smem4);     // [F_STAGES][rows][CC]
  float4* sw = reinterpret_cast<float4*>(ring + F_STAGES * rows * CC);
  float* ssum = reinterpret_cast<float*>(sw + n_items);   // [slot][9]
  int* spk = reinterpret_cast<int*>(ssum + n_items * F_CORNERS);
  int* sorted = spk + n_items;                    // the slot's item
  int* src = sorted + n_items;                    // [rows]
  int* bstart = src + rows;                       // [npix + 1]
  int* cursor = bstart + npix + 1;                // [npix]
  // before the sort, in item order, each item's anchor weights, anchor,
  // packed word and dcols row wait in ssum
  float4* tw = reinterpret_cast<float4*>(ssum);
  int* tanchor = reinterpret_cast<int*>(tw + n_items);
  int* tpk = tanchor + n_items;
  int* tsrc = tpk + n_items;

  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / g.tiles_x) * g.ty;
  const int ox0 = (blockIdx.x % g.tiles_x) * g.tx;
  const int y0 = oy0 * g.stride - (g.kh - 1) / 2 * g.dilation - g.radius;
  const int x0 = ox0 * g.stride - (g.kw - 1) / 2 * g.dilation - g.radius;
  const int ch_begin = blockIdx.z * g.chunks_per_split;
  const int n = min(ch_begin + g.chunks_per_split, g.n_chunks) - ch_begin;
  const bf16* img = x + static_cast<int64_t>(b) * g.H * g.W * g.Cin;
  float* dimg = dx + static_cast<int64_t>(b) * g.H * g.W * g.Cin;

  for (int row = threadIdx.x; row < npix; row += F_THREADS) {
    const int gy = y0 + row / g.fw, gx = x0 + row % g.fw;
    src[row] = gy >= 0 && gy < g.H && gx >= 0 && gx < g.W
                   ? (gy * g.W + gx) * g.Cin
                   : -1;
  }
  for (int i = threadIdx.x; i <= npix; i += F_THREADS) bstart[i] = 0;
  __syncthreads();
  if (!(DROP & 1) && n > 0)                  // chunk 0's x, in flight
    fast_copy(ring, img, dcols, src, npix, 0, npix, g.Cin, ch_begin * CC);
  // each item's packed word, anchor weights and dcols row; items are
  // counted by their anchor for the buckets
  for (int it = threadIdx.x; it < n_items; it += F_THREADS) {
    int k;
    const int64_t site = item_site(g, b, oy0, ox0, it, &k);
    int anchor = -1;
    if (site >= 0) {
      const ItemCorners c =
          item_corners(g, offset, mask, site, k, it, oy0, ox0, y0, x0);
      tpk[it] = (c.ry * g.fw + c.rx) * (1 << F_SHIFT) | (c.bits & 511);
      tw[it] = make_float4(c.w[0][0], c.w[0][1], c.w[1][0], c.w[1][1]);
      tsrc[it] = static_cast<int>((site * K + k) * g.Cin);
      anchor = c.ay * g.fw + c.ax;
      atomicAdd(bstart + anchor + 1, 1);
    }
    tanchor[it] = anchor;
  }
  __syncthreads();
  if (threadIdx.x < 32) bucket_starts(bstart, npix);
  __syncthreads();
  for (int i = threadIdx.x; i < npix; i += F_THREADS) cursor[i] = bstart[i];
  __syncthreads();
  // the sort, stable so that every launch takes the same order (one warp, 32
  // items at a time; lanes with one anchor rank by lane): each item's slot
  // receives the item, its weights, its packed word and its dcols row
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    for (int base = 0; base < n_items; base += 32) {
      const int it = base + lane;
      const int anchor = it < n_items ? tanchor[it] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, anchor);
      const int rank = __popc(peers & ((1u << lane) - 1));
      const int pos = anchor >= 0 ? cursor[anchor] + rank : 0;
      __syncwarp();
      if (anchor >= 0 && rank == 0) cursor[anchor] += __popc(peers);
      __syncwarp();
      if (anchor < 0) continue;
      sorted[pos] = it;
      sw[pos] = tw[it];
      spk[pos] = tpk[it];
      src[npix + pos] = tsrc[it];
    }
  }
  __syncthreads();
  const int n_valid = bstart[npix];
  const int n_rows = npix + n_valid;
  if (!(DROP & 1) && n > 0)                  // chunk 0's dcols, in flight
    fast_copy(ring, img, dcols, src, npix, npix, n_rows, g.Cin,
              ch_begin * CC);
  for (int i = threadIdx.x; i < n_valid * F_CORNERS; i += F_THREADS)
    ssum[i] = 0.f;

  const int lane = threadIdx.x & 31;
  const int l = lane & (LANES - 1);           // lane within the group
  const int group = threadIdx.x / LANES;
  const unsigned gmask = ((1u << LANES) - 1) << (lane & ~(LANES - 1));
  const float inv_fw = 1.f / g.fw;  // pixel / fw, exact for these sizes
  for (int i = 0; i < n; ++i) {
    const int c0 = (ch_begin + i) * CC;
    const bf16* sx = ring + (i % F_STAGES) * rows * CC;
    const bf16* sdc = sx + npix * CC;
    cp_async_wait_all();
    __syncthreads();                 // chunk i landed; chunk i - 1 read
    if (!(DROP & 1) && i + 1 < n)
      fast_copy(ring + ((i + 1) % F_STAGES) * rows * CC, img, dcols, src,
                npix, 0, n_rows, g.Cin, c0 + CC);
    // the dot products S_p, one slot per group, two corners at a time: the
    // lane's 8 channels in two chains, the lanes' parts summed by a fixed
    // butterfly, added to the slot's sums in chunk order
    for (int s = group; !(DROP & 2) && s < n_valid; s += F_GROUPS) {
      const int pk = spk[s];
      float d[8];
      widen8(sdc + s * CC + l * 8, d);
      const int q0 = pk >> F_SHIFT;
      for (int bits = pk & 511; bits != 0;) {
        int p[2];
        float sp[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {    // the next two corners (or one)
          p[h] = bits != 0 ? __ffs(bits) - 1 : -1;
          bits &= bits - 1;
          const int c = p[h] < 0 ? p[0] : p[h];  // none left: read p[0]'s
          float v[8];
          widen8(sx + (q0 + (c / 3) * g.fw + c % 3) * CC + l * 8, v);
          float sa = d[0] * v[0], sb = d[4] * v[4];
#pragma unroll
          for (int j = 1; j < 4; ++j) {
            sa = fmaf(d[j], v[j], sa);
            sb = fmaf(d[4 + j], v[4 + j], sb);
          }
          sp[h] = sa + sb;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sp[h] += __shfl_xor_sync(gmask, sp[h], 1, LANES);
          sp[h] += __shfl_xor_sync(gmask, sp[h], 2, LANES);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (l == 0 && p[h] >= 0) ssum[s * F_CORNERS + p[h]] += sp[h];
      }
    }
    // dx, one footprint pixel a group: the sum over the slots anchored at
    // the pixel and at its left, upper and upper-left neighbours (per row,
    // two adjacent buckets: one contiguous run), two slots at a time, then
    // one reduction into device memory for each 4 channels
    for (int pix = group; !(DROP & 4) && pix < npix; pix += F_GROUPS) {
      const int py = __float2int_rz((pix + 0.5f) * inv_fw);
      const int px = pix - py * g.fw;
      const int gy = y0 + py, gx = x0 + px;
      if (gy < 0 || gy >= g.H || gx < 0 || gx >= g.W) continue;
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int a = 0; a < 2; ++a) {      // the anchor's row: pixel - a rows
        if (py < a) continue;
        const int own = pix - a * g.fw;
        const int mid = bstart[own];
        const int lo = px > 0 ? bstart[own - 1] : mid;
        const int hi = bstart[own + 1];
        for (int s = lo; s < hi; s += 2) {
          float w[2], v[2][8];
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // before mid: the left neighbour's
            const int t = min(s + h, hi - 1);
            const float4 w4 = sw[t];
            w[h] = s + h >= hi ? 0.f
                   : t < mid   ? (a ? w4.w : w4.y)
                               : (a ? w4.z : w4.x);
            widen8(sdc + t * CC + l * 8, v[h]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[j] = fmaf(w[h], v[h][j], acc[j]);
        }
      }
      if (c0 + l * 8 >= g.Cin) continue;
      if ((DROP & 8) && acc[0] != NEVER) continue;
      float* dst = dimg + (static_cast<int64_t>(gy) * g.W + gx) * g.Cin + c0 +
                   l * 8;
      red4(dst, acc);
      red4(dst + 4, acc + 4);
    }
  }
  __syncthreads();

  // the sums weighted by the hats and their derivatives, computed again
  // from the offsets, in corner order; under a channel split, partials
  for (int s = threadIdx.x; s < n_valid; s += F_THREADS) {
    const int pk = spk[s];
    int k;
    const int64_t item =
        item_site(g, b, oy0, ox0, sorted[s], &k) * K + k;
    const float oyf = f32(offset[2 * item]);
    const float oxf = f32(offset[2 * item + 1]);
    const int fy = static_cast<int>(floorf(oyf));
    const int fx = static_cast<int>(floorf(oxf));
    float hy[3], dhy[3], hx[3], dhx[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int u = fy - 1 + j;
      hat(oyf, u, u >= -g.radius && u <= g.radius + 1, &hy[j], &dhy[j]);
      const int v = fx - 1 + j;
      hat(oxf, v, v >= -g.radius && v <= g.radius + 1, &hx[j], &dhx[j]);
    }
    float s_m = 0.f, s_y = 0.f, s_x = 0.f;
#pragma unroll
    for (int p = 0; p < F_CORNERS; ++p) {
      if (!(pk & (1 << p))) continue;
      const int j = p / 3, i = p % 3;
      const float sp = ssum[s * F_CORNERS + p];
      s_m += hy[j] * hx[i] * sp;
      s_y += dhy[j] * hx[i] * sp;
      s_x += hy[j] * dhx[i] * sp;
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

// dx's fp32 sums rounded to bf16, 8 a thread (the fast route: n a multiple
// of 8, both 16-byte aligned)
__global__ void deform_col2im_round8_kernel(const float4* __restrict__ dx32,
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

// dxh: the bf16 dx that the fp32 sums in dx are rounded into (bf16 only);
// fast: the bf16 fast route (bf16 only).
template <int VEC, typename T, typename TO>
cudaError_t launch(const T* dcols, const T* x, const TO* offset,
                   const T* mask, float* dx, bf16* dxh, TO* doffset,
                   T* dmask, float* part, int B, const Shape& g, int n_split,
                   int smem, bool fast, cudaStream_t stream) {
  auto* kern = deform_col2im_tile_kernel<VEC, T, TO>;
  int threads = THREADS;
  if constexpr (!kF32<T>) {
    if (fast) {
      kern = deform_col2im_bf16_fast_kernel<TO>;
      threads = F_THREADS;
    }
  }
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  [[maybe_unused]] const int64_t n_dx =
      static_cast<int64_t>(B) * g.H * g.W * g.Cin;
  if constexpr (!kF32<T>) {                  // dx32 zeroed, rounded after
    if (!(kDrop<T> & 16)) {
      e = cudaMemsetAsync(dx, 0, n_dx * sizeof(float), stream);
      if (e != cudaSuccess) return e;
    }
  }
  const int tiles_y = (g.Ho + g.ty - 1) / g.ty;
  const dim3 grid(tiles_y * g.tiles_x, B, n_split);
  kern<<<grid, threads, smem, stream>>>(dcols, x, offset, mask, dx, doffset,
                                        dmask, part, g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (part != nullptr) {
    const int64_t items =
        static_cast<int64_t>(B) * g.Ho * g.Wo * g.kh * g.kw;
    deform_col2im_finish_kernel<T, TO>
        <<<static_cast<unsigned>((items + 255) / 256), 256, 0, stream>>>(
            part, mask, doffset, dmask, items, n_split);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if constexpr (!kF32<T>) {
    if (!(kDrop<T> & 16) && fast) {
      const int64_t n8 = n_dx / 8;
      deform_col2im_round8_kernel<<<static_cast<unsigned>(std::min<int64_t>(
                                        (n8 + 255) / 256, 4096)),
                                    256, 0, stream>>>(
          reinterpret_cast<const float4*>(dx), reinterpret_cast<uint4*>(dxh),
          n8);
      e = cudaGetLastError();
    } else if (!(kDrop<T> & 16)) {
      deform_col2im_round_kernel<<<static_cast<unsigned>(std::min<int64_t>(
                                       (n_dx + 255) / 256, 4096)),
                                   256, 0, stream>>>(dx, dxh, n_dx);
      e = cudaGetLastError();
    }
  }
  return e;
}

// Whether the bf16 fast route can take a call (deform_col2im.py:
// col2im_fast): Cin a multiple of 8, dcols, x, dx32 and dx 16-byte aligned,
// x and dcols indexed by 32-bit offsets.
bool fast_fits(const void* dcols, const void* x, const void* dx32,
               const void* dx, int B, int H, int W, int Cin, int Ho, int Wo,
               int K) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return Cin % 8 == 0 && aligned(dcols) && aligned(x) && aligned(dx32) &&
         aligned(dx) &&
         static_cast<int64_t>(B) * H * W * Cin < (int64_t{1} << 31) &&
         static_cast<int64_t>(B) * Ho * Wo * K * Cin < (int64_t{1} << 31);
}

// Check the arguments and the plan (see the entries below) and launch.
// route: 0 the general kernel, 1 the bf16 fast route (refused where
// fast_fits does not hold).
template <typename T, typename TO>
int run(const T* dcols, const T* x, const TO* offset, const T* mask,
        float* dx, bf16* dxh, TO* doffset, T* dmask, float* part, int B,
        int H, int W, int Cin, int Ho, int Wo, int kh, int kw, int stride,
        int dilation, int radius, int ty, int tx, int fh, int fw,
        int n_split, int smem, int route, void* stream) {
  const bool fast = route == 1;
  if (B < 0 || H <= 0 || W <= 0 || Cin <= 0 || Ho < 0 || Wo < 0 || kh <= 0 ||
      kw <= 0 || stride <= 0 || dilation <= 0 || radius <= 0 || ty <= 0 ||
      tx <= 0 || n_split <= 0 || (mask == nullptr) != (dmask == nullptr) ||
      (n_split > 1) != (part != nullptr) || route < 0 || route > 1 ||
      fh < (ty - 1) * stride + (kh - 1) * dilation + 2 * radius + 2 ||
      fw < (tx - 1) * stride + (kw - 1) * dilation + 2 * radius + 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (fast ? kF32<T> || !fast_fits(dcols, x, dx, dxh, B, H, W, Cin, Ho, Wo,
                                   kh * kw) ||
                 smem < fast_smem(fh * fw, ty * tx * kh * kw)
           : smem < ((fh * fw + ty * tx * kh * kw) * (CC + 2) +
                     ty * tx * kh * kw * (4 * GEO + 4 + 3 + 1) +
                     2 * fh * fw + 2) *
                        static_cast<int>(sizeof(float)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Ho == 0 || Wo == 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  Shape g{H, W, Cin, Ho, Wo, kh, kw, stride, dilation, radius, ty, tx, fh, fw,
        (Wo + tx - 1) / tx, 0, (Cin + CC - 1) / CC};
  g.chunks_per_split = (g.n_chunks + n_split - 1) / n_split;
  // 4 channels a load (16 bytes of fp32, 8 of bf16) and a float4 of dx
  constexpr uintptr_t align = 4 * sizeof(T);
  const bool aligned = Cin % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(dcols) % align == 0 &&
                       reinterpret_cast<uintptr_t>(x) % align == 0 &&
                       reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const cudaError_t e =
      aligned ? launch<4>(dcols, x, offset, mask, dx, dxh, doffset, dmask,
                          part, B, g, n_split, smem, fast, s)
              : launch<1>(dcols, x, offset, mask, dx, dxh, doffset, dmask,
                          part, B, g, n_split, smem, false, s);
  return static_cast<int>(e);
}

}  // namespace

// dcols: [B*Ho*Wo, kh*kw*Cin] (taps outer, channels inner, as K2 lays out
// cols); x, dx: [B, H, W, Cin] (dx zeroed by the caller, then accumulated);
// offset, doffset: [B, Ho, Wo, 2*kh*kw] (dy, dx)-interleaved, offset
// already clamped to [-radius, radius]; mask, dmask: [B, Ho, Wo, kh*kw] or
// both null (v1).  All fp32 contiguous.  The plan (deform_col2im.py:
// col2im_plan): tiles of ty x tx sites, footprints of fh x fw pixels,
// n_split channel splits (part: [n_split, B*Ho*Wo*kh*kw, 3] scratch when
// n_split > 1, else null), smem bytes of dynamic shared memory.  Returns
// cudaGetLastError().
extern "C" int stmask_deform_col2im(const float* dcols, const float* x,
                                    const float* offset, const float* mask,
                                    float* dx, float* doffset, float* dmask,
                                    float* part, int B, int H, int W, int Cin,
                                    int Ho, int Wo, int kh, int kw,
                                    int stride, int dilation, int radius,
                                    int ty, int tx, int fh, int fw,
                                    int n_split, int smem, void* stream) {
  return run<float, float>(dcols, x, offset, mask, dx, nullptr, doffset,
                           dmask, part, B, H, W, Cin, Ho, Wo, kh, kw, stride,
                           dilation, radius, ty, tx, fh, fw, n_split, smem, 0,
                           stream);
}

// As stmask_deform_col2im with dcols, x, mask, offset, dx, d_offset and
// d_mask bf16; dx32: [B, H, W, Cin] fp32 scratch, zeroed here, where dx
// sums before it is rounded into dx.  route: the wrapper's (col2im_fast),
// 1 the fast route and its plan, 0 the general kernel; a fast route that
// fast_fits refuses returns cudaErrorInvalidValue and launches nothing.
extern "C" int stmask_deform_col2im_bf16(
    const __nv_bfloat16* dcols, const __nv_bfloat16* x,
    const __nv_bfloat16* offset, const __nv_bfloat16* mask, float* dx32,
    __nv_bfloat16* dx, __nv_bfloat16* doffset, __nv_bfloat16* dmask,
    float* part, int B, int H, int W, int Cin, int Ho, int Wo, int kh,
    int kw, int stride, int dilation, int radius, int ty, int tx, int fh,
    int fw, int n_split, int smem, int route, void* stream) {
  return run(dcols, x, offset, mask, dx32, dx, doffset, dmask, part, B, H, W,
             Cin, Ho, Wo, kh, kw, stride, dilation, radius, ty, tx, fh, fw,
             n_split, smem, route, stream);
}

// As stmask_deform_col2im_bf16 with fp32 offsets and d_offset (FCB's
// analytic offsets).
extern "C" int stmask_deform_col2im_bf16_f32off(
    const __nv_bfloat16* dcols, const __nv_bfloat16* x, const float* offset,
    const __nv_bfloat16* mask, float* dx32, __nv_bfloat16* dx,
    float* doffset, __nv_bfloat16* dmask, float* part, int B, int H, int W,
    int Cin, int Ho, int Wo, int kh, int kw, int stride, int dilation,
    int radius, int ty, int tx, int fh, int fw, int n_split, int smem,
    int route, void* stream) {
  return run(dcols, x, offset, mask, dx32, dx, doffset, dmask, part, B, H, W,
             Cin, Ho, Wo, kh, kw, stride, dilation, radius, ty, tx, fh, fw,
             n_split, smem, route, stream);
}
