// K3: backward of the cross-frame local correlation, NHWC, with the leaky
// ReLU's derivative folded in: one launch gives both gradients.  Two
// entries: fp32, and bf16 features (x1, x2, dx1, dx2 bf16; g and out fp32,
// as K1's bf16 entry writes its output in fp32).
//
// Replaces: the XLA transpose of stmask_tpu/ops/correlation.py::correlate,
// which the JAX package differentiates in training (models/stmask.py:139);
// its forward on the card is K1 (csrc/correlation.cu), which replaces the
// Pallas kernel kernels/correlation_pallas.py::correlate_pallas.
//
// Given the upstream gradient g[b, y, x, d] with d = dy * P + dx (dy, dx in
// [0, P), r = (P - 1) / 2) and, when the activation was applied, the
// forward's output out[b, y, x, d]:
//
//   g'[b, y, x, d]    = g where out >= 0, else 0.1 * g   (JAX's rule: slope
//                       1 at exactly 0; g' = g without the activation)
//   dx1[b, y, x, c]   = sum_d g'[b, y, x, d]
//                             * x2[b, y + dy - r, x + dx - r, c] / C
//   dx2[b, y', x', c] = sum_d g'[b, y' - dy + r, x' - dx + r, d]
//                             * x1[b, y' - dy + r, x' - dx + r, c] / C
//
// with every term whose pixel lies outside the image counted as zero.
//
// What bounds it on an H100: at the training shape (B 4, 24 x 40, C 256,
// P 11) it does 2 * 2 * 3840 * 121 * 256 = 0.48 GFLOP of fp32 FMAs less the
// out-of-image terms (0.39 GFLOP, 5.9 us at 67 TFLOP/s) and must move g,
// out (1.9 MB each), x1, x2 (3.9 MB each) in and dx1, dx2 out: 19.5 MB,
// 5.8 us at 3.35 TB/s.  Both are near a launch's own latency; what costs
// is the re-reading: each x row feeds the P output rows within r of it,
// and each output row reads P * P values of g and out per pixel.
//
// Design: for a fixed (b, y, dy) both outputs are a band product.  dx1's
// row y is sum_e G[dy][e][i] * S[i + e], where S is x2's source row
// s = y + dy - r staged from column x0 - r on, and G[dy][e][i] = g'[y,
// x0 + i, dy * P + e].  dx2's row y has the same form with S x1's row
// s = y - dy + r and G taken anti-diagonally from g's row s: G[dy][e][i] =
// g'[s, x0 + i + e - r, dy * P + P - 1 - e].  One block per (output, b,
// y, tile of up to 64 columns, slice of up to 128 channels): 2 * 4 * 24 *
// 1 * 2 = 384 blocks of 320 threads at the training shape, 72 KB of
// shared memory each, so all are resident at once.  A prologue stages the
// g (and out) values of the block's G with 4-byte cp.async (g's pixel
// stride is an argument, so the channel slice of a larger gradient that
// torch.cat's backward hands over is read in place) and forms G once,
// applying the derivative, for the dy whose source row lies in the image.
// The main loop walks those source rows: it stages each row tile [tile +
// 2r, slice] with 16-byte cp.async (4-byte copies when C % 4 != 0),
// zero-filled outside the image, double-buffered so that the next row's
// copies overlap this row's math, one barrier a row.  A thread holds TX
// columns x 4 channels of the output in registers; a window of TX float4
// of S slides over e, and each float4 of G feeds TX columns: per row
// TX + P - 1 + P float4 loads for 4 * TX * P FMAs.  Rows of S are padded
// by 4 floats, so that the threads of a quarter-warp, which read
// neighbouring channels of one row, hit distinct banks.  Every output is
// summed in a fixed order (dy, then e) by one thread and written once: no
// atomics, bit-identical over launches.
//
// Timed on the card with one part cut out at a time: the x rows' staging
// (~77 MB through L2, each row read for ~10 output rows) and the prologue
// cost the most, then the FMAs.  Blocks of 2 or 3 output rows read x 2-3x
// less but were slower: their G prologue, or their per-row g staging,
// grew by as much.
//
// Why fp32 FMAs and not tensor cores: the band fills P / (tile + 2r), about
// 22%, of a dense [tile, tile + 2r] product, and the path is fp32 with TF32
// off, so it would need 3xTF32 products: more work than the band itself.
//
// The bf16 entry has two routes, the wrapper's choice
// (kernels/correlation_bwd.py::corr_bwd_fast), with the same blocks, the
// same thread for each output and the same order of its fp32 FMAs (dy,
// then e), so that they agree bit for bit:
// - the general route is the kernel above with the source rows widened to
//   fp32 as they are staged (plain loads of 4 channels at a time, since
//   cp.async copies bytes as they are; S stays fp32): those loads do not
//   overlap the previous row's math;
// - the fast route (C % 8 == 0, x1, x2, dx1 and dx2 16-byte aligned: every
//   training site) keeps S in bf16: raw source rows copied by 16-byte
//   cp.async into a ring of FSTAGES rows, FSTAGES - 1 of them in flight
//   while one is read, the first ones issued before the prologue so that
//   they land while G is formed; the window widens its bf16 channels to
//   fp32 in registers as it slides (a shift or a mask, csrc/bf16x2.cuh).
//   Its prologue forms G from g and out read straight into registers,
//   sixteen values a thread in flight, without a staging buffer; the
//   channel slices of a column tile, which read the same G, run as one
//   thread-block cluster, each block forming a share of G's slabs and
//   writing them into every block's shared memory.
// Both sum in fp32 and round each output to bf16 once, when it is
// written.

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "bf16x2.cuh"
#include "common.cuh"

// Measurement builds only (stmask_torch/kernels/split.py; the library's own
// build leaves it 0): STMASK_CORRBWD_DROP leaves parts of the bf16 entry's
// work out, on both routes: bit 1 the source rows' staging, 2 the
// prologue's G formation, 4 the FMAs (and their shared-memory reads), 8
// the output stores (kept behind a test that never holds, so that the sums
// stay).  The fp32 entry ignores it.
#ifndef STMASK_CORRBWD_DROP
#define STMASK_CORRBWD_DROP 0
#endif

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int TX = 4;            // columns of a thread's register tile
constexpr int MAX_TILE = 64;     // columns per block
constexpr int MAX_CQ = 32;       // channel quads per block (128 channels)
constexpr int G_BYTES = 64 * 1024;   // most shared memory G may take

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;
// the parts a measurement build leaves out of the entry of type T
template <typename T>
constexpr int kDrop = kF32<T> ? 0 : STMASK_CORRBWD_DROP;
// A value no output takes: dropped stores are kept behind v == NEVER.
constexpr float NEVER = -1.2345e-38f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0));
}

// T: the features' type (float or bf16); g and out are fp32 in both.
template <typename T>
struct Args {
  const float* g;
  const float* out;        // nullptr: no activation, g' = g
  const T* x1;
  const T* x2;
  T* dx1;
  T* dx2;
  int64_t ldg;             // g's pixel stride (floats)
  int H, W, C;
  int tile, cq, cq_log2, nslice, ldc, vec;
  int chunk;               // G slabs staged at a time in the prologue
};

// Four bf16 channels at p (8-byte aligned) as fp32.
__device__ __forceinline__ float4 ld_bf16x4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// Stage source row s's tile of columns x0 - r ... into S, one commit group
// (bf16: converted by plain loads, the group empty).
template <int P, typename T>
__device__ __forceinline__ void stage_row(const Args<T>& a, float* S,
                                          const T* X, int b, int s, int x0,
                                          int c0) {
  constexpr int R = (P - 1) / 2;
  const int rows = a.tile + 2 * R;
  const int64_t row = (static_cast<int64_t>(b) * a.H + s) * a.W;
  if constexpr (std::is_same<T, bf16>::value) {
    const int cs = 4 * a.cq;
    const int per = a.vec ? a.cq : cs;    // loads a staged row
    for (int e = threadIdx.x; !(kDrop<T> & 1) && e < rows * per;
         e += blockDim.x) {
      const int k = e / per, c = c0 + (a.vec ? 4 * (e % per) : e % per);
      const int xs = x0 - R + k;
      const bool ok = xs >= 0 && xs < a.W && c < a.C;
      const T* src = X + (row + xs) * a.C + c;
      float* dst = S + k * a.ldc + c - c0;
      if (a.vec)
        *reinterpret_cast<float4*>(dst) =
            ok ? ld_bf16x4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
      else
        *dst = ok ? __bfloat162float(*src) : 0.f;
    }
  } else if (a.vec) {
    for (int e = threadIdx.x; e < rows * a.cq; e += blockDim.x) {
      const int k = e >> a.cq_log2, c = c0 + 4 * (e & (a.cq - 1));
      const int xs = x0 - R + k;
      const bool ok = xs >= 0 && xs < a.W && c < a.C;
      cp_async16(S + k * a.ldc + c - c0, ok ? X + (row + xs) * a.C + c : X,
                 ok);
    }
  } else {
    const int cs = 4 * a.cq;
    for (int e = threadIdx.x; e < rows * cs; e += blockDim.x) {
      const int k = e >> (a.cq_log2 + 2), c = c0 + (e & (cs - 1));
      const int xs = x0 - R + k;
      const bool ok = xs >= 0 && xs < a.W && c < a.C;
      cp_async4(S + k * a.ldc + c - c0, ok ? X + (row + xs) * a.C + c : X,
                ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The prologue: G[dy][e][i], the slab of g' that links output row y to
// its source row s = y + dy - r (dx1) or y - dy + r (dx2), the derivative
// applied, dx2's taken anti-diagonally: dx1's G[dy][e][i] = g'[y, x0 + i,
// dy * P + e], dx2's g'[s, x0 + i + e - r, dy * P + P - 1 - e], for the
// dy whose s lies in the image (the main loop reads no other).  g's (and
// out's) values as read are staged `a.chunk` slabs at a time into `raw`
// [2][chunk][tile + 2r][P], zero outside the image.
template <int P, typename T>
__device__ __forceinline__ void fill_g(const Args<T>& a, float* G, float* raw,
                                       bool second, int b, int y, int x0) {
  constexpr int R = (P - 1) / 2;
  if constexpr ((kDrop<T> & 2) != 0) return;
  const int rows = a.tile + 2 * R;
  const int npix = second ? rows : a.tile;
  const int gx0 = second ? x0 - R : x0;
  const int d0 = second ? max(0, y + R - a.H + 1) : max(0, R - y);
  const int d1 = second ? min(P, y + R + 1) : min(P, a.H + R - y);
  for (int j0 = d0; j0 < d1; j0 += a.chunk) {
    const int nj = min(a.chunk, d1 - j0);
    for (int j = 0; j < nj; ++j) {
      const int dy = j0 + j;
      const int s = second ? y - dy + R : y + dy - R;
      const int64_t row0 = (static_cast<int64_t>(b) * a.H +
                            (second ? s : y)) * a.W + gx0;
      float* const dst = raw + j * rows * P;
      for (int n = threadIdx.x; n < npix * P; n += blockDim.x) {
        const int k = n / P, m = n - k * P;
        const bool ok = gx0 + k >= 0 && gx0 + k < a.W;
        const int64_t pix = ok ? row0 + k : 0;
        cp_async4(dst + n, a.g + pix * a.ldg + dy * P + m, ok);
        if (a.out)
          cp_async4(dst + a.chunk * rows * P + n,
                    a.out + pix * (P * P) + dy * P + m, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    for (int j = 0; j < nj; ++j) {
      const float* const src = raw + j * rows * P;
      float* const Gd = G + (j0 + j) * P * a.tile;
      for (int n = threadIdx.x; n < a.tile * P; n += blockDim.x) {
        const int i = n / P, e = n - i * P;
        const int k = second ? (i + e) * P + (P - 1 - e) : n;
        float v = src[k];
        if (a.out && !(src[k + a.chunk * rows * P] >= 0.f)) v *= 0.1f;
        Gd[e * a.tile + i] = v;
      }
    }
    __syncthreads();                   // raw is refilled next round
  }
}

template <int P, typename T>
__global__ void correlation_bwd_kernel(const Args<T> a) {
  constexpr int R = (P - 1) / 2;
  extern __shared__ __align__(16) float smem[];
  const int rows = a.tile + 2 * R;
  const int s_elems = rows * a.ldc;
  // G [P (dy)][P (e)][tile], then the source rows [2][rows][ldc], which
  // the prologue's g and out as read overlay
  float* const G = smem;
  float* const S = G + P * P * a.tile;

  const int slice = blockIdx.x % a.nslice;
  const int x0 = (blockIdx.x / a.nslice) * a.tile;
  const int c0 = slice * 4 * a.cq;
  const int y = blockIdx.y;
  const int b = blockIdx.z >> 1;
  const bool second = blockIdx.z & 1;          // dx2
  const T* const X = second ? a.x1 : a.x2;
  const int ncol = min(a.tile, a.W - x0);
  // the source rows within r of row y
  const int s0 = max(0, y - R);
  const int s1 = min(a.H, y + R + 1);

  fill_g<P, T>(a, G, S, second, b, y, x0);

  const int grp = threadIdx.x >> a.cq_log2;    // columns TX*grp ...
  const int q = threadIdx.x & (a.cq - 1);      // channels c0 + 4q ...
  const int i0 = TX * grp;
  const bool active = i0 < ncol;

  float4 acc[TX];
#pragma unroll
  for (int t = 0; t < TX; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);

  stage_row<P, T>(a, S, X, b, s0, x0, c0);
  for (int s = s0; s < s1; ++s) {
    const int buf = (s - s0) & 1;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();            // s's row landed; s - 1's math done
    if (s + 1 < s1)
      stage_row<P, T>(a, S + (buf ^ 1) * s_elems, X, b, s + 1, x0, c0);
    if constexpr ((kDrop<T> & 4) != 0) continue;   // without the FMAs
    if (active) {
      // out[i0 + t] += G[dy][e][i0 + t] * S[i0 + t + e]: a window of TX
      // rows of S slides over e, each G float4 feeds TX columns
      const int dy = second ? y - s + R : s - y + R;
      const float* const gs = G + dy * P * a.tile + i0;
      const float* const sp = S + buf * s_elems + i0 * a.ldc + 4 * q;
      float4 win[TX];
#pragma unroll
      for (int t = 0; t < TX - 1; ++t)
        win[t + 1] = *reinterpret_cast<const float4*>(sp + t * a.ldc);
#pragma unroll
      for (int e = 0; e < P; ++e) {
#pragma unroll
        for (int t = 0; t < TX - 1; ++t) win[t] = win[t + 1];
        win[TX - 1] =
            *reinterpret_cast<const float4*>(sp + (e + TX - 1) * a.ldc);
        float w[TX];
#pragma unroll
        for (int t = 0; t < TX; t += 4) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(gs + e * a.tile + t);
          w[t] = w4.x;
          w[t + 1] = w4.y;
          w[t + 2] = w4.z;
          w[t + 3] = w4.w;
        }
#pragma unroll
        for (int t = 0; t < TX; ++t) {
          acc[t].x += w[t] * win[t].x;
          acc[t].y += w[t] * win[t].y;
          acc[t].z += w[t] * win[t].z;
          acc[t].w += w[t] * win[t].w;
        }
      }
    }
  }

  if (!active) return;
  T* const D = second ? a.dx2 : a.dx1;
  const float fc = static_cast<float>(a.C);
  const int c = c0 + 4 * q;
#pragma unroll
  for (int t = 0; t < TX; ++t) {
    if (i0 + t >= ncol) break;
    T* const p =
        D + ((static_cast<int64_t>(b) * a.H + y) * a.W + x0 + i0 + t) * a.C +
        c;
    const float4 v = make_float4(acc[t].x / fc, acc[t].y / fc, acc[t].z / fc,
                                 acc[t].w / fc);
    if constexpr ((kDrop<T> & 8) != 0) {
      if (v.x != NEVER) continue;
    }
    if constexpr (std::is_same<T, bf16>::value) {
      if (a.vec) {
        if (c < a.C) {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
          uint2 raw;
          raw.x = *reinterpret_cast<const unsigned*>(&lo);
          raw.y = *reinterpret_cast<const unsigned*>(&hi);
          *reinterpret_cast<uint2*>(p) = raw;
        }
        continue;
      }
    } else {
      if (a.vec) {
        if (c < a.C) *reinterpret_cast<float4*>(p) = v;
        continue;
      }
    }
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (c + u < a.C) {
        if constexpr (std::is_same<T, bf16>::value)
          p[u] = __float2bfloat16_rn(vv[u]);
        else
          p[u] = vv[u];
      }
  }
}

// ---- bf16 fast route -------------------------------------------------------

constexpr int FSTAGES = 4;   // source rows in the ring
static_assert(FSTAGES >= 2, "a row is read while the next ones land");

// Four bf16 channels in shared memory (8-byte aligned) widened to fp32.
__device__ __forceinline__ float4 widen4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_lo(raw.x), bf16_hi(raw.x), bf16_lo(raw.y),
                     bf16_hi(raw.y));
}

// Copy source row s's tile of columns x0 - r ... (channels c0 ... of the
// slice, as bf16) into the ring's buffer S with 16-byte cp.async,
// zero-filled outside the image; one commit group, empty when s lies past
// the last source row.
template <int P>
__device__ __forceinline__ void fast_stage(const Args<bf16>& a, bf16* S,
                                           const bf16* X, int b, int s,
                                           int s1, int x0, int c0, int lds) {
  constexpr int R = (P - 1) / 2;
  const int rows = a.tile + 2 * R;
  const int per_log2 = a.cq_log2 - 1;      // 8 channels a copy
  const int64_t row = (static_cast<int64_t>(b) * a.H + s) * a.W;
  for (int e = threadIdx.x; !(kDrop<bf16> & 1) && s < s1 &&
                            e < (rows << per_log2);
       e += blockDim.x) {
    const int k = e >> per_log2;
    const int c = c0 + 8 * (e & ((1 << per_log2) - 1));
    const int xs = x0 - R + k;
    const bool ok = xs >= 0 && xs < a.W && c < a.C;
    cp_async16(S + k * lds + c - c0, ok ? X + (row + xs) * a.C + c : X, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// One value of G's slab dy, as fill_g forms it, read straight from g (and
// out) without the staging.  The slab's elements n walk g's order (the P
// channels of a pixel next to each other): pixel k = n / P, channel dy * P
// + m with m = n % P.  dx1's pixel k is x0 + k and gives G[dy][m][k]; dx2's
// is x0 - r + k and gives G[dy][P - 1 - m][k - (P - 1 - m)].  dst: the
// index into G, -1 where that column lies outside the tile.
template <int P>
__device__ __forceinline__ float g_value(const Args<bf16>& a, bool second,
                                         int b, int y, int x0, int dy, int n,
                                         int& dst) {
  constexpr int R = (P - 1) / 2;
  const int k = n / P, m = n - k * P;
  const int e = second ? P - 1 - m : m;
  const int i = second ? k - e : k;
  dst = -1;
  if (i < 0 || i >= a.tile) return 0.f;
  dst = (dy * P + e) * a.tile + i;
  const int s = second ? y - dy + R : y;
  const int gx = (second ? x0 - R : x0) + k;
  if (gx < 0 || gx >= a.W) return 0.f;
  const int64_t pix = (static_cast<int64_t>(b) * a.H + s) * a.W + gx;
  float v = __ldg(a.g + pix * a.ldg + dy * P + m);
  if (a.out && !(__ldg(a.out + pix * (P * P) + dy * P + m) >= 0.f)) v *= 0.1f;
  return v;
}

constexpr int GU = 16;   // values of G a thread holds in flight
constexpr int MAX_CLUSTER = 8;   // the portable cluster size

// fill_g's G without the staging, shared by the blocks of a cluster (the
// channel slices of one column tile, which read the same G): block `rank`
// of `cs` forms the slabs dy = d0 + rank, d0 + rank + cs, ... of [d0, d1)
// (every slab the main loop reads) and writes each into the G of every
// block of the cluster; GU values a thread a round, each round's loads
// before its stores.
template <int P>
__device__ __forceinline__ void fast_fill_g(const Args<bf16>& a, float* G,
                                            cg::cluster_group& cluster,
                                            bool second, int b, int y,
                                            int x0) {
  constexpr int R = (P - 1) / 2;
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int per_dy = (second ? a.tile + 2 * R : a.tile) * P;
  const int d0 = second ? max(0, y + R - a.H + 1) : max(0, R - y);
  const int d1 = second ? min(P, y + R + 1) : min(P, a.H + R - y);
  const int mine = max(0, (d1 - d0 - rank + cs - 1) / cs);
  const int total = mine * per_dy;
  for (int n0 = threadIdx.x; n0 < total; n0 += GU * blockDim.x) {
    float v[GU];
    int dst[GU];
#pragma unroll
    for (int u = 0; u < GU; ++u) {
      const int n = n0 + u * blockDim.x;
      v[u] = 0.f;
      dst[u] = -1;
      if (n < total)
        v[u] = g_value<P>(a, second, b, y, x0,
                          d0 + rank + cs * (n / per_dy), n % per_dy, dst[u]);
    }
#pragma unroll
    for (int u = 0; u < GU; ++u)
      if (dst[u] >= 0)
        for (int r = 0; r < cs; ++r)
          *cluster.map_shared_rank(G + dst[u], r) = v[u];
  }
}

template <int P>
__global__ void correlation_bwd_bf16_fast_kernel(const Args<bf16> a) {
  constexpr int R = (P - 1) / 2;
  constexpr int DROP = kDrop<bf16>;
  extern __shared__ __align__(16) float smem[];
  const int rows = a.tile + 2 * R;
  const int lds = 4 * a.cq + 8;      // bf16 row stride: 16 bytes of padding
  const int s_elems = rows * lds;
  // G [P (dy)][P (e)][tile] fp32, then the ring [FSTAGES][rows][lds] bf16
  float* const G = smem;
  bf16* const S = reinterpret_cast<bf16*>(G + P * P * a.tile);

  const int slice = blockIdx.x % a.nslice;
  const int x0 = (blockIdx.x / a.nslice) * a.tile;
  const int c0 = slice * 4 * a.cq;
  const int y = blockIdx.y;
  const int b = blockIdx.z >> 1;
  const bool second = blockIdx.z & 1;          // dx2
  const bf16* const X = second ? a.x1 : a.x2;
  const int ncol = min(a.tile, a.W - x0);
  const int s0 = max(0, y - R);
  const int s1 = min(a.H, y + R + 1);

  // another block's shared memory may be written only once every block of
  // the cluster has started: arrive now, wait before G's first write
  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // the first rows' copies land while G is formed
#pragma unroll
  for (int k = 0; k < FSTAGES - 1; ++k)
    fast_stage<P>(a, S + k * s_elems, X, b, s0 + k, s1, x0, c0, lds);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (!(DROP & 2)) fast_fill_g<P>(a, G, cluster, second, b, y, x0);
  cluster.sync();              // every slab of G is in every block

  const int grp = threadIdx.x >> a.cq_log2;
  const int q = threadIdx.x & (a.cq - 1);
  const int i0 = TX * grp;
  const bool active = i0 < ncol;

  float4 acc[TX];
#pragma unroll
  for (int t = 0; t < TX; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int s = s0; s < s1; ++s) {
    const int k = s - s0;
    // row s landed (the FSTAGES - 2 later ones may still be in flight);
    // row s - 1's math, which read the buffer refilled next, is done
    asm volatile("cp.async.wait_group %0;\n" ::"n"(FSTAGES - 2));
    __syncthreads();
    fast_stage<P>(a, S + ((k + FSTAGES - 1) % FSTAGES) * s_elems, X, b,
                  s + FSTAGES - 1, s1, x0, c0, lds);
    if (active && !(DROP & 4)) {
      // the general route's window and FMAs, on rows widened from bf16
      const int dy = second ? y - s + R : s - y + R;
      const float* const gs = G + dy * P * a.tile + i0;
      const bf16* const sp = S + (k % FSTAGES) * s_elems + i0 * lds + 4 * q;
      float4 win[TX];
#pragma unroll
      for (int t = 0; t < TX - 1; ++t) win[t + 1] = widen4(sp + t * lds);
#pragma unroll
      for (int e = 0; e < P; ++e) {
#pragma unroll
        for (int t = 0; t < TX - 1; ++t) win[t] = win[t + 1];
        win[TX - 1] = widen4(sp + (e + TX - 1) * lds);
        float w[TX];
#pragma unroll
        for (int t = 0; t < TX; t += 4) {
          const float4 w4 =
              *reinterpret_cast<const float4*>(gs + e * a.tile + t);
          w[t] = w4.x;
          w[t + 1] = w4.y;
          w[t + 2] = w4.z;
          w[t + 3] = w4.w;
        }
#pragma unroll
        for (int t = 0; t < TX; ++t) {
          acc[t].x += w[t] * win[t].x;
          acc[t].y += w[t] * win[t].y;
          acc[t].z += w[t] * win[t].z;
          acc[t].w += w[t] * win[t].w;
        }
      }
    }
  }

  if (!active) return;
  bf16* const D = second ? a.dx2 : a.dx1;
  const float fc = static_cast<float>(a.C);
  const int c = c0 + 4 * q;
  if (c >= a.C) return;
#pragma unroll
  for (int t = 0; t < TX; ++t) {
    if (i0 + t >= ncol) break;
    const float4 v = make_float4(acc[t].x / fc, acc[t].y / fc, acc[t].z / fc,
                                 acc[t].w / fc);
    if ((DROP & 8) && v.x != NEVER) continue;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned*>(&lo);
    raw.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(
        D + ((static_cast<int64_t>(b) * a.H + y) * a.W + x0 + i0 + t) * a.C +
        c) = raw;
  }
}

// ---- launch ----------------------------------------------------------------

// The blocks of both entries and routes: equal column tiles of at most
// MAX_TILE columns, each a whole number of TX, with G within G_BYTES, and
// channel slices of cq quads (a power of two up to MAX_CQ, so that the
// threads of one column group fill whole quarter-warps or divide them).
// Returns the number of column tiles.
template <int P, typename T>
int plan(Args<T>& a) {
  const int max_tile = std::min(MAX_TILE, G_BYTES / (P * P * 4) / TX * TX);
  const int ntile = (a.W + max_tile - 1) / max_tile;
  a.tile = ((a.W + ntile - 1) / ntile + TX - 1) / TX * TX;
  const int quads = (a.C + 3) / 4;
  a.cq = 1;
  a.cq_log2 = 0;
  while (a.cq < MAX_CQ && a.cq < quads) {
    a.cq *= 2;
    ++a.cq_log2;
  }
  a.nslice = (quads + a.cq - 1) / a.cq;
  a.ldc = 4 * a.cq + 4;
  return ntile;
}

template <int P, typename T>
cudaError_t launch(const Args<T>& base, int B, cudaStream_t stream) {
  constexpr int R = (P - 1) / 2;
  Args<T> a = base;
  const int ntile = plan<P>(a);
  // the prologue's g and out overlay the two source rows: as many slabs a
  // round as fit, at least one (then the overlay is larger)
  const int rows = a.tile + 2 * R;
  const int slab = 2 * rows * P;
  a.chunk = std::max(1, 2 * rows * a.ldc / slab);
  const int overlay = std::max(2 * rows * a.ldc, a.chunk * slab);
  const size_t smem =
      (static_cast<size_t>(P) * P * a.tile + overlay) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        correlation_bwd_kernel<P, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = a.tile / TX * a.cq;
  const dim3 grid(ntile * a.nslice, a.H, 2 * B);
  correlation_bwd_kernel<P, T><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_fast(const Args<bf16>& base, int B, cudaStream_t stream) {
  constexpr int R = (P - 1) / 2;
  Args<bf16> a = base;
  const int ntile = plan<P>(a);
  const size_t smem =
      static_cast<size_t>(P) * P * a.tile * sizeof(float) +
      static_cast<size_t>(FSTAGES) * (a.tile + 2 * R) * (4 * a.cq + 8) *
          sizeof(bf16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        correlation_bwd_bf16_fast_kernel<P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  // the channel slices of a column tile share G: one cluster (at most
  // MAX_CLUSTER blocks, else each block forms G alone)
  const int cs = a.nslice <= MAX_CLUSTER ? a.nslice : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ntile * a.nslice, a.H, 2 * B);
  cfg.blockDim = dim3(a.tile / TX * a.cq, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, correlation_bwd_bf16_fast_kernel<P>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int P, typename T>
cudaError_t dispatch(const Args<T>& a, int B, int route, cudaStream_t s) {
  if constexpr (!kF32<T>) {
    if (route) return launch_fast<P>(a, B, s);
  }
  return launch<P>(a, B, s);
}

// Check the arguments and launch the kernel of patch size P; `align`: the
// byte alignment the vectorized loads and stores need (4 channels).
// route: 1 the bf16 fast route (refused unless C % 8 == 0 and x1, x2, dx1,
// dx2 are 16-byte aligned), 0 the general one.
template <typename T>
int run(const float* g, const float* out, const T* x1, const T* x2, T* dx1,
        T* dx2, int ldg, int B, int H, int W, int C, int P, int route,
        void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || P <= 0 || P % 2 == 0 ||
      P > 31 || ldg < P * P || H > 65535 || B > 32767)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr uintptr_t align = 4 * sizeof(T);
  const bool vec = C % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x1) % align == 0 &&
                   reinterpret_cast<uintptr_t>(x2) % align == 0 &&
                   reinterpret_cast<uintptr_t>(dx1) % align == 0 &&
                   reinterpret_cast<uintptr_t>(dx2) % align == 0;
  const bool fast_fits = C % 8 == 0 &&
                         reinterpret_cast<uintptr_t>(x1) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(x2) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(dx1) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(dx2) % 16 == 0;
  if (route != 0 && (kF32<T> || route != 1 || !fast_fits))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<T> a{g, out, x1, x2, dx1, dx2, ldg, H, W, C, 0, 0, 0, 0, 0,
                  vec ? 1 : 0};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (P) {
    case 1: e = dispatch<1>(a, B, route, s); break;
    case 3: e = dispatch<3>(a, B, route, s); break;
    case 5: e = dispatch<5>(a, B, route, s); break;
    case 7: e = dispatch<7>(a, B, route, s); break;
    case 9: e = dispatch<9>(a, B, route, s); break;
    case 11: e = dispatch<11>(a, B, route, s); break;
    case 13: e = dispatch<13>(a, B, route, s); break;
    case 15: e = dispatch<15>(a, B, route, s); break;
    case 17: e = dispatch<17>(a, B, route, s); break;
    case 19: e = dispatch<19>(a, B, route, s); break;
    case 21: e = dispatch<21>(a, B, route, s); break;
    case 23: e = dispatch<23>(a, B, route, s); break;
    case 25: e = dispatch<25>(a, B, route, s); break;
    case 27: e = dispatch<27>(a, B, route, s); break;
    case 29: e = dispatch<29>(a, B, route, s); break;
    default: e = dispatch<31>(a, B, route, s); break;
  }
  return static_cast<int>(e);
}

}  // namespace

// g: [B, H, W, P*P] with channel stride 1 and pixel stride ldg >= P*P;
// out: [B, H, W, P*P] contiguous, or null when the forward applied no
// activation; x1, x2, dx1, dx2: [B, H, W, C] contiguous.  All fp32.  P odd,
// 1 to 31.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int stmask_correlation_bwd(const float* g, const float* out,
                                      const float* x1, const float* x2,
                                      float* dx1, float* dx2, int ldg, int B,
                                      int H, int W, int C, int P,
                                      void* stream) {
  return run<float>(g, out, x1, x2, dx1, dx2, ldg, B, H, W, C, P, 0, stream);
}

// As stmask_correlation_bwd with x1, x2, dx1 and dx2 bf16 (g and out
// fp32): the sums in fp32, each output rounded to bf16.  route: 1 the fast
// route, 0 the general one (both give the same bits); a fast route the
// call cannot take (C % 8 != 0, or a pointer of x1, x2, dx1, dx2 not
// 16-byte aligned) is refused with cudaErrorInvalidValue.
extern "C" int stmask_correlation_bwd_bf16(const float* g, const float* out,
                                           const __nv_bfloat16* x1,
                                           const __nv_bfloat16* x2,
                                           __nv_bfloat16* dx1,
                                           __nv_bfloat16* dx2, int ldg, int B,
                                           int H, int W, int C, int P,
                                           int route, void* stream) {
  return run<bf16>(g, out, x1, x2, dx1, dx2, ldg, B, H, W, C, P, route,
                   stream);
}
