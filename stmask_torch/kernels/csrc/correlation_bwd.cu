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
// The bf16 entry is the same kernel with the source rows converted to fp32
// as they are staged (plain loads of 4 channels at a time, since cp.async
// copies bytes as they are, and S stays fp32), the sums in fp32 as above
// and each output rounded to bf16 once, when it is written.  Its loads do
// not overlap the previous row's math the way cp.async does: a first
// version, right and simple (ROADMAP B lists its second pass).

#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TX = 4;            // columns of a thread's register tile
constexpr int MAX_TILE = 64;     // columns per block
constexpr int MAX_CQ = 32;       // channel quads per block (128 channels)
constexpr int G_BYTES = 64 * 1024;   // most shared memory G may take

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
    for (int e = threadIdx.x; e < rows * per; e += blockDim.x) {
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

template <int P, typename T>
cudaError_t launch(const Args<T>& base, int B, cudaStream_t stream) {
  constexpr int R = (P - 1) / 2;
  Args<T> a = base;
  // equal column tiles of at most MAX_TILE columns, each a whole number
  // of TX, with G within G_BYTES
  const int max_tile = std::min(MAX_TILE, G_BYTES / (P * P * 4) / TX * TX);
  const int ntile = (a.W + max_tile - 1) / max_tile;
  a.tile = ((a.W + ntile - 1) / ntile + TX - 1) / TX * TX;
  // channel quads per block: a power of two up to MAX_CQ, so that the
  // threads of one column group fill whole quarter-warps or divide them
  const int quads = (a.C + 3) / 4;
  a.cq = 1;
  a.cq_log2 = 0;
  while (a.cq < MAX_CQ && a.cq < quads) {
    a.cq *= 2;
    ++a.cq_log2;
  }
  a.nslice = (quads + a.cq - 1) / a.cq;
  a.ldc = 4 * a.cq + 4;
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

// Check the arguments and launch the kernel of patch size P; `align`: the
// byte alignment the vectorized loads and stores need (4 channels).
template <typename T>
int run(const float* g, const float* out, const T* x1, const T* x2, T* dx1,
        T* dx2, int ldg, int B, int H, int W, int C, int P, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || P <= 0 || P % 2 == 0 ||
      P > 31 || ldg < P * P || H > 65535 || B > 32767)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr uintptr_t align = 4 * sizeof(T);
  const bool vec = C % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x1) % align == 0 &&
                   reinterpret_cast<uintptr_t>(x2) % align == 0 &&
                   reinterpret_cast<uintptr_t>(dx1) % align == 0 &&
                   reinterpret_cast<uintptr_t>(dx2) % align == 0;
  const Args<T> a{g, out, x1, x2, dx1, dx2, ldg, H, W, C, 0, 0, 0, 0, 0,
                  vec ? 1 : 0};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (P) {
    case 1: e = launch<1>(a, B, s); break;
    case 3: e = launch<3>(a, B, s); break;
    case 5: e = launch<5>(a, B, s); break;
    case 7: e = launch<7>(a, B, s); break;
    case 9: e = launch<9>(a, B, s); break;
    case 11: e = launch<11>(a, B, s); break;
    case 13: e = launch<13>(a, B, s); break;
    case 15: e = launch<15>(a, B, s); break;
    case 17: e = launch<17>(a, B, s); break;
    case 19: e = launch<19>(a, B, s); break;
    case 21: e = launch<21>(a, B, s); break;
    case 23: e = launch<23>(a, B, s); break;
    case 25: e = launch<25>(a, B, s); break;
    case 27: e = launch<27>(a, B, s); break;
    case 29: e = launch<29>(a, B, s); break;
    default: e = launch<31>(a, B, s); break;
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
  return run<float>(g, out, x1, x2, dx1, dx2, ldg, B, H, W, C, P, stream);
}

// As stmask_correlation_bwd with x1, x2, dx1 and dx2 bf16 (g and out
// fp32): the sums in fp32, each output rounded to bf16.
extern "C" int stmask_correlation_bwd_bf16(const float* g, const float* out,
                                           const __nv_bfloat16* x1,
                                           const __nv_bfloat16* x2,
                                           __nv_bfloat16* dx1,
                                           __nv_bfloat16* dx2, int ldg, int B,
                                           int H, int W, int C, int P,
                                           void* stream) {
  return run<bf16>(g, out, x1, x2, dx1, dx2, ldg, B, H, W, C, P, stream);
}
