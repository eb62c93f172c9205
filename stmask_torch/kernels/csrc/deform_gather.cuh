// Shared by the fused deformable conv (deform_conv.cu) and its weight
// gradient (deform_wgrad.cu), each built into its own library: the
// modulated bilinear sample of one (site, tap), cp.async, the TF32 split,
// the reduction of a thread-block cluster's partial tiles in rank order,
// and the clustered launch.
//
// The sample (the forward's and the weight gradient's alike):
//   bilinear(x[b], py_k, px_k)[c] * m[b, oy, ox, k]
//   py_k = oy * stride - pad_h + (k / kw) * dilation + offset[.., 2k]
//   px_k = ox * stride - pad_w + (k % kw) * dilation + offset[.., 2k + 1]
// with pad = (k - 1) / 2 * dilation and every bilinear corner outside the
// image weighted zero on its own.  Column k * Cin + c of a site is tap k,
// channel c.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;    // threads of a block, in both kernels
constexpr int MAX_SPLIT = 16;   // blocks of a split cluster (non-portable)

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;

// What one call samples: the input, the offsets and modulation, and the
// geometry.  M = B * Ho * Wo sites, Ktot = kh * kw * Cin columns.  The
// offsets are of type TO: T, or fp32 beside bf16 x (FCB's analytic
// offsets, which the JAX package computes in fp32 from bf16 box deltas).
template <typename T, typename TO = T>
struct Sample {
  const T* x;            // [B, H, W, Cin]
  const TO* offset;      // [B, Ho, Wo, >= 2K], site stride off_ld
  const T* mask;         // [B, Ho, Wo, >= K], site stride mask_ld, or null
  int H, W, Cin, Ho, Wo, kh, kw, stride, dilation;
  int M, Ktot, off_ld, mask_ld;
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(__ldg(p));
}
// x rounded to bf16 (round to nearest even), as an fp32 value
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo exactly, hi with the 13 low mantissa bits cleared (TF32;
// the MMA reads only the top 19 bits of each operand, so lo loses only its
// own low bits there: 2^-20 of x at most).
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}
// The four bilinear corners of one (site, tap): element index of each
// corner's first channel within the site's image (-1 when outside) and its
// weight.  fp32 folds the modulation into the weight; bf16 keeps the
// weight rounded to bf16 and applies the modulation m after the sum.
template <typename T>
struct Corners {
  const T* img;
  int idx[4];
  float w[4];
  float m;
};

// One (site, tap)'s offset (dy, dx) and modulation, as read from memory.
struct TapIn {
  float dy, dx, m;
};

template <typename T, typename TO>
__device__ __forceinline__ TapIn tap_in(const Sample<T, TO>& p, int m,
                                        int tap) {
  if (m >= p.M) return TapIn{0.f, 0.f, 0.f};
  const TO* off = p.offset + static_cast<int64_t>(m) * p.off_ld + 2 * tap;
  return TapIn{ld(off), ld(off + 1),
               p.mask != nullptr
                   ? ld(p.mask + static_cast<int64_t>(m) * p.mask_ld + tap)
                   : 1.f};
}

// The corners of the sample at the integer point (by, bx) of image b
// (tap position and stride already applied) plus the offset in `in`.
template <typename T, typename TO>
__device__ __forceinline__ void corners_at(const Sample<T, TO>& p, int b,
                                           int by, int bx, const TapIn& in,
                                           Corners<T>& cn) {
  cn.m = in.m;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    cn.idx[j] = -1;
    cn.w[j] = 0.f;
  }
  const float py = static_cast<float>(by) + in.dy;
  const float px = static_cast<float>(bx) + in.dx;
  const float mk = in.m;
  // Clamping far-away coordinates keeps the int conversion defined and
  // changes nothing: every corner of such a sample is outside the image.
  const float fy = floorf(fminf(fmaxf(py, -2.f), static_cast<float>(p.H)));
  const float fx = floorf(fminf(fmaxf(px, -2.f), static_cast<float>(p.W)));
  const int y0 = static_cast<int>(fy);
  const int x0 = static_cast<int>(fx);
  const float ly = py - fy, lx = px - fx;
  const float hy = 1.f - ly, hx = 1.f - lx;
  cn.img = p.x + static_cast<int64_t>(b) * p.H * p.W * p.Cin;
  const float wy[2] = {hy, ly}, wx[2] = {hx, lx};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int yy = y0 + (j >> 1), xx = x0 + (j & 1);
    if (yy >= 0 && yy < p.H && xx >= 0 && xx < p.W) {
      cn.idx[j] = (yy * p.W + xx) * p.Cin;
      if constexpr (kF32<T>)
        cn.w[j] = wy[j >> 1] * wx[j & 1] * mk;
      else
        cn.w[j] = rbf(wy[j >> 1] * wx[j & 1]);
    }
  }
}

// The corners of site m's sample at tap `tap` (none past the last site).
template <typename T, typename TO>
__device__ __forceinline__ void corners_from(const Sample<T, TO>& p, int m,
                                             int tap, const TapIn& in,
                                             Corners<T>& cn) {
  if (m >= p.M) {
    cn.img = p.x;
    cn.m = in.m;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cn.idx[j] = -1;
      cn.w[j] = 0.f;
    }
    return;
  }
  const int ox = m % p.Wo;
  const int t = m / p.Wo;
  const int oy = t % p.Ho;
  const int b = t / p.Ho;
  const int pad_h = (p.kh - 1) / 2 * p.dilation;
  const int pad_w = (p.kw - 1) / 2 * p.dilation;
  corners_at(p, b, oy * p.stride - pad_h + (tap / p.kw) * p.dilation,
             ox * p.stride - pad_w + (tap % p.kw) * p.dilation, in, cn);
}

// One channel of a bf16 sample: the rounded corner products summed in
// fp32, rounded, times the modulation, rounded.
__device__ __forceinline__ float bf16_sample(const float (&w)[4],
                                             const float (&v)[4], float m) {
  const float s = rbf(w[0] * v[0]) + rbf(w[1] * v[1]) + rbf(w[2] * v[2]) +
                  rbf(w[3] * v[3]);
  return rbf(rbf(s) * m);
}

// One sampled element (site m, column k), for the shapes off the fast
// path; zero past the last site or column.
template <typename T, typename TO>
__device__ __forceinline__ float sample_scalar(const Sample<T, TO>& p, int m,
                                               int k) {
  if (m >= p.M || k >= p.Ktot) return 0.f;
  const int tap = k / p.Cin, c = k - tap * p.Cin;
  Corners<T> cn;
  corners_from(p, m, tap, tap_in(p, m, tap), cn);
  if constexpr (kF32<T>) {
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (cn.idx[j] >= 0) v += cn.w[j] * __ldg(cn.img + cn.idx[j] + c);
    return v;
  } else {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = cn.idx[j] >= 0 ? ld(cn.img + cn.idx[j] + c) : 0.f;
    return bf16_sample(cn.w, v, cn.m);
  }
}

// Split reduction.  Each of the cluster's n_split blocks holds its partial
// fp32 tile [ROWS][COLS] at `part` in its own shared memory, written before
// a cluster barrier.  n_split is a power of two (it divides ROWS): block r
// sums the r-th ROWS / n_split rows of all the partial tiles through
// distributed shared memory in rank order (deterministic, no atomics), four
// columns at a time with every rank's load in flight before the sum, and
// hands each sum to emit(row, col, v).  A cluster barrier after it keeps
// every partial tile alive until it is read.  NT: the threads of a block.
template <int ROWS, int COLS, int NT = THREADS, typename Emit>
__device__ __forceinline__ void cluster_reduce(cg::cluster_group& cluster,
                                               float* part, int n_split,
                                               Emit&& emit) {
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows = ROWS / n_split;
  const int r0 = rank * rows;
  for (int e = threadIdx.x; e < rows * COLS / 4; e += NT) {
    const int rl = r0 + e / (COLS / 4), c = (e % (COLS / 4)) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q0 = 0; q0 < n_split; q0 += 4) {
      float4 q[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (q0 + r < n_split)
          q[r] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(part, q0 + r) + rl * COLS + c);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (q0 + r < n_split) {
          v[0] += q[r].x;
          v[1] += q[r].y;
          v[2] += q[r].z;
          v[3] += q[r].w;
        }
    }
    emit(rl, c, v);
  }
}

// Let `kernel` take `smem` bytes of dynamic shared memory and a
// non-portable cluster size.
template <typename P>
cudaError_t allow_clusters(void (*kernel)(P), int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// Launch `kernel` on a grid (gx, gy, split) of `threads`-thread blocks
// whose split dimension is one thread-block cluster (1 to MAX_SPLIT
// blocks), with `smem` bytes of dynamic shared memory (see allow_clusters).
template <typename P>
cudaError_t launch_split(void (*kernel)(P), int gx, int gy, int split,
                         int smem, void* stream, const P& p,
                         int threads = THREADS) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy, split);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

}  // namespace
