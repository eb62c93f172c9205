// K3: backward of the cross-frame local correlation, fp32, NHWC.
//
// Replaces: the XLA transpose of stmask_tpu/ops/correlation.py::correlate,
// which the JAX package differentiates in training (models/stmask.py:139);
// its forward on the card is K1 (csrc/correlation.cu), which replaces the
// Pallas kernel kernels/correlation_pallas.py::correlate_pallas.
//
// Given g[b, y, x, d], the upstream gradient already multiplied by the
// leaky ReLU's derivative, with d = (dy + r) * P + (dx + r):
//
//   dx1[b, y, x, c]   = sum_d g[b, y, x, d] * x2[b, y + dy, x + dx, c] / C
//   dx2[b, y', x', c] = sum_d g[b, y' - dy, x' - dx, d]
//                             * x1[b, y' - dy, x' - dx, c] / C
//
// with every term whose pixel lies outside the image counted as zero.
//
// What bounds it on an H100: operations.  At the training shape
// (B 4, 24 x 40, C 256, P 11) it does 2 * 2 * 3840 * 121 * 256 = 0.48 GFLOP
// of fp32 FMAs (7 us at 67 TFLOP/s) and must move 3 * 3.9 MB in (g is
// 1.9 MB) and 2 * 3.9 MB out: 18 MB, 5 us at 3.35 TB/s.
//
// Design (a first, simple kernel): gather form, so no atomics and a
// deterministic sum.  One thread owns VEC channels of one pixel of both
// outputs and walks the P * P displacements in order, reading the
// displaced pixel of x2 (for dx1) and of x1 (for dx2) as float4 when
// C % 4 == 0.  Neighbouring threads hold neighbouring channels of one
// pixel, so every read of x1 / x2 is a contiguous run and the g value of a
// displacement is one broadcast load for the C / VEC threads of a pixel.
// Every x1 / x2 pixel is re-read by the P * P pixels around it: from L1 and
// L2, not from HBM (each input is 3.9 MB).  Staging rows in shared memory,
// as K1 does, is later work.

#include <cstdint>

#include "common.cuh"

namespace {

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ void fma(T& acc, float w, const T& v) {
    acc += w * v;
  }
  static __device__ __forceinline__ T div(const T& v, float c) {
    return v / c;
  }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ void fma(T& acc, float w, const T& v) {
    acc.x += w * v.x;
    acc.y += w * v.y;
    acc.z += w * v.z;
    acc.w += w * v.w;
  }
  static __device__ __forceinline__ T div(const T& v, float c) {
    return make_float4(v.x / c, v.y / c, v.z / c, v.w / c);
  }
};

template <int VEC>
__global__ void correlation_bwd_kernel(const float* __restrict__ g,
                                       const float* __restrict__ x1,
                                       const float* __restrict__ x2,
                                       float* __restrict__ dx1,
                                       float* __restrict__ dx2, int H, int W,
                                       int C, int P, int64_t total) {
  using V = Vec<VEC>;
  using T = typename V::T;
  const int cv = C / VEC;
  const int r = (P - 1) / 2;
  const int PP = P * P;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % cv) * VEC;
    const int64_t pix = i / cv;                 // (b * H + y) * W + x
    const int x = static_cast<int>(pix % W);
    const int64_t by = pix / W;
    const int y = static_cast<int>(by % H);
    const int64_t img = (by / H) * H * W;       // first pixel of image b
    const float* gp = g + pix * PP;
    T acc1 = V::zero();
    T acc2 = V::zero();
    for (int dy = 0; dy < P; ++dy) {
      const int yy = y + dy - r;                // x2 row read for dx1
      const int ys = y - dy + r;                // source row of dx2's term
      const bool yy_in = yy >= 0 && yy < H;
      const bool ys_in = ys >= 0 && ys < H;
      for (int dx = 0; dx < P; ++dx) {
        const int d = dy * P + dx;
        const int xx = x + dx - r;
        const int xs = x - dx + r;
        if (yy_in && xx >= 0 && xx < W) {
          const int64_t q = img + static_cast<int64_t>(yy) * W + xx;
          V::fma(acc1, gp[d], *reinterpret_cast<const T*>(x2 + q * C + c));
        }
        if (ys_in && xs >= 0 && xs < W) {
          const int64_t q = img + static_cast<int64_t>(ys) * W + xs;
          V::fma(acc2, g[q * PP + d],
                 *reinterpret_cast<const T*>(x1 + q * C + c));
        }
      }
    }
    const float fc = static_cast<float>(C);
    *reinterpret_cast<T*>(dx1 + pix * C + c) = V::div(acc1, fc);
    *reinterpret_cast<T*>(dx2 + pix * C + c) = V::div(acc2, fc);
  }
}

template <int VEC>
cudaError_t launch(const float* g, const float* x1, const float* x2,
                   float* dx1, float* dx2, int B, int H, int W, int C, int P,
                   cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(B) * H * W * (C / VEC);
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks == 0) return cudaSuccess;
  correlation_bwd_kernel<VEC><<<static_cast<unsigned>(blocks), threads, 0,
                                stream>>>(g, x1, x2, dx1, dx2, H, W, C, P,
                                          total);
  return cudaGetLastError();
}

}  // namespace

// g: [B, H, W, P*P]; x1, x2, dx1, dx2: [B, H, W, C].  All fp32 contiguous.
// P odd.  Returns cudaGetLastError() after the launch.
extern "C" int stmask_correlation_bwd(const float* g, const float* x1,
                                      const float* x2, float* dx1,
                                      float* dx2, int B, int H, int W, int C,
                                      int P, void* stream) {
  if (B < 0 || H <= 0 || W <= 0 || C <= 0 || P <= 0 || P % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = C % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(x1) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x2) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dx1) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dx2) % 16 == 0;
  const cudaError_t e =
      aligned ? launch<4>(g, x1, x2, dx1, dx2, B, H, W, C, P, s)
              : launch<1>(g, x1, x2, dx1, dx2, B, H, W, C, P, s);
  return static_cast<int>(e);
}
