// K2: modulated deformable gather (im2col), fp32, NHWC.
//
// Replaces: the gather half of stmask_tpu/ops/deform_conv.py::deform_conv2d
// (deform_conv.py:50-84) with ops/sampling.py::bilinear_sample_block, the
// hand-written XLA gather that the JAX package runs at the 7 DCN sites of
// the R50 backbone.  (The reference's own op was the DCNv2 CUDA kernel.)
// The contraction with the [K*Cin, Cout] weight stays one cuBLAS matmul in
// the caller, as the JAX package leaves its jnp.dot to XLA.
//
//   cols[(b, oy, ox), k * Cin + c] = m[b, oy, ox, k] * bilinear(x[b], py, px)[c]
//   py = oy * stride - pad_h + (k / kw) * dilation + offset[b, oy, ox, 2k]
//   px = ox * stride - pad_w + (k % kw) * dilation + offset[b, oy, ox, 2k+1]
//
// with pad = (k - 1) / 2 * dilation and every bilinear corner outside the
// image weighted zero.  The (tap, channel) column order equals
// weight.reshape(K * Cin, Cout) of the HWIO weight.
//
// What bounds it on an H100: bytes.  Each output element costs ~9 flops
// but 4 bytes written and up to 16 bytes of corner reads; at the largest
// main-path site (layer1_0: x 96x160x128 -> cols 48x80 x 9x128) the
// function must read 7.9 MB and write 17.7 MB: ~7.6 us at 3.35 TB/s
// against ~0.6 us of fp32 ALU time.
//
// Design: one thread per (site, tap, group of VEC channels), channel
// innermost, so a warp's corner reads are contiguous runs of NHWC channels
// and its writes to cols are contiguous (cols is written exactly once, in
// its memory order).  VEC = 4 (float4 loads and stores) when Cin % 4 == 0
// and the pointers are 16-byte aligned.  The offset and mask of a
// (site, tap) are read by the Cin / VEC threads that share them, which the
// L1 cache serves.  Corner rows are re-read by neighbouring taps and
// sites from L2 (x of every main-path site fits in the 50 MB L2).
//
// No path launches K2 any more: the forward runs the gather fused into its
// GEMM (deform_conv.cu), and the DCN backward fuses it into the weight
// gradient's (deform_wgrad.cu), so cols never reaches HBM.  K2 stays as the
// yardstick both are timed against.

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
  static __device__ __forceinline__ T scale(const T& v, float m) {
    return v * m;
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
  static __device__ __forceinline__ T scale(const T& v, float m) {
    return make_float4(v.x * m, v.y * m, v.z * m, v.w * m);
  }
};

template <int VEC>
__global__ void deform_im2col_kernel(
    const float* __restrict__ x, const float* __restrict__ offset,
    const float* __restrict__ mask, float* __restrict__ cols, int H, int W,
    int Cin, int Ho, int Wo, int kh, int kw, int stride, int dilation,
    int64_t total) {
  using V = Vec<VEC>;
  using T = typename V::T;
  const int K = kh * kw;
  const int cv = Cin / VEC;
  const int pad_h = (kh - 1) / 2 * dilation;
  const int pad_w = (kw - 1) / 2 * dilation;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % cv) * VEC;
    const int64_t rest = i / cv;
    const int k = static_cast<int>(rest % K);
    const int64_t site = rest / K;              // (b * Ho + oy) * Wo + ox
    const int ox = static_cast<int>(site % Wo);
    const int64_t bo = site / Wo;
    const int oy = static_cast<int>(bo % Ho);
    const int64_t b = bo / Ho;

    const float* off = offset + site * 2 * K + 2 * k;
    const float py = static_cast<float>(oy * stride - pad_h +
                                        (k / kw) * dilation) + off[0];
    const float px = static_cast<float>(ox * stride - pad_w +
                                        (k % kw) * dilation) + off[1];
    const float m = mask != nullptr ? mask[site * K + k] : 1.f;

    // Clamping far-away coordinates keeps the int conversion defined and
    // changes nothing: every corner of such a sample is outside the image.
    const float fy = floorf(fminf(fmaxf(py, -2.f), static_cast<float>(H)));
    const float fx = floorf(fminf(fmaxf(px, -2.f), static_cast<float>(W)));
    const int y0 = static_cast<int>(fy);
    const int x0 = static_cast<int>(fx);
    const float ly = py - fy, lx = px - fx;
    const float hy = 1.f - ly, hx = 1.f - lx;

    const float* img = x + b * H * W * Cin + c;
    T acc = V::zero();
    const bool y0_in = y0 >= 0 && y0 < H, y1_in = y0 + 1 >= 0 && y0 + 1 < H;
    const bool x0_in = x0 >= 0 && x0 < W, x1_in = x0 + 1 >= 0 && x0 + 1 < W;
    if (y0_in && x0_in)
      V::fma(acc, hy * hx,
             *reinterpret_cast<const T*>(img + (int64_t(y0) * W + x0) * Cin));
    if (y0_in && x1_in)
      V::fma(acc, hy * lx,
             *reinterpret_cast<const T*>(img +
                                         (int64_t(y0) * W + x0 + 1) * Cin));
    if (y1_in && x0_in)
      V::fma(acc, ly * hx,
             *reinterpret_cast<const T*>(img +
                                         (int64_t(y0 + 1) * W + x0) * Cin));
    if (y1_in && x1_in)
      V::fma(acc, ly * lx,
             *reinterpret_cast<const T*>(
                 img + (int64_t(y0 + 1) * W + x0 + 1) * Cin));
    *reinterpret_cast<T*>(cols + i * VEC) = V::scale(acc, m);
  }
}

template <int VEC>
cudaError_t launch(const float* x, const float* offset, const float* mask,
                   float* cols, int B, int H, int W, int Cin, int Ho, int Wo,
                   int kh, int kw, int stride, int dilation,
                   cudaStream_t stream) {
  const int64_t total =
      static_cast<int64_t>(B) * Ho * Wo * kh * kw * (Cin / VEC);
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks == 0) return cudaSuccess;
  deform_im2col_kernel<VEC><<<static_cast<unsigned>(blocks), threads, 0,
                              stream>>>(x, offset, mask, cols, H, W, Cin, Ho,
                                        Wo, kh, kw, stride, dilation, total);
  return cudaGetLastError();
}

}  // namespace

// x: [B, H, W, Cin]; offset: [B, Ho, Wo, 2*kh*kw] (dy, dx)-interleaved per
// tap; mask: [B, Ho, Wo, kh*kw] or null (v1); cols: [B*Ho*Wo, kh*kw*Cin].
// All fp32 contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int stmask_deform_im2col(const float* x, const float* offset,
                                    const float* mask, float* cols, int B,
                                    int H, int W, int Cin, int Ho, int Wo,
                                    int kh, int kw, int stride, int dilation,
                                    void* stream) {
  if (B < 0 || H <= 0 || W <= 0 || Cin <= 0 || Ho < 0 || Wo < 0 || kh <= 0 ||
      kw <= 0 || stride <= 0 || dilation <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(cols) % 16 == 0;
  const cudaError_t e =
      aligned ? launch<4>(x, offset, mask, cols, B, H, W, Cin, Ho, Wo, kh, kw,
                          stride, dilation, s)
              : launch<1>(x, offset, mask, cols, B, H, W, Cin, Ho, Wo, kh, kw,
                          stride, dilation, s);
  return static_cast<int>(e);
}
