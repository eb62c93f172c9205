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
// Design (a simple one): one warp a (site, tap) item, lanes over the
// channels (VEC = 4 channels a lane where Cin is a multiple of 4 and the
// pointers are aligned for it, else 1).  Each lane computes the item's
// block, weights and derivatives, reads dcols and the up to four corners'
// channels, folds its part of S into three sums and adds the weighted
// dcols to dx with fp32 reductions in device memory (float4 ones, sm_90,
// at VEC 4).  A fixed butterfly reduces the three sums, so d_offset and
// d_mask are the same bit for bit over two launches; dx's low bits depend
// on the order of the adds.  The bf16 entries read bf16 values as they
// are, compute in fp32, sum dx into an fp32 buffer that the entry zeroes
// and then rounds to bf16 (a second small kernel), and round d_offset and
// d_mask once.

#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;

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
    ld<VEC>(dc + c, d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (at[j] < 0) continue;
      float v[VEC];
      ld<VEC>(x + at[j] + c, v);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) s += d[i] * v[i];
      s_m += cw[j] * s;
      s_y += cy[j] * s;
      s_x += cx[j] * s;
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

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// dx: the fp32 sums (the bf16 entries' scratch), zeroed here; dxh: the bf16
// dx they are rounded into (bf16 only).
template <typename T, typename TO>
int run(const T* dcols, const T* x, const TO* offset, const T* mask,
        float* dx, bf16* dxh, TO* doffset, T* dmask, int B, int H, int W,
        int Cin, int Ho, int Wo, int kh, int kw, int stride, int dilation,
        void* stream_) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if (B < 0 || H < 1 || W < 1 || Cin < 1 || Ho < 0 || Wo < 0 || kh < 1 ||
      kw < 1 || stride < 1 || dilation < 1)
    return cudaErrorInvalidValue;
  const int64_t items64 = static_cast<int64_t>(B) * Ho * Wo * kh * kw;
  const int64_t n_dx = static_cast<int64_t>(B) * H * W * Cin;
  if (items64 * Cin >= (int64_t{1} << 31) || n_dx >= (int64_t{1} << 31))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(dx, 0, n_dx * sizeof(float), stream);
  if (e != cudaSuccess) return e;
  const Shape g{H, W, Cin, Ho, Wo, kh, kw, stride, dilation,
                static_cast<int>(items64)};
  if (items64 > 0) {
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
    if (n_dx > 0) {
      deform_exact_bwd_round_kernel<<<static_cast<unsigned>(std::min<int64_t>(
                                          (n_dx + 255) / 256, 4096)),
                                      256, 0, stream>>>(dx, dxh, n_dx);
      e = cudaGetLastError();
    }
  }
  return e;
}

}  // namespace

// dcols [B*Ho*Wo, K*Cin], x [B, H, W, Cin], offset [B, Ho, Wo, 2K] (raw),
// mask [B, Ho, Wo, K] or null -> dx (zeroed here), d_offset, d_mask (null
// without the mask); every tensor contiguous.
extern "C" int stmask_deform_exact_bwd(const float* dcols, const float* x,
                                       const float* offset, const float* mask,
                                       float* dx, float* doffset, float* dmask,
                                       int B, int H, int W, int Cin, int Ho,
                                       int Wo, int kh, int kw, int stride,
                                       int dilation, void* stream) {
  return run<float, float>(dcols, x, offset, mask, dx, nullptr, doffset,
                           dmask, B, H, W, Cin, Ho, Wo, kh, kw, stride,
                           dilation, stream);
}

// As stmask_deform_exact_bwd with dcols, x, mask, offset, dx, d_offset and
// d_mask bf16; dx32: [B, H, W, Cin] fp32 scratch, zeroed here, where dx
// sums before it is rounded into dx.
extern "C" int stmask_deform_exact_bwd_bf16(
    const __nv_bfloat16* dcols, const __nv_bfloat16* x,
    const __nv_bfloat16* offset, const __nv_bfloat16* mask, float* dx32,
    __nv_bfloat16* dx, __nv_bfloat16* doffset, __nv_bfloat16* dmask, int B,
    int H, int W, int Cin, int Ho, int Wo, int kh, int kw, int stride,
    int dilation, void* stream) {
  return run(dcols, x, offset, mask, dx32, dx, doffset, dmask, B, H, W, Cin,
             Ho, Wo, kh, kw, stride, dilation, stream);
}

// As stmask_deform_exact_bwd_bf16 with fp32 offsets and d_offset (FCB's
// analytic offsets).
extern "C" int stmask_deform_exact_bwd_bf16_f32off(
    const __nv_bfloat16* dcols, const __nv_bfloat16* x, const float* offset,
    const __nv_bfloat16* mask, float* dx32, __nv_bfloat16* dx,
    float* doffset, __nv_bfloat16* dmask, int B, int H, int W, int Cin,
    int Ho, int Wo, int kh, int kw, int stride, int dilation, void* stream) {
  return run(dcols, x, offset, mask, dx32, dx, doffset, dmask, B, H, W, Cin,
             Ho, Wo, kh, kw, stride, dilation, stream);
}
