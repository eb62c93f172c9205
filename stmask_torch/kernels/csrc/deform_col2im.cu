// K4: backward of the window-clamped modulated deformable gather (col2im),
// fp32, NHWC.
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
//   dx[b, by + u, bx + w, c] += m * hy_u * hx_w * dcols[s, k, c]   (atomic)
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
// (0.17 ms at 3.35 TB/s); x's corners come from L2.
//
// Design (a first, simple kernel): one warp per (site, tap).  The corner
// weights are computed once per warp; the lanes walk the channels (float4
// when Cin % 4 == 0), read dcols once and each in-image corner pixel once,
// add into dx with fp32 atomics (so dx's low bits depend on the order of
// the adds) and keep a partial S per corner pair.  The S are summed by a
// warp shuffle butterfly and lane 0 writes d_mask and d_offset, so those
// two are deterministic.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;

__device__ __forceinline__ float dot(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

template <int VEC>
__global__ void __launch_bounds__(WARPS * 32) deform_col2im_kernel(
    const float* __restrict__ dcols, const float* __restrict__ x,
    const float* __restrict__ offset, const float* __restrict__ mask,
    float* __restrict__ dx, float* __restrict__ doffset,
    float* __restrict__ dmask, int H, int W, int Cin, int Ho, int Wo, int kh,
    int kw, int stride, int dilation, int radius, int64_t items) {
  const int lane = threadIdx.x & 31;
  const int K = kh * kw;
  const int pad_h = (kh - 1) / 2 * dilation;
  const int pad_w = (kw - 1) / 2 * dilation;
  for (int64_t item = static_cast<int64_t>(blockIdx.x) * WARPS +
                      (threadIdx.x >> 5);
       item < items; item += static_cast<int64_t>(gridDim.x) * WARPS) {
    const int k = static_cast<int>(item % K);
    const int64_t site = item / K;              // (b * Ho + oy) * Wo + ox
    const int ox = static_cast<int>(site % Wo);
    const int64_t bo = site / Wo;
    const int oy = static_cast<int>(bo % Ho);
    const int64_t b = bo / Ho;
    const float oyf = offset[site * 2 * K + 2 * k];
    const float oxf = offset[site * 2 * K + 2 * k + 1];
    const float m = mask != nullptr ? mask[site * K + k] : 1.f;
    const int by = oy * stride - pad_h + (k / kw) * dilation;
    const int bx = ox * stride - pad_w + (k % kw) * dilation;
    const int fy = static_cast<int>(floorf(oyf));
    const int fx = static_cast<int>(floorf(oxf));

    float hy[3], dhy[3], hx[3], dhx[3];
    int row[3], col[3];
    bool rin[3], cin_[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int u = fy - 1 + j;
      hat(oyf, u, u >= -radius && u <= radius + 1, &hy[j], &dhy[j]);
      row[j] = by + u;
      rin[j] = row[j] >= 0 && row[j] < H;
      const int v = fx - 1 + j;
      hat(oxf, v, v >= -radius && v <= radius + 1, &hx[j], &dhx[j]);
      col[j] = bx + v;
      cin_[j] = col[j] >= 0 && col[j] < W;
    }
    // corner pairs that carry a weight and lie in the image (warp-uniform)
    float wgt[9];
    unsigned active = 0;
#pragma unroll
    for (int p = 0; p < 9; ++p) {
      const int j = p / 3, i = p % 3;
      wgt[p] = hy[j] * hx[i];
      if ((wgt[p] != 0.f || dhy[j] * hx[i] != 0.f || hy[j] * dhx[i] != 0.f)
          && rin[j] && cin_[i])
        active |= 1u << p;
    }

    float S[9];
#pragma unroll
    for (int p = 0; p < 9; ++p) S[p] = 0.f;
    if (active != 0) {
      const float* dc_row = dcols + item * Cin;
      const float* img = x + b * H * W * Cin;
      float* dimg = dx + b * H * W * Cin;
      for (int c = lane * VEC; c < Cin; c += 32 * VEC) {
        float4 dc;
        if constexpr (VEC == 4) {
          dc = *reinterpret_cast<const float4*>(dc_row + c);
        } else {
          dc = make_float4(dc_row[c], 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int p = 0; p < 9; ++p) {
          if (!(active & (1u << p))) continue;
          const int64_t q =
              (static_cast<int64_t>(row[p / 3]) * W + col[p % 3]) * Cin + c;
          float4 xv;
          if constexpr (VEC == 4) {
            xv = *reinterpret_cast<const float4*>(img + q);
          } else {
            xv = make_float4(img[q], 0.f, 0.f, 0.f);
          }
          S[p] += dot(dc, xv);
          if (wgt[p] != 0.f) {
            const float a = m * wgt[p];
            atomicAdd(dimg + q, a * dc.x);
            if constexpr (VEC == 4) {
              atomicAdd(dimg + q + 1, a * dc.y);
              atomicAdd(dimg + q + 2, a * dc.z);
              atomicAdd(dimg + q + 3, a * dc.w);
            }
          }
        }
      }
    }
    float s_m = 0.f, s_y = 0.f, s_x = 0.f;
#pragma unroll
    for (int p = 0; p < 9; ++p) {
      if (!(active & (1u << p))) continue;
      const float sp = warp_sum(S[p]);
      const int j = p / 3, i = p % 3;
      s_m += wgt[p] * sp;
      s_y += dhy[j] * hx[i] * sp;
      s_x += hy[j] * dhx[i] * sp;
    }
    if (lane == 0) {
      if (dmask != nullptr) dmask[site * K + k] = s_m;
      doffset[site * 2 * K + 2 * k] = m * s_y;
      doffset[site * 2 * K + 2 * k + 1] = m * s_x;
    }
  }
}

template <int VEC>
cudaError_t launch(const float* dcols, const float* x, const float* offset,
                   const float* mask, float* dx, float* doffset, float* dmask,
                   int B, int H, int W, int Cin, int Ho, int Wo, int kh,
                   int kw, int stride, int dilation, int radius,
                   cudaStream_t stream) {
  const int64_t items = static_cast<int64_t>(B) * Ho * Wo * kh * kw;
  if (items == 0) return cudaSuccess;
  const int64_t need = (items + WARPS - 1) / WARPS;
  const int64_t blocks = need < (int64_t(1) << 30) ? need : int64_t(1) << 30;
  deform_col2im_kernel<VEC><<<static_cast<unsigned>(blocks), WARPS * 32, 0,
                              stream>>>(dcols, x, offset, mask, dx, doffset,
                                        dmask, H, W, Cin, Ho, Wo, kh, kw,
                                        stride, dilation, radius, items);
  return cudaGetLastError();
}

}  // namespace

// dcols: [B*Ho*Wo, kh*kw*Cin] (taps outer, channels inner, as K2 lays out
// cols); x, dx: [B, H, W, Cin] (dx zeroed by the caller, then accumulated);
// offset, doffset: [B, Ho, Wo, 2*kh*kw] (dy, dx)-interleaved, offset
// already clamped to [-radius, radius]; mask, dmask: [B, Ho, Wo, kh*kw] or
// both null (v1).  All fp32 contiguous.  Returns cudaGetLastError().
extern "C" int stmask_deform_col2im(const float* dcols, const float* x,
                                    const float* offset, const float* mask,
                                    float* dx, float* doffset, float* dmask,
                                    int B, int H, int W, int Cin, int Ho,
                                    int Wo, int kh, int kw, int stride,
                                    int dilation, int radius, void* stream) {
  if (B < 0 || H <= 0 || W <= 0 || Cin <= 0 || Ho < 0 || Wo < 0 || kh <= 0 ||
      kw <= 0 || stride <= 0 || dilation <= 0 || radius <= 0 ||
      (mask == nullptr) != (dmask == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = Cin % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(dcols) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const cudaError_t e =
      aligned ? launch<4>(dcols, x, offset, mask, dx, doffset, dmask, B, H,
                          W, Cin, Ho, Wo, kh, kw, stride, dilation, radius, s)
              : launch<1>(dcols, x, offset, mask, dx, doffset, dmask, B, H,
                          W, Cin, Ho, Wo, kh, kw, stride, dilation, radius,
                          s);
  return static_cast<int>(e);
}
