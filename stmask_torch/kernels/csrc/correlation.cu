// K1: cross-frame local correlation (cost volume), fp32, NHWC.
//
// Replaces: stmask_tpu/kernels/correlation_pallas.py::correlate_pallas
// (_corr_kernel), the JAX package's Pallas kernel, called by the tracker's
// candidate_shift once per frame.
//
//   out[b, y, x, dy*P + dx] = act( sum_c x1[b, y, x, c]
//                                   * x2[b, y + dy - r, x + dx - r, c] / C )
//
// with r = (P - 1) / 2, reads outside the image counting as zero and act
// the leaky ReLU with slope 0.1 when apply_activation is set.
//
// What bounds it on an H100: at the main-path shape (B 1, 24 x 40, C 256,
// P 11) it does 2 * 960 * 121 * 256 = 59.5 MFLOP and must move
// 2 * 983 KB in + 465 KB out = 2.4 MB: 0.9 us of fp32 ALU time, 0.7 us of
// HBM time.  Both are far below a kernel launch, so the kernel is launch-
// and latency-bound, and the design aims at being simple and right.
//
// Design: one block per (b, y, tile of TILE_X columns); one thread per
// (column in tile, displacement), so TILE_X * P^2 threads (968 for P 11).
// The channels are walked in chunks of 32: each chunk stages x1's row tile
// and the P x (TILE_X + P - 1) window of x2 in shared memory (zero-filled
// outside the image, so the inner loop has no bounds tests), then every
// thread accumulates its dot product in fp32 registers.  Rows in shared
// memory are padded to 33 floats so that threads with neighbouring
// displacements read different banks.  The block's outputs are one
// contiguous run of TILE_X * P^2 floats, written coalesced.

#include "common.cuh"

namespace {

constexpr int kChunk = 32;             // channels staged per pass
constexpr int kRow = kChunk + 1;       // padded shared-memory row stride

__global__ void correlation_kernel(const float* __restrict__ x1,
                                   const float* __restrict__ x2,
                                   float* __restrict__ out, int H, int W,
                                   int C, int patch, int tile_x,
                                   int apply_activation) {
  extern __shared__ float smem[];
  const int r = (patch - 1) / 2;
  const int pp = patch * patch;
  const int win_w = tile_x + patch - 1;
  float* s1 = smem;                      // [tile_x][kRow]
  float* s2 = smem + tile_x * kRow;      // [patch][win_w][kRow]

  const int b = blockIdx.z;
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * tile_x;
  const int tid = threadIdx.x;
  const int xl = tid / pp;
  const int d = tid - xl * pp;
  const int dy = d / patch;
  const int dx = d - dy * patch;
  const bool active = xl < tile_x && x0 + xl < W;
  const size_t img = static_cast<size_t>(b) * H * W * C;

  float acc = 0.f;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int cn = min(kChunk, C - c0);
    for (int i = tid; i < tile_x * kChunk; i += blockDim.x) {
      const int c = i % kChunk;
      const int gx = x0 + i / kChunk;
      float v = 0.f;
      if (gx < W && c < cn)
        v = x1[img + (static_cast<size_t>(y) * W + gx) * C + c0 + c];
      s1[(i / kChunk) * kRow + c] = v;
    }
    for (int i = tid; i < patch * win_w * kChunk; i += blockDim.x) {
      const int c = i % kChunk;
      const int cell = i / kChunk;
      const int wy = cell / win_w;
      const int wx = cell - wy * win_w;
      const int gy = y + wy - r;
      const int gx = x0 + wx - r;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < cn)
        v = x2[img + (static_cast<size_t>(gy) * W + gx) * C + c0 + c];
      s2[cell * kRow + c] = v;
    }
    __syncthreads();
    if (active) {
      const float* a = s1 + xl * kRow;
      const float* q = s2 + (dy * win_w + xl + dx) * kRow;
#pragma unroll 8
      for (int c = 0; c < cn; ++c) acc += a[c] * q[c];
    }
    __syncthreads();
  }
  if (active) {
    float v = acc / static_cast<float>(C);
    if (apply_activation && v < 0.f) v *= 0.1f;
    out[((static_cast<size_t>(b) * H + y) * W + x0 + xl) * pp + d] = v;
  }
}

}  // namespace

// x1, x2: [B, H, W, C] fp32 contiguous; out: [B, H, W, patch^2].
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int stmask_correlation(const float* x1, const float* x2,
                                  float* out, int B, int H, int W, int C,
                                  int patch, int apply_activation,
                                  void* stream) {
  const int pp = patch * patch;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || patch <= 0 || patch % 2 == 0
      || pp > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile_x = max(1, min(8, 1024 / pp));
  const int threads = (tile_x * pp + 31) / 32 * 32;
  const size_t smem =
      static_cast<size_t>(tile_x + patch * (tile_x + patch - 1)) * kRow *
      sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        correlation_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((W + tile_x - 1) / tile_x, H, B);
  correlation_kernel<<<grid, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      x1, x2, out, H, W, C, patch, tile_x, apply_activation);
  return static_cast<int>(cudaGetLastError());
}
