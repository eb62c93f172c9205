// K1: cross-frame local correlation (cost volume), NHWC, fp32 or bf16
// inputs (one kernel template), fp32 output.
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
// HBM time.  Both are below a kernel launch, so what counts is latency:
// enough blocks for every SM, few barriers, and few shared-memory loads
// per FMA.
//
// Design: for one (b, y, dy) the P dx outputs at every x are a band
// |x' - x| <= r of the product of x1's row [W, C] with x2's row y + dy - r
// [W + 2r, C].  One block per (b, y, dy, tile of up to 64 columns): 264
// blocks at the main shape.  The block stages x1's row tile and x2's
// padded row tile in shared memory with 16-byte cp.async copies (4-byte
// ones when C % 4 != 0), zero-filled outside the image, in chunks of 128
// channels, double-buffered so that the next chunk's copies overlap this
// chunk's math.  A row of x2 outside the image makes the whole block's
// output zero, written without staging.
// Each thread owns a register tile of 2 columns x P displacements and a
// slice of the channels (CL threads share a column group, CL a power of
// two): per 4 channels it reads 2 + 2 + P - 1 float4 for 8 * P FMAs.
// Rows are padded by 4 floats so that the 8 threads of a quarter-warp,
// which read neighbouring channels of one row, hit distinct banks.  The
// CL partial tiles are summed by an xor-butterfly of shuffles, level by
// level (a fixed order: deterministic), and each output is written once
// by one of the CL threads.  (Run as P dependent chains, one value at a
// time, the butterfly's shuffle latency cost more than the math.)
//
// bf16 inputs (the tracker's bf16 features in the JAX package's bf16 eval;
// the Pallas kernel's arithmetic, correlation_pallas.py:28-30): the rows
// are staged as bf16 (half the bytes, 16-byte copies of 8 channels) and
// widened to fp32 in registers; each product of two bf16 values (exact in
// fp32) is rounded to bf16, and the products are summed in fp32, scaled by
// 1/C and written as fp32.  Tiling, chunks and the butterfly are those of
// fp32; rows are padded by 8 bf16 (16 bytes).

#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TX = 2;            // columns per thread
constexpr int MAX_TILE = 64;     // columns per block
constexpr int THREADS = 512;
constexpr int CHUNK = 128;       // channels staged per pass

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;

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

// Four neighbouring channels from shared memory, as fp32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// x rounded to bf16 (round to nearest even), as an fp32 value
__device__ __forceinline__ float rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
struct Args {
  const T* x1;
  const T* x2;
  float* out;
  int H, W, C, tile, cc, ldc, cl, act, vec;
};

// Stage channels [c0, c0 + cc) of x1's row tile [tile] and x2's row tile
// [tile + 2r] (columns x0 - r ...) into one buffer, rows ldc elements apart.
template <int P, typename T>
__device__ __forceinline__ void stage(const Args<T>& a, T* s, int b, int y,
                                      int gy, int x0, int c0) {
  constexpr int R = (P - 1) / 2;
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const int rows1 = a.tile, rows = 2 * a.tile + 2 * R;
  const int64_t row1 = (static_cast<int64_t>(b) * a.H + y) * a.W;
  const int64_t row2 = (static_cast<int64_t>(b) * a.H + gy) * a.W;
  if (a.vec) {
    const int per_row = a.cc / VEC;
    for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
      const int rr = e / per_row, c = c0 + (e - rr * per_row) * VEC;
      const int gx = rr < rows1 ? x0 + rr : x0 - R + rr - rows1;
      const bool ok = gx >= 0 && gx < a.W && c < a.C;
      const T* src = rr < rows1 ? a.x1 + (row1 + gx) * a.C + c
                                : a.x2 + (row2 + gx) * a.C + c;
      cp_async16(s + rr * a.ldc + c - c0, ok ? src : a.x1, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * a.cc; e += blockDim.x) {
      const int rr = e / a.cc, c = c0 + (e - rr * a.cc);
      const int gx = rr < rows1 ? x0 + rr : x0 - R + rr - rows1;
      const bool ok = gx >= 0 && gx < a.W && c < a.C;
      const T* src = rr < rows1 ? a.x1 + (row1 + gx) * a.C + c
                                : a.x2 + (row2 + gx) * a.C + c;
      if constexpr (kF32<T>) {
        cp_async4(s + rr * a.ldc + c - c0, ok ? src : a.x1, ok);
      } else {
        // no 2-byte cp.async: a plain copy (this buffer is read after the
        // next barrier)
        s[rr * a.ldc + c - c0] = ok ? __ldg(src) : __float2bfloat16_rn(0.f);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int P, typename T>
__global__ void __launch_bounds__(THREADS)
    correlation_kernel(const Args<T> a) {
  constexpr int R = (P - 1) / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.z;
  const int y = blockIdx.y / P, dy = blockIdx.y % P;
  const int gy = y + dy - R;
  const int x0 = blockIdx.x * a.tile;
  const int ncol = min(a.tile, a.W - x0);
  const int pp = P * P;

  if (gy < 0 || gy >= a.H) {         // x2's row is outside: all zero
    for (int e = threadIdx.x; e < ncol * P; e += blockDim.x) {
      const int xl = e / P, dx = e - xl * P;
      a.out[((static_cast<int64_t>(b) * a.H + y) * a.W + x0 + xl) * pp +
            dy * P + dx] = 0.f;
    }
    return;
  }

  const int cl = a.cl;               // threads per column group
  const int g = threadIdx.x / cl;    // columns TX*g .. TX*g + TX - 1
  const int lane_c = threadIdx.x % cl;
  const int stage_elems = (2 * a.tile + 2 * R) * a.ldc;
  const int nchunk = (a.C + a.cc - 1) / a.cc;

  float acc[TX][P];
#pragma unroll
  for (int i = 0; i < TX; ++i)
#pragma unroll
    for (int d = 0; d < P; ++d) acc[i][d] = 0.f;

  stage<P>(a, smem, b, y, gy, x0, 0);
  for (int k = 0; k < nchunk; ++k) {
    if (k + 1 < nchunk) {
      stage<P>(a, smem + ((k + 1) % 2) * stage_elems, b, y, gy, x0,
               (k + 1) * a.cc);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const T* s1 = smem + (k % 2) * stage_elems + TX * g * a.ldc;
    const T* s2 = s1 + a.tile * a.ldc;   // x2 column TX*g - R + j
    if (TX * g < ncol) {
      for (int c = 4 * lane_c; c < a.cc; c += 4 * cl) {
        float4 u[TX];
#pragma unroll
        for (int i = 0; i < TX; ++i) u[i] = load4(s1 + i * a.ldc + c);
#pragma unroll
        for (int j = 0; j < TX + P - 1; ++j) {
          const float4 v = load4(s2 + j * a.ldc + c);
#pragma unroll
          for (int i = 0; i < TX; ++i) {
            const int d = j - i;
            if (d >= 0 && d < P) {
              if constexpr (kF32<T>)
                acc[i][d] += u[i].x * v.x + u[i].y * v.y + u[i].z * v.z +
                             u[i].w * v.w;
              else
                acc[i][d] += rbf(u[i].x * v.x) + rbf(u[i].y * v.y) +
                             rbf(u[i].z * v.z) + rbf(u[i].w * v.w);
            }
          }
        }
      }
    }
    __syncthreads();                 // the buffer is refilled next round
  }

  // Sum the cl channel slices (lanes of one column group are adjacent and
  // cl divides 32), level by level so that the TX * P shuffles of a level
  // are independent, and write each output once.
  for (int o = cl / 2; o > 0; o /= 2) {
#pragma unroll
    for (int i = 0; i < TX; ++i)
#pragma unroll
      for (int d = 0; d < P; ++d)
        acc[i][d] += __shfl_xor_sync(0xffffffffu, acc[i][d], o);
  }
  const float inv_c = 1.f / static_cast<float>(a.C);
#pragma unroll
  for (int i = 0; i < TX; ++i) {
#pragma unroll
    for (int d = 0; d < P; ++d) {
      float v = acc[i][d];
      const int xl = TX * g + i;
      if ((i * P + d) % cl == lane_c && xl < ncol) {
        v *= inv_c;
        if (a.act && v < 0.f) v *= 0.1f;
        a.out[((static_cast<int64_t>(b) * a.H + y) * a.W + x0 + xl) * pp +
              dy * P + d] = v;
      }
    }
  }
}

template <int P, typename T>
cudaError_t launch(const Args<T>& base, int B, cudaStream_t stream) {
  constexpr int R = (P - 1) / 2;
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  Args<T> a = base;
  // a whole number of column groups, so a group never reads past x2's tile
  a.tile = min((a.W + TX - 1) / TX * TX, MAX_TILE);
  const int groups = (a.tile + TX - 1) / TX;
  // channel slices per column group: a power of two, at most 32, that
  // keeps the block within THREADS threads
  a.cl = 1;
  while (a.cl < 32 && groups * a.cl * 2 <= THREADS &&
         a.cl * 4 < (a.C + 3) / 4 * 4)
    a.cl *= 2;
  // channel chunks of up to CHUNK (a whole number of 16-byte copies when
  // vectorised), double-buffered when there are several; rows padded by
  // 16 bytes
  const int rows = 2 * a.tile + 2 * R;
  const int step = a.vec ? VEC : 4;
  a.cc = min((a.C + step - 1) / step * step, CHUNK);
  a.ldc = a.cc + VEC;
  const int nchunk = (a.C + a.cc - 1) / a.cc;
  const size_t smem = static_cast<size_t>(nchunk > 1 ? 2 : 1) * rows *
                      a.ldc * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        correlation_kernel<P, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = (groups * a.cl + 31) / 32 * 32;
  const dim3 grid((a.W + a.tile - 1) / a.tile, a.H * P, B);
  correlation_kernel<P, T><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int run(const T* x1, const T* x2, float* out, int B, int H, int W, int C,
        int patch, int apply_activation, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || patch <= 0 || patch % 2 == 0
      || patch > 31 || static_cast<int64_t>(H) * patch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const bool vec = C % VEC == 0 &&
                   reinterpret_cast<uintptr_t>(x1) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x2) % 16 == 0;
  const Args<T> a{x1, x2, out, H, W, C, 0, 0, 0, 0, apply_activation,
                  vec ? 1 : 0};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (patch) {
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

// x1, x2: [B, H, W, C] contiguous, fp32 (stmask_correlation) or bf16
// (stmask_correlation_bf16); out: [B, H, W, patch^2] fp32; patch odd, 1 to
// 31.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int stmask_correlation(const float* x1, const float* x2,
                                  float* out, int B, int H, int W, int C,
                                  int patch, int apply_activation,
                                  void* stream) {
  return run<float>(x1, x2, out, B, H, W, C, patch, apply_activation, stream);
}

extern "C" int stmask_correlation_bf16(const void* x1, const void* x2,
                                       float* out, int B, int H, int W, int C,
                                       int patch, int apply_activation,
                                       void* stream) {
  return run<bf16>(static_cast<const bf16*>(x1), static_cast<const bf16*>(x2),
                   out, B, H, W, C, patch, apply_activation, stream);
}
