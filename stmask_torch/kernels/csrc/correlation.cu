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
// the Pallas kernel's arithmetic, correlation_pallas.py:28-30): each
// product of two bf16 values (exact in fp32) is rounded to bf16, and the
// products are summed in fp32, scaled by 1/C and written as fp32.  Two
// routes, the wrapper's choice (kernels/correlation.py::corr_fast):
// - the fast route (C % 8 == 0, x1 and x2 16-byte aligned: every TF site),
//   packed bf16x2 products below;
// - the general route: the fp32 kernel's tiling, chunks and butterfly, the
//   rows staged as bf16 (16-byte copies of 8 channels where C allows),
//   widened to fp32 in registers, each product rounded through
//   cvt.rn.bf16.f32; rows padded by 8 bf16 (16 bytes).

#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "bf16x2.cuh"
#include "common.cuh"

// Measurement builds only (stmask_torch/kernels/split.py; the library's own
// build leaves it 0): STMASK_CORR_DROP leaves parts of the bf16 entry's work
// out, bit 1 the copies into shared memory, 2 the products (and their
// shared-memory reads), 4 the butterfly over the channel slices, 8 the
// output stores (kept behind a test that never holds, so that the sums
// stay).  The fp32 entry ignores it.
#ifndef STMASK_CORR_DROP
#define STMASK_CORR_DROP 0
#endif

namespace {

using bf16 = __nv_bfloat16;

constexpr int TX = 2;            // columns per thread
constexpr int MAX_TILE = 64;     // columns per block
constexpr int THREADS = 512;
constexpr int CHUNK = 128;       // channels staged per pass

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;
// the parts a measurement build leaves out of the entry of type T
template <typename T>
constexpr int kDrop = kF32<T> ? 0 : STMASK_CORR_DROP;
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
  if (kDrop<T> & 1) {
  } else if (a.vec) {
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
    for (int e = threadIdx.x; !(kDrop<T> & 8) && e < ncol * P;
         e += blockDim.x) {
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
    if (!(kDrop<T> & 2) && TX * g < ncol) {
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
  for (int o = (kDrop<T> & 4) ? 0 : cl / 2; o > 0; o /= 2) {
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
        if ((kDrop<T> & 8) && v != NEVER) continue;
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


// ---- bf16 fast route -------------------------------------------------------
// C % 8 == 0 and x1, x2 16-byte aligned (every TF site of the port).  The
// blocks are the general route's, (b, y, dy, column tile); what differs is
// the arithmetic and the staging.  Operands stay packed bf16x2 from shared
// memory to the multiply: each 16-byte read is 8 channels, each pair of
// products one fma.rn.bf16x2 with a -0 addend (rbf of the fp32 product:
// the product of two bf16 values is exact in fp32), each rounded half
// widened by one mask or one shift (a bf16 in the high half of a word with
// a zero low half is its fp32 value) and added in fp32.  That is 2.5
// instructions a product against the general route's ~4.5 (widen, FMUL,
// cvt.rn.bf16.f32, widen, FADD).  Chunks of FCHUNK channels in a ring of
// FSTAGES buffers, one barrier a chunk; rows padded by 16 bytes.  One
// column a thread and 8 channel slices a column (320 threads at the eval
// shape) were the fastest of 2 or 4 columns and chunks of 32 to 256
// channels on the card.
constexpr int FCHUNK = 128;      // channels staged per pass
constexpr int FSTAGES = 3;
constexpr int FLDC = FCHUNK + 8;  // row stride, bf16
static_assert(FSTAGES >= 3, "chunk k + 2 is staged while chunk k is read");

// x1's row tile and x2's padded row tile, channels [c0, c0 + FCHUNK), as
// 16-byte copies zero-filled outside the image and past C.
template <int P>
__device__ __forceinline__ void fast_stage(const Args<bf16>& a, bf16* s,
                                           int b, int y, int gy, int x0,
                                           int c0) {
  constexpr int R = (P - 1) / 2;
  constexpr int PER_ROW = FCHUNK / 8;
  const int rows1 = a.tile, rows = 2 * a.tile + 2 * R;
  const int64_t row1 = (static_cast<int64_t>(b) * a.H + y) * a.W;
  const int64_t row2 = (static_cast<int64_t>(b) * a.H + gy) * a.W;
  for (int e = threadIdx.x; !(kDrop<bf16> & 1) && e < rows * PER_ROW;
       e += blockDim.x) {
    const int rr = e / PER_ROW, c = c0 + (e % PER_ROW) * 8;
    const int gx = rr < rows1 ? x0 + rr : x0 - R + rr - rows1;
    const bool ok = gx >= 0 && gx < a.W && c < a.C;
    const bf16* src = rr < rows1 ? a.x1 + (row1 + gx) * a.C + c
                                 : a.x2 + (row2 + gx) * a.C + c;
    cp_async16(s + rr * FLDC + c - c0, ok ? src : a.x1, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// acc + the 8 rounded products of u's and v's channels, summed in fp32
__device__ __forceinline__ float dot8(const uint4& u, const uint4& v,
                                      float acc) {
  const uint32_t q0 = mul_bf16x2(u.x, v.x), q1 = mul_bf16x2(u.y, v.y);
  const uint32_t q2 = mul_bf16x2(u.z, v.z), q3 = mul_bf16x2(u.w, v.w);
  const float t0 = bf16_lo(q0) + bf16_hi(q0), t1 = bf16_lo(q1) + bf16_hi(q1);
  const float t2 = bf16_lo(q2) + bf16_hi(q2), t3 = bf16_lo(q3) + bf16_hi(q3);
  return acc + ((t0 + t1) + (t2 + t3));
}

template <int P>
__global__ void __launch_bounds__(THREADS)
    correlation_bf16_fast_kernel(const Args<bf16> a) {
  constexpr int R = (P - 1) / 2;
  constexpr int DROP = kDrop<bf16>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const smem = reinterpret_cast<bf16*>(smem_raw);
  const int b = blockIdx.z;
  const int y = blockIdx.y / P, dy = blockIdx.y % P;
  const int gy = y + dy - R;
  const int x0 = blockIdx.x * a.tile;
  const int ncol = min(a.tile, a.W - x0);
  const int pp = P * P;

  if (gy < 0 || gy >= a.H) {         // x2's row is outside: all zero
    for (int e = threadIdx.x; !(DROP & 8) && e < ncol * P; e += blockDim.x) {
      const int xl = e / P, dx = e - xl * P;
      a.out[((static_cast<int64_t>(b) * a.H + y) * a.W + x0 + xl) * pp +
            dy * P + dx] = 0.f;
    }
    return;
  }

  const int cl = a.cl;
  const int g = threadIdx.x / cl;    // the thread's column
  const int lane_c = threadIdx.x % cl;
  const int stage_elems = (2 * a.tile + 2 * R) * FLDC;
  const int nchunk = (a.C + FCHUNK - 1) / FCHUNK;

  float acc[P];
#pragma unroll
  for (int d = 0; d < P; ++d) acc[d] = 0.f;

  fast_stage<P>(a, smem, b, y, gy, x0, 0);
  if (nchunk > 1) fast_stage<P>(a, smem + stage_elems, b, y, gy, x0, FCHUNK);
  for (int k = 0; k < nchunk; ++k) {
    if (k + 1 < nchunk)
      asm volatile("cp.async.wait_group 1;\n" ::);
    else
      asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();   // chunk k is in; buffer (k + 2) % 3 was read at k - 1
    if (k + 2 < nchunk)
      fast_stage<P>(a, smem + ((k + 2) % FSTAGES) * stage_elems, b, y, gy,
                    x0, (k + 2) * FCHUNK);
    const bf16* s1 = smem + (k % FSTAGES) * stage_elems + g * FLDC;
    const bf16* s2 = s1 + a.tile * FLDC;  // x2 column g - R + d
    const int lim = min(FCHUNK, a.C - k * FCHUNK);
    if (!(DROP & 2) && g < ncol) {
      for (int c = 8 * lane_c; c < lim; c += 8 * cl) {
        const uint4 u = *reinterpret_cast<const uint4*>(s1 + c);
#pragma unroll
        for (int d = 0; d < P; ++d)
          acc[d] = dot8(u, *reinterpret_cast<const uint4*>(s2 + d * FLDC + c),
                        acc[d]);
      }
    }
  }

  // the cl channel slices summed as in the general route
  for (int o = (DROP & 4) ? 0 : cl / 2; o > 0; o /= 2) {
#pragma unroll
    for (int d = 0; d < P; ++d)
      acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], o);
  }
  const float inv_c = 1.f / static_cast<float>(a.C);
#pragma unroll
  for (int d = 0; d < P; ++d) {
    float v = acc[d];
    if (d % cl == lane_c && g < ncol) {
      v *= inv_c;
      if (a.act && v < 0.f) v *= 0.1f;
      if ((DROP & 8) && v != NEVER) continue;
      a.out[((static_cast<int64_t>(b) * a.H + y) * a.W + x0 + g) * pp +
            dy * P + d] = v;
    }
  }
}

template <int P>
cudaError_t launch_fast(const Args<bf16>& base, int B, cudaStream_t stream) {
  constexpr int R = (P - 1) / 2;
  Args<bf16> a = base;
  a.tile = min(a.W, MAX_TILE);
  // channel slices per column: a power of two, at most 32, one 16-byte
  // read of each chunk's row a slice at least, within THREADS
  a.cl = 1;
  while (a.cl < 32 && a.cl * 2 * 8 <= FCHUNK && a.tile * a.cl * 2 <= THREADS
         && a.cl * 8 < a.C)
    a.cl *= 2;
  const int nchunk = (a.C + FCHUNK - 1) / FCHUNK;
  const size_t smem = static_cast<size_t>(min(nchunk, FSTAGES)) *
                      (2 * a.tile + 2 * R) * FLDC * sizeof(bf16);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        correlation_bf16_fast_kernel<P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int threads = (a.tile * a.cl + 31) / 32 * 32;
  const dim3 grid((a.W + a.tile - 1) / a.tile, a.H * P, B);
  correlation_bf16_fast_kernel<P><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int P, typename T>
cudaError_t dispatch(const Args<T>& a, int B, int route, cudaStream_t s) {
  if constexpr (!kF32<T>) {
    if (route) return launch_fast<P>(a, B, s);
  }
  return launch<P>(a, B, s);
}

// route: 1 the bf16 fast route (refused unless C % 8 == 0 and x1, x2 are
// 16-byte aligned), 0 the general one
template <typename T>
int run(const T* x1, const T* x2, float* out, int B, int H, int W, int C,
        int patch, int apply_activation, int route, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || patch <= 0 || patch % 2 == 0
      || patch > 31 || static_cast<int64_t>(H) * patch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const bool vec = C % VEC == 0 &&
                   reinterpret_cast<uintptr_t>(x1) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x2) % 16 == 0;
  if (route != 0 && (kF32<T> || route != 1 || !vec))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<T> a{x1, x2, out, H, W, C, 0, 0, 0, 0, apply_activation,
                  vec ? 1 : 0};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (patch) {
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

// x1, x2: [B, H, W, C] contiguous, fp32 (stmask_correlation) or bf16
// (stmask_correlation_bf16, which takes the route: 1 fast, 0 general); out:
// [B, H, W, patch^2] fp32; patch odd, 1 to 31.  Returns cudaGetLastError()
// after the launch (0 on success; cudaErrorInvalidValue for a fast route
// the call cannot take).
extern "C" int stmask_correlation(const float* x1, const float* x2,
                                  float* out, int B, int H, int W, int C,
                                  int patch, int apply_activation,
                                  void* stream) {
  return run<float>(x1, x2, out, B, H, W, C, patch, apply_activation, 0,
                    stream);
}

extern "C" int stmask_correlation_bf16(const void* x1, const void* x2,
                                       float* out, int B, int H, int W, int C,
                                       int patch, int apply_activation,
                                       int route, void* stream) {
  return run<bf16>(static_cast<const bf16*>(x1), static_cast<const bf16*>(x2),
                   out, B, H, W, C, patch, apply_activation, route, stream);
}
