// Fused modulated deformable conv (gather, GEMM and bias in one kernel),
// fp32, NHWC.
//
// Replaces: stmask_tpu/ops/deform_conv.py::deform_conv2d (deform_conv.py:31,
// with ops/sampling.py::bilinear_sample_block), the exact deformable conv
// that the JAX package runs at the 7 DCN sites of the R50 backbone (v2,
// 3x3) and that FCB needs as a v1 3x5 / 5x3 conv.  K2 (deform_im2col.cu)
// computes the same gather into a `cols` matrix for a separate matmul; this
// kernel never writes `cols`.
//
//   out[b, oy, ox, n] = bias[n] + sum_{k, c} W[n, k / kw, k % kw, c]
//                         * m[b, oy, ox, k] * bilinear(x[b], py_k, px_k)[c]
//   py_k = oy * stride - pad_h + (k / kw) * dilation + offset[.., 2k]
//   px_k = ox * stride - pad_w + (k % kw) * dilation + offset[.., 2k + 1]
//
// with pad = (k - 1) / 2 * dilation and every bilinear corner outside the
// image weighted zero on its own.  W is [Cout, kh, kw, Cin]: the module's
// OIHW weight in the channels-last layout the model is kept in, read in
// place, so each output channel's K = kh * kw * Cin weights are one
// contiguous row in (tap, channel) order.
//
// What bounds it on an H100: operations.  An implicit GEMM of M = B*Ho*Wo
// sites, N = Cout, K = kh*kw*Cin; each main-path site is 2*M*N*K = 1.13
// GFLOP, done as three TF32 products (below): 6.9 us at the 495 TFLOP/s
// dense TF32 peak of the tensor cores, plus the gather's fp32 flops, against
// ~1.5 MB of inputs and output (0.5 us at 3.35 TB/s).
//
// Math: 3xTF32 on the tensor cores (mma.sync m16n8k8).  The path is fp32
// with TF32 off, and plain TF32 keeps ~3 decimal digits, so each operand x
// is split as hi + lo, hi being x with its 13 low mantissa bits cleared
// (exact TF32) and lo = x - hi, and a*b is summed as lo_a*hi_b + hi_a*lo_b
// + hi_a*hi_b in fp32.  The dropped lo*lo term and the MMA's truncation of
// lo are ~2^-20 of the product, within the 5e-6 the fused result is held
// to after an fp32 sum over K up to 4608, which a single TF32 product
// misses (by 2e-5 to 5e-5 at the main-path sites, weights scaled by 1/K).
// A first version with the same
// pipeline and register-blocked fp32 FFMA instead was slower than K2 plus
// cuBLAS on the main path; with three TF32 products the tensor cores have
// room to spare, and the limit moves to the gather and the pipeline.
//
// Design (one block per 64 x 128 output tile and K-split, 256 threads):
// - A (the gathered, modulated samples) is produced straight into shared
//   memory, 32 (tap, channel) columns per chunk, already split into its
//   hi and lo parts.  When Cin is a multiple of 32 a chunk never straddles
//   a tap, so each thread computes the four corner addresses and weights
//   of its two sites once per tap (their offsets and modulation read one
//   tap ahead) and reads each corner as a 16-byte run of NHWC channels; 8
//   threads cover a site's 32 channels, so a warp reads 128-byte runs.
//   The next chunk's corner loads for one site are in flight while half of
//   this chunk's products run, and are combined and stored after them.
// - B (the weight, one K-contiguous row per output channel) comes through
//   a 3-stage shared-memory ring of 16-byte cp.async copies, two chunks
//   ahead of the math, kept [BN][BK] as the mma's column-major B fragment
//   reads it, and is split in registers.
// - Each of the 8 warps owns a 32 x 32 piece of the tile: per 8 columns of
//   K it loads 16 A and 8 B fragment registers (row strides of 36 floats
//   put the 32 lanes on 32 banks) and issues 24 MMAs.  A 128-wide
//   tile gathers A once for all of Cout = 128 (layer1) and half as often
//   as a 64-wide one elsewhere.
// - K is split across the blocks of a thread-block cluster (1 to 16, so
//   that the grid fills the SMs: layer1 4, layer2 8, layer3 16 at the main
//   path; 16 is a non-portable cluster size, which the H100 allows).  Each
//   block leaves its partial tile in its own shared memory; after a cluster
//   barrier block r sums rows [r*64/S, (r+1)*64/S) of all S partial tiles
//   through distributed shared memory in rank order (deterministic, no
//   atomics), adds the bias and writes them once.
// - Shapes off the fast path (Cin not a multiple of 32, Cout not a
//   multiple of 4, unaligned pointers) take the same pipeline with one
//   scalar sample per A element and 4-byte copies: right, and slow.
// - Registers: 128 a thread (two blocks an SM), no spill.

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64;          // output sites per tile
constexpr int BN = 128;         // output channels per tile
constexpr int BK = 32;          // (tap, channel) columns per chunk
constexpr int THREADS = 256;
constexpr int A_LD = BK + 4;    // A tile [BM][A_LD] row stride
constexpr int B_LD = BK + 4;    // B tile [BN][B_LD] row stride
constexpr int B_STAGES = 3;
constexpr int MAX_SPLIT = 16;   // blocks of a K-split cluster (non-portable)
constexpr int A_STAGE = 2 * BM * A_LD;  // hi then lo parts of one A tile
constexpr int A_FLOATS = 2 * A_STAGE;
constexpr int B_STAGE = BN * B_LD;
constexpr int B_FLOATS = B_STAGES * B_STAGE;
constexpr int SMEM_BYTES = (A_FLOATS + B_FLOATS) * 4;
static_assert(BM * BN <= A_FLOATS + B_FLOATS, "partial tile must fit");

struct Params {
  const float* x;        // [B, H, W, Cin]
  const float* offset;   // [B, Ho, Wo, >= 2K], site stride off_ld
  const float* mask;     // [B, Ho, Wo, >= K], site stride mask_ld, or null
  const float* weight;   // [Cout, K * Cin]
  const float* bias;     // [Cout] or null
  float* out;            // [B, Ho, Wo, Cout]
  int H, W, Cin, Ho, Wo, kh, kw, stride, dilation;
  int M, N, Ktot, off_ld, mask_ld;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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
// d += a * b on a 16 x 8 x 8 TF32 tile (fp32 accumulate).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The four bilinear corners of one (site, tap): element index of each
// corner's first channel within the site's image (-1 when outside) and its
// weight, the modulation folded in.
struct Corners {
  const float* img;
  int idx[4];
  float w[4];
};

// One (site, tap)'s offset (dy, dx) and modulation, as read from memory.
struct TapIn {
  float dy, dx, m;
};

__device__ __forceinline__ TapIn tap_in(const Params& p, int m, int tap) {
  if (m >= p.M) return TapIn{0.f, 0.f, 0.f};
  const float* off = p.offset + static_cast<int64_t>(m) * p.off_ld + 2 * tap;
  return TapIn{__ldg(off), __ldg(off + 1),
               p.mask != nullptr
                   ? __ldg(p.mask + static_cast<int64_t>(m) * p.mask_ld + tap)
                   : 1.f};
}

__device__ __forceinline__ void corners_from(const Params& p, int m, int tap,
                                             const TapIn& in, Corners& cn) {
  cn.img = p.x;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    cn.idx[j] = -1;
    cn.w[j] = 0.f;
  }
  if (m >= p.M) return;
  const int ox = m % p.Wo;
  const int t = m / p.Wo;
  const int oy = t % p.Ho;
  const int b = t / p.Ho;
  const int pad_h = (p.kh - 1) / 2 * p.dilation;
  const int pad_w = (p.kw - 1) / 2 * p.dilation;
  const float py = static_cast<float>(oy * p.stride - pad_h +
                                      (tap / p.kw) * p.dilation) + in.dy;
  const float px = static_cast<float>(ox * p.stride - pad_w +
                                      (tap % p.kw) * p.dilation) + in.dx;
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
      cn.w[j] = wy[j >> 1] * wx[j & 1] * mk;
    }
  }
}

// One scalar A element (site m, column k), for the shapes off the fast
// path.
__device__ __forceinline__ float sample_scalar(const Params& p, int m,
                                               int k) {
  if (m >= p.M || k >= p.Ktot) return 0.f;
  const int tap = k / p.Cin, c = k - tap * p.Cin;
  Corners cn;
  corners_from(p, m, tap, tap_in(p, m, tap), cn);
  float v = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (cn.idx[j] >= 0) v += cn.w[j] * __ldg(cn.img + cn.idx[j] + c);
  return v;
}

// Weight columns [k0, k0 + BK) of output channels [n0, n0 + BN) into one
// ring stage, [BN][B_LD]; 8 threads copy one channel's 128-byte run.
template <bool FAST>
__device__ __forceinline__ void load_b(const Params& p, float* bs, int k0,
                                       int n0) {
  const int tid = threadIdx.x;
  if (FAST) {
#pragma unroll
    for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (BK / 4), c4 = (e % (BK / 4)) * 4;
      const bool ok = n0 + r < p.N && k0 + c4 < p.Ktot;
      cp_async16(bs + r * B_LD + c4,
                 ok ? p.weight + static_cast<int64_t>(n0 + r) * p.Ktot + k0 +
                          c4
                    : p.weight,
                 ok);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK, c = e % BK;
      const bool ok = n0 + r < p.N && k0 + c < p.Ktot;
      cp_async4(bs + r * B_LD + c,
                ok ? p.weight + static_cast<int64_t>(n0 + r) * p.Ktot + k0 + c
                   : p.weight,
                ok);
    }
  }
}

// The A chunk held in registers between its loads and its store.
struct AStage {
  float v[8];
};

template <bool FAST>
struct Gather {
  // fast path: thread -> sites (tid / 8) and (tid / 8 + 32), channels
  // c .. c + 3 of the chunk, c = (tid % 8) * 4 within it; corners cached
  // per tap, and the next tap's offsets and modulation read one tap ahead.
  Corners cn[2];
  TapIn next[2];
  int tap = -1, next_tap = -1, c = 0;

  // fast path: make chunk k0 the one that issue() and combine() read.
  __device__ __forceinline__ void begin(const Params& p, int m0, int k0) {
    const int tid = threadIdx.x;
    const int t = k0 / p.Cin;
    if (t != tap) {
      const int ms[2] = {m0 + tid / 8, m0 + tid / 8 + 32};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (t != next_tap) next[s] = tap_in(p, ms[s], t);
        corners_from(p, ms[s], t, next[s], cn[s]);
        if (t + 1 < p.kh * p.kw) next[s] = tap_in(p, ms[s], t + 1);
      }
      tap = t;
      next_tap = t + 1;
    }
    c = k0 - t * p.Cin + (tid % 8) * 4;
  }

  // fast path: the four corner runs of site s (zero outside the image).
  __device__ __forceinline__ void issue(int s, float4 (&raw)[4]) const {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      raw[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (cn[s].idx[j] >= 0)
        raw[j] = __ldg(
            reinterpret_cast<const float4*>(cn[s].img + cn[s].idx[j] + c));
    }
  }

  __device__ __forceinline__ void combine(int s, const float4 (&raw)[4],
                                          AStage& st) const {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v.x += cn[s].w[j] * raw[j].x;
      v.y += cn[s].w[j] * raw[j].y;
      v.z += cn[s].w[j] * raw[j].z;
      v.w += cn[s].w[j] * raw[j].w;
    }
    st.v[4 * s] = v.x;
    st.v[4 * s + 1] = v.y;
    st.v[4 * s + 2] = v.z;
    st.v[4 * s + 3] = v.w;
  }

  // other shapes: one scalar sample per element.
  __device__ __forceinline__ void load_scalar(const Params& p, int m0, int k0,
                                              AStage& st) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = threadIdx.x + i * THREADS;
      st.v[i] = sample_scalar(p, m0 + e / BK, k0 + e % BK);
    }
  }

  // Store the chunk split into its hi and lo parts (as[0 .. BM*A_LD) and
  // as[BM*A_LD ..)).
  __device__ __forceinline__ void store(const AStage& st, float* as) const {
    const int tid = threadIdx.x;
    float hi[8], lo[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      hi[i] = tf32_hi(st.v[i]);
      lo[i] = st.v[i] - hi[i];
    }
    if (FAST) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        float* a = as + (tid / 8 + 32 * s) * A_LD + (tid % 8) * 4;
        *reinterpret_cast<float4*>(a) = make_float4(
            hi[4 * s], hi[4 * s + 1], hi[4 * s + 2], hi[4 * s + 3]);
        *reinterpret_cast<float4*>(a + BM * A_LD) = make_float4(
            lo[4 * s], lo[4 * s + 1], lo[4 * s + 2], lo[4 * s + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = tid + i * THREADS;
        as[(e / BK) * A_LD + e % BK] = hi[i];
        as[BM * A_LD + (e / BK) * A_LD + e % BK] = lo[i];
      }
    }
  }
};

template <bool FAST>
__global__ void __launch_bounds__(THREADS, 2)
    deform_conv_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* const a_s = smem;
  float* const b_s = smem + A_FLOATS;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;     // mma fragment coordinates
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 32;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z, n_split = gridDim.z;
  const int nk = (p.Ktot + BK - 1) / BK;
  const int kb = static_cast<int>(static_cast<int64_t>(nk) * split / n_split);
  const int ke =
      static_cast<int>(static_cast<int64_t>(nk) * (split + 1) / n_split);

  // acc[mt][nt]: rows wm + 16 mt + {g, g + 8}, columns wn + 8 nt + 2 t4 + {0, 1}
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // 3xTF32 products of K columns [kk0, kk0 + 16) of the current A and B
  // stages.
  auto mma_steps = [&](const float* as, const float* bs, int kk0) {
#pragma unroll
    for (int kk = kk0; kk < kk0 + 16; kk += 8) {
      uint32_t ahi[2][4], alo[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* a = as + mt * 16 * A_LD + kk;
        const int at[4] = {0, 8 * A_LD, 4, 8 * A_LD + 4};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ahi[mt][r] = __float_as_uint(a[at[r]]);
          alo[mt][r] = __float_as_uint(a[BM * A_LD + at[r]]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t bhi[2], blo[2];
        const float* b = bs + nt * 8 * B_LD + kk;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float x = b[r * 4], hi = tf32_hi(x);
          bhi[r] = __float_as_uint(hi);
          blo[r] = __float_as_uint(x - hi);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_tf32(acc[mt][nt], alo[mt], bhi);
          mma_tf32(acc[mt][nt], ahi[mt], blo);
          mma_tf32(acc[mt][nt], ahi[mt], bhi);
        }
      }
    }
  };

  if (kb < ke) {
    Gather<FAST> gather;
    AStage st;
    float4 raw[4];
    load_b<FAST>(p, b_s, kb * BK, n0);
    cp_async_commit();
    if (kb + 1 < ke) load_b<FAST>(p, b_s + B_STAGE, (kb + 1) * BK, n0);
    cp_async_commit();
    if (FAST) {
      gather.begin(p, m0, kb * BK);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        gather.issue(s, raw);
        gather.combine(s, raw, st);
      }
    } else {
      gather.load_scalar(p, m0, kb * BK, st);
    }
    gather.store(st, a_s);

    for (int kc = kb; kc < ke; ++kc) {
      const int i = kc - kb;
      const bool more = kc + 1 < ke;
      cp_async_wait<1>();          // weight chunk kc has landed
      __syncthreads();             // ... for every thread, and A chunk kc too
      if (kc + 2 < ke)
        load_b<FAST>(p, b_s + ((i + 2) % B_STAGES) * B_STAGE, (kc + 2) * BK,
                     n0);
      cp_async_commit();
      const float* as = a_s + (i % 2) * A_STAGE + (wm + g) * A_LD + t4;
      const float* bs =
          b_s + (i % B_STAGES) * B_STAGE + (wn + g) * B_LD + t4;
      if (FAST) {
        // The next chunk's corner loads for one site are in flight while
        // half of this chunk's products run.  (On the last chunk the
        // current chunk's corners are read again and dropped, so that no
        // branch splits the loads from the products.)
        if (more) gather.begin(p, m0, (kc + 1) * BK);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          gather.issue(s, raw);
          mma_steps(as, bs, 16 * s);
          gather.combine(s, raw, st);
        }
      } else {
        if (more) gather.load_scalar(p, m0, (kc + 1) * BK, st);
        mma_steps(as, bs, 0);
        mma_steps(as, bs, 16);
      }
      if (more) gather.store(st, a_s + ((i + 1) % 2) * A_STAGE);
    }
    cp_async_wait<0>();
  }

  if (n_split == 1) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mt * 16 + g + 8 * h;
        if (m >= p.M) continue;
        float* o = p.out + static_cast<int64_t>(m) * p.N;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = n0 + wn + nt * 8 + 2 * t4;
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (n + j < p.N)
              o[n + j] = acc[mt][nt][2 * h + j] +
                         (p.bias != nullptr ? __ldg(p.bias + n + j) : 0.f);
        }
      }
    return;
  }

  // Split K: sum the cluster's partial tiles through distributed shared
  // memory, in rank order, four columns at a time with every rank's load
  // in flight before the sum.
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();                 // every thread is done with a_s / b_s
  float* part = smem;              // [BM][BN]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(part + (wm + mt * 16 + g + 8 * h) * BN +
                                   wn + nt * 8 + 2 * t4) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  cluster.sync();
  const int rows = BM / n_split;
  const int rank = static_cast<int>(cluster.block_rank());
  for (int e = tid; e < rows * BN / 4; e += THREADS) {
    const int rl = rank * rows + e / (BN / 4), c = (e % (BN / 4)) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r0 = 0; r0 < n_split; r0 += 4) {
      float4 q[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (r0 + r < n_split)
          q[r] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(part, r0 + r) + rl * BN + c);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (r0 + r < n_split) {
          v[0] += q[r].x;
          v[1] += q[r].y;
          v[2] += q[r].z;
          v[3] += q[r].w;
        }
    }
    const int m = m0 + rl, n = n0 + c;
    if (m >= p.M) continue;
    float* o = p.out + static_cast<int64_t>(m) * p.N + n;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (p.bias != nullptr && n + j < p.N) v[j] += __ldg(p.bias + n + j);
    if (FAST && n < p.N) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < p.N) o[j] = v[j];
    }
  }
  cluster.sync();                  // keep every partial tile alive until read
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      count = 132;
  }
  return count;
}

}  // namespace

// x: [B, H, W, Cin]; offset: [B, Ho, Wo, 2*kh*kw] (dy, dx)-interleaved per
// tap, sites off_ld floats apart; mask: [B, Ho, Wo, kh*kw], sites mask_ld
// floats apart, or null (v1); weight: [Cout, kh, kw, Cin]; bias: [Cout] or
// null; out: [B, Ho, Wo, Cout].  All fp32; x, weight and out contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int stmask_deform_conv(const float* x, const float* offset,
                                  const float* mask, const float* weight,
                                  const float* bias, float* out, int B, int H,
                                  int W, int Cin, int Ho, int Wo, int Cout,
                                  int kh, int kw, int stride, int dilation,
                                  int off_ld, int mask_ld, void* stream) {
  if (B < 0 || H <= 0 || W <= 0 || Cin <= 0 || Ho < 0 || Wo < 0 ||
      Cout <= 0 || kh <= 0 || kw <= 0 || stride <= 0 || dilation <= 0 ||
      off_ld < 2 * kh * kw || (mask != nullptr && mask_ld < kh * kw) ||
      static_cast<int64_t>(H) * W * Cin > INT32_MAX ||
      static_cast<int64_t>(B) * Ho * Wo > INT32_MAX ||
      static_cast<int64_t>(kh) * kw * Cin > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, offset, mask, weight, bias, out, H, W, Cin, Ho, Wo, kh, kw,
           stride, dilation, B * Ho * Wo, Cout, kh * kw * Cin, off_ld,
           mask_ld};
  if (p.M == 0) return static_cast<int>(cudaSuccess);
  const bool fast = Cin % BK == 0 && Cout % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(weight) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int mt = (p.M + BM - 1) / BM, nt = (Cout + BN - 1) / BN;
  const int nk = (p.Ktot + BK - 1) / BK;
  // Split K over a cluster until the grid fills the SMs, keeping at least
  // 4 chunks per block.
  int split = 1;
  while (split < MAX_SPLIT && mt * nt * split < sm_count() &&
         nk >= 8 * split)
    split *= 2;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(mt, nt, split);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static bool smem_set = false;
  if (!smem_set) {
    for (const auto kernel : {deform_conv_kernel<true>,
                              deform_conv_kernel<false>}) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    smem_set = true;
  }
  const cudaError_t e =
      fast ? cudaLaunchKernelEx(&cfg, deform_conv_kernel<true>, p)
           : cudaLaunchKernelEx(&cfg, deform_conv_kernel<false>, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
