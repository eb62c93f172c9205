// Fused modulated deformable conv (gather, GEMM and bias in one kernel),
// NHWC, in fp32 or bf16 (one kernel template, two element types).
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
// - The sample, cp.async, the TF32 split and the cluster reduction are in
//   deform_gather.cuh, shared with the weight gradient (deform_wgrad.cu).
//
// bf16 (the JAX package's bf16 eval, deform_conv.py:84-88 with
// sampling.py:83) has two routes.  The fast route (below, "the bf16 fast
// route") takes Cin a multiple of 64, Cout of 128, at most 16 taps,
// dilation 1 and 16-byte aligned x, weight and out: every DCN site of R50,
// R101 and FCB.  Its bound on an H100 is the same (the bf16 product at 989
// TFLOP/s, the gather's fp32 flops), but the gather sets its time: a
// build without the gather takes under half the whole kernel's time
// (kernels/split.py; PERF.md).  Each sample asks L2 for 4 corner
// runs (8 bytes a (site, column), once per tile column) and each tile row
// for the weight's rows: at the measured times that is 5-6 TB/s asked of
// L2, so L2's bandwidth may be what limits the gather; no counter of L2
// traffic or L1 hits was read, and the gather's instructions and latency
// may limit it as well.  So the MMA warps never wait on the gather:
// producer warps fill a ring that consumer warpgroups read with wgmma, and
// the tile is 64 x 256 where Cout allows, which halves the gather.  Every
// other bf16 call takes the general route: the fp32 design on bf16, with
// the same tiles, ring, clusters and epilogue order and the rounding points
// of the JAX path.  Each corner weight wy * wx is
// computed in fp32 and rounded to bf16, each weight * sample product is
// rounded to bf16, the four are summed in fp32 and rounded, and the
// modulation multiply is rounded again (two channels at a time: the two
// roundings of a product are one bf16x2 multiply, deform_gather.cuh's
// bf16_sample2, which the weight gradient's fast path shares); the sample
// is stored to shared memory as bf16.  The weight ring holds bf16, and one
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 per 16 columns makes the
// product exactly (no hi/lo split: bf16 x bf16 is exact in fp32), summed in
// fp32.  The fp32 sum is rounded to bf16 and then the bias added in bf16.
// A and B rows are BK + 8 bf16 apart (80 bytes): 16-byte aligned for
// cp.async, and the 32 lanes' fragment words fall on 32 banks.  Bound: the
// product's 2*M*N*K flops at 989 TFLOP/s, the gather's at 67 TFLOP/s, or
// the bytes (half of fp32's) at 3.35 TB/s.  The offsets may be fp32 beside
// bf16 x and weight (a third instantiation): FCB's analytic "ali" offsets,
// which the JAX package computes in fp32 from bf16 box deltas and samples
// at unrounded; the sample coordinates are fp32 either way.

#include "deform_gather.cuh"
#include "wgmma.cuh"

// Measurement builds only (stmask_torch/kernels/split.py; the
// library's own build leaves it 0): STMASK_DCONV_DROP leaves parts of the
// bf16 kernels out, bit 1 the products, 2 the gather (A zero), 4 the output
// stores (kept behind a test that never holds, so that the products stay),
// 8 the cluster's reduction (each block writes its own partial tile).
#ifndef STMASK_DCONV_DROP
#define STMASK_DCONV_DROP 0
#endif

namespace {

constexpr int DROP = STMASK_DCONV_DROP;
// A value no output takes: a dropped store is kept behind v == NEVER.
constexpr float NEVER = -1.2345e-38f;

constexpr int BM = 64;          // output sites per tile
constexpr int BN = 128;         // output channels per tile
constexpr int BK = 32;          // (tap, channel) columns per chunk
constexpr int B_STAGES = 3;

// Shared-memory geometry per element type, in elements of T.  fp32 keeps
// the hi and lo parts of each A tile; bf16 one part.
template <typename T>
struct Tile {
  static constexpr bool F32 = kF32<T>;
  static constexpr int LD = F32 ? BK + 4 : BK + 8;   // A and B row stride
  static constexpr int A_STAGE = (F32 ? 2 : 1) * BM * LD;
  static constexpr int A_ELEMS = 2 * A_STAGE;
  static constexpr int B_STAGE = BN * LD;
  static constexpr int B_ELEMS = B_STAGES * B_STAGE;
  static constexpr int SMEM_BYTES =
      (A_ELEMS + B_ELEMS) * static_cast<int>(sizeof(T));
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // per cp.async
  static_assert(BM * BN * 4 <= SMEM_BYTES, "partial tile must fit");
};

template <typename T, typename TO = T>
struct Params : Sample<T, TO> {
  const T* weight;       // [Cout, K * Cin]
  const T* bias;         // [Cout] or null
  T* out;                // [B, Ho, Wo, Cout]
  int N;
};

// d += a * b on a 16 x 8 x 8 TF32 tile (fp32 accumulate).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a * b on a 16 x 8 x 16 bf16 tile (fp32 accumulate).  a[0..3]: rows
// g, g + 8, g, g + 8 at columns 2 t4 + {0, 1}, + {0, 1}, + 8 + {0, 1},
// + 8 + {0, 1}; b[0..1]: column g at rows 2 t4 + {0, 1} and + 8 + {0, 1};
// the lower-index element in the low half of each register.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Weight columns [k0, k0 + BK) of output channels [n0, n0 + BN) into one
// ring stage, [BN][LD]; a channel's BK-column run comes in 16-byte copies.
template <typename T, bool FAST, typename P>
__device__ __forceinline__ void load_b(const P& p, T* bs, int k0, int n0) {
  constexpr int LD = Tile<T>::LD, VEC = Tile<T>::VEC;
  const int tid = threadIdx.x;
  if (FAST) {
#pragma unroll
    for (int i = 0; i < BK * BN / VEC / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / (BK / VEC), c = (e % (BK / VEC)) * VEC;
      const bool ok = n0 + r < p.N && k0 + c < p.Ktot;
      cp_async16(bs + r * LD + c,
                 ok ? p.weight + static_cast<int64_t>(n0 + r) * p.Ktot + k0 +
                          c
                    : p.weight,
                 ok);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK, c = e % BK;
      const bool ok = n0 + r < p.N && k0 + c < p.Ktot;
      const T* src =
          ok ? p.weight + static_cast<int64_t>(n0 + r) * p.Ktot + k0 + c
             : p.weight;
      if constexpr (Tile<T>::F32) {
        cp_async4(bs + r * LD + c, src, ok);
      } else {
        // no 2-byte cp.async: a plain copy (the stage it fills is read two
        // chunks later, after two barriers)
        bs[r * LD + c] = ok ? __ldg(src) : __float2bfloat16_rn(0.f);
      }
    }
  }
}

// The A chunk held in registers between its loads and its store (bf16
// values already rounded).
struct AStage {
  float v[8];
};

// The four corner runs of one site: 4 channels each.
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  float4 r[4];
};
template <>
struct Raw<bf16> {
  uint2 r[4];
};

template <typename T, bool FAST>
struct Gather {
  // fast path: thread -> sites (tid / 8) and (tid / 8 + 32), channels
  // c .. c + 3 of the chunk, c = (tid % 8) * 4 within it; corners cached
  // per tap, and the next tap's offsets and modulation read one tap ahead.
  Corners<T> cn[2];
  TapIn next[2];
  int tap = -1, next_tap = -1, c = 0;

  // fast path: make chunk k0 the one that issue() and combine() read.
  template <typename P>
  __device__ __forceinline__ void begin(const P& p, int m0, int k0) {
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
  __device__ __forceinline__ void issue(int s, Raw<T>& raw) const {
    using V = decltype(raw.r[0]);
    using VT = typename std::remove_reference<V>::type;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      raw.r[j] = VT{};
      if (cn[s].idx[j] >= 0)
        raw.r[j] = __ldg(
            reinterpret_cast<const VT*>(cn[s].img + cn[s].idx[j] + c));
    }
  }

  __device__ __forceinline__ void combine(int s, const Raw<T>& raw,
                                          AStage& st) const {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (Tile<T>::F32) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v.x += cn[s].w[j] * raw.r[j].x;
        v.y += cn[s].w[j] * raw.r[j].y;
        v.z += cn[s].w[j] * raw.r[j].z;
        v.w += cn[s].w[j] * raw.r[j].w;
      }
    } else {
      // two channel pairs (deform_gather.cuh: bf16_sample2)
      uint32_t w2[4], lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w2[j] = pack_bf16(cn[s].w[j], cn[s].w[j]);
        lo[j] = raw.r[j].x;
        hi[j] = raw.r[j].y;
      }
      const uint32_t m2 = pack_bf16(cn[s].m, cn[s].m);
      const uint32_t a = bf16_sample2(w2, lo, m2), b = bf16_sample2(w2, hi, m2);
      v = make_float4(bf16_lo(a), bf16_hi(a), bf16_lo(b), bf16_hi(b));
    }
    st.v[4 * s] = v.x;
    st.v[4 * s + 1] = v.y;
    st.v[4 * s + 2] = v.z;
    st.v[4 * s + 3] = v.w;
  }

  // other shapes: one scalar sample per element.
  template <typename P>
  __device__ __forceinline__ void load_scalar(const P& p, int m0, int k0,
                                              AStage& st) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = threadIdx.x + i * THREADS;
      st.v[i] = sample_scalar(p, m0 + e / BK, k0 + e % BK);
    }
  }

  // Store the chunk: fp32 split into its hi and lo parts (as[0 .. BM*LD)
  // and as[BM*LD ..)), bf16 as it is.
  __device__ __forceinline__ void store(const AStage& st, T* as) const {
    constexpr int LD = Tile<T>::LD;
    const int tid = threadIdx.x;
    if constexpr (Tile<T>::F32) {
      float hi[8], lo[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        hi[i] = tf32_hi(st.v[i]);
        lo[i] = st.v[i] - hi[i];
      }
      if (FAST) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          float* a = as + (tid / 8 + 32 * s) * LD + (tid % 8) * 4;
          *reinterpret_cast<float4*>(a) = make_float4(
              hi[4 * s], hi[4 * s + 1], hi[4 * s + 2], hi[4 * s + 3]);
          *reinterpret_cast<float4*>(a + BM * LD) = make_float4(
              lo[4 * s], lo[4 * s + 1], lo[4 * s + 2], lo[4 * s + 3]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = tid + i * THREADS;
          as[(e / BK) * LD + e % BK] = hi[i];
          as[BM * LD + (e / BK) * LD + e % BK] = lo[i];
        }
      }
    } else {
      if (FAST) {
#pragma unroll
        for (int s = 0; s < 2; ++s)
          *reinterpret_cast<uint2*>(as + (tid / 8 + 32 * s) * LD +
                                    (tid % 8) * 4) =
              make_uint2(pack_bf16(st.v[4 * s], st.v[4 * s + 1]),
                         pack_bf16(st.v[4 * s + 2], st.v[4 * s + 3]));
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = tid + i * THREADS;
          as[(e / BK) * LD + e % BK] = __float2bfloat16_rn(st.v[i]);
        }
      }
    }
  }
};

// The output value of one site and channel from its fp32 sum: fp32 adds
// the bias; bf16 rounds the sum to bf16, then adds the bias in bf16.
template <typename T, typename TO>
__device__ __forceinline__ float epilogue(const Params<T, TO>& p, float acc,
                                          int n) {
  const float b = p.bias != nullptr ? ld(p.bias + n) : 0.f;
  if constexpr (Tile<T>::F32)
    return acc + b;
  else
    return p.bias != nullptr ? rbf(rbf(acc) + b) : rbf(acc);
}

__device__ __forceinline__ void store_out(float* o, float v) { *o = v; }
__device__ __forceinline__ void store_out(bf16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

template <typename T, typename TO, bool FAST>
__global__ void __launch_bounds__(THREADS, 2)
    deform_conv_kernel(const Params<T, TO> p) {
  using TT = Tile<T>;
  constexpr int LD = TT::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const a_s = reinterpret_cast<T*>(smem_raw);
  T* const b_s = a_s + TT::A_ELEMS;

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

  // The products of K columns [kk0, kk0 + 16) of the current A and B
  // stages: fp32 as 3xTF32 (two k8 steps), bf16 as one k16 step.
  auto mma_steps = [&](const T* as, const T* bs, int kk0) {
    if constexpr (TT::F32) {
#pragma unroll
      for (int kk = kk0; kk < kk0 + 16; kk += 8) {
        uint32_t ahi[2][4], alo[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* a = as + mt * 16 * LD + kk;
          const int at[4] = {0, 8 * LD, 4, 8 * LD + 4};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ahi[mt][r] = __float_as_uint(a[at[r]]);
            alo[mt][r] = __float_as_uint(a[BM * LD + at[r]]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          uint32_t bhi[2], blo[2];
          const float* b = bs + nt * 8 * LD + kk;
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
    } else {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const T* ap = as + mt * 16 * LD + kk0;
        const int at[4] = {0, 8 * LD, 8, 8 * LD + 8};
#pragma unroll
        for (int r = 0; r < 4; ++r)
          a[mt][r] = *reinterpret_cast<const uint32_t*>(ap + at[r]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const T* bp = bs + nt * 8 * LD + kk0;
        const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(bp),
                               *reinterpret_cast<const uint32_t*>(bp + 8)};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], a[mt], b);
      }
    }
  };
  // a thread's first fragment column within a chunk: t4 of a TF32 k8
  // fragment, 2 t4 of a bf16 k16 one
  const int kq = TT::F32 ? t4 : 2 * t4;

  if (kb < ke) {
    Gather<T, FAST> gather;
    AStage st;
    if (!TT::F32 && (DROP & 2)) st = AStage{};   // no gather: A is zero
    Raw<T> raw;
    load_b<T, FAST>(p, b_s, kb * BK, n0);
    cp_async_commit();
    if (kb + 1 < ke) load_b<T, FAST>(p, b_s + TT::B_STAGE, (kb + 1) * BK, n0);
    cp_async_commit();
    if (FAST) {
      gather.begin(p, m0, kb * BK);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (TT::F32 || !(DROP & 2)) {
          gather.issue(s, raw);
          gather.combine(s, raw, st);
        }
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
        load_b<T, FAST>(p, b_s + ((i + 2) % B_STAGES) * TT::B_STAGE,
                        (kc + 2) * BK, n0);
      cp_async_commit();
      const T* as = a_s + (i % 2) * TT::A_STAGE + (wm + g) * LD + kq;
      const T* bs = b_s + (i % B_STAGES) * TT::B_STAGE + (wn + g) * LD + kq;
      if (FAST) {
        // The next chunk's corner loads for one site are in flight while
        // half of this chunk's products run.  (On the last chunk the
        // current chunk's corners are read again and dropped, so that no
        // branch splits the loads from the products.)
        if (more && (TT::F32 || !(DROP & 2)))
          gather.begin(p, m0, (kc + 1) * BK);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if (TT::F32 || !(DROP & 2)) gather.issue(s, raw);
          if (TT::F32 || !(DROP & 1)) mma_steps(as, bs, 16 * s);
          if (TT::F32 || !(DROP & 2)) gather.combine(s, raw, st);
        }
      } else {
        if (more) gather.load_scalar(p, m0, (kc + 1) * BK, st);
        if (TT::F32 || !(DROP & 1)) {
          mma_steps(as, bs, 0);
          mma_steps(as, bs, 16);
        }
      }
      if (more) gather.store(st, a_s + ((i + 1) % 2) * TT::A_STAGE);
    }
    cp_async_wait<0>();
  }

  if (n_split == 1 || (!TT::F32 && (DROP & 8))) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + mt * 16 + g + 8 * h;
        if (m >= p.M) continue;
        T* o = p.out + static_cast<int64_t>(m) * p.N;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = n0 + wn + nt * 8 + 2 * t4;
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (n + j < p.N && (TT::F32 || !(DROP & 4) ||
                                acc[mt][nt][2 * h + j] == NEVER))
              store_out(o + n + j, epilogue(p, acc[mt][nt][2 * h + j], n + j));
        }
      }
    return;
  }

  // Split K: sum the cluster's partial tiles in rank order
  // (deform_gather.cuh), add the bias and write each row once.
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();                 // every thread is done with a_s / b_s
  float* part = reinterpret_cast<float*>(smem_raw);   // [BM][BN]
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
  cluster_reduce<BM, BN>(cluster, part, n_split, [&](int rl, int c,
                                                     float (&v)[4]) {
    const int m = m0 + rl, n = n0 + c;
    if (m >= p.M) return;
    T* o = p.out + static_cast<int64_t>(m) * p.N + n;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n + j < p.N) v[j] = epilogue(p, v[j], n + j);
    if (!TT::F32 && (DROP & 4) && v[0] != NEVER) return;
    if (FAST && n < p.N) {
      if constexpr (TT::F32)
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      else
        *reinterpret_cast<uint2*>(o) =
            make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < p.N) store_out(o + j, v[j]);
    }
  });
  cluster.sync();                  // keep every partial tile alive until read
}

// ---- the bf16 fast route -------------------------------------------------
// Cin a multiple of 64, Cout of 128, at most FMAX_TAPS taps, dilation 1,
// x, weight and out 16-byte aligned (every DCN site of R50, R101 and FCB).
// One block of FTHREADS threads per BM x BN output tile and K-split: BM x
// BN is 128 x 128, or 64 x 256 where Cout is a multiple of 256 (each
// gathered site then serves twice the channels).  Warps 0-7 are two
// consumer warpgroups, each the wgmmas of a 64 x 128 piece; warps 8-15 are
// the producers, which gather A and bring B into a ring of FSTAGES stages.
constexpr int FBK = 64;           // (tap, channel) columns a chunk
constexpr int FSTAGES = 4;        // ring stages of A and B
constexpr int FCONSUMERS = 256;   // two warpgroups
constexpr int FPRODUCERS = 256;   // two warpgroups
constexpr int FTHREADS = FCONSUMERS + FPRODUCERS;
constexpr int FMAX_TAPS = 16;     // kh * kw of the fast route

// The tile of BM sites: BN channels, the bytes of a ring stage, and the
// producers' shares.
template <int BM>
struct FTile {
  static constexpr int BN = 128 * 128 / BM;
  static constexpr int A_STAGE = BM * SW128_ROW;     // [BM sites][64]
  static constexpr int B_STAGE = BN * SW128_ROW;     // [BN channels][64]
  static constexpr int SPP = BM * 8 / FPRODUCERS;    // sites a producer
  static constexpr int RPP = BN * 8 / FPRODUCERS;    // B rows a producer
  static_assert(BM == 128 || BM == 64, "128 x 128 or 64 x 256");
  static_assert(BM * BN * 4 <= FSTAGES * (A_STAGE + B_STAGE),
                "the split's partial tile fits in the ring");
};

// Shared memory of a call with `taps` taps: the ring behind the swizzle's
// alignment, its mbarriers, then the corner table of every tap (16 bytes a
// site).
template <int BM>
constexpr int fsmem(int taps) {
  return SW128_ALIGN + FSTAGES * (FTile<BM>::A_STAGE + FTile<BM>::B_STAGE) +
         2 * FSTAGES * 8 + BM * taps * 16;
}

// One (site, tap) of the gather in 16 bytes: the element index of the
// corner block's first channel (corner j at + (j / 2) W Cin + (j % 2) Cin,
// as if every corner lay inside the image), the corner weights rounded to
// bf16 (two a word; zero for every corner off the image, which is then not
// read) and the modulation (both halves).
template <typename TO>
__device__ __forceinline__ uint4 make_entry(const Params<bf16, TO>& p, int m,
                                            int t, const TapIn& in) {
  Corners<bf16> cn;
  corners_from(p, m, t, in, cn);
  int first = 0;
#pragma unroll
  for (int j = 3; j >= 0; --j)
    if (cn.idx[j] >= 0)
      first = static_cast<int>(cn.img - p.x) + cn.idx[j] -
              ((j >> 1) * p.W + (j & 1)) * p.Cin;
  return make_uint4(static_cast<uint32_t>(first), pack_bf16(cn.w[0], cn.w[1]),
                    pack_bf16(cn.w[2], cn.w[3]),
                    m < p.M ? pack_bf16(cn.m, cn.m) : 0u);
}

template <int BM, typename TO>
__global__ void __launch_bounds__(FTHREADS, 1)
    deform_conv_bf16_fast_kernel(const Params<bf16, TO> p) {
  using FT = FTile<BM>;
  constexpr int BN = FT::BN, A_STAGE = FT::A_STAGE, B_STAGE = FT::B_STAGE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle is a function of the address: align the ring to it
  unsigned char* const base =
      smem_raw + ((SW128_ALIGN - (smem_u32(smem_raw) & (SW128_ALIGN - 1))) &
                  (SW128_ALIGN - 1));
  unsigned char* const a_s = base;                        // [S][BM][128]
  unsigned char* const b_s = a_s + FSTAGES * A_STAGE;     // [S][BN][128]
  uint64_t* const bars = reinterpret_cast<uint64_t*>(b_s + FSTAGES * B_STAGE);
  uint4* const tab = reinterpret_cast<uint4*>(bars + 2 * FSTAGES);  // [tap][BM]
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * FSTAGES;
  // the split's partial tile [BM][BN] fp32 takes the ring's place
  float* const part = reinterpret_cast<float*>(base);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z, n_split = gridDim.z;
  const bool whole = n_split == 1 || (DROP & 8);
  const int ntap = p.kh * p.kw;
  const int nk = p.Ktot / FBK;
  const int kb = static_cast<int>(static_cast<int64_t>(nk) * split / n_split);
  const int ke =
      static_cast<int>(static_cast<int64_t>(nk) * (split + 1) / n_split);

  if (tid == 0) {
    // full: every producer's stores and its cp.async copies (.noinc);
    // empty: every consumer thread, once its wgmmas have read the stage
    for (int s = 0; s < FSTAGES; ++s) {
      mbar_init(full0 + 8 * s, 2 * FPRODUCERS);
      mbar_init(empty0 + 8 * s, FCONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Chunk kc covers channels 64 (kc / ntap) .. + 63 of tap kc % ntap: the
  // chunks run channel block by channel block, every tap of a block in
  // turn (where offsets are smooth, a block's corner runs are read again
  // from L1 from tap to tap).
  if (tid < FCONSUMERS) {
    // Consumers: per chunk, wait for its stage, four k16 wgmmas of this
    // warpgroup's 64 sites x 128 channels, one group kept in flight; a
    // stage is handed back once the group that read it is done.
    const int wg = tid / 128;
    const int ms = BM == 128 ? 64 * wg : 0;     // the piece's first site
    const int ns = BM == 128 ? 0 : 128 * wg;    // ... and channel
    // acc[4 j + e]: site row0 + 8 (e / 2), channel ns + 8 j + 2 t4 + e % 2
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    const int lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int row0 = ms + ((tid / 32) % 4) * 16 + g;
    const uint32_t a0 = smem_u32(a_s) + ms * SW128_ROW;
    const uint32_t b0 = smem_u32(b_s) + ns * SW128_ROW;
    for (int kc = kb; kc < ke; ++kc) {
      const int i = kc - kb, s = i % FSTAGES;
      mbar_wait(full0 + 8 * s, (i / FSTAGES) & 1);
      fence_proxy_async();           // the cp.async copies, for wgmma
      if (!(DROP & 1)) {
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < FBK / 16; ++k)
          wgmma_bf16_k128(
              acc, desc_sw128(a0 + s * A_STAGE + 32 * k, 16, 8 * SW128_ROW),
              desc_sw128(b0 + s * B_STAGE + 32 * k, 16, 8 * SW128_ROW));
        wgmma_commit();
        wgmma_wait<1>();
      }
      if (i > 0) mbar_arrive(empty0 + 8 * ((i - 1) % FSTAGES));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 64; ++e) hold(acc[e]);
    if (whole) {
      // the sum rounded to bf16, the bias added in bf16 (epilogue)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + row0 + 8 * h;
        if (m >= p.M) continue;
        bf16* o = p.out + static_cast<int64_t>(m) * p.N + n0 + ns;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = 8 * j + 2 * t4;
          const float v0 = epilogue(p, acc[4 * j + 2 * h], n0 + ns + c);
          const float v1 =
              epilogue(p, acc[4 * j + 2 * h + 1], n0 + ns + c + 1);
          if (!(DROP & 4) || v0 == NEVER)
            *reinterpret_cast<uint32_t*>(o + c) = pack_bf16(v0, v1);
        }
      }
      return;
    }
    __syncthreads();               // every stage consumed, the ring is free
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(part + (row0 + 8 * h) * BN + ns + 8 * j +
                                   2 * t4) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  } else {
    // Producers: thread q of a site's eight gathers 8 channels (16 bytes)
    // of sites ps + 32 j and brings weight rows ps + 32 j.  The corner
    // table holds every tap (tab[tap][site]); producers 0..BM-1 fill site
    // pt's entry of the next chunk's tap during the first ntap chunks (its
    // offset and modulation read one chunk further ahead), behind a
    // barrier a chunk; after them nothing is refilled.
    constexpr int PS = FPRODUCERS / 8;
    const int pt = tid - FCONSUMERS;
    const int q = pt % 8, ps = pt / 8;
    const bool filler = pt < BM;
    const int ldw = p.W * p.Cin;               // from one image row to the next
    TapIn ahead{0.f, 0.f, 0.f};
    if (filler && !(DROP & 2)) {
      const int t = kb % ntap;
      tab[t * BM + pt] = make_entry(p, m0 + pt, t, tap_in(p, m0 + pt, t));
      if (kb + 1 < ke) ahead = tap_in(p, m0 + pt, (kb + 1) % ntap);
    }
    for (int kc = kb; kc < ke; ++kc) {
      const int i = kc - kb, s = i % FSTAGES;
      const int tap = kc % ntap, c0 = (kc / ntap) * FBK;
      const int col = tap * p.Cin + c0;
      if (!(DROP & 2) && i < ntap) {
        // this tap's entries are complete
        asm volatile("bar.sync 1, %0;\n" ::"n"(FPRODUCERS) : "memory");
        if (filler && i + 1 < ntap && kc + 1 < ke) {
          tab[((kc + 1) % ntap) * BM + pt] =
              make_entry(p, m0 + pt, (kc + 1) % ntap, ahead);
          if (i + 2 < ntap && kc + 2 < ke)
            ahead = tap_in(p, m0 + pt, (kc + 2) % ntap);
        }
      }
      mbar_wait(empty0 + 8 * s, ((i / FSTAGES) & 1) ^ 1);
      // B: weight rows n0 + ps + 32 j, columns col + 8 q .. + 7
      unsigned char* const bs = b_s + s * B_STAGE;
#pragma unroll
      for (int j = 0; j < FT::RPP; ++j) {
        const int r = ps + PS * j;
        cp_async16(bs + sw128(r, q),
                   p.weight + static_cast<int64_t>(n0 + r) * p.Ktot + col +
                       8 * q,
                   true);
      }
      mbar_arrive_cp_async(full0 + 8 * s);
      // A: the four corner runs of each site first (a corner of weight
      // zero, as every one off the image, is not read), then their combine
      // (deform_gather.cuh: bf16_sample2, the JAX package's bf16 sample)
      if (!(DROP & 2)) {
        const uint4* const tt = tab + tap * BM + ps;
        uint4 v[FT::SPP][4];
#pragma unroll
        for (int j = 0; j < FT::SPP; ++j) {
          const uint4 e = tt[PS * j];
          const bf16* const px = p.x + static_cast<int>(e.x) + c0 + 8 * q;
          const bool ok[4] = {(e.y & 0xffffu) != 0u, (e.y >> 16) != 0u,
                              (e.z & 0xffffu) != 0u, (e.z >> 16) != 0u};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            v[j][c] = make_uint4(0u, 0u, 0u, 0u);
            if (ok[c])
              v[j][c] = __ldg(reinterpret_cast<const uint4*>(
                  px + (c >> 1) * ldw + (c & 1) * p.Cin));
          }
        }
        unsigned char* const as = a_s + s * A_STAGE;
#pragma unroll
        for (int j = 0; j < FT::SPP; ++j) {
          const uint4 e = tt[PS * j];
          const uint32_t w2[4] = {__byte_perm(e.y, 0, 0x1010),
                                  __byte_perm(e.y, 0, 0x3232),
                                  __byte_perm(e.z, 0, 0x1010),
                                  __byte_perm(e.z, 0, 0x3232)};
          const uint32_t c4x[4] = {v[j][0].x, v[j][1].x, v[j][2].x,
                                   v[j][3].x};
          const uint32_t c4y[4] = {v[j][0].y, v[j][1].y, v[j][2].y,
                                   v[j][3].y};
          const uint32_t c4z[4] = {v[j][0].z, v[j][1].z, v[j][2].z,
                                   v[j][3].z};
          const uint32_t c4w[4] = {v[j][0].w, v[j][1].w, v[j][2].w,
                                   v[j][3].w};
          *reinterpret_cast<uint4*>(as + sw128(ps + PS * j, q)) =
              make_uint4(bf16_sample2(w2, c4x, e.w),
                         bf16_sample2(w2, c4y, e.w),
                         bf16_sample2(w2, c4z, e.w),
                         bf16_sample2(w2, c4w, e.w));
        }
        fence_proxy_async();         // this thread's A stores, for wgmma
      }
      mbar_arrive(full0 + 8 * s);
    }
    if (whole) return;
    __syncthreads();               // (the consumers' partial tile follows)
  }

  // Split K: sum the cluster's partial tiles in rank order
  // (deform_gather.cuh), round, add the bias and write each row once.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  cluster_reduce<BM, BN, FTHREADS>(cluster, part, n_split,
                                   [&](int rl, int c, float (&v)[4]) {
    const int m = m0 + rl, n = n0 + c;
    if (m >= p.M) return;
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = epilogue(p, v[j], n + j);
    if ((DROP & 4) && v[0] != NEVER) return;
    *reinterpret_cast<uint2*>(p.out + static_cast<int64_t>(m) * p.N + n) =
        make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  });
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

template <typename T, typename TO>
int launch(const T* x, const TO* offset, const T* mask, const T* weight,
           const T* bias, T* out, int B, int H, int W, int Cin, int Ho,
           int Wo, int Cout, int kh, int kw, int stride, int dilation,
           int off_ld, int mask_ld, void* stream) {
  using TT = Tile<T>;
  if (B < 0 || H <= 0 || W <= 0 || Cin <= 0 || Ho < 0 || Wo < 0 ||
      Cout <= 0 || kh <= 0 || kw <= 0 || stride <= 0 || dilation <= 0 ||
      off_ld < 2 * kh * kw || (mask != nullptr && mask_ld < kh * kw) ||
      static_cast<int64_t>(H) * W * Cin > INT32_MAX ||
      static_cast<int64_t>(B) * Ho * Wo > INT32_MAX ||
      static_cast<int64_t>(kh) * kw * Cin > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Params<T, TO> p{{x, offset, mask, H, W, Cin, Ho, Wo, kh, kw, stride,
                   dilation, B * Ho * Wo, kh * kw * Cin, off_ld, mask_ld},
                  weight, bias, out, Cout};
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

  static bool smem_set = false;
  if (!smem_set) {
    for (const auto kernel : {deform_conv_kernel<T, TO, true>,
                              deform_conv_kernel<T, TO, false>}) {
      const cudaError_t e = allow_clusters(kernel, TT::SMEM_BYTES);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    smem_set = true;
  }
  const cudaError_t e = launch_split(
      fast ? deform_conv_kernel<T, TO, true>
           : deform_conv_kernel<T, TO, false>,
      mt, nt, split, TT::SMEM_BYTES, stream, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// What the fast route needs of a call (the wrapper, kernels/deform_conv.py::
// conv_fast, chooses the route; a fast call without these is refused).
bool fast_fits(const void* x, const void* weight, const void* out, int Cin,
               int Cout, int kh, int kw, int dilation) {
  return Cin % FBK == 0 && Cout % 128 == 0 && kh * kw <= FMAX_TAPS &&
         dilation == 1 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(weight) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

template <int BM, typename TO>
int launch_fast(const Params<bf16, TO>& p, int split, void* stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = allow_clusters(deform_conv_bf16_fast_kernel<BM, TO>,
                                         fsmem<BM>(FMAX_TAPS));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const cudaError_t e = launch_split(
      deform_conv_bf16_fast_kernel<BM, TO>, (p.M + BM - 1) / BM,
      p.N / FTile<BM>::BN, split, fsmem<BM>(p.kh * p.kw), stream, p,
      FTHREADS);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 entries, on the wrapper's route: split 0 the general route
// above, which chooses its own split; else the fast route with that split
// (a power of two up to MAX_SPLIT that leaves every block a chunk, and a
// call that fast_fits; refused otherwise), its tile 64 x 256 where Cout is
// a multiple of 256, else 128 x 128.
template <typename TO>
int launch_bf16(const bf16* x, const TO* offset, const bf16* mask,
                const bf16* weight, const bf16* bias, bf16* out, int B, int H,
                int W, int Cin, int Ho, int Wo, int Cout, int kh, int kw,
                int stride, int dilation, int off_ld, int mask_ld, int split,
                void* stream) {
  if (split == 0)
    return launch<bf16, TO>(x, offset, mask, weight, bias, out, B, H, W, Cin,
                            Ho, Wo, Cout, kh, kw, stride, dilation, off_ld,
                            mask_ld, stream);
  if (!fast_fits(x, weight, out, Cin, Cout, kh, kw, dilation) || B < 0 ||
      H <= 0 || W <= 0 || Ho < 0 || Wo < 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || off_ld < 2 * kh * kw ||
      (mask != nullptr && mask_ld < kh * kw) || split < 1 ||
      split > MAX_SPLIT || (split & (split - 1)) != 0 ||
      static_cast<int64_t>(B) * H * W * Cin > INT32_MAX ||
      static_cast<int64_t>(B) * Ho * Wo > INT32_MAX ||
      static_cast<int64_t>(kh) * kw * Cin / FBK < split)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params<bf16, TO> p{{x, offset, mask, H, W, Cin, Ho, Wo, kh, kw,
                            stride, dilation, B * Ho * Wo, kh * kw * Cin,
                            off_ld, mask_ld},
                           weight, bias, out, Cout};
  if (p.M == 0) return static_cast<int>(cudaSuccess);
  return Cout % 256 == 0 ? launch_fast<64>(p, split, stream)
                         : launch_fast<128>(p, split, stream);
}

}  // namespace

// x: [B, H, W, Cin]; offset: [B, Ho, Wo, 2*kh*kw] (dy, dx)-interleaved per
// tap, sites off_ld elements apart; mask: [B, Ho, Wo, kh*kw], sites mask_ld
// elements apart, or null (v1); weight: [Cout, kh, kw, Cin]; bias: [Cout]
// or null; out: [B, Ho, Wo, Cout].  All of one type (fp32 for
// stmask_deform_conv, bf16 for stmask_deform_conv_bf16), or all bf16 but
// the fp32 offset (stmask_deform_conv_bf16_f32off); x, weight and out
// contiguous.  The bf16 entries also take split, which names the route
// (kernels/deform_conv.py::conv_plan): 0 the general route, which chooses
// its own split; 1 to 16, a power of two, the fast route with that many
// blocks of a cluster sharing a tile's K.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue, launching nothing, for a fast
// call that the fast route cannot take).
extern "C" int stmask_deform_conv(const float* x, const float* offset,
                                  const float* mask, const float* weight,
                                  const float* bias, float* out, int B, int H,
                                  int W, int Cin, int Ho, int Wo, int Cout,
                                  int kh, int kw, int stride, int dilation,
                                  int off_ld, int mask_ld, void* stream) {
  return launch<float, float>(x, offset, mask, weight, bias, out, B, H, W,
                              Cin, Ho, Wo, Cout, kh, kw, stride, dilation,
                              off_ld, mask_ld, stream);
}

extern "C" int stmask_deform_conv_bf16(const void* x, const void* offset,
                                       const void* mask, const void* weight,
                                       const void* bias, void* out, int B,
                                       int H, int W, int Cin, int Ho, int Wo,
                                       int Cout, int kh, int kw, int stride,
                                       int dilation, int off_ld, int mask_ld,
                                       int split, void* stream) {
  return launch_bf16<bf16>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(offset),
      static_cast<const bf16*>(mask), static_cast<const bf16*>(weight),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), B, H, W, Cin,
      Ho, Wo, Cout, kh, kw, stride, dilation, off_ld, mask_ld, split, stream);
}

extern "C" int stmask_deform_conv_bf16_f32off(
    const void* x, const float* offset, const void* mask, const void* weight,
    const void* bias, void* out, int B, int H, int W, int Cin, int Ho, int Wo,
    int Cout, int kh, int kw, int stride, int dilation, int off_ld,
    int mask_ld, int split, void* stream) {
  return launch_bf16<float>(
      static_cast<const bf16*>(x), offset, static_cast<const bf16*>(mask),
      static_cast<const bf16*>(weight), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), B, H, W, Cin, Ho, Wo, Cout, kh, kw, stride,
      dilation, off_ld, mask_ld, split, stream);
}
