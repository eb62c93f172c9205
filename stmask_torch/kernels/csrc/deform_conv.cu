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
// sampling.py:83): the same tiles, ring, clusters and epilogue order, with
// the rounding points of the JAX path.  Each corner weight wy * wx is
// computed in fp32 and rounded to bf16, each weight * sample product is
// rounded to bf16, the four are summed in fp32 and rounded, and the
// modulation multiply is rounded again; the sample is stored to shared
// memory as bf16.  The weight ring holds bf16, and one
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

namespace {

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

__device__ __forceinline__ float4 widen(const float4& v) { return v; }
__device__ __forceinline__ float4 widen(const uint2& v) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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
      float q[4][4];               // [channel][corner]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 f = widen(raw.r[j]);
        q[0][j] = f.x;
        q[1][j] = f.y;
        q[2][j] = f.z;
        q[3][j] = f.w;
      }
      v.x = bf16_sample(cn[s].w, q[0], cn[s].m);
      v.y = bf16_sample(cn[s].w, q[1], cn[s].m);
      v.z = bf16_sample(cn[s].w, q[2], cn[s].m);
      v.w = bf16_sample(cn[s].w, q[3], cn[s].m);
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
    Raw<T> raw;
    load_b<T, FAST>(p, b_s, kb * BK, n0);
    cp_async_commit();
    if (kb + 1 < ke) load_b<T, FAST>(p, b_s + TT::B_STAGE, (kb + 1) * BK, n0);
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
      if (more) gather.store(st, a_s + ((i + 1) % 2) * TT::A_STAGE);
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
        T* o = p.out + static_cast<int64_t>(m) * p.N;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = n0 + wn + nt * 8 + 2 * t4;
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (n + j < p.N)
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

}  // namespace

// x: [B, H, W, Cin]; offset: [B, Ho, Wo, 2*kh*kw] (dy, dx)-interleaved per
// tap, sites off_ld elements apart; mask: [B, Ho, Wo, kh*kw], sites mask_ld
// elements apart, or null (v1); weight: [Cout, kh, kw, Cin]; bias: [Cout]
// or null; out: [B, Ho, Wo, Cout].  All of one type (fp32 for
// stmask_deform_conv, bf16 for stmask_deform_conv_bf16), or all bf16 but
// the fp32 offset (stmask_deform_conv_bf16_f32off); x, weight and out
// contiguous.  Returns cudaGetLastError() after the launch.
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
                                       void* stream) {
  return launch<bf16, bf16>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(offset),
      static_cast<const bf16*>(mask), static_cast<const bf16*>(weight),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), B, H, W, Cin,
      Ho, Wo, Cout, kh, kw, stride, dilation, off_ld, mask_ld, stream);
}

extern "C" int stmask_deform_conv_bf16_f32off(
    const void* x, const float* offset, const void* mask, const void* weight,
    const void* bias, void* out, int B, int H, int W, int Cin, int Ho, int Wo,
    int Cout, int kh, int kw, int stride, int dilation, int off_ld,
    int mask_ld, void* stream) {
  return launch<bf16, float>(
      static_cast<const bf16*>(x), offset, static_cast<const bf16*>(mask),
      static_cast<const bf16*>(weight), static_cast<const bf16*>(bias),
      static_cast<bf16*>(out), B, H, W, Cin, Ho, Wo, Cout, kh, kw, stride,
      dilation, off_ld, mask_ld, stream);
}
