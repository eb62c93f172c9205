// Weight gradient of the modulated deformable conv, NHWC, with the gather
// fused into the GEMM: d_w straight from (x, offset, mask, g), the sampled
// columns never written to device memory.  Entries: fp32; bf16 (g, x, mask
// and d_w bf16, the offsets bf16 or fp32; below the fp32 design).
//
// Replaces, in the DCN backward of the training path, K2 (deform_im2col.cu,
// which wrote cols [M, K*Cin]) and the cuBLAS SGEMM g^T @ cols after it.
// In the JAX package this is the transpose of the window path's
// contraction jnp.dot(vals, weight.reshape(k*cin, cout))
// (stmask_tpu/ops/deform_conv.py:347, in deform_conv2d_window :270), which
// XLA differentiates.
//
//   d_w[n, k / kw, k % kw, c] = sum_{m < M} g[m, n] * m[m, k]
//                                 * bilinear(x[b(m)], py_k(m), px_k(m))[c]
//
// with the forward's sample (deform_gather.cuh: the same corners, zero
// weight outside the image, the same modulation).  g is [M = B*Ho*Wo,
// Cout], d_w [Cout, kh, kw, Cin], the weight's own layout.
//
// What bounds it on an H100: operations.  The GEMM d_w [Cout x K*Cin] =
// g^T [Cout x M] . cols [M x K*Cin] is 2*M*Cout*K*Cin = 9.06 GFLOP at each
// of the 7 main-path sites with 8 frames, done as three TF32 products
// (below): 55 us a site at the 495 TFLOP/s dense TF32 peak, plus the
// gather's fp32 flops, against 6-16 MB of x, offset, mask and g read and
// 0.6-9.4 MB of d_w written (2-8 us at 3.35 TB/s).
//
// Math: 3xTF32 on the tensor cores, as in the forward: each operand is
// split as hi + lo (hi exact in TF32), and a*b is summed as lo_a*hi_b +
// hi_a*hi_b + hi_a*lo_b in fp32, because the path is fp32 with TF32 off.
// The tensor cores' fp32 accumulation does not round to nearest: one chain
// of MMAs over a split's thousands of sites drifted past the 1e-5 (of
// max|d_w|) the kernel is held to.  So each chunk of 32 sites is summed
// fresh (12 MMAs) and added to the running sum with an fp32 add.
//
// Design (one block per tile of TM output channels x 64 (tap, channel)
// columns and M-split; TM = 128 with 256 threads, two blocks an SM, or 256
// with 512 threads, one block an SM, when Cout is a multiple of 256, so
// that each gathered column serves twice the channels; in two runs on an
// H100 SXM at 700 W the 256 tile took 1.6-3.1% less time than the 128
// tile at layer2 and 4.7-7.1% less at layer3, each at its fastest split:
// chip_smoke.py's [tiles] lines):
// - The MMA is Hopper's wgmma (m64n64k8, TF32), one warpgroup per 64
//   channels: A (g, its rows output channels) from registers, B (the
//   gathered columns) straight from shared memory, asynchronously.
//   mma.sync, which needs every B fragment in registers, spent as much
//   time loading them as on the products.
// - A: g's chunk [32 sites][TM channels] (rows contiguous in Cout) comes
//   by 16-byte cp.async into two stages; rows TM + 8 floats apart put a
//   warp's 32 scalar fragment loads on 32 banks (TF32 has no
//   ldmatrix.trans); each value is split into hi and lo in registers.
// - B: the chunk's columns in wgmma's K-major layout without swizzle, hi
//   and lo planes, two stages (layout at b_at below).
// - The gather, per chunk of 32 sites, in three steps a chunk apart, so
//   that one barrier a chunk suffices and the wgmmas of chunk kc overlap
//   the gather of the next ones: (1) one or two warps compute a table of
//   the corners of every (site, tap) of chunk kc + 3 (index of each
//   corner's NHWC run, weight with the modulation folded in), once per
//   (site, tap) instead of once per thread, each filling thread following
//   its site without dividing; (2) every thread copies its corner runs of
//   chunk kc + 2 (4 columns of 1 or 2 sites, 16 bytes a corner) into its
//   own slots of a staging area by cp.async, so that no gathered value
//   waits in a register; (3) while chunk kc's wgmmas run, it combines
//   its runs of chunk kc + 1 (the forward's combine: corners in order)
//   and stores them split into B.
// - M is split across the blocks of a thread-block cluster (1 to 16;
//   kernels/deform_wgrad.py::wgrad_plan: layer1 16, layer2 8, layer3 4 at
//   the main path).  The partial tiles are summed through distributed
//   shared memory in rank order (deform_gather.cuh): d_w is the same bit
//   for bit on every launch, with no atomics.  The M tail is zero-filled
//   in both operands.
// - Shapes off the fast path (Cin not a multiple of 32, Cout not of the
//   tile height, unaligned pointers) take the 128-channel tile with one
//   scalar sample per element stored before the chunk's products and
//   4-byte copies of g: right, and slow.  Any kh, kw, stride and dilation,
//   with or without the modulation.
// - Registers: 128 a thread at most, no spill (ptxas).
//
// The bf16 entries (g, x, mask and d_w bf16; the offsets bf16, or fp32 for
// FCB's analytic ones) compute the bf16 sample of the fused conv's bf16
// entry (deform_gather.cuh: bf16_sample / bf16_sample2, the JAX package's
// bf16 values): each hat weight wy * wx rounded to bf16, each weight x
// value product rounded, the four summed in fp32 in corner order and
// rounded, then the product with the modulation rounded.  The modulation
// is therefore kept apart from the corner weights (folding it in, as fp32
// does, would round m * wy * wx once instead of the JAX package's two
// roundings).  The product g^T . cols of bf16 values is exact in fp32; it
// is summed in fp32 and d_w rounded to bf16 once, when it is written.  Its
// bound: the same 2*M*Cout*K*Cin as one bf16 product (9.2 us a main-path
// site at the 989 TFLOP/s dense bf16 peak) plus the gather's flops, against
// half the fp32 path's bytes.
//
// bf16 fast path (Cin a multiple of 32, Cout of the tile height, x, g and
// d_w 16-byte aligned: every DCN site of the flagship and of FCB).  The
// fp32 fast path's tiles, clusters and gather pipeline, with what bf16
// allows:
// - Both operands bf16 in shared memory, each site's 64 values one
//   128-byte row in the 128-byte swizzle (chunk q of row s at q ^ (s % 8),
//   patterns 1024-byte aligned).  A = g^T comes by 16-byte cp.async, 64
//   channels a block [32 sites][64], and is read MN-major (wgmma's
//   transpose bit for 16-bit A); B, the gathered columns [32 sites][64],
//   is read MN-major too.  No register fragments, no hi / lo split.
// - One wgmma.m64n64k16.f32.bf16.bf16 per 16 sites a warpgroup, against
//   three m64n64k8 TF32 ones per 8 sites on the fp32 path.
// - The gather as on the fp32 path, in bf16: the corner table once per
//   (site, tap) three chunks ahead (the weights rounded, two a word, and
//   the modulation beside them); each thread's 16-byte (TM 128: 8
//   channels) or 8-byte (TM 256: 4 channels) corner runs by cp.async into
//   a staging area two chunks ahead (two buffers); and, while chunk kc's
//   wgmmas run, the combine of chunk kc + 1 into the other B stage, two
//   channels at a time (bf16_sample2: bf16x2 multiplies for the rounded
//   products, fp32 adds).
// - The sums: one chain of wgmmas over the block's sites in fp32
//   accumulators, with no fresh sum a chunk as on the fp32 path.  The
//   tensor cores' truncating accumulation moved the fp32 path by ~1e-5 of
//   max|d_w| over a split's sites; the bf16 result is held to one bf16 ulp
//   of each value plus 2^-12 of max|d_w|, 24 times that, and the fresh
//   sums would take 32 more registers.  The split's partial tiles are
//   added through distributed shared memory in rank order, as on the fp32
//   path: the same bits on every launch, no atomics.
// - Registers: 128 a thread at most (two blocks an SM at TM 128), no spill.
// Other shapes (Cin 48, Cout 96, an unaligned x or g) take the general
// path above (the 128-channel tile, one bf16_sample an element, g
// converted to fp32 as it is loaded, three TF32 products of which two are
// zero): right, and slow.

#include "deform_gather.cuh"
#include "wgmma.cuh"

namespace {

constexpr int TN = 64;          // (tap, channel) columns per tile
constexpr int BS = 32;          // sites per chunk (MMA reduction)
// The gathered columns of a chunk, as wgmma reads its B operand: K-major
// without swizzle, per 8 sites (kb) 8 groups of 8 columns, each group two
// 8 x 16-byte core matrices (sites 0-3, then 4-7) LBO = 128 bytes apart,
// groups SBO = 272 bytes apart (16 bytes of padding spread the combine's
// stores over the banks).  Two planes (hi, lo) a stage.
constexpr int LBO = 128, SBO = 272;
constexpr int KB_FLOATS = TN / 8 * SBO / 4;   // one 8-site block
constexpr int PLANE = BS / 8 * KB_FLOATS;
constexpr int C_STAGE = 2 * PLANE;
constexpr int STAGED = BS * 4 * TN;           // corner runs [site][4][TN]
constexpr int ENTRIES = BS * (TN / 32);       // corner-table entries a chunk

// The tile's TM output channels, 64 a warpgroup: 128 (256 threads, two
// blocks an SM) or 256 (512 threads, one block an SM).
template <int TM>
struct Geo {
  static constexpr int NT = 2 * TM;             // threads
  static constexpr int LDG = TM + 8;            // g chunk row stride
  static constexpr int G_STAGE = BS * LDG;      // two stages
  static constexpr int SPT = BS * (TN / 4) / NT;  // gathered sites a thread
  static constexpr int SMEM_BYTES =
      4 * (2 * G_STAGE + 2 * C_STAGE + STAGED) + 3 * ENTRIES * 32 +
      ENTRIES * 16 + 16;
  static_assert(TM * TN * 4 <= SMEM_BYTES, "partial tile must fit");
  static_assert(SPT == 1 || SPT == 2, "one or two sites a thread");
  static_assert(ENTRIES <= NT, "a thread fills one table entry");
};

// Where B element (site k, column n) lies in a plane.
__device__ __forceinline__ int b_at(int k, int n) {
  return (k / 8) * KB_FLOATS + (n / 8) * (SBO / 4) + (n % 8) * 4 +
         ((k % 8) / 4) * (LBO / 4) + k % 4;
}

// The low word of the shared-memory matrix descriptor of a B block at p
// (16-byte aligned): start address and LBO.  The high word (SBO, no
// swizzle) is the constant DESC_HI.
__device__ __forceinline__ uint32_t b_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return ((a & 0x3FFFF) >> 4) | ((LBO >> 4) << 16);
}
constexpr int DESC_HI = SBO >> 4;

// d (+)= a * B on a 64 x 64 x 8 TF32 tile of a warpgroup (fp32
// accumulate): a is this warp's 16 rows of A in registers (rows g, g + 8,
// g, g + 8 at sites t4, t4, t4 + 4, t4 + 4), B [64 columns][8 sites] read
// from shared memory at the block
// whose descriptor's low word is desc plus OFF (16-byte units);
// d[4 j .. 4 j + 3] are rows g, g, g + 8, g + 8 of the warp's slice at
// columns 8 j + 2 t4 + {0, 1}.  scale_d 0 writes d fresh.  Asynchronous:
// d and a belong to the MMA until wgmma_wait.
template <int OFF>
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint32_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 lo;\n.reg .b64 desc;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "add.u32 lo, %36, %38;\n"
      "mov.b64 desc, {lo, %39};\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, desc, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(desc), "r"(scale_d),
        "n"(OFF), "n"(DESC_HI));
}

// T: the type of g, x, the mask and d_w; TO: the offsets' (T, or fp32
// beside bf16).
template <typename T = float, typename TO = T>
struct Params : Sample<T, TO> {
  const T* g;            // [M, N]
  T* dw;                 // [N, Ktot]
  int N;
};

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One (site, tap) of a chunk: each corner's first channel as an element
// index into x (-1 outside the image) and its weight with the modulation
// folded in.
struct Entry {
  int idx[4];
  float w[4];
};

// Where a table-filling thread is: its next site fm (image fb, row foy,
// column fox).  Kept in shared memory between chunks, so that it holds no
// register through the products.
struct Cursor {
  int fm, fb, foy, fox;
};

// g rows [m0, m0 + BS), channels [n0, n0 + TM) into one stage, [BS][LDG];
// zero past the last site or channel (the fast path has no channel past
// the last: Cout is a multiple of TM there).  bf16 g is converted by plain
// loads, as it is read.
template <bool FAST, int TM, typename T, typename TO>
__device__ __forceinline__ void load_g(const Params<T, TO>& p, float* gs,
                                       int m0, int n0) {
  using G = Geo<TM>;
  constexpr int LDG = G::LDG, NT = G::NT;
  const int tid = threadIdx.x;
  if (FAST) {
#pragma unroll
    for (int i = 0; i < BS * TM / 4 / NT; ++i) {
      const int e = tid + i * NT;
      const int r = e / (TM / 4), c = (e % (TM / 4)) * 4;
      const bool ok = m0 + r < p.M;
      cp_async16(gs + r * LDG + c,
                 ok ? p.g + static_cast<int64_t>(m0 + r) * p.N + n0 + c
                    : p.g,
                 ok);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BS * TM / NT; ++i) {
      const int e = tid + i * NT;
      const int r = e / TM, c = e % TM;
      const bool ok = m0 + r < p.M && n0 + c < p.N;
      const T* src = p.g + static_cast<int64_t>(m0 + r) * p.N + n0 + c;
      if constexpr (kF32<T>)
        cp_async4(gs + r * LDG + c, ok ? src : p.g, ok);
      else
        gs[r * LDG + c] = ok ? ld(src) : 0.f;
    }
  }
}

template <bool FAST, int TM, typename T = float, typename TO = T>
__global__ void __launch_bounds__(2 * TM, FAST ? 256 / TM : 1)
    deform_wgrad_kernel(const Params<T, TO> p) {
  using G = Geo<TM>;
  constexpr int LDG = G::LDG, NT = G::NT, G_STAGE = G::G_STAGE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* const g_s = reinterpret_cast<float*>(smem_raw);   // [2][BS][LDG]
  float* const c_s = g_s + 2 * G_STAGE;              // [2][hi, lo planes]
  float* const st_s = c_s + 2 * C_STAGE;             // staged corner runs
  Entry* const tab = reinterpret_cast<Entry*>(st_s + STAGED);  // [3][ENTRIES]
  Cursor* const cur = reinterpret_cast<Cursor*>(tab + 3 * ENTRIES);
  int* const nfw = reinterpret_cast<int*>(cur + ENTRIES);  // filling warps

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, t4 = lane % 4;    // fragment coordinates
  const int row0 = (warp / 4) * 64 + (warp % 4) * 16 + gq;  // A and D rows
  const int j0 = blockIdx.x * TN;            // first column of the tile
  const int n0 = blockIdx.y * TM;            // first output channel
  const int split = blockIdx.z, n_split = gridDim.z;
  const int nc = (p.M + BS - 1) / BS;
  const int cb = static_cast<int>(static_cast<int64_t>(nc) * split / n_split);
  const int ce =
      static_cast<int>(static_cast<int64_t>(nc) * (split + 1) / n_split);

  // acc[4 j + e]: channel row0 + 8 (e / 2), column 8 j + 2 t4 + e % 2.
  // A chunk's products are summed in sum (a chain of 12 MMAs, the first
  // writing it fresh) and added to acc with an fp32 add (see the top).
  float acc[32], sum[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;

  // The 3xTF32 products of chunk stage i into sum, then into acc: per 8
  // sites (kb) three asynchronous wgmmas, with work(kb) run while they are
  // in flight.
  auto products = [&](int i, auto&& work) {
    const float* gs = g_s + (i % 2) * G_STAGE + t4 * LDG + row0;
    const float* bs = c_s + (i % 2) * C_STAGE;
#pragma unroll
    for (int kb = 0; kb < BS / 8; ++kb) {
      uint32_t ahi[4], alo[4];
      const float* ap = gs + kb * 8 * LDG;
      const int at[4] = {0, 8, 4 * LDG, 4 * LDG + 8};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = ap[at[r]], hi = tf32_hi(x);
        ahi[r] = __float_as_uint(hi);
        alo[r] = __float_as_uint(x - hi);
      }
      const uint32_t desc = b_desc(bs + kb * KB_FLOATS);
      wgmma_fence();
      wgmma_tf32<0>(sum, alo, desc, kb != 0);              // lo_a * hi_b
      wgmma_tf32<0>(sum, ahi, desc, 1);                    // hi_a * hi_b
      wgmma_tf32<PLANE * 4 / 16>(sum, ahi, desc, 1);       // hi_a * lo_b
      wgmma_commit();
      work(kb);
      wgmma_wait();
#pragma unroll
      for (int e = 0; e < 32; ++e) hold(sum[e]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        hold(ahi[r]);
        hold(alo[r]);
      }
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] += sum[e];
  };

  if constexpr (FAST) {
    if (cb < ce) {
    // Fast path (Cin a multiple of 32: each 32-column half of the tile
    // lies in one tap, both halves in the same one when the tile does).
    // One barrier a chunk; then, while chunk kc's wgmmas run, every thread
    // combines its staged runs of chunk kc + 1 into B and copies its runs
    // of chunk kc + 2; after them the first one or two warps fill the
    // corner table of chunk kc + 3, with the offsets and modulation of its
    // sites read one fill ahead.  A thread reads only the staging slots it
    // copied, so only B and the table need the barrier.
    // log2 entries a site: one when the tile lies in one tap; else one a
    // half, the half past the last column (if any) gathering nothing
    const int hsh = (j0 + TN <= p.Ktot &&
                     j0 / p.Cin == (j0 + TN - 1) / p.Cin) ? 0 : 1;
    const int e = tid;
    const bool filler = e < (BS << hsh);
    constexpr int SPT = G::SPT;
    // entry e's tap (-1 past the last column)
    auto ftap = [&]() {
      const int fcol = j0 + 32 * (e & hsh);
      return fcol < p.Ktot ? fcol / p.Cin : -1;
    };
    TapIn in;              // the offset and modulation of the next site
    auto fill = [&](Entry* t) {
      Cursor c = cur[e];
      const int tap = ftap();
      Corners<float> cn;
      if (c.fm < p.M && tap >= 0) {
        const int pad_h = (p.kh - 1) / 2 * p.dilation;
        const int pad_w = (p.kw - 1) / 2 * p.dilation;
        corners_at(p, c.fb,
                   c.foy * p.stride - pad_h + (tap / p.kw) * p.dilation,
                   c.fox * p.stride - pad_w + (tap % p.kw) * p.dilation,
                   in, cn);
      } else {
        cn.img = p.x;
#pragma unroll
        for (int j = 0; j < 4; ++j) cn.idx[j] = -1, cn.w[j] = 0.f;
      }
      const int base = static_cast<int>(cn.img - p.x);
      Entry en;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        en.idx[j] = cn.idx[j] >= 0 ? base + cn.idx[j] : -1;
        en.w[j] = cn.w[j];
      }
      t[e] = en;
      c.fm += BS;
      c.fox += BS;
      while (c.fox >= p.Wo) {
        c.fox -= p.Wo;
        if (++c.foy == p.Ho) c.foy = 0, ++c.fb;
      }
      in = tap_in(p, tap >= 0 ? c.fm : p.M, tap);
      cur[e] = c;
    };
    // The gathering thread: SPT sites from s0 on (neighbours in a B row),
    // columns col .. col + 3 of the tile (channels ch .. ch + 3 of a tap)
    const int s0 = SPT * (tid / 16);
    const int col = (tid % 16) * 4;
    const int ent = (col / 32) & hsh;    // the thread's entry of a site
    const int hcol = j0 + (col & ~31);
    const int ch = hcol - hcol / p.Cin * p.Cin + col % 32;
    // site s0 + h's four corner runs into its staging slots
    auto stage = [&](const Entry* t, int h) {
      const int s = s0 + h;
      const int4 idx = *reinterpret_cast<const int4*>(t[(s << hsh) + ent].idx);
      const int ix[4] = {idx.x, idx.y, idx.z, idx.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = ix[j] >= 0;
        cp_async16(st_s + (s * 4 + j) * TN + col, ok ? p.x + ix[j] + ch : p.x,
                   ok);
      }
    };
    // site s0 + h's staged runs combined into B (hi and lo planes at cs)
    auto combine = [&](const Entry* t, float* cs, int h) {
      const int s = s0 + h;
      const float4 w4 =
          *reinterpret_cast<const float4*>(t[(s << hsh) + ent].w);
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 r =
            *reinterpret_cast<const float4*>(st_s + (s * 4 + j) * TN + col);
        v[0] += w[j] * r.x;
        v[1] += w[j] * r.y;
        v[2] += w[j] * r.z;
        v[3] += w[j] * r.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int at = b_at(s, col + q);
        const float hi = tf32_hi(v[q]);
        cs[at] = hi;
        cs[PLANE + at] = v[q] - hi;
      }
    };


    if (tid == 0) *nfw = (BS << hsh) / 32;
    if (filler) {
      const int fm = cb * BS + (e >> hsh);
      cur[e] = Cursor{fm, fm / p.Wo / p.Ho, fm / p.Wo % p.Ho, fm % p.Wo};
      const int tap = ftap();
      in = tap_in(p, tap >= 0 ? fm : p.M, tap);
      for (int q = 0; q < 3 && cb + q < ce; ++q) fill(tab + q * ENTRIES);
    }
    __syncthreads();
    load_g<true, TM>(p, g_s, cb * BS, n0);
#pragma unroll
    for (int h = 0; h < SPT; ++h) stage(tab, h);
    cp_async_commit();
    cp_async_wait<0>();            // chunk cb's corners (and g)
#pragma unroll
    for (int h = 0; h < SPT; ++h) {
      combine(tab, c_s, h);
      if (cb + 1 < ce) stage(tab + ENTRIES, h);
    }
    cp_async_commit();

    for (int kc = cb; kc < ce; ++kc) {
      const int i = kc - cb;
      cp_async_wait<0>();          // g of chunk kc, corners of kc + 1
      fence_proxy_async();         // this thread's B stores, for wgmma
      __syncthreads();             // chunk kc's B planes and g for everyone
      if (kc + 1 < ce)
        load_g<true, TM>(p, g_s + ((i + 1) % 2) * G_STAGE, (kc + 1) * BS,
                         n0);
      // one site's combine, then one site's copies, in the windows of
      // the four MMA batches (a site's slots are read before refilled)
      products(i, [&](int kb) {
        if (kb < SPT) {
          if (kc + 1 < ce)
            combine(tab + ((i + 1) % 3) * ENTRIES,
                    c_s + ((i + 1) % 2) * C_STAGE, kb);
        } else if (kb >= 2 && kb - 2 < SPT) {
          if (kc + 2 < ce) stage(tab + ((i + 2) % 3) * ENTRIES, kb - 2);
        }
        if (kb == BS / 8 - 1) cp_async_commit();
      });
      // (the filling warps' count is read from shared memory: a flag held
      // through the loop would take a register and spill)
      if (kc + 3 < ce && warp < *reinterpret_cast<volatile int*>(nfw))
        fill(tab + (i % 3) * ENTRIES);
    }
    cp_async_wait<0>();
    }
  } else if (cb < ce) {
    // Other shapes (TM = 128 only): one scalar sample per element, stored
    // before the chunk's products.
    load_g<false, TM>(p, g_s, cb * BS, n0);
    cp_async_commit();
    for (int kc = cb; kc < ce; ++kc) {
      const int i = kc - cb;
      float* cs = c_s + (i % 2) * C_STAGE;
#pragma unroll 1
      for (int el = tid; el < BS * TN; el += NT) {
        const float v = sample_scalar(p, kc * BS + el / TN, j0 + el % TN);
        const int at = b_at(el / TN, el % TN);
        const float hi = tf32_hi(v);
        cs[at] = hi;
        cs[PLANE + at] = v - hi;
      }
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();             // the chunk's B planes and g for everyone
      if (kc + 1 < ce)
        load_g<false, TM>(p, g_s + ((i + 1) % 2) * G_STAGE, (kc + 1) * BS,
                          n0);
      cp_async_commit();
      products(i, [](int) {});
    }
    cp_async_wait<0>();
  }

  if (n_split == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + row0 + 8 * h;
      if (n >= p.N) continue;
      T* o = p.dw + static_cast<int64_t>(n) * p.Ktot;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const int j = j0 + 8 * jb + 2 * t4;
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (j + q < p.Ktot) st(o + j + q, acc[4 * jb + 2 * h + q]);
      }
    }
    return;
  }

  // Split M: sum the cluster's partial tiles in rank order
  // (deform_gather.cuh) and write each row of the tile once.
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();                 // every thread is done with g_s / c_s
  float* part = reinterpret_cast<float*>(smem_raw);   // [TM][TN]
#pragma unroll
  for (int jb = 0; jb < 8; ++jb)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(part + (row0 + 8 * h) * TN + 8 * jb +
                                 2 * t4) =
          make_float2(acc[4 * jb + 2 * h], acc[4 * jb + 2 * h + 1]);
  cluster.sync();
  cluster_reduce<TM, TN, NT>(cluster, part, n_split, [&](int r, int c,
                                                         float (&v)[4]) {
    const int n = n0 + r, j = j0 + c;
    if (n >= p.N) return;
    T* o = p.dw + static_cast<int64_t>(n) * p.Ktot + j;
    if constexpr (FAST) {
      if (j < p.Ktot) {
        *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        return;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (j + q < p.Ktot) st(o + q, v[q]);
  });
  cluster.sync();                  // keep every partial tile alive until read
}

// ---- the bf16 fast path --------------------------------------------------
// Both operands in bf16 in shared memory, each site's 64 values one
// 128-byte row in the 128-byte swizzle (wgmma.cuh: 16-byte chunk q of row
// s at chunk q ^ (s % 8)), as wgmma reads an MN-major operand.
constexpr int ROW = SW128_ROW;                // bytes of a site's 64 values
constexpr int B16_STAGE = BS * ROW;           // B: [BS sites][TN columns]
constexpr int RUNS16 = BS * 4 * TN * 2;       // corner runs [site][4][TN]
constexpr int SW_ALIGN = SW128_ALIGN;         // one swizzle pattern, 8 rows
// The descriptors' strides (bytes): SBO from 8 sites to the next 8, LBO
// from 64 channels of A to the next 64 (each operand of one wgmma is one
// 64-wide atom, so the hardware does not step by it)
constexpr int SBO16 = 8 * ROW, LBO16 = BS * ROW;

template <int TM>
struct Geo16 {
  static constexpr int NT = 2 * TM;                 // threads
  static constexpr int CH = TN * BS / NT;           // channels a thread gathers
  static constexpr int TPS = TN / CH;               // threads a site
  static constexpr int G_STAGE = TM / 64 * BS * ROW;  // A: [TM / 64][BS][64]
  static constexpr int SMEM_BYTES = SW_ALIGN + 2 * B16_STAGE + 2 * G_STAGE +
                                    2 * RUNS16 + 3 * ENTRIES * 32 +
                                    ENTRIES * 16 + 16;
  static_assert(TM * TN * 4 <= SMEM_BYTES - SW_ALIGN, "partial tile must fit");
  static_assert(NT / TPS == BS, "one site a thread");
  static_assert(CH == 8 || CH == 4, "16- or 8-byte corner runs");
  static_assert(ENTRIES <= NT, "a thread fills one table entry");
};

// One (site, tap) of a bf16 chunk: each corner's first channel as an
// element index into x (-1 outside the image), the corner weights rounded
// to bf16 (two a word) and the modulation (in both halves), kept apart.
struct Entry16 {
  int idx[4];
  uint32_t w[2];
  uint32_t m2;
  uint32_t pad;
};

// The shared-memory matrix descriptor of an MN-major operand in the
// 128-byte swizzle at shared address a (1024-byte aligned pattern).
__device__ __forceinline__ uint64_t desc16(uint32_t a) {
  return desc_sw128(a, LBO16, SBO16);
}

template <int TM, typename TO>
__global__ void __launch_bounds__(2 * TM, 256 / TM)
    deform_wgrad_bf16_kernel(const Params<bf16, TO> p) {
  using G = Geo16<TM>;
  constexpr int NT = G::NT, CH = G::CH, TPS = G::TPS, G_STAGE = G::G_STAGE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle is a function of the address: align the operands to it
  unsigned char* const base =
      smem_raw + ((SW_ALIGN - (smem_u32(smem_raw) & (SW_ALIGN - 1))) &
                  (SW_ALIGN - 1));
  unsigned char* const b_s = base;                    // [2][BS][ROW]
  unsigned char* const g_s = b_s + 2 * B16_STAGE;     // [2][TM / 64][BS][ROW]
  unsigned char* const st_s = g_s + 2 * G_STAGE;      // [2][BS][4][TN] bf16
  Entry16* const tab = reinterpret_cast<Entry16*>(st_s + 2 * RUNS16);
  Cursor* const cur = reinterpret_cast<Cursor*>(tab + 3 * ENTRIES);
  int* const nfw = reinterpret_cast<int*>(cur + ENTRIES);  // filling warps

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int row0 = (warp / 4) * 64 + (warp % 4) * 16 + gq;  // D rows
  const int j0 = blockIdx.x * TN;
  const int n0 = blockIdx.y * TM;
  const int split = blockIdx.z, n_split = gridDim.z;
  const int nc = (p.M + BS - 1) / BS;
  const int cb = static_cast<int>(static_cast<int64_t>(nc) * split / n_split);
  const int ce =
      static_cast<int>(static_cast<int64_t>(nc) * (split + 1) / n_split);

  // acc[4 j + e]: channel row0 + 8 (e / 2), column 8 j + 2 t4 + e % 2; one
  // chain of wgmmas over the block's sites (see the top)
  float acc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.f;

  if (cb < ce) {
    // log2 entries a site, the filling threads and their taps: as the fp32
    // fast path
    const int hsh = (j0 + TN <= p.Ktot &&
                     j0 / p.Cin == (j0 + TN - 1) / p.Cin) ? 0 : 1;
    const int e = tid;
    const bool filler = e < (BS << hsh);
    auto ftap = [&]() {
      const int fcol = j0 + 32 * (e & hsh);
      return fcol < p.Ktot ? fcol / p.Cin : -1;
    };
    TapIn in;
    auto fill = [&](Entry16* t) {
      Cursor c = cur[e];
      const int tap = ftap();
      Corners<bf16> cn;
      if (c.fm < p.M && tap >= 0) {
        const int pad_h = (p.kh - 1) / 2 * p.dilation;
        const int pad_w = (p.kw - 1) / 2 * p.dilation;
        corners_at(p, c.fb,
                   c.foy * p.stride - pad_h + (tap / p.kw) * p.dilation,
                   c.fox * p.stride - pad_w + (tap % p.kw) * p.dilation,
                   in, cn);
      } else {
        cn.img = p.x;
        cn.m = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) cn.idx[j] = -1, cn.w[j] = 0.f;
      }
      const int img = static_cast<int>(cn.img - p.x);
      Entry16 en;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        en.idx[j] = cn.idx[j] >= 0 ? img + cn.idx[j] : -1;
      en.w[0] = pack_bf16(cn.w[0], cn.w[1]);
      en.w[1] = pack_bf16(cn.w[2], cn.w[3]);
      en.m2 = pack_bf16(cn.m, cn.m);
      en.pad = 0;
      t[e] = en;
      c.fm += BS;
      c.fox += BS;
      while (c.fox >= p.Wo) {
        c.fox -= p.Wo;
        if (++c.foy == p.Ho) c.foy = 0, ++c.fb;
      }
      in = tap_in(p, tap >= 0 ? c.fm : p.M, tap);
      cur[e] = c;
    };
    // The gathering thread: site s, columns col .. col + CH - 1 of the tile
    // (channels ch .. of one tap), in B row s at swizzled byte bo.
    const int s = tid / TPS;
    const int col = (tid % TPS) * CH;
    const int ent = (s << hsh) + ((col / 32) & hsh);   // its table entry
    const int hcol = j0 + (col & ~31);
    const int ch = hcol - hcol / p.Cin * p.Cin + col % 32;
    const int bo = sw128(s, col / 8) + (col % 8) * 2;
    // the four corner runs of chunk table t into the staging buffer runs
    auto stage = [&](const Entry16* t, unsigned char* runs) {
      const int4 idx = *reinterpret_cast<const int4*>(t[ent].idx);
      const int ix[4] = {idx.x, idx.y, idx.z, idx.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = ix[j] >= 0;
        unsigned char* dst = runs + ((s * 4 + j) * TN + col) * 2;
        const bf16* src = ok ? p.x + ix[j] + ch : p.x;
        if constexpr (CH == 8)
          cp_async16(dst, src, ok);
        else
          cp_async8(dst, src, ok);
      }
    };
    // the staged runs combined (bf16_sample2) into B at bs
    auto combine = [&](const Entry16* t, const unsigned char* runs,
                       unsigned char* bs) {
      const uint4 wm = *reinterpret_cast<const uint4*>(t[ent].w);
      const uint32_t w2[4] = {__byte_perm(wm.x, 0, 0x1010),
                              __byte_perm(wm.x, 0, 0x3232),
                              __byte_perm(wm.y, 0, 0x1010),
                              __byte_perm(wm.y, 0, 0x3232)};
      uint32_t v[4][CH / 2];          // [corner][channel pair]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned char* r = runs + ((s * 4 + j) * TN + col) * 2;
        if constexpr (CH == 8) {
          const uint4 q = *reinterpret_cast<const uint4*>(r);
          v[j][0] = q.x, v[j][1] = q.y, v[j][2] = q.z, v[j][3] = q.w;
        } else {
          const uint2 q = *reinterpret_cast<const uint2*>(r);
          v[j][0] = q.x, v[j][1] = q.y;
        }
      }
      uint32_t o[CH / 2];
#pragma unroll
      for (int q = 0; q < CH / 2; ++q) {
        const uint32_t c4[4] = {v[0][q], v[1][q], v[2][q], v[3][q]};
        o[q] = bf16_sample2(w2, c4, wm.z);
      }
      if constexpr (CH == 8)
        *reinterpret_cast<uint4*>(bs + bo) = make_uint4(o[0], o[1], o[2], o[3]);
      else
        *reinterpret_cast<uint2*>(bs + bo) = make_uint2(o[0], o[1]);
    };
    // g rows [m0, m0 + BS), channels [n0, n0 + TM) into stage gs: 64
    // channels a block [BS][ROW], swizzled; zero past the last site
    auto load_g16 = [&](unsigned char* gs, int m0) {
#pragma unroll
      for (int i = 0; i < BS * TM / 8 / NT; ++i) {
        const int q = tid + i * NT;
        const int r = q / (TM / 8), c8 = q % (TM / 8);
        const bool ok = m0 + r < p.M;
        cp_async16(gs + (c8 / 8) * BS * ROW + sw128(r, c8 % 8),
                   ok ? p.g + static_cast<int64_t>(m0 + r) * p.N + n0 + 8 * c8
                      : p.g,
                   ok);
      }
    };
    const uint32_t a_sh = smem_u32(g_s) + (warp / 4) * BS * ROW;
    const uint32_t b_sh = smem_u32(b_s);

    if (tid == 0) *nfw = (BS << hsh) / 32;
    if (filler) {
      const int fm = cb * BS + (e >> hsh);
      cur[e] = Cursor{fm, fm / p.Wo / p.Ho, fm / p.Wo % p.Ho, fm % p.Wo};
      const int tap = ftap();
      in = tap_in(p, tap >= 0 ? fm : p.M, tap);
      for (int q = 0; q < 3 && cb + q < ce; ++q) fill(tab + q * ENTRIES);
    }
    __syncthreads();
    load_g16(g_s, cb * BS);
    stage(tab, st_s);
    cp_async_commit();
    if (cb + 1 < ce) stage(tab + ENTRIES, st_s + RUNS16);
    cp_async_commit();
    cp_async_wait<1>();              // chunk cb's g and corner runs
    asm volatile("" ::: "memory");   // (the combine's loads stay below it)
    combine(tab, st_s, b_s);

    // Chunk kc: its g and B (both combined and landed) are read by the
    // wgmmas; meanwhile every thread copies g of kc + 1 and its corner runs
    // of kc + 2, and combines its runs of kc + 1 into the other B stage;
    // after them the filling warps fill the table of kc + 3.  Each buffer
    // is rewritten only after the barrier that follows its last reader.
    for (int kc = cb; kc < ce; ++kc) {
      const int i = kc - cb;
      cp_async_wait<0>();            // g of kc, corner runs of kc + 1
      fence_proxy_async();           // cp.async and B stores, for wgmma
      __syncthreads();
      if (kc + 1 < ce) load_g16(g_s + ((i + 1) % 2) * G_STAGE, (kc + 1) * BS);
      if (kc + 2 < ce)
        stage(tab + ((i + 2) % 3) * ENTRIES, st_s + (i % 2) * RUNS16);
      cp_async_commit();
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < BS / 16; ++kb)
        wgmma_bf16_mn64(
            acc, desc16(a_sh + (i % 2) * G_STAGE + kb * 16 * ROW),
            desc16(b_sh + (i % 2) * B16_STAGE + kb * 16 * ROW));
      wgmma_commit();
      if (kc + 1 < ce)
        combine(tab + ((i + 1) % 3) * ENTRIES, st_s + ((i + 1) % 2) * RUNS16,
                b_s + ((i + 1) % 2) * B16_STAGE);
      wgmma_wait();
#pragma unroll
      for (int q = 0; q < 32; ++q) hold(acc[q]);
      if (kc + 3 < ce && warp < *reinterpret_cast<volatile int*>(nfw))
        fill(tab + (i % 3) * ENTRIES);
    }
    cp_async_wait<0>();
  }

  // d_w rounded to bf16 once, each element written once (Ktot is a
  // multiple of 32 here, so a pair or a run of 4 lies wholly inside)
  if (n_split == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bf16* o = p.dw + static_cast<int64_t>(n0 + row0 + 8 * h) * p.Ktot;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb) {
        const int j = j0 + 8 * jb + 2 * t4;
        if (j < p.Ktot)
          *reinterpret_cast<uint32_t*>(o + j) =
              pack_bf16(acc[4 * jb + 2 * h], acc[4 * jb + 2 * h + 1]);
      }
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();                 // every thread is done with the stages
  float* part = reinterpret_cast<float*>(base);        // [TM][TN]
#pragma unroll
  for (int jb = 0; jb < 8; ++jb)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(part + (row0 + 8 * h) * TN + 8 * jb +
                                 2 * t4) =
          make_float2(acc[4 * jb + 2 * h], acc[4 * jb + 2 * h + 1]);
  cluster.sync();
  cluster_reduce<TM, TN, NT>(cluster, part, n_split, [&](int r, int c,
                                                         float (&v)[4]) {
    const int j = j0 + c;
    if (j < p.Ktot)
      *reinterpret_cast<uint2*>(p.dw + static_cast<int64_t>(n0 + r) * p.Ktot +
                                j) =
          make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  });
  cluster.sync();                  // keep every partial tile alive until read
}

template <int TM, typename TO>
int launch16(const Params<bf16, TO>& p, int split, void* stream) {
  using G = Geo16<TM>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e =
        allow_clusters(deform_wgrad_bf16_kernel<TM, TO>, G::SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const cudaError_t e = launch_split(
      deform_wgrad_bf16_kernel<TM, TO>, (p.Ktot + TN - 1) / TN, p.N / TM,
      split, G::SMEM_BYTES, stream, p, G::NT);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <bool FAST, int TM, typename T = float, typename TO = T>
int launch(const Params<T, TO>& p, int split, void* stream) {
  using G = Geo<TM>;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = allow_clusters(deform_wgrad_kernel<FAST, TM, T, TO>,
                                         G::SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const cudaError_t e = launch_split(
      deform_wgrad_kernel<FAST, TM, T, TO>, (p.Ktot + TN - 1) / TN,
      (p.N + TM - 1) / TM, split, G::SMEM_BYTES, stream, p, G::NT);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The arguments every entry takes, checked.
bool bad_args(int B, int H, int W, int Cin, int Ho, int Wo, int Cout, int kh,
              int kw, int stride, int dilation, int split) {
  return B < 0 || H <= 0 || W <= 0 || Cin <= 0 || Ho < 0 || Wo < 0 ||
         Cout <= 0 || kh <= 0 || kw <= 0 || stride <= 0 || dilation <= 0 ||
         split < 1 || split > MAX_SPLIT || (split & (split - 1)) != 0 ||
         static_cast<int64_t>(B) * H * W * Cin > INT32_MAX ||
         static_cast<int64_t>(B) * Ho * Wo > INT32_MAX ||
         static_cast<int64_t>(kh) * kw * Cin > INT32_MAX;
}

// The bf16 entries: the bf16 fast path where the fp32 entry takes its
// fast path, else the general path with the 128-channel tile.
template <typename TO>
int launch_bf16(const bf16* g, const bf16* x, const TO* offset,
                const bf16* mask, bf16* dw, int B, int H, int W, int Cin,
                int Ho, int Wo, int Cout, int kh, int kw, int stride,
                int dilation, int tm, int split, void* stream) {
  const bool fast = Cin % 32 == 0 && Cout % tm == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dw) % 16 == 0;
  if ((tm != 128 && tm != 256) || (tm == 256 && !fast) ||
      bad_args(B, H, W, Cin, Ho, Wo, Cout, kh, kw, stride, dilation, split))
    return static_cast<int>(cudaErrorInvalidValue);
  const int k = kh * kw;
  const Params<bf16, TO> p{{x, offset, mask, H, W, Cin, Ho, Wo, kh, kw,
                            stride, dilation, B * Ho * Wo, k * Cin, 2 * k, k},
                           g, dw, Cout};
  if (!fast) return launch<false, 128>(p, split, stream);
  return tm == 256 ? launch16<256>(p, split, stream)
                   : launch16<128>(p, split, stream);
}

}  // namespace

// g: [B*Ho*Wo, Cout]; x: [B, H, W, Cin]; offset: [B, Ho, Wo, 2*kh*kw]
// (dy, dx)-interleaved per tap; mask: [B, Ho, Wo, kh*kw] or null (v1);
// dw: [Cout, kh, kw, Cin], every element written.  All fp32 and
// contiguous.  tm: the tile's output channels, 128, or 256 on the fast
// path (Cin a multiple of 32, Cout of tm, x, g and dw 16-byte aligned);
// split: the blocks of a cluster that share a tile's sites, a power of
// two from 1 to 16.
// Returns cudaGetLastError() after the launch.
extern "C" int stmask_deform_wgrad(const float* g, const float* x,
                                   const float* offset, const float* mask,
                                   float* dw, int B, int H, int W, int Cin,
                                   int Ho, int Wo, int Cout, int kh, int kw,
                                   int stride, int dilation, int tm,
                                   int split, void* stream) {
  const bool fast = Cin % 32 == 0 && Cout % tm == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dw) % 16 == 0;
  if ((tm != 128 && tm != 256) || (tm == 256 && !fast) ||
      bad_args(B, H, W, Cin, Ho, Wo, Cout, kh, kw, stride, dilation, split))
    return static_cast<int>(cudaErrorInvalidValue);
  const int k = kh * kw;
  const Params<> p{{x, offset, mask, H, W, Cin, Ho, Wo, kh, kw, stride,
                    dilation, B * Ho * Wo, k * Cin, 2 * k, k},
                   g, dw, Cout};
  if (tm == 256) return launch<true, 256>(p, split, stream);
  return fast ? launch<true, 128>(p, split, stream)
              : launch<false, 128>(p, split, stream);
}

// As stmask_deform_wgrad with g, x, mask and dw bf16 and bf16 offsets (tm
// and the fast path's conditions as there): the bf16 sample, the sums in
// fp32, d_w rounded to bf16.
extern "C" int stmask_deform_wgrad_bf16(
    const __nv_bfloat16* g, const __nv_bfloat16* x,
    const __nv_bfloat16* offset, const __nv_bfloat16* mask,
    __nv_bfloat16* dw, int B, int H, int W, int Cin, int Ho, int Wo,
    int Cout, int kh, int kw, int stride, int dilation, int tm, int split,
    void* stream) {
  return launch_bf16(g, x, offset, mask, dw, B, H, W, Cin, Ho, Wo, Cout, kh,
                     kw, stride, dilation, tm, split, stream);
}

// As stmask_deform_wgrad_bf16 with fp32 offsets (FCB's analytic ones).
extern "C" int stmask_deform_wgrad_bf16_f32off(
    const __nv_bfloat16* g, const __nv_bfloat16* x, const float* offset,
    const __nv_bfloat16* mask, __nv_bfloat16* dw, int B, int H, int W,
    int Cin, int Ho, int Wo, int Cout, int kh, int kw, int stride,
    int dilation, int tm, int split, void* stream) {
  return launch_bf16(g, x, offset, mask, dw, B, H, W, Cin, Ho, Wo, Cout, kh,
                     kw, stride, dilation, tm, split, stream);
}
