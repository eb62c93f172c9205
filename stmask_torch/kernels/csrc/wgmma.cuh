// Hopper's warpgroup MMA (wgmma) and shared-memory barriers (mbarrier), as
// the bf16 fast paths of the fused deformable conv (deform_conv.cu) and of
// its weight gradient (deform_wgrad.cu) use them: the fences, commit and
// wait of an asynchronous wgmma group, the 128-byte swizzle of an operand
// kept in shared memory and the matrix descriptor that reads it, the bf16
// products, and the mbarrier operations of a producer / consumer ring.
// sm_90a only (wgmma does not exist on plain sm_90).
#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are pending.
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Stores through the generic proxy are seen by wgmma (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keep x in its register until here (an in-flight wgmma owns it).
__device__ __forceinline__ void hold(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void hold(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// The 128-byte swizzle: a row of 128 bytes (64 bf16 values), its 16-byte
// chunk q at chunk q ^ (row % 8); a pattern of 8 rows is 1024 bytes and
// lies 1024-byte aligned.  Byte offset of chunk q of row r.
constexpr int SW128_ROW = 128;
constexpr int SW128_ALIGN = 1024;
__device__ __forceinline__ int sw128(int r, int q) {
  return r * SW128_ROW + ((q ^ (r % 8)) << 4);
}

// The matrix descriptor of an operand in the 128-byte swizzle at shared
// address a: LBO and SBO in bytes (a K-major operand: SBO = 1024, from 8
// rows to the next 8, LBO unused; an MN-major one: SBO from 8 rows of K to
// the next 8, LBO from one 64-wide atom of M or N to the next).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t a, int lbo, int sbo) {
  const uint32_t lo = ((a & 0x3FFFF) >> 4) |
                      (static_cast<uint32_t>(lbo >> 4) << 16);
  const uint32_t hi = static_cast<uint32_t>(sbo >> 4) | (1u << 30);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// d += A * B on a 64 x 64 x 16 bf16 tile of a warpgroup (fp32
// accumulate), both operands MN-major (transposed) from shared memory.
// d[4 j .. 4 j + 3] are rows g, g, g + 8, g + 8 of the warp's 16 rows at
// columns 8 j + 2 t4 + {0, 1} (g = lane / 4, t4 = lane % 4).
// Asynchronous: d belongs to the MMA until wgmma_wait.
__device__ __forceinline__ void wgmma_bf16_mn64(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d += A * B on a 64 x 128 x 16 bf16 tile of a warpgroup (fp32
// accumulate), both operands K-major from shared memory (A [64 rows][K],
// B [128 columns][K]); d laid out as in wgmma_bf16_mn64, j up to 15.
// Asynchronous: d belongs to the MMA until wgmma_wait.
__device__ __forceinline__ void wgmma_bf16_k128(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

// ---- mbarriers (shared::cta) ----------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// The barriers' initialisation seen by every thread (and by the async
// proxy) before their first use; a __syncthreads() follows it.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// One arrival on bar when every cp.async this thread issued so far has
// landed (counted in the barrier's expected arrivals: .noinc).
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}
// Wait until the phase of parity `parity` of bar has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

}  // namespace
