// Packed bf16 pairs, shared by the fused deformable conv, its weight
// gradient (through deform_gather.cuh) and K1's bf16 fast route: two
// channels in a 32-bit word, the lower channel in the low half.  A bf16
// value in the high half of a word with a zero low half is its fp32 value.
#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
// a * b of both halves, each rounded once (a * b + -0: the product of two
// bf16 values is exact in fp32, so this is rbf of the fp32 product)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

}  // namespace
