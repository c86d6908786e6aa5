// Building blocks shared by the attention kernels on the bf16 tensor cores:
// K11's tile path (decode.cu) and K12 (prefill.cu).  Device functions only,
// included by each source: u4 codes into exact bf16 pairs by a byte permute
// under 128's exponent and one subtraction, a float pair as bf16 and as a
// bf16 term plus its bf16 remainder (p * v_scale kept at float32 precision on
// the tensor cores), and the mma.sync m16n8k16 bf16 product with float32 sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// 128 + each byte of v's two halves (bytes 0-127 under 0x43) minus 128: exact
__device__ __forceinline__ uint32_t minus_128(uint32_t v) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), __floats2bfloat162_rn(128.f, 128.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Byte U of x and byte U of y (nibble codes, 0-15) as the bf16 pair (x's, y's),
// exactly: each byte goes under 128's exponent (0x43 above it; the selector's
// sign-replicating nibbles put zeros there first), then 128 comes off.
template <int U>
__device__ __forceinline__ uint32_t code_pair(uint32_t x, uint32_t y) {
  constexpr uint32_t sel = U | ((8 | U) << 4) | ((4 + U) << 8) | ((8 | U) << 12);
  return minus_128(prmt(x, y, sel) | 0x43004300u);
}

// Bytes 2 H and 2 H + 1 of x (codes of one byte each, 0-127) as a bf16 pair, exactly.
template <int H>
__device__ __forceinline__ uint32_t byte_pair(uint32_t x) {
  return minus_128(prmt(x, 0x43434343u, H ? 0x4342u : 0x4140u));
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// x0, x1 as a bf16 pair and the pair of their remainders (exact in float32,
// then rounded): x = hi + lo to ~2^-17 relative
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = bf16_pair(__fsub_rn(x0, hf.x), __fsub_rn(x1, hf.y));
}

// d += a . b, m16n8k16, bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace
