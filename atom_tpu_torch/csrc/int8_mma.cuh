// Building blocks of the integer GEMMs (gemm_packed.cu: K1's family and K14).
// Device functions only: the bf16 rounding, the mma.sync m16n8k32 s8 product
// and the per-head asymmetric u4 quantizer of ops/reference.py quantize_kv_asym.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The per-head asymmetric u4 quantizer of ops/reference.py quantize_kv_asym, from
// the head's max and min: scale = bf16((max - min, at least 1e-5) / 15), zero =
// clamp(rint(-min / scale), 0, 15), code = clamp(rint(x / scale) + zero, 0, 15),
// stored zero value bf16(-zero * scale).  IEEE division, no contraction.
struct KvQuant {
  float scale;
  float zero;
  float zero_val;
};

__device__ __forceinline__ KvQuant kv_quant_params(float xmax, float xmin) {
  KvQuant q;
  q.scale = bf16_round(__fdiv_rn(fmaxf(__fsub_rn(xmax, xmin), 1e-5f), 15.f));
  q.zero = fminf(fmaxf(rintf(__fdiv_rn(-xmin, q.scale)), 0.f), 15.f);
  q.zero_val = bf16_round(__fmul_rn(-q.zero, q.scale));
  return q;
}

__device__ __forceinline__ int kv_quant_code(float v, const KvQuant& q) {
  return (int)fminf(fmaxf(__fadd_rn(rintf(__fdiv_rn(v, q.scale)), q.zero), 0.f), 15.f);
}

}  // namespace
