// Building blocks shared by the integer GEMMs: K1's family (gemm_packed.cu) and
// the grouped int8 GEMMs K14 (gemm_int8.cu).  Device functions only, included
// by each source: int8 operand loads, the mma.sync m16n8k32 s8 product and its
// byte transposes, the int32 dot of one 128-row group of int8 codes (K14), and
// the per-head asymmetric u4 quantizer of ops/reference.py quantize_kv_asym.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t ld_u32(const int8_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t ld_a(const int8_t* A, int lda, int M, int row, int col) {
  return row < M ? ld_u32(A + (size_t)row * lda + col) : 0u;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// t[c] = byte c of w[0..3], in order: a 4 x 4 byte transpose.
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&t)[4]) {
  const uint32_t a = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t b = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t c = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t d = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(a, c, 0x5410);
  t[1] = __byte_perm(a, c, 0x7632);
  t[2] = __byte_perm(b, d, 0x5410);
  t[3] = __byte_perm(b, d, 0x7632);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mt][c][j]: mma tile of rows m0 + 16*mt, columns n0 + 4*n8 + c
// (n8 = the mma's own column index); j indexes the mma's 4 accumulators.

// One warp: int32 dot of one 128-row group of int8 codes, A columns [kb, kb + 128)
// against the weight rows wg [128, N], rows [m0, m0+32), cols [n0, n0+32).
__device__ __forceinline__ void dot_int8_group(const int8_t* A, int lda, int M, int m0,
                                               const int8_t* wg, int N, int n0, int kb,
                                               int lane, int (&acc)[2][4][4]) {
  const int gid = lane >> 2, tig = lane & 3;
  const int8_t* wrow = wg + (size_t)(tig * 4) * N + n0 + 4 * gid;
  uint32_t w[4][2][4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[s][0][i] = ld_u32(wrow + (size_t)(s * 32 + i) * N);
      w[s][1][i] = ld_u32(wrow + (size_t)(s * 32 + 16 + i) * N);
    }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t t0[4], t1[4];
    transpose4(w[s][0], t0);
    transpose4(w[s][1], t1);
    const int k = kb + s * 32 + tig * 4;
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = m0 + mt * 16 + gid;
      a[mt][0] = ld_a(A, lda, M, r, k);
      a[mt][1] = ld_a(A, lda, M, r + 8, k);
      a[mt][2] = ld_a(A, lda, M, r, k + 16);
      a[mt][3] = ld_a(A, lda, M, r + 8, k + 16);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][c], a[mt], t0[c], t1[c]);
  }
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
