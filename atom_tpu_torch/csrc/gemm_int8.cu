// Grouped-scale int8 GEMMs (K14): the int8-carrier drop-ins for the W4A4
// serving matmul and its k/v variant with the output quantized to u4 per head.
//
// K14a replaces atom_tpu/ops/pallas_gemm.py:77 grouped_int8_gemm (_gemm_kernel
// :47): out f32 [M,N] = sum_g (A_g . W_g)_i32 * sa[:,g] * sw[g,:] over the
// 128-wide groups of int8 codes (the INT4 body's codes in int8 carriers, then
// the INT8 keeper as the last group), added in group order, keeper last.
// K14b replaces :203 grouped_int8_gemm_o4 (_gemm_o4_kernel :157): the same
// product, then per 128-column head an asymmetric u4 quantization of the row
// (ops/reference.py quantize_kv_asym): codes int8 [M,N] in [0,15] and params
// f32 [M, N/128, 2] = (scale, zero value), both bf16-rounded.
//
// What bounds them on the H100: at M = 32 the weight stream (K*N bytes of
// int8 codes, twice K1's nibble planes) at 64 MACs per weight byte, far below
// the ~590 int8 operations per byte where the tensor cores become the limit;
// at M = 1024 the int8 tensor cores.
//
// Design.  A GEMM of K1's float order with every group read as int8 codes: a
// block owns a 32-row x 32-column tile and walks all of K, its 8 warps take
// the groups round-robin and compute each group's exact int32 dot with
// mma.sync m16n8k32 (dot_int8_group in int8_mma.cuh); the
// int32 group tiles go through shared memory and the float accumulation runs
// group by group in order, acc += float(acc_g) * sa * sw: the TPU kernel's
// f32 order, so K14a equals its plain version, and K1 on the same codes, bit
// for bit.  K14b's block owns one whole head (128 columns: four 32-column
// tiles walked in turn, their sums kept in registers), so the per-head
// quantizer runs in the same block on values that never leave registers: a
// row's 128 values lie with 8 neighbouring lanes (16 each), whose max and min
// are reduced by shuffles; the quantizer is the one of K2/K7's epilogue
// (kv_quant_params, kv_quant_code).  The TPU kernel keeps a whole row of
// heads per block instead (its N is not tiled).  Rows past M load zeros and
// are not stored.
//
// Known limits (later work): as K1, A is re-read from L2 by every column
// block and nothing is staged in shared memory; K14b has only N/128 column
// blocks, 32 at the k/v width of Llama-2-7B, so a decode-size M fills a
// quarter of the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

constexpr int GROUP = 128;
constexpr int TM = 32;     // output rows per block
constexpr int TN = 32;     // output columns per tile
constexpr int NWARP = 8;   // warps per block
constexpr int TS = TN + 1; // shared tile row stride
constexpr int HEAD = 128;  // head width of K14b's output quantization

// Rows [m0, m0+32) x columns [n0, n0+32): acc[j] += float(dot_g) * sa * sw for
// every group in order; this thread's 4 outputs are row er, columns ec..ec+3.
__device__ __forceinline__ void grouped_tile(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
                                             const float* __restrict__ sa, const float* __restrict__ sw,
                                             int M, int N, int ng, int m0, int n0, int er, int ec,
                                             int (*tile)[TM * TS], float (&acc)[4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int lda = ng * GROUP;
  const int row = m0 + er;
  for (int base = 0; base < ng; base += NWARP) {
    const int g = base + warp;
    if (g < ng) {
      int ia[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int j = 0; j < 4; ++j) ia[mt][c][j] = 0;
      dot_int8_group(A, lda, M, m0, W + (size_t)g * GROUP * N, N, n0, g * GROUP, lane, ia);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = mt * 16 + gid + (j >> 1) * 8;
            const int col = 4 * (tig * 2 + (j & 1)) + c;
            tile[warp][r * TS + col] = ia[mt][c][j];
          }
    }
    __syncthreads();
    const int n_here = min(NWARP, ng - base);
    for (int q = 0; q < n_here; ++q) {
      const int gg = base + q;
      const float s_a = row < M ? sa[(size_t)row * ng + gg] : 0.f;
      const float* s_w = sw + (size_t)gg * N + n0 + ec;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t = __fmul_rn(__fmul_rn(__int2float_rn(tile[q][er * TS + ec + j]), s_a), s_w[j]);
        acc[j] = __fadd_rn(acc[j], t);
      }
    }
    __syncthreads();
  }
}

// K14a: one 32 x 32 tile per block.
__global__ void __launch_bounds__(NWARP * 32)
grouped_int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
                         const float* __restrict__ sa, const float* __restrict__ sw,
                         float* __restrict__ out, int M, int N, int ng) {
  __shared__ int tile[NWARP][TM * TS];
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int er = threadIdx.x / (TN / 4), ec = (threadIdx.x % (TN / 4)) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  grouped_tile(A, W, sa, sw, M, N, ng, m0, n0, er, ec, tile, acc);
  if (m0 + er >= M) return;
  *reinterpret_cast<float4*>(out + (size_t)(m0 + er) * N + n0 + ec) = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// K14b: one 32-row x 128-column head per block, then the head's quantizer.
__global__ void __launch_bounds__(NWARP * 32)
grouped_int8_gemm_o4_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
                            const float* __restrict__ sa, const float* __restrict__ sw,
                            int8_t* __restrict__ codes, float* __restrict__ params, int M, int N, int ng) {
  constexpr int NSUB = HEAD / TN;
  __shared__ int tile[NWARP][TM * TS];
  const int head = blockIdx.x, m0 = blockIdx.y * TM;
  const int er = threadIdx.x / (TN / 4), ec = (threadIdx.x % (TN / 4)) * 4;
  float acc[NSUB][4];
#pragma unroll
  for (int sub = 0; sub < NSUB; ++sub) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[sub][j] = 0.f;
    grouped_tile(A, W, sa, sw, M, N, ng, m0, head * HEAD + sub * TN, er, ec, tile, acc[sub]);
  }
  // row er's 128 values: 16 with each of the 8 lanes er*8 .. er*8+7 (one
  // aligned group of 8 lanes of a warp)
  float xmax = acc[0][0], xmin = acc[0][0];
#pragma unroll
  for (int sub = 0; sub < NSUB; ++sub)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      xmax = fmaxf(xmax, acc[sub][j]);
      xmin = fminf(xmin, acc[sub][j]);
    }
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) {
    xmax = fmaxf(xmax, __shfl_xor_sync(0xffffffffu, xmax, o));
    xmin = fminf(xmin, __shfl_xor_sync(0xffffffffu, xmin, o));
  }
  const int row = m0 + er;
  if (row >= M) return;
  const KvQuant q = kv_quant_params(xmax, xmin);
  int8_t* crow = codes + (size_t)row * N + head * HEAD;
#pragma unroll
  for (int sub = 0; sub < NSUB; ++sub) {
    char4 c4;
    c4.x = (signed char)kv_quant_code(acc[sub][0], q);
    c4.y = (signed char)kv_quant_code(acc[sub][1], q);
    c4.z = (signed char)kv_quant_code(acc[sub][2], q);
    c4.w = (signed char)kv_quant_code(acc[sub][3], q);
    *reinterpret_cast<char4*>(crow + sub * TN + ec) = c4;
  }
  if (ec == 0) {
    float* prm = params + ((size_t)row * (N / HEAD) + head) * 2;
    prm[0] = q.scale;
    prm[1] = q.zero_val;
  }
}

}  // namespace

// K14a: a int8 [M, ng*128], w int8 [ng*128, N], sa f32 [M, ng], sw f32 [ng, N]
// -> out f32 [M, N].  N % 32 == 0.
extern "C" int atom_grouped_int8_gemm(const void* a, const void* w, const void* sa, const void* sw,
                                      void* out, int M, int N, int ng, void* stream) {
  const dim3 grid(N / TN, (M + TM - 1) / TM);
  grouped_int8_gemm_kernel<<<grid, NWARP * 32, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)w, (const float*)sa, (const float*)sw, (float*)out, M, N, ng);
  return (int)cudaGetLastError();
}

// K14b: the same operands -> codes int8 [M, N] in [0, 15], params f32
// [M, N/128, 2].  N % 128 == 0.
extern "C" int atom_grouped_int8_gemm_o4(const void* a, const void* w, const void* sa, const void* sw,
                                         void* codes, void* params, int M, int N, int ng, void* stream) {
  const dim3 grid(N / HEAD, (M + TM - 1) / TM);
  grouped_int8_gemm_o4_kernel<<<grid, NWARP * 32, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)w, (const float*)sa, (const float*)sw, (int8_t*)codes,
      (float*)params, M, N, ng);
  return (int)cudaGetLastError();
}
