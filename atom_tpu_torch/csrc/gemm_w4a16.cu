// Weight-only INT4 GEMM with bf16 activations (K13): the W4A16 baseline stack's
// projections and the opt-in 4-bit lm_head.
//
// Replaces atom_tpu/ops/pallas_gemm_w4a16.py:97 w4a16_gemm (_w4a16_kernel :62):
// out [M,N] = sum_g (sum_{k in group g} bf16(a[m,k]) * code[k,n]) * scale[g,n]
// with signed 4-bit codes in 128-row groups and one float32 scale per group and
// column, applied to the group's float32 partial sum (not to the weight: the
// weight is never dequantized).  Written as float32, or rounded once to bf16.
// Nibble planes as in K1 (formats.py): byte row r of group g holds code row
// g*128 + r in its low nibble and g*128 + 64 + r in its high nibble.
//
// What bounds it on the H100: at decode (M = 32) the product does 2 * 32
// operations per 4-bit code, 128 per weight byte, below the ~295 operations
// per byte where the bf16 tensor cores become the limit: the weight stream
// (K*N/2 bytes of codes + K*N/32 of scales) bounds every call.  At prefill
// (M = 1024) the tensor cores do.
//
// Design.  A block owns a 32-row x 32-column output tile and walks all of K.
// Its 8 warps take the 128-row groups round-robin (warp w: groups w, w+8, ...),
// so 8 groups' weight loads are in flight per block.  Per group a warp loads
// its 64 byte rows x 32 columns of nibble planes at once (16 words a thread),
// converts the nibbles to bf16 in registers (exact: |code| <= 8) and runs
// mma.sync m16n8k16 (bf16 x bf16 -> f32), eight K steps, four low-nibble and
// four high-nibble ones.  Loads are shaped as K5's: a thread (gid = lane / 4,
// tig = lane % 4) reads 4 bytes of each of the byte rows s*16 + 4*tig + i, so
// byte c of a word belongs to output column n0 + 4*gid + c, which mma column
// tile c holds in its column gid; the mma's K slots {2tig, 2tig+1, 2tig+8,
// 2tig+9} stand for the 4 consecutive rows 4*tig + {0,1,2,3}, so the A
// fragment of a row is one 8-byte load of four bf16 values.  The group's f32
// partial tile is then multiplied by the group's scale and added to the warp's
// running sum, as the TPU kernel scales each group's partial sum; the eight
// warps' sums are added in warp order through shared memory at the end
// (deterministic).  Products of bf16 and a 4-bit code are exact in float32, so
// only the order of the float32 additions differs from the TPU kernel and the
// plain version.  Rows past M load zeros and are not stored; K is whole groups
// (the wrapper cuts a padded weight's groups to the activation's); N is a
// multiple of 32.
//
// Known limits (later work): every block re-reads its A rows (32 x K bf16,
// from L2), twice the bytes of its weight slice at decode; at prefill every
// 32-row tile re-reads the weights (from L2 where they fit); no shared-memory
// staging, cp.async or wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 128;
constexpr int HALF = 64;
constexpr int TM = 32;     // output rows per block
constexpr int TN = 32;     // output columns per block
constexpr int NWARP = 8;
constexpr int TS = TN + 1; // shared tile row stride

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The signed nibble at bit `pos` of w, as a float.
__device__ __forceinline__ float nibble(uint32_t w, int pos) {
  return (float)(((int)(w << (28 - pos))) >> 28);
}

// bf16x2 register {low: the code of byte c of w0, high: that of w1}, the low
// (high = false) or high nibble of the byte.
__device__ __forceinline__ uint32_t pack_codes(uint32_t w0, uint32_t w1, int c, bool high) {
  const int pos = 8 * c + (high ? 4 : 0);
  const __nv_bfloat162 p = __floats2bfloat162_rn(nibble(w0, pos), nibble(w1, pos));
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <bool OUT_BF16>
__global__ void __launch_bounds__(NWARP * 32)
gemm_w4a16_kernel(const __nv_bfloat16* __restrict__ A, const int8_t* __restrict__ Wp,
                  const float* __restrict__ scale, void* __restrict__ out, int M, int N, int ng) {
  __shared__ float tile[TM * TS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int K = ng * GROUP;
  const bool second = m0 + 16 < M;  // rows m0+16.. exist (uniform over the block)

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][c][j] = 0.f;

  for (int g = warp; g < ng; g += NWARP) {
    const int8_t* wrow = Wp + (size_t)(g * HALF + 4 * tig) * N + n0 + 4 * gid;
    uint32_t w[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[s][i] = __ldg(reinterpret_cast<const unsigned int*>(wrow + (size_t)(s * 16 + i) * N));

    float part[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[mt][c][j] = 0.f;

#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // low nibbles: rows s*16 + ..; high nibbles: 64 rows on
        const int k = g * GROUP + h * HALF + s * 16 + 4 * tig;
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = m0 + mt * 16 + gid;
          uint2 x = make_uint2(0u, 0u), y = make_uint2(0u, 0u);
          if (r < M) x = __ldg(reinterpret_cast<const uint2*>(A + (size_t)r * K + k));
          if (r + 8 < M) y = __ldg(reinterpret_cast<const uint2*>(A + (size_t)(r + 8) * K + k));
          a[mt][0] = x.x;  // row r,     K slots 2tig, 2tig+1   = k, k+1
          a[mt][1] = y.x;  // row r + 8
          a[mt][2] = x.y;  // row r,     K slots 2tig+8, 2tig+9 = k+2, k+3
          a[mt][3] = y.y;  // row r + 8
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t b0 = pack_codes(w[s][0], w[s][1], c, h);  // rows 4tig, 4tig+1
          const uint32_t b1 = pack_codes(w[s][2], w[s][3], c, h);  // rows 4tig+2, 4tig+3
          mma_bf16(part[0][c], a[0], b0, b1);
          if (second) mma_bf16(part[1][c], a[1], b0, b1);
        }
      }
    }
    // the group's scale on its partial sums, then into the running sum
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float sc = __ldg(scale + (size_t)g * N + n0 + 4 * (2 * tig + jj) + c);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int jr = 0; jr < 2; ++jr) {
            const int j = jr * 2 + jj;
            acc[mt][c][j] = __fadd_rn(acc[mt][c][j], __fmul_rn(part[mt][c][j], sc));
          }
      }
  }

  // add the eight warps' sums in warp order
  for (int i = threadIdx.x; i < TM * TS; i += NWARP * 32) tile[i] = 0.f;
  __syncthreads();
  for (int wv = 0; wv < NWARP; ++wv) {
    if (warp == wv) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = mt * 16 + gid + (j >> 1) * 8;
            const int col = 4 * (tig * 2 + (j & 1)) + c;
            tile[r * TS + col] = __fadd_rn(tile[r * TS + col], acc[mt][c][j]);
          }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < TM * TN; i += NWARP * 32) {
    const int r = i / TN, col = i % TN;
    if (m0 + r >= M) continue;
    const size_t o = (size_t)(m0 + r) * N + n0 + col;
    if (OUT_BF16)
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(tile[r * TS + col]);
    else
      static_cast<float*>(out)[o] = tile[r * TS + col];
  }
}

}  // namespace

// a bf16 [M, ng*128], packed int8 [ng*64, N], scale f32 [ng, N] -> out [M, N]
// (bf16 if out_bf16, else f32).  N % 32 == 0.
extern "C" int atom_gemm_w4a16(const void* a, const void* packed, const void* scale, void* out,
                               int M, int N, int ng, int out_bf16, void* stream) {
  const dim3 grid(N / TN, (M + TM - 1) / TM);
  const cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16)
    gemm_w4a16_kernel<true><<<grid, NWARP * 32, 0, st>>>(
        (const __nv_bfloat16*)a, (const int8_t*)packed, (const float*)scale, out, M, N, ng);
  else
    gemm_w4a16_kernel<false><<<grid, NWARP * 32, 0, st>>>(
        (const __nv_bfloat16*)a, (const int8_t*)packed, (const float*)scale, out, M, N, ng);
  return (int)cudaGetLastError();
}
