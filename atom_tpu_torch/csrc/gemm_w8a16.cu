// Weight-only INT8 GEMM with bf16 activations (K5), the serving lm_head.
//
// Replaces atom_tpu/ops/pallas_gemm_w4a16.py:203 w8a16_gemm (_w8a16_kernel
// :184): out f32 [M,N] = (sum_k bf16(a[m,k]) * codes[k,n]) * scale[n], float32
// accumulation, the per-column scale applied once after the whole sum.
//
// What bounds it on the H100: the head runs at M <= 32 rows (the decode batch,
// or the one last row of a prefill), so the product does 2*M <= 64 operations
// per weight byte against the ~295 where the bf16 tensor cores become the
// limit.  The one read of the int8 weight (132 MB at K 4096, N 32256) from HBM
// bounds every call.
//
// Design.  A block owns 64 output columns and walks all of K for every 32-row
// tile of M.  Its 8 warps take the 16-deep K steps round-robin (split K), so
// eight steps' weight loads are in flight per block; each warp keeps a
// 32 x 64 float32 partial tile in registers, and the eight partial tiles are
// added in warp order through shared memory at the end (deterministic).
// The product is mma.sync m16n8k16 (bf16 x bf16 -> f32).  int8 codes are exact
// in bf16, so they are converted in registers and the weight never exists in
// bf16 in memory.  Loads are shaped for the memory system, and the fragments
// follow by permuting indices the sum does not care about:
//   * a thread (gid = lane / 4, tig = lane % 4) loads 8 bytes of each of the
//     weight rows k0 + 4*tig + {0,1,2,3}: columns n0 + 8*gid .. + 7.  A row's
//     64-byte segment is read by 8 neighbouring threads.  Byte c of a load
//     belongs to mma column tile c, whose column index gid therefore stands
//     for output column n0 + 8*gid + c.
//   * the mma's K slots {2*tig, 2*tig+1, 2*tig+8, 2*tig+9} are mapped to
//     k0 + 4*tig + {0,1,2,3} on both operands, so the A fragment of a row is
//     one 8-byte load of four consecutive bf16 values.
// A is re-read (from L2) by every column block: N/64 x M x K x 2 bytes, about
// the size of the weight stream at M = 32.  No shared-memory staging, TMA or
// wgmma yet: those are what a faster version would be built from.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 32;     // output rows per pass
constexpr int TN = 64;     // output columns per block
constexpr int TK = 16;     // K per mma step
constexpr int NWARP = 8;
constexpr int TS = TN + 1; // shared tile row stride

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16x2 register {low: code byte c of w_lo, high: code byte c of w_hi}
__device__ __forceinline__ uint32_t pack_codes(uint32_t w_lo, uint32_t w_hi, int c) {
  const float lo = (float)(int)(signed char)((w_lo >> (8 * c)) & 0xFFu);
  const float hi = (float)(int)(signed char)((w_hi >> (8 * c)) & 0xFFu);
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__global__ void __launch_bounds__(NWARP * 32)
gemm_w8a16_kernel(const __nv_bfloat16* __restrict__ A, const int8_t* __restrict__ Wc,
                  const float* __restrict__ scale, float* __restrict__ out, int M, int N, int K) {
  __shared__ float tile[TM * TS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * TN;
  const int steps = K / TK;

  for (int m0 = 0; m0 < M; m0 += TM) {
    const bool second = m0 + 16 < M;  // rows m0+16.. exist (uniform over the block)
    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][c][j] = 0.f;

#pragma unroll 2
    for (int s = warp; s < steps; s += NWARP) {
      const int k = s * TK + 4 * tig;
      const int8_t* wrow = Wc + (size_t)k * N + n0 + 8 * gid;
      uint2 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = __ldg(reinterpret_cast<const uint2*>(wrow + (size_t)i * N));
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
      for (int c = 0; c < 8; ++c) {
        const int cb = c & 3;
        const uint32_t w0 = c < 4 ? w[0].x : w[0].y, w1 = c < 4 ? w[1].x : w[1].y;
        const uint32_t w2 = c < 4 ? w[2].x : w[2].y, w3 = c < 4 ? w[3].x : w[3].y;
        const uint32_t b0 = pack_codes(w0, w1, cb);  // K slots 2tig, 2tig+1
        const uint32_t b1 = pack_codes(w2, w3, cb);  // K slots 2tig+8, 2tig+9
        mma_bf16(acc[0][c], a[0], b0, b1);
        if (second) mma_bf16(acc[1][c], a[1], b0, b1);
      }
    }

    // add the eight warps' partial tiles in warp order
    for (int i = threadIdx.x; i < TM * TS; i += NWARP * 32) tile[i] = 0.f;
    __syncthreads();
    for (int wv = 0; wv < NWARP; ++wv) {
      if (warp == wv) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int c = 0; c < 8; ++c)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int r = mt * 16 + gid + (j >> 1) * 8;
              const int col = 8 * (tig * 2 + (j & 1)) + c;
              tile[r * TS + col] = __fadd_rn(tile[r * TS + col], acc[mt][c][j]);
            }
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < TM * TN; i += NWARP * 32) {
      const int r = i / TN, col = i % TN;
      if (m0 + r < M)
        out[(size_t)(m0 + r) * N + n0 + col] = __fmul_rn(tile[r * TS + col], scale[n0 + col]);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int atom_gemm_w8a16(const void* a, const void* codes, const void* scale, void* out,
                               int M, int N, int K, void* stream) {
  gemm_w8a16_kernel<<<N / TN, NWARP * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)a, (const int8_t*)codes, (const float*)scale, (float*)out, M, N, K);
  return (int)cudaGetLastError();
}
