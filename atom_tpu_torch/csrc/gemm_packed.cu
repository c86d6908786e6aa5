// 4-bit-weight dual-path GEMM (K1) and the fused kernels built on it: the qkv
// projections K2 (float in, K/V into the hot ring), K7 (int in, K/V codes out:
// prefill) and K8 (int in, K/V into the hot ring); K9, the GEMM with the
// activation quantization (and optional RMSNorm) in front and the residual add
// behind; and K10, the whole quantized MLP block.
//
// K1 replaces atom_tpu/ops/pallas_gemm_packed.py:284 packed_w4_gemm (bodies
// _gemm_packed_kernel :63, _gemm_packed_scratch_kernel :100, the K-blocked
// :127/:178): out f32 [M,N] = sum_g (A_g . W_g)_i32 * sa[:,g] * sw[g,:]
//                              + (A_k . W_k)_i32 * sa[:,ng] * sw[ng,:].
// K2 replaces :1261 packed_w4_gemm_qkv_ring_fused (_gemm_qkv_ring_fused_kernel
// :1073, _quant_prologue :438, _qkv_ring_epilogue :937, _kv_quantize_tile :909).
// K7 replaces :792 packed_w4_gemm_qkv (_gemm_qkv_kernel :701) and K8 :1196
// packed_w4_gemm_qkv_ring (_gemm_qkv_ring_kernel :1049).
//
// What bounds them on the H100: at decode M = 32 the product is 32 x K x N int8
// MACs against K*N/2 bytes of 4-bit weights, 64 MACs per weight byte, far below
// the ~590 int8 ops per byte where the tensor cores become the limit: the
// weight stream from HBM bounds every call.
//
// Design.  A block owns a 32-row x 32-column output tile and walks all of K.
// Its 8 warps take the 128-wide groups round-robin (warp w: groups w, w+8, ...)
// so 8 groups' weight loads are in flight per block.  Each warp computes a
// group's exact int32 dot with mma.sync m16n8k32 (s8 x s8 -> s32): a thread
// loads 4 byte-rows x 4 columns of nibble planes as four 32-bit words,
// transposes them with byte permutes so one register holds one column's
// 4 consecutive K codes, and masks each nibble plane into the high nibble of
// its byte (the byte then reads as 16 x the signed code; the int32 sum is
// shifted back down by 4, exactly).  The low nibbles of a byte row are K
// codes r, the high nibbles K codes r + 64 (formats.py nibble planes), so the
// mma's K index j < 16 maps to code s*16 + j and j >= 16 to 64 + s*16 + j-16;
// the A fragment is read with the same permutation.  The int32 group tiles go
// through shared memory and the float accumulation then runs group by group
// in order, acc += float(acc_g) * sa * sw, keeper last: the TPU kernel's f32
// order, so the result matches the plain version bit for bit.  The file is
// built with --fmad=false and the float math uses _rn intrinsics, so no
// multiply-add is contracted.
//
// The int8 operand loads, the s8 mma and its byte transposes, the keeper's
// int32 group dot and the per-head u4 quantizer live in int8_mma.cuh, shared
// with the grouped int8 GEMMs (K14, gemm_int8.cu).
//
// Known limits (later work): every block re-reads A (32 x K bytes, from L2)
// for its 32 columns, twice the bytes of its weight slice; there is no
// shared-memory staging, cp.async or wgmma yet.
//
// K2 runs as three launches on one stream: the RMSNorm + dual-path
// quantization prologue (one block per token row, since every output tile
// needs the whole quantized row), the GEMM above into an f32 [M, N] scratch,
// and the epilogue (one block per row and 128-column head: RoPE on q and k,
// per-head asymmetric u4 quantization of post-RoPE K and of V, in-place ring
// stores at column `row`).  The per-head reductions span 128 columns, wider
// than a GEMM tile, hence the second pass.  K8 is K2 without its prologue: the
// caller hands in the quantized activation.  K7 is the GEMM followed by an
// epilogue with the same per-head arithmetic (one __device__ function serves
// both epilogues) that writes one byte per code and float32 params, the layout
// prefill appends to the pages from; at prefill M is the prompt bucket (up to
// 1024 rows), every 32-row tile re-reads the weights (from L2 where they fit)
// and the f32 [M, N] scratch is 50 MB at M 1024, N 12288: the product is then
// bound by the int8 tensor-core rate, not bytes.  The TPU kernels pad M to
// their tile; these guard row < M instead.  NaN note: the TPU kernel's bf16
// rounding is integer bit math that turns a NaN into Inf; here
// __float2bfloat16_rn keeps NaN.
//
// K9 replaces :540 packed_w4_gemm_fused_in (_gemm_fused_in_kernel :494,
// _quant_prologue :438): two launches, the prologue above (its norm optional;
// rstd always comes from outside, as on the TPU, so the statistic is the one
// the unfused chain uses) and the GEMM with the epilogue
// out = bf16(resid + bf16(acc)): the GEMM output is rounded to bf16 before the
// add, then the sum once more, which is what x + quant_gemm(...) does, so K9
// equals the unfused chain bit for bit.  Bound: the weight stream, as K1.
//
// K10 replaces atom_tpu/ops/pallas_mlp.py:238 fused_mlp_packed (_fused_mlp_kernel
// :84).  On the TPU one sequential grid runs prologue, gate/up tiles and down
// tiles in turn with the act codes in VMEM.  Here blocks run in parallel and
// the down product needs every act code of a row, so the phases are launches
// on one stream: (1) the prologue, (2) the gate/up GEMM into an f32 [M, 2*inter]
// scratch, (3) SiLU(gate) * up in f32 and the requantization per 128 channels
// (the last 128 of inter the INT8 keeper, every other block INT4 with the
// clip), (4) the down GEMM with the residual epilogue (or resid + row_scale *
// acc, the MoE form, without the bf16 pin, as the TPU kernel has it).  The
// scratch (2.8 MB at 7B), act codes and scales stay in L2 between launches.
// SiLU is x / (1 + expf(-x)) with IEEE division, the formula of PyTorch's CUDA
// silu, so the act codes equal the plain version's.  Bound: the two weight
// streams (gate/up 45 MB + down 22.5 MB at 7B): memory.  Later work: fold
// (3) into (2)'s epilogue with a 128-column tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace {

constexpr int GROUP = 128;
constexpr int HALF = 64;
constexpr int TM = 32;     // output rows per block
constexpr int TN = 32;     // output columns per block
constexpr int NWARP = 8;   // warps per block
constexpr int TS = TN + 1; // shared tile row stride (no bank conflicts)
constexpr int HEAD = 128;  // head_dim of the qkv epilogue

// One warp: 16 x (int32 dot) of nibble group g, rows [m0, m0+32), cols [n0, n0+32).
__device__ __forceinline__ void dot_nibble_group(const int8_t* A, int lda, int M, int m0,
                                                 const int8_t* wp, int N, int n0, int g,
                                                 int lane, int (&acc)[2][4][4]) {
  const int gid = lane >> 2, tig = lane & 3;
  const int8_t* wrow = wp + (size_t)(g * HALF + tig * 4) * N + n0 + 4 * gid;
  uint32_t w[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) w[s][i] = ld_u32(wrow + (size_t)(s * 16 + i) * N);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    uint32_t t[4];
    transpose4(w[s], t);
    const int k = g * GROUP + s * 16 + tig * 4;
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = m0 + mt * 16 + gid;
      a[mt][0] = ld_a(A, lda, M, r, k);
      a[mt][1] = ld_a(A, lda, M, r + 8, k);
      a[mt][2] = ld_a(A, lda, M, r, k + HALF);
      a[mt][3] = ld_a(A, lda, M, r + 8, k + HALF);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t lo = (t[c] << 4) & 0xF0F0F0F0u;  // 16 x code r
      const uint32_t hi = t[c] & 0xF0F0F0F0u;         // 16 x code r + 64
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][c], a[mt], lo, hi);
    }
  }
}

// Epilogues of the GEMM: the f32 product (K1 and the qkv kernels' scratch);
// bf16(resid + bf16(acc)), resid optional (K9, K10); bf16(resid + row_scale *
// acc) (K10 with a per-row output scale).
enum Epilogue { EPI_F32 = 0, EPI_RESID = 1, EPI_ROW_SCALE = 2 };

template <int EPI>
__global__ void __launch_bounds__(NWARP * 32)
gemm_packed_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ wp,
                   const int8_t* __restrict__ wk, const float* __restrict__ sa,
                   const float* __restrict__ sw, void* __restrict__ out,
                   const __nv_bfloat16* __restrict__ resid, const float* __restrict__ row_scale,
                   int M, int N, int ng) {
  __shared__ int tile[NWARP][TM * TS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int total = ng + 1;  // body groups + keeper
  const int lda = total * GROUP;
  // this thread's 4 output elements: row er, columns ec .. ec + 3
  const int er = threadIdx.x / (TN / 4), ec = (threadIdx.x % (TN / 4)) * 4;
  const int row = m0 + er;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int base = 0; base < total; base += NWARP) {
    const int g = base + warp;
    if (g < total) {
      int ia[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int j = 0; j < 4; ++j) ia[mt][c][j] = 0;
      if (g < ng)
        dot_nibble_group(A, lda, M, m0, wp, N, n0, g, lane, ia);
      else
        dot_int8_group(A, lda, M, m0, wk, N, n0, ng * GROUP, lane, ia);
      const int shift = g < ng ? 4 : 0;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = mt * 16 + gid + (j >> 1) * 8;
            const int col = 4 * (tig * 2 + (j & 1)) + c;
            tile[warp][r * TS + col] = ia[mt][c][j] >> shift;
          }
    }
    __syncthreads();
    const int n_here = min(NWARP, total - base);
    for (int q = 0; q < n_here; ++q) {
      const int gg = base + q;
      const float s_a = row < M ? sa[(size_t)row * total + gg] : 0.f;
      const float* s_w = sw + (size_t)gg * N + n0 + ec;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float t = __fmul_rn(__fmul_rn(__int2float_rn(tile[q][er * TS + ec + j]), s_a), s_w[j]);
        acc[j] = __fadd_rn(acc[j], t);
      }
    }
    __syncthreads();
  }
  if (row >= M) return;
  const size_t o = (size_t)row * N + n0 + ec;
  if (EPI == EPI_F32) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    return;
  }
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out) + o;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v = acc[j];
    if (EPI == EPI_RESID) {
      if (resid != nullptr) v = __fadd_rn(__bfloat162float(resid[o + j]), bf16_round(v));
    } else {
      v = __fadd_rn(__bfloat162float(resid[o + j]), __fmul_rn(row_scale[row], v));
    }
    ob[j] = __float2bfloat16_rn(v);
  }
}

// One warp quantizes one 128-channel group of one row symmetrically (lane:
// 4 consecutive channels): an INT8 keeper without clip, or abits with a_clip.
__device__ __forceinline__ void quant_group_store(const float (&v)[4], int lane, bool keeper, int abits,
                                                  float a_clip, int8_t* __restrict__ codes4,
                                                  float* __restrict__ scale_out) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const int qmax = keeper ? 127 : (1 << (abits - 1)) - 1;
  amax = fmaxf(amax, 1e-5f);
  if (!keeper && a_clip < 1.f) amax = __fmul_rn(amax, a_clip);
  const float scale = __fdiv_rn(amax, (float)qmax);
  char4 codes;
  float q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q[i] = fminf(fmaxf(rintf(__fdiv_rn(v[i], scale)), (float)(-qmax - 1)), (float)qmax);
  codes.x = (signed char)q[0];
  codes.y = (signed char)q[1];
  codes.z = (signed char)q[2];
  codes.w = (signed char)q[3];
  *reinterpret_cast<char4*>(codes4) = codes;
  if (lane == 0) *scale_out = scale;
}

// Prologue of K2, K9 and K10: one block per token row m; warp w quantizes
// groups w, w+8, ...  With a norm weight: xn = bf16(y * rstd); v = bf16(xn *
// wg); without (wg null): v = y.  Then per 128-group symmetric quantization
// (INT4 body with clip, the last group an INT8 keeper without clip).
__global__ void __launch_bounds__(256)
quant_prologue_kernel(const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ wg,
                      const float* __restrict__ rstd, int8_t* __restrict__ a, float* __restrict__ sa,
                      int K, int ng, int abits, float a_clip) {
  const int m = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool norm = wg != nullptr;
  const float r = norm ? rstd[m] : 1.f;
  for (int g = warp; g <= ng; g += 8) {
    const int k0 = g * GROUP + lane * 4;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = __bfloat162float(y[(size_t)m * K + k0 + i]);
      if (norm) {
        const float xn = bf16_round(__fmul_rn(v[i], r));
        v[i] = bf16_round(__fmul_rn(xn, __bfloat162float(wg[k0 + i])));
      }
    }
    quant_group_store(v, lane, g == ng, abits, a_clip, a + (size_t)m * K + k0,
                      sa + (size_t)m * (ng + 1) + g);
  }
}

// K10 phase 3: act = SiLU(gate) * up in f32 from the gate/up product
// gu [M, 2*inter] (gate columns, then up), requantized per 128 channels into
// the down GEMM's input layout; the last block of inter is the INT8 keeper.
__global__ void __launch_bounds__(256)
silu_mul_quant_kernel(const float* __restrict__ gu, int8_t* __restrict__ a, float* __restrict__ sa,
                      int inter, int abits, float a_clip) {
  const int m = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nblk = inter / GROUP;
  const float* row = gu + (size_t)m * 2 * inter;
  for (int blk = warp; blk < nblk; blk += 8) {
    const int c0 = blk * GROUP + lane * 4;
    const float4 g4 = *reinterpret_cast<const float4*>(row + c0);
    const float4 u4 = *reinterpret_cast<const float4*>(row + inter + c0);
    const float g[4] = {g4.x, g4.y, g4.z, g4.w};
    const float u[4] = {u4.x, u4.y, u4.z, u4.w};
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = __fmul_rn(__fdiv_rn(g[i], __fadd_rn(1.f, expf(-g[i]))), u[i]);
    quant_group_store(v, lane, blk == nblk - 1, abits, a_clip, a + (size_t)m * inter + c0,
                      sa + (size_t)m * nblk + blk);
  }
}

__device__ __forceinline__ float block_max128(float v, float* sm) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) sm[threadIdx.x >> 5] = v;
  __syncthreads();
  v = fmaxf(fmaxf(sm[0], sm[1]), fmaxf(sm[2], sm[3]));
  __syncthreads();
  return v;
}

// The per-head arithmetic shared by the ring epilogue (K2, K8) and the prefill
// epilogue (K7), for block (m, head column block hb) with one thread per
// channel d.  Column blocks [0, n_q/128) are q heads, then H k heads, then H v
// heads.  q and k are rotated (RoPE) in float32; k (after RoPE) and v get the
// per-head asymmetric u4 quantization of ops/reference.py quantize_kv_asym:
// scale = bf16((max - min, at least 1e-5) / 15), zero = clamp(rint(-min /
// scale), 0, 15), code = clamp(rint(x / scale) + zero, 0, 15), and the stored
// zero value is bf16(-zero * scale).
struct HeadValue {
  float v;      // the (rotated) value; all a q head needs
  float scale;  // k / v heads only
  float zero_val;
  int code;
};

__device__ __forceinline__ HeadValue head_rope_quant(const float* __restrict__ x,
                                                     const float* __restrict__ cosv,
                                                     const float* __restrict__ sinv, int m, int d,
                                                     bool rotate, bool quantize, float* red) {
  HeadValue r;
  r.v = x[d];
  r.scale = 0.f;
  r.zero_val = 0.f;
  r.code = 0;
  if (rotate) {
    const float rot = d < HEAD / 2 ? -x[d + HEAD / 2] : x[d - HEAD / 2];
    r.v = __fadd_rn(__fmul_rn(r.v, cosv[m * HEAD + d]), __fmul_rn(rot, sinv[m * HEAD + d]));
  }
  if (!quantize) return r;  // uniform over the block: a block is one head
  const float xmax = block_max128(r.v, red);
  const float xmin = -block_max128(-r.v, red);
  const KvQuant kq = kv_quant_params(xmax, xmin);
  r.scale = kq.scale;
  r.code = kv_quant_code(r.v, kq);
  r.zero_val = kq.zero_val;
  return r;
}

// Ring epilogue (K2, K8): q out; K/V codes and params into ring column `row`.
__global__ void __launch_bounds__(HEAD)
qkv_ring_epilogue_kernel(const float* __restrict__ qkv, const float* __restrict__ cosv,
                         const float* __restrict__ sinv, __nv_bfloat16* __restrict__ q,
                         int8_t* __restrict__ ring_k, __nv_bfloat16* __restrict__ ring_prm,
                         int8_t* __restrict__ ring_v, int n_q, int H, int W, int row) {
  __shared__ float red[4];
  __shared__ int codes[HEAD];
  const int m = blockIdx.x, hb = blockIdx.y, d = threadIdx.x;
  const int N = n_q + 2 * H * HEAD;
  const int nqh = n_q / HEAD;
  const bool is_q = hb < nqh;
  const bool is_k = !is_q && hb < nqh + H;
  const HeadValue hv = head_rope_quant(qkv + (size_t)m * N + (size_t)hb * HEAD, cosv, sinv, m, d,
                                       is_q || is_k, !is_q, red);
  if (is_q) {
    q[(size_t)m * n_q + (size_t)hb * HEAD + d] = __float2bfloat16_rn(hv.v);
    return;
  }
  const int h = is_k ? hb - nqh : hb - nqh - H;
  if (d == 0) {
    const int plane = is_k ? 0 : 2;
    ring_prm[(((size_t)m * 4 + plane) * H + h) * W + row] = __float2bfloat16_rn(hv.scale);
    ring_prm[(((size_t)m * 4 + plane + 1) * H + h) * W + row] = __float2bfloat16_rn(hv.zero_val);
  }
  if (is_k) {
    codes[d] = hv.code;
    __syncthreads();
    if (d < HEAD / 2)
      ring_k[(((size_t)m * H + h) * (HEAD / 2) + d) * W + row] =
          (int8_t)(codes[d] | (codes[d + HEAD / 2] << 4));
  } else {
    ring_v[(((size_t)m * H + h) * W + row) * HEAD + d] = (int8_t)hv.code;
  }
}

// Prefill epilogue (K7): q out; K/V as one byte per code [M, H, 128] and
// float32 params [M, H, 2] = (scale, zero value), both already bf16-rounded.
__global__ void __launch_bounds__(HEAD)
qkv_codes_epilogue_kernel(const float* __restrict__ qkv, const float* __restrict__ cosv,
                          const float* __restrict__ sinv, __nv_bfloat16* __restrict__ q,
                          int8_t* __restrict__ k_codes, float* __restrict__ k_prm,
                          int8_t* __restrict__ v_codes, float* __restrict__ v_prm, int n_q, int H) {
  __shared__ float red[4];
  const int m = blockIdx.x, hb = blockIdx.y, d = threadIdx.x;
  const int N = n_q + 2 * H * HEAD;
  const int nqh = n_q / HEAD;
  const bool is_q = hb < nqh;
  const bool is_k = !is_q && hb < nqh + H;
  const HeadValue hv = head_rope_quant(qkv + (size_t)m * N + (size_t)hb * HEAD, cosv, sinv, m, d,
                                       is_q || is_k, !is_q, red);
  if (is_q) {
    q[(size_t)m * n_q + (size_t)hb * HEAD + d] = __float2bfloat16_rn(hv.v);
    return;
  }
  const int h = is_k ? hb - nqh : hb - nqh - H;
  const size_t mh = (size_t)m * H + h;
  (is_k ? k_codes : v_codes)[mh * HEAD + d] = (int8_t)hv.code;
  if (d == 0) {
    float* prm = is_k ? k_prm : v_prm;
    prm[mh * 2] = hv.scale;
    prm[mh * 2 + 1] = hv.zero_val;
  }
}

template <int EPI>
cudaError_t launch_gemm_epi(const void* a, const void* wp, const void* wk, const void* sa,
                            const void* sw, void* out, const void* resid, const void* row_scale,
                            int M, int N, int ng, cudaStream_t st) {
  const dim3 grid(N / TN, (M + TM - 1) / TM);
  gemm_packed_kernel<EPI><<<grid, NWARP * 32, 0, st>>>(
      (const int8_t*)a, (const int8_t*)wp, (const int8_t*)wk, (const float*)sa, (const float*)sw,
      out, (const __nv_bfloat16*)resid, (const float*)row_scale, M, N, ng);
  return cudaGetLastError();
}

cudaError_t launch_gemm(const void* a, const void* wp, const void* wk, const void* sa,
                        const void* sw, void* out, int M, int N, int ng, cudaStream_t st) {
  return launch_gemm_epi<EPI_F32>(a, wp, wk, sa, sw, out, nullptr, nullptr, M, N, ng, st);
}

cudaError_t launch_prologue(const void* y, const void* wg, const void* rstd, void* a, void* sa,
                            int M, int K, int abits, float a_clip, cudaStream_t st) {
  quant_prologue_kernel<<<M, 256, 0, st>>>((const __nv_bfloat16*)y, (const __nv_bfloat16*)wg,
                                           (const float*)rstd, (int8_t*)a, (float*)sa, K,
                                           K / GROUP - 1, abits, a_clip);
  return cudaGetLastError();
}

cudaError_t launch_ring_epilogue(const void* qkv, const void* cosv, const void* sinv, void* q,
                                 void* ring_k, void* ring_prm, void* ring_v, int M, int n_q, int H,
                                 int W, int row, cudaStream_t st) {
  const int N = n_q + 2 * H * HEAD;
  qkv_ring_epilogue_kernel<<<dim3(M, N / HEAD), HEAD, 0, st>>>(
      (const float*)qkv, (const float*)cosv, (const float*)sinv, (__nv_bfloat16*)q,
      (int8_t*)ring_k, (__nv_bfloat16*)ring_prm, (int8_t*)ring_v, n_q, H, W, row);
  return cudaGetLastError();
}

}  // namespace

extern "C" int atom_gemm_packed(const void* a, const void* wp, const void* wk, const void* sa,
                                const void* sw, void* out, int M, int N, int ng, void* stream) {
  return (int)launch_gemm(a, wp, wk, sa, sw, out, M, N, ng, (cudaStream_t)stream);
}

// K2: prologue (norm + activation quantization), GEMM, ring epilogue.
extern "C" int atom_qkv_ring_fused(const void* y, const void* wg, const void* rstd, const void* wp,
                                   const void* wk, const void* sw, const void* cosv,
                                   const void* sinv, void* a_scratch, void* sa_scratch,
                                   void* qkv_scratch, void* q, void* ring_k, void* ring_prm,
                                   void* ring_v, int M, int K, int n_q, int H, int W, int row,
                                   int abits, float a_clip, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int ng = K / GROUP - 1;
  const int N = n_q + 2 * H * HEAD;
  cudaError_t err = launch_prologue(y, wg, rstd, a_scratch, sa_scratch, M, K, abits, a_clip, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm(a_scratch, wp, wk, sa_scratch, sw, qkv_scratch, M, N, ng, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_ring_epilogue(qkv_scratch, cosv, sinv, q, ring_k, ring_prm, ring_v, M, n_q, H,
                                   W, row, st);
}

// K8: GEMM on the caller's quantized activation, ring epilogue.
extern "C" int atom_qkv_ring(const void* a, const void* wp, const void* wk, const void* sa,
                             const void* sw, const void* cosv, const void* sinv, void* qkv_scratch,
                             void* q, void* ring_k, void* ring_prm, void* ring_v, int M, int ng,
                             int n_q, int H, int W, int row, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int N = n_q + 2 * H * HEAD;
  const cudaError_t err = launch_gemm(a, wp, wk, sa, sw, qkv_scratch, M, N, ng, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_ring_epilogue(qkv_scratch, cosv, sinv, q, ring_k, ring_prm, ring_v, M, n_q, H,
                                   W, row, st);
}

// K7: GEMM, then q / K codes / V codes / params in the prefill layout.
extern "C" int atom_qkv_codes(const void* a, const void* wp, const void* wk, const void* sa,
                              const void* sw, const void* cosv, const void* sinv, void* qkv_scratch,
                              void* q, void* k_codes, void* k_prm, void* v_codes, void* v_prm,
                              int M, int ng, int n_q, int H, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int N = n_q + 2 * H * HEAD;
  const cudaError_t err = launch_gemm(a, wp, wk, sa, sw, qkv_scratch, M, N, ng, st);
  if (err != cudaSuccess) return (int)err;
  qkv_codes_epilogue_kernel<<<dim3(M, N / HEAD), HEAD, 0, st>>>(
      (const float*)qkv_scratch, (const float*)cosv, (const float*)sinv, (__nv_bfloat16*)q,
      (int8_t*)k_codes, (float*)k_prm, (int8_t*)v_codes, (float*)v_prm, n_q, H);
  return (int)cudaGetLastError();
}

// K9: prologue (norm optional: wg and rstd null without it), then the GEMM with
// the residual epilogue into bf16 (resid null: bf16(acc)) or, with out_f32, the
// plain f32 product.
extern "C" int atom_gemm_fused_in(const void* y, const void* wg, const void* rstd, const void* wp,
                                  const void* wk, const void* sw, const void* resid,
                                  void* a_scratch, void* sa_scratch, void* out, int M, int K, int N,
                                  int abits, int out_f32, float a_clip, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int ng = K / GROUP - 1;
  const cudaError_t err = launch_prologue(y, wg, rstd, a_scratch, sa_scratch, M, K, abits, a_clip, st);
  if (err != cudaSuccess) return (int)err;
  if (out_f32) return (int)launch_gemm(a_scratch, wp, wk, sa_scratch, sw, out, M, N, ng, st);
  return (int)launch_gemm_epi<EPI_RESID>(a_scratch, wp, wk, sa_scratch, sw, out, resid, nullptr, M, N,
                                         ng, st);
}

// K10: prologue, gate/up GEMM, SiLU * up + requantization, down GEMM with the
// residual epilogue (row_scale null) or resid + row_scale * acc.
extern "C" int atom_fused_mlp(const void* y, const void* wg, const void* rstd, const void* gu_wp,
                              const void* gu_wk, const void* gu_sw, const void* dn_wp,
                              const void* dn_wk, const void* dn_sw, const void* resid,
                              const void* row_scale, void* a_scratch, void* sa_scratch,
                              void* gu_scratch, void* act, void* act_scales, void* out, int M, int D,
                              int inter, int abits, float a_clip, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_prologue(y, wg, rstd, a_scratch, sa_scratch, M, D, abits, a_clip, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm(a_scratch, gu_wp, gu_wk, sa_scratch, gu_sw, gu_scratch, M, 2 * inter,
                    D / GROUP - 1, st);
  if (err != cudaSuccess) return (int)err;
  silu_mul_quant_kernel<<<M, 256, 0, st>>>((const float*)gu_scratch, (int8_t*)act,
                                           (float*)act_scales, inter, abits, a_clip);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nga = inter / GROUP - 1;
  if (row_scale != nullptr)
    return (int)launch_gemm_epi<EPI_ROW_SCALE>(act, dn_wp, dn_wk, act_scales, dn_sw, out, resid,
                                               row_scale, M, D, nga, st);
  return (int)launch_gemm_epi<EPI_RESID>(act, dn_wp, dn_wk, act_scales, dn_sw, out, resid, nullptr, M,
                                         D, nga, st);
}
