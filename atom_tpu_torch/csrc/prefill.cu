// Causal flash attention over u4 K/V codes with their affine parameters (K12).
//
// Replaces atom_tpu/ops/pallas_prefill.py:164 flash_code_attention
// (_prefill_kernel :54).  For query row r (global position row_offset + r) and
// key slot c <= that position, per query head (GQA: kv head = q head / groups,
// no repeated K/V in memory):
//   score = ((q . kcodes) * k_scale + sum(q) * k_zero) * sm_scale
//   p = exp(score - m),  l = sum p
//   out = (sum_c (p * v_scale)_c * vcodes_c + sum_c p * v_zero) / max(l, 1e-20)
// K and V are never dequantized.
//
// What bounds it: at T = 1024, 32 heads, the causal half of (row, key) pairs
// meets three products of 128 multiply-adds each (q.K, and p.V as two bf16
// terms, below): 12.9 GFLOP on the bf16 tensor cores (0.013 ms at 989 TFLOP/s)
// against 25.7 MB of q, codes, params and output (0.0077 ms at 3.35 TB/s):
// operations.
//
// Design (FlashAttention-2's layout on mma.sync):
//  * A block owns one query tile (64 rows: 4 warps of 16 rows) of one query
//    head and walks the key tiles of 64 slots from 0 to the last one
//    its last row can see; it never reads or computes a tile past that one.
//    Which tile and how many key tiles come from the launch plan
//    (ops/prefill.py::flash_plan), taken as it is: its entries run heaviest
//    first, so the causal triangle leaves no tail, and a plan entry's blocks
//    are the HQ query heads side by side, so sibling heads of one kv head read
//    the same K/V tiles from L2.
//  * Copies: each key tile's K and V codes (64 rows of 128 bytes, H * 128
//    bytes apart) and its params (8 bytes a slot and kv head) arrive by
//    cp.async into one of two raw stages while the block works on the tile
//    before; slots past Tk are zero-filled.  (Not TMA or bulk copies: a
//    param row is 8 bytes, below their 16-byte grain, and a code row would
//    be 64 bulk copies a tile; cp.async also has no barrier wait that could
//    hang.)  The block then converts the tile once into bf16 in shared
//    memory (a byte permute under 0x43 and one subtraction: exact), rows
//    272 bytes apart, so that ldmatrix reads them without bank conflicts.
//  * q.K: q's A fragments are loaded once; K's B fragments by ldmatrix (the
//    row-major [slot][channel] tile is q.K^T's B operand as it stands).  bf16
//    mma.sync m16n8k16 with float32 sums: q is bf16 and a code a small
//    integer, so every product is exact and only the order of the additions
//    moves, as on the TPU's matrix unit.  The affine correction and sm_scale
//    per element in the written order; the causal and Tk masks only on a
//    warp's diagonal and last tiles.  A warp none of whose rows sees the
//    tile skips it (an exact no-op: alpha 1, p 0).
//  * Online softmax in registers: a row's quad shares its max by shuffles;
//    masked slots give p = 0 exactly, so keys past the last visible one
//    cannot change the output.  l and sum p * v_zero stay per-thread float32
//    shares, rescaled by alpha and summed over the quad at the end.
//  * p.V: the score accumulators become the A fragments (no trip through
//    shared memory), p * v_scale as two bf16 terms, hi and its remainder, two
//    mma's a k-step (~2^-17 relative, where one bf16 rounding, 2^-9, would
//    lose the float32 precision the TPU kernel keeps); V's B fragments by
//    ldmatrix.trans.  Each tile's p.V starts from zero and joins the running
//    output in one multiply-add with the softmax's rescale.
//  * out = (acc + sum p * v_zero) / max(l, 1e-20), rounded once to bf16.
// One launch, no workspace, no atomics, deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int D = 128;           // head_dim
constexpr int NW = 4;            // warps of a block, 16 query rows each
constexpr int NT = 32 * NW;      // threads of a block
constexpr int TQ = 16 * NW;      // query rows of a block
constexpr int TK = 64;           // key slots of a step
constexpr int KP = D + 8;        // bf16 row pitch of the converted tiles (272 bytes)
constexpr int MAX_ENTRIES = 256; // query tiles a plan may list
constexpr float NEG_INF = -1e30f;

// The launch plan of ops/prefill.py::flash_plan: entry i is query tile
// q_tile[i] (rows TQ q_tile[i] ..), walking key tiles 0 .. n_kt[i] - 1.
struct FlashPlan {
  int n;
  int q_tile[MAX_ENTRIES];
  int n_kt[MAX_ENTRIES];
};

// Dynamic shared memory: two raw stages (K codes [64][128] bytes, V codes
// [64][128] bytes, params [64][4] float: k scale, k zero, v scale, v zero),
// then the converted tiles K [64][KP] and V [64][KP] bf16.
constexpr int RAW_PRM = 2 * TK * D;
constexpr int RAW_BYTES = RAW_PRM + TK * 4 * 4;
constexpr int CONV_BYTES = TK * KP * 2;
constexpr int SMEM_BYTES = 2 * RAW_BYTES + 2 * CONV_BYTES;

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// 16 (8) bytes from global into shared memory; `in` false: zeros, nothing read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(in ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Block (plan entry blockIdx.x / HQ, query head blockIdx.x % HQ).  Warp w owns
// the tile's rows 16 w .. 16 w + 15; a thread rows gid and gid + 8 of those
// (the mma fragments' rows) and, of a 64-slot score tile, slots 8 n + 2 tig +
// {0, 1} of n-tile n.
__global__ void __launch_bounds__(NT)
flash_tile_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_codes,
                  const float* __restrict__ k_prm, const int8_t* __restrict__ v_codes,
                  const float* __restrict__ v_prm, __nv_bfloat16* __restrict__ out, int Tq, int Tk, int HQ,
                  int H, int groups, int row_offset, float sm_scale, const __grid_constant__ FlashPlan plan) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks_t = reinterpret_cast<__nv_bfloat16*>(smem + 2 * RAW_BYTES);
  __nv_bfloat16* vs_t = ks_t + TK * KP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int entry = blockIdx.x / HQ, hq = blockIdx.x % HQ, h = hq / groups;
  const int n_kt = plan.n_kt[entry];
  const int wr0 = plan.q_tile[entry] * TQ + 16 * warp;  // the warp's first row
  const int pos0 = row_offset + wr0;                    // and its position

  // key tile j's codes and params into raw stage j & 1, as one cp.async group
  auto issue = [&](int j) {
    unsigned char* raw = smem + (j & 1) * RAW_BYTES;
    const int k0 = j * TK;
    for (int i = tid; i < TK * 8; i += NT) {
      const int s = i >> 3, c = i & 7, slot = k0 + s;
      const bool in = slot < Tk;
      const size_t g = ((size_t)(in ? slot : 0) * H + h) * D + 16 * c;
      cp_async16(raw + s * D + 16 * c, k_codes + g, in);
      cp_async16(raw + TK * D + s * D + 16 * c, v_codes + g, in);
    }
    for (int i = tid; i < 2 * TK; i += NT) {
      const int s = i & (TK - 1), kv = i / TK, slot = k0 + s;
      const bool in = slot < Tk;
      cp_async8(raw + RAW_PRM + (4 * s + 2 * kv) * 4, (kv ? v_prm : k_prm) + ((size_t)(in ? slot : 0) * H + h) * 2, in);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  issue(0);

  // q's A fragments (k-step kk: channels 16 kk + 2 tig (+1) and + 8) and the
  // rows' channel sums, while the first tile flies; rows past Tq are zeros
  uint32_t qa[8][4];
  float qsum[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = wr0 + gid + 8 * rr;
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(q + ((size_t)(row < Tq ? row : 0) * HQ + hq) * D);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const uint32_t w = row < Tq ? qr[8 * kk + 4 * hf + tig] : 0u;
        qa[kk][rr + 2 * hf] = w;
        qsum[rr] = __fadd_rn(qsum[rr], __fadd_rn(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u)));
      }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    qsum[rr] = __fadd_rn(qsum[rr], __shfl_xor_sync(0xffffffffu, qsum[rr], 1));
    qsum[rr] = __fadd_rn(qsum[rr], __shfl_xor_sync(0xffffffffu, qsum[rr], 2));
  }

  // state of rows gid, gid + 8: m the same across a row's quad, l and
  // sum p * v_zero this thread's shares; o[n][e]: row gid + 8 (e >> 1),
  // channel 8 n + 2 tig + (e & 1)
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, z[2] = {0.f, 0.f};
  float o[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // tile j has landed for every thread; every warp is done with tile j - 1
    if (j + 1 < n_kt) issue(j + 1);
    const unsigned char* raw = smem + (j & 1) * RAW_BYTES;
    // the codes into bf16: 8 bytes in, 16 bytes out a step, K then V
    for (int i = tid; i < 2 * TK * 16; i += NT) {
      const int kv = i / (TK * 16), s = (i >> 4) & (TK - 1), c = i & 15;
      const uint2 w = *reinterpret_cast<const uint2*>(raw + kv * TK * D + s * D + 8 * c);
      *reinterpret_cast<uint4*>((kv ? vs_t : ks_t) + s * KP + 8 * c) =
          make_uint4(byte_pair<0>(w.x), byte_pair<1>(w.x), byte_pair<0>(w.y), byte_pair<1>(w.y));
    }
    __syncthreads();
    const int k0 = j * TK;
    if (k0 > pos0 + 15) continue;  // no row of the warp sees the tile
    const bool edge = k0 + TK - 1 > pos0 || k0 + TK > Tk;
    const float4* prm = reinterpret_cast<const float4*>(raw + RAW_PRM);

    // scores: n-tile n holds slots 8 n .. 8 n + 7
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, ks_t + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * KP + 16 * kk + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * np], qa[kk], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qa[kk], b[2], b[3]);
      }
    // the affine correction, sm_scale, the masks and the tile's row max
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float4 p0 = prm[8 * n + 2 * tig], p1 = prm[8 * n + 2 * tig + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1, slot = k0 + 8 * n + 2 * tig + (e & 1);
        const float4& pp = (e & 1) ? p1 : p0;
        float x = __fmul_rn(__fadd_rn(__fmul_rn(sc[n][e], pp.x), __fmul_rn(qsum[rr], pp.y)), sm_scale);
        if (edge && (slot > pos0 + gid + 8 * rr || slot >= Tk)) x = NEG_INF;
        sc[n][e] = x;
        mx[rr] = fmaxf(mx[rr], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      alpha[rr] = expf(__fsub_rn(m[rr], m_new));
      m[rr] = m_new;
      l[rr] = __fmul_rn(l[rr], alpha[rr]);
      z[rr] = __fmul_rn(z[rr], alpha[rr]);
    }
    // p; l and sum p * v_zero; the scores become p * v_scale
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float4 p0 = prm[8 * n + 2 * tig], p1 = prm[8 * n + 2 * tig + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1, slot = k0 + 8 * n + 2 * tig + (e & 1);
        const float4& pp = (e & 1) ? p1 : p0;
        const bool valid = !edge || (slot <= pos0 + gid + 8 * rr && slot < Tk);
        const float p = valid ? expf(__fsub_rn(sc[n][e], m[rr])) : 0.f;
        l[rr] = __fadd_rn(l[rr], p);
        z[rr] = __fmaf_rn(p, pp.w, z[rr]);
        sc[n][e] = __fmul_rn(p, pp.z);
      }
    }
    // p.V: k-step ks takes the scores' n-tiles 2 ks and 2 ks + 1 as its A
    // fragment, hi and remainder; channel quarter cq (n-tiles 4 cq .. + 3)
    // from a zero accumulator, joined to the output with the rescale
    uint32_t a[4][2][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      split_pair(sc[2 * ks][0], sc[2 * ks][1], a[ks][0][0], a[ks][1][0]);
      split_pair(sc[2 * ks][2], sc[2 * ks][3], a[ks][0][1], a[ks][1][1]);
      split_pair(sc[2 * ks + 1][0], sc[2 * ks + 1][1], a[ks][0][2], a[ks][1][2]);
      split_pair(sc[2 * ks + 1][2], sc[2 * ks + 1][3], a[ks][0][3], a[ks][1][3]);
    }
#pragma unroll
    for (int cq = 0; cq < 4; ++cq) {
      float pv[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[u][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          uint32_t b[4];
          ldsm_x4_trans(b, vs_t + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * KP + 8 * (4 * cq + 2 * t + (lane >> 4)));
          mma_bf16(pv[2 * t], a[ks][0], b[0], b[1]);
          mma_bf16(pv[2 * t], a[ks][1], b[0], b[1]);
          mma_bf16(pv[2 * t + 1], a[ks][0], b[2], b[3]);
          mma_bf16(pv[2 * t + 1], a[ks][1], b[2], b[3]);
        }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * cq + u][e] = __fmaf_rn(o[4 * cq + u][e], alpha[e >> 1], pv[u][e]);
    }
  }

  // l and sum p * v_zero over the row's quad; out = (acc + z) / max(l, 1e-20)
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l[rr] = __fadd_rn(l[rr], __shfl_xor_sync(0xffffffffu, l[rr], x));
      z[rr] = __fadd_rn(z[rr], __shfl_xor_sync(0xffffffffu, z[rr], x));
    }
    const int row = wr0 + gid + 8 * rr;
    if (row >= Tq) continue;
    const float den = fmaxf(l[rr], 1e-20f);
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + ((size_t)row * HQ + hq) * D) + tig;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      dst[4 * n] = bf16_pair(__fdiv_rn(__fadd_rn(o[n][2 * rr], z[rr]), den),
                             __fdiv_rn(__fadd_rn(o[n][2 * rr + 1], z[rr]), den));
  }
}

}  // namespace

// plan: {n, q_tile[0 .. n), n_kt[0 .. n)} as ops/prefill.py::FlashPlan.args()
// gives it.  A plan the kernel cannot run is refused.
extern "C" int atom_flash_code_attention(const void* q, const void* k_codes, const void* k_prm,
                                         const void* v_codes, const void* v_prm, void* out, int Tq,
                                         int Tk, int HQ, int H, int groups, int row_offset,
                                         float sm_scale, const int* plan_args, void* stream) {
  FlashPlan plan;
  plan.n = plan_args[0];
  if (plan.n < 1 || plan.n > MAX_ENTRIES || H < 1 || groups < 1 || HQ != H * groups || row_offset < 0)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < plan.n; ++i) {
    plan.q_tile[i] = plan_args[1 + i];
    plan.n_kt[i] = plan_args[1 + plan.n + i];
    if (plan.q_tile[i] < 0 || plan.q_tile[i] * TQ >= Tq || plan.n_kt[i] < 1 || (plan.n_kt[i] - 1) * TK >= Tk)
      return (int)cudaErrorInvalidValue;
  }
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  flash_tile_kernel<<<plan.n * HQ, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)k_codes, (const float*)k_prm, (const int8_t*)v_codes,
      (const float*)v_prm, (__nv_bfloat16*)out, Tq, Tk, HQ, H, groups, row_offset, sm_scale, plan);
  return (int)cudaGetLastError();
}
