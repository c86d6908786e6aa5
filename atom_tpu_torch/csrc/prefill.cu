// Causal flash attention over u4 K/V codes with their affine parameters (K12).
//
// Replaces atom_tpu/ops/pallas_prefill.py:164 flash_code_attention
// (_prefill_kernel :54).  For query row r (global position row_offset + r) and
// key slot c <= that position, per query head (GQA: kv head = q head / groups,
// no repeated K/V in memory):
//   score = ((q . kcodes) * k_scale + sum(q) * k_zero) * sm_scale
//   p = exp(score - m),  l = sum p
//   out = (sum_c (p * v_scale)_c * vcodes_c + sum_c p * v_zero) / max(l, 1e-20)
// K and V are never dequantized.  The products q * code are exact in float32
// (a bf16 value times an integer below 16) and are summed in float32; p . V is
// float32 as well, as the TPU kernel keeps it, so no tensor-core product with
// rounded operands enters the result.
//
// On the TPU a triangular grid of (query block, key block) pairs is enumerated
// on the host for the largest offset and carries the softmax state from one
// grid step to the next.  Here a block owns TQ = 32 query rows of one query
// head and loops over the key blocks of TK = 64 slots up to the last one its
// rows can see, so fully masked key blocks are never visited and the grid needs
// no bound on the offset.  Per key block: the K and V codes become float32 in
// shared memory (K transposed, so that a thread reads 4 consecutive slots of
// one channel as one 16-byte word), then three phases: scores as 4 x 4
// register tiles, the online-softmax update with rows spread over lanes, and
// p . V as 8-row x 4-channel register tiles.  The running m, l live in shared
// memory, the output accumulator in registers.
//
// What bounds it: at T = 1024, 32 heads, the K/V codes and q/out are ~25 MB but
// the causal half of 2 x 128 multiply-adds per (query, key, head) is 8.6 G
// float32 multiply-adds outside the tensor cores: operations (67 TFLOP/s).
// The accumulations use fmaf, one instruction per multiply-add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;    // head_dim
constexpr int TQ = 32;    // query rows per block
constexpr int TK = 64;    // key slots per step
constexpr int KP = TK + 4;  // row pitch of the transposed K tile (16-byte aligned rows)
constexpr int NT = 128;   // threads per block
constexpr float NEG_INF = -1e30f;

struct Smem {
  float qT[D][TQ];     // q transposed: [channel][row]
  float kT[D][KP];     // K codes transposed: [channel][slot]
  float v[TK][D];      // V codes: [slot][channel]
  float pT[TK][TQ];    // scores, then p * v_scale: [slot][row]
  float ks[TK], kz[TK], vs[TK], vz[TK];
  float qsum[TQ], m[TQ], l[TQ], alpha[TQ], zsum[TQ];
  float red[3][NT / 32][TQ];  // per-warp partial max / sum p / sum p * v_zero
};

__global__ void __launch_bounds__(NT)
flash_code_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_codes,
                  const float* __restrict__ k_prm, const int8_t* __restrict__ v_codes,
                  const float* __restrict__ v_prm, __nv_bfloat16* __restrict__ out, int Tq, int Tk,
                  int HQ, int H, int groups, int row_offset, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * TQ, hq = blockIdx.y, h = hq / groups;

  // q tile -> shared (rows past Tq read as zero and are never stored)
  for (int r = 0; r < TQ; ++r) {
    const int row = q0 + r;
    sm.qT[tid][r] = row < Tq ? __bfloat162float(q[((size_t)row * HQ + hq) * D + tid]) : 0.f;
  }
  if (tid < TQ) {
    sm.m[tid] = NEG_INF;
    sm.l[tid] = 0.f;
  }
  __syncthreads();
  if (tid < TQ) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s += sm.qT[d][tid];
    sm.qsum[tid] = s;
  }

  // score tiles: rows sy*4.., slots sx*4..; output tiles: rows py*8.., channels px*4..
  const int sy = tid >> 4, sx = tid & 15;
  const int py = tid >> 5, px = tid & 31;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int last_row = row_offset + min(q0 + TQ, Tq) - 1;  // last position this block's rows hold
  const int n_kb = min((Tk + TK - 1) / TK, last_row / TK + 1);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * TK;
    __syncthreads();  // the previous step's reads of kT, v, pT are done; qsum is written
    for (int kk = 0; kk < TK; ++kk) {
      const int slot = k0 + kk;
      const bool in = slot < Tk;
      const size_t base = ((size_t)slot * H + h) * D + tid;
      sm.kT[tid][kk] = in ? (float)k_codes[base] : 0.f;
      sm.v[kk][tid] = in ? (float)v_codes[base] : 0.f;
    }
    if (tid < TK) {
      const int slot = k0 + tid;
      const bool in = slot < Tk;
      const size_t pb = ((size_t)slot * H + h) * 2;
      sm.ks[tid] = in ? k_prm[pb] : 0.f;
      sm.kz[tid] = in ? k_prm[pb + 1] : 0.f;
      sm.vs[tid] = in ? v_prm[pb] : 0.f;
      sm.vz[tid] = in ? v_prm[pb + 1] : 0.f;
    }
    __syncthreads();

    // --- scores: s[4 rows][4 slots] = q . kcodes, then the affine correction and the mask
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 qv = *reinterpret_cast<const float4*>(&sm.qT[d][sy * 4]);
        const float4 kv = *reinterpret_cast<const float4*>(&sm.kT[d][sx * 4]);
        const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
        const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = sy * 4 + i;
        const int pos = row_offset + q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = sx * 4 + j;
          const int slot = k0 + c;
          float sc = (s[i][j] * sm.ks[c] + sm.qsum[r] * sm.kz[c]) * sm_scale;
          if (slot > pos || slot >= Tk) sc = NEG_INF;
          sm.pT[c][r] = sc;
        }
      }
    }
    __syncthreads();

    // --- online softmax: warp w takes slots [w*16, w*16+16) of row r = lane
    {
      const int r = lane;
      const int c0 = warp * (TK / 4);
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < TK / 4; ++c) mx = fmaxf(mx, sm.pT[c0 + c][r]);
      sm.red[0][warp][r] = mx;
      __syncthreads();
      const float m_old = sm.m[r];
      const float m_new = fmaxf(fmaxf(fmaxf(sm.red[0][0][r], sm.red[0][1][r]),
                                      fmaxf(sm.red[0][2][r], sm.red[0][3][r])), m_old);
      const int pos = row_offset + q0 + r;
      float ls = 0.f, zs = 0.f;
#pragma unroll
      for (int c = 0; c < TK / 4; ++c) {
        const int slot = k0 + c0 + c;
        const bool valid = slot <= pos && slot < Tk;
        const float p = valid ? expf(sm.pT[c0 + c][r] - m_new) : 0.f;
        ls += p;
        zs = fmaf(p, sm.vz[c0 + c], zs);
        sm.pT[c0 + c][r] = p * sm.vs[c0 + c];
      }
      sm.red[1][warp][r] = ls;
      sm.red[2][warp][r] = zs;
      __syncthreads();  // every thread has read m[r]; the partial sums and pT are written
      if (warp == 0) {
        const float a = expf(m_old - m_new);
        sm.alpha[r] = a;
        sm.m[r] = m_new;
        sm.l[r] = sm.l[r] * a + (sm.red[1][0][r] + sm.red[1][1][r] + sm.red[1][2][r] + sm.red[1][3][r]);
        sm.zsum[r] = sm.red[2][0][r] + sm.red[2][1][r] + sm.red[2][2][r] + sm.red[2][3][r];
      }
    }
    __syncthreads();

    // --- p . V: pv[8 rows][4 channels], then acc = acc * alpha + pv + zsum
    {
      float pv[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) pv[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < TK; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(&sm.v[c][px * 4]);
        const float4 p0 = *reinterpret_cast<const float4*>(&sm.pT[c][py * 8]);
        const float4 p1 = *reinterpret_cast<const float4*>(&sm.pT[c][py * 8 + 4]);
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
        const float pa[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) pv[i][j] = fmaf(pa[i], va[j], pv[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = sm.alpha[py * 8 + i], z = sm.zsum[py * 8 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = acc[i][j] * a + pv[i][j] + z;
      }
    }
  }
  __syncthreads();  // the last step's l is written

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = py * 8 + i, row = q0 + r;
    if (row >= Tq) continue;
    const float l = fmaxf(sm.l[r], 1e-20f);
    __nv_bfloat16* o = out + ((size_t)row * HQ + hq) * D + px * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = __float2bfloat16_rn(acc[i][j] / l);
  }
}

}  // namespace

extern "C" int atom_flash_code_attention(const void* q, const void* k_codes, const void* k_prm,
                                         const void* v_codes, const void* v_prm, void* out, int Tq,
                                         int Tk, int HQ, int H, int groups, int row_offset,
                                         float sm_scale, void* stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_code_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  flash_code_kernel<<<dim3((Tq + TQ - 1) / TQ, HQ), NT, sizeof(Smem), (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)k_codes, (const float*)k_prm, (const int8_t*)v_codes,
      (const float*)v_prm, (__nv_bfloat16*)out, Tq, Tk, HQ, H, groups, row_offset, sm_scale);
  return (int)cudaGetLastError();
}
