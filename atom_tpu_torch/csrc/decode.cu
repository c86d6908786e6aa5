// Decode attention over pages + hot ring (K3), the ring -> pages flush (K4) and
// decode attention over the pages alone with its softmax state (K11).
//
// K3 replaces atom_tpu/ops/pallas_decode.py:416 paged_ring_decode_attention
// (_decode_ring_kernel :195, _decode_page_step :335).  One block per
// (sequence, kv head), one thread per head channel (head_dim 128).  The block
// walks the ring first, then the sequence's flushed pages in order, as the TPU
// grid does; a loop in the block takes the place of the TPU's sequential page
// grid axis.  Each chunk (ring: W lanes, page: S slots) runs one step of the
// online softmax for the G query heads of this kv head (GQA, kv-head-major q):
//   score = ((q . codes) * k_scale + sum(q) * k_zero) * sm_scale
//   p = exp(score - m), masked lanes -1e30 / p = 0
//   acc = acc * alpha + sum_s (p * v_scale)_s * vcode_s + sum_s p * v_zero
// K and V stay 4-bit codes; their affine dequantization folds into the score
// and into p, as in the TPU kernel.  Ring lanes are valid when
// (row - col + W) % W < n_hot; page slots when pos < seq_len (the flushed
// length).  Output acc / max(l, 1e-20) in bf16.
//
// What bounds it: the INT4 K/V bytes and bf16 params of each sequence's
// pages and ring, read once (~1.1 MB per sequence and layer at context 512):
// memory bound.  Design: threads read K channel-plane bytes slot-contiguous
// and V slot-plane bytes channel-contiguous, so every load is coalesced; the
// scores and p live in shared memory only.  A split over pages for long
// contexts (more blocks per sequence plus a merge) is later work.
//
// K4 replaces :720 flush_hot_pallas (_flush_kernel :647).  The TPU version
// runs two aliased passes (first page, wrapped page) and rewrites whole page
// blocks with a select, the sink page 0 included.  Blocks here run
// concurrently, so each block (sequence, kv head) writes only the valid lanes
// of the ring block [lo, hi) into its one or two pages, both passes in one
// block; a V byte holds two slots, so its nibble is merged by a
// read-modify-write of that byte, which only this block touches (W <= S/2).
// Inactive sequences have no valid lane and write nothing.  Bound: a few
// hundred KB per layer every W-th step, launch latency dominates.
//
// K11 replaces :533 paged_decode_attention_rotated (_decode_kernel :74, the page
// step of :335, the finalize of :187): K3 without the ring, returning also the
// online-softmax state m, l per query row so that the caller merges it with a
// second part (the ring, or a prompt chunk's own keys).  The mixed step calls it
// with the decode batch (G = HQ / H query rows per kv head) and with one
// sequence whose query axis holds all C queries of a prompt chunk (G * C rows
// per kv head: 256 at 7B, 2048 for 64 q / 8 kv heads).  Registers and shared
// memory hold GMAX query rows, so the grid gets a third axis over tiles of
// GMAX rows; every tile of a (sequence, kv head) walks the same pages, which
// the first tile brings into L2 for the others.  A sequence with nothing
// flushed walks no page and stores out = 0, m = -1e30, l = 0.  Bound: the
// pages' bytes read once (memory); the design re-reads them once per tile
// from L2, and each tile is latency-bound as K3 is.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;   // head_dim: one thread per channel
constexpr int DH = D / 2;
constexpr int GMAX = 8;  // query heads per kv head
constexpr int NWARPS = D / 32;
constexpr float NEG_INF = -1e30f;

struct BlockRed {
  float v[NWARPS][GMAX];
};

// Reduce v[0..G) over the block (max or sum); every thread gets the result.
template <bool MAX>
__device__ __forceinline__ void block_reduce(float (&v)[GMAX], int G, BlockRed& red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
    float x = v[g];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x, o);
      x = MAX ? fmaxf(x, y) : __fadd_rn(x, y);
    }
    if (lane == 0) red.v[warp][g] = x;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
    float x = red.v[0][g];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) x = MAX ? fmaxf(x, red.v[w][g]) : __fadd_rn(x, red.v[w][g]);
    v[g] = x;
  }
  __syncthreads();
}

struct Chunk {
  const int8_t* k;            // [D/2][L] channel-plane bytes, row stride L
  const __nv_bfloat16* prm;   // plane j at prm + j * plane_stride, lane-indexed
  size_t plane_stride;
  const int8_t* v;            // ring: [L][D] codes; page: [L/2][D] slot-plane bytes
  int L;
};

// One online-softmax step over a chunk of L lanes.
template <bool RING>
__device__ void attend_chunk(const Chunk& ch, int G, const float (*qs)[D], const float* qsum,
                             float* pw /* [G][L] shared */, BlockRed& red, float sm_scale,
                             int valid_a, int valid_b, float (&m)[GMAX], float (&l)[GMAX],
                             float (&acc)[GMAX]) {
  // RING: lane valid iff (valid_a - lane + L) % L < valid_b   (row, n_hot)
  // page: lane valid iff valid_a + lane < valid_b             (pos0, seq_len)
  const int tid = threadIdx.x;
  const int L = ch.L;
  float mx[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) mx[g] = NEG_INF;
  for (int s = tid; s < L; s += D) {
    const bool valid = RING ? ((valid_a - s + L) % L) < valid_b : valid_a + s < valid_b;
    float dlo[GMAX], dhi[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) dlo[g] = dhi[g] = 0.f;
    for (int c = 0; c < DH; ++c) {
      const int byte = (uint8_t)ch.k[(size_t)c * L + s];
      const float lo = (float)(byte & 0x0F), hi = (float)(byte >> 4);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        dlo[g] = __fadd_rn(dlo[g], __fmul_rn(qs[g][c], lo));
        dhi[g] = __fadd_rn(dhi[g], __fmul_rn(qs[g][c + DH], hi));
      }
    }
    const float ks = __bfloat162float(ch.prm[s]);
    const float kz = __bfloat162float(ch.prm[ch.plane_stride + s]);
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      float sc = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(dlo[g], dhi[g]), ks), __fmul_rn(qsum[g], kz)),
                           sm_scale);
      if (!valid) sc = NEG_INF;
      pw[g * L + s] = sc;
      mx[g] = fmaxf(mx[g], sc);
    }
  }
  block_reduce<true>(mx, G, red);
  float alpha[GMAX], ls[GMAX], zs[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
    const float m_new = fmaxf(m[g], mx[g]);
    alpha[g] = expf(__fsub_rn(m[g], m_new));
    m[g] = m_new;
    ls[g] = 0.f;
    zs[g] = 0.f;
  }
  for (int s = tid; s < L; s += D) {
    const bool valid = RING ? ((valid_a - s + L) % L) < valid_b : valid_a + s < valid_b;
    const float vs = __bfloat162float(ch.prm[2 * ch.plane_stride + s]);
    const float vz = __bfloat162float(ch.prm[3 * ch.plane_stride + s]);
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) break;
      const float p = valid ? expf(__fsub_rn(pw[g * L + s], m[g])) : 0.f;
      ls[g] = __fadd_rn(ls[g], p);
      zs[g] = __fadd_rn(zs[g], __fmul_rn(p, vz));
      pw[g * L + s] = __fmul_rn(p, vs);
    }
  }
  block_reduce<false>(ls, G, red);  // its __syncthreads also publishes pw
  block_reduce<false>(zs, G, red);
  float pv[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) pv[g] = 0.f;
  const int d = tid;
  if (RING) {
    for (int s = 0; s < L; ++s) {
      const float code = (float)ch.v[(size_t)s * D + d];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        pv[g] = __fadd_rn(pv[g], __fmul_rn(pw[g * L + s], code));
      }
    }
  } else {
    const int half = L / 2;
    for (int r = 0; r < half; ++r) {
      const int byte = (uint8_t)ch.v[(size_t)r * D + d];
      const float lo = (float)(byte & 0x0F), hi = (float)(byte >> 4);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) break;
        pv[g] = __fadd_rn(pv[g], __fadd_rn(__fmul_rn(pw[g * L + r], lo), __fmul_rn(pw[g * L + r + half], hi)));
      }
    }
  }
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
    acc[g] = __fadd_rn(__fadd_rn(__fmul_rn(acc[g], alpha[g]), pv[g]), zs[g]);
    l[g] = __fadd_rn(__fmul_rn(l[g], alpha[g]), ls[g]);
  }
  __syncthreads();  // pw is rewritten by the next chunk
}

// Load G query rows (row0 ...) into shared memory as float32 with their channel sums.
__device__ __forceinline__ void load_queries(const __nv_bfloat16* __restrict__ q, size_t row0, int G,
                                             float (*qs)[D], float* qsum, BlockRed& red) {
  const int d = threadIdx.x;
  float sums[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    sums[g] = 0.f;
    if (g < G) {
      qs[g][d] = __bfloat162float(q[(row0 + g) * D + d]);
      sums[g] = qs[g][d];
    }
  }
  block_reduce<false>(sums, G, red);
  if (d < G) qsum[d] = sums[d];
  __syncthreads();
}

// Walk sequence b's flushed pages of kv head h in order, one online-softmax step per page.
__device__ __forceinline__ void attend_pages(const int8_t* __restrict__ k_pages,
                                             const __nv_bfloat16* __restrict__ params,
                                             const int8_t* __restrict__ v_pages,
                                             const int* __restrict__ table_row, int seq_len, int H, int h,
                                             int S, int max_pages, int G, const float (*qs)[D],
                                             const float* qsum, float* pw, BlockRed& red, float sm_scale,
                                             float (&m)[GMAX], float (&l)[GMAX], float (&acc)[GMAX]) {
  const int n_pg = min((seq_len + S - 1) / S, max_pages);
  for (int i = 0; i < n_pg; ++i) {
    const size_t p = (size_t)table_row[i];
    Chunk pg;
    pg.k = k_pages + (p * H + h) * DH * S;
    pg.prm = params + (p * 4 * H + h) * S;
    pg.plane_stride = (size_t)H * S;
    pg.v = v_pages + (p * H + h) * (S / 2) * D;
    pg.L = S;
    attend_chunk<false>(pg, G, qs, qsum, pw, red, sm_scale, i * S, seq_len, m, l, acc);
  }
}

__global__ void __launch_bounds__(D)
paged_ring_decode_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_pages,
                         const __nv_bfloat16* __restrict__ params, const int8_t* __restrict__ v_pages,
                         const int* __restrict__ page_table, const int* __restrict__ seq_lens,
                         const int8_t* __restrict__ ring_k, const __nv_bfloat16* __restrict__ ring_prm,
                         const int8_t* __restrict__ ring_v, const int* __restrict__ n_hot,
                         __nv_bfloat16* __restrict__ out, int HQ, int H, int S, int W, int max_pages,
                         int row, float sm_scale) {
  extern __shared__ float pw[];  // [G][max(S, W)]
  __shared__ float qs[GMAX][D];
  __shared__ float qsum[GMAX];
  __shared__ BlockRed red;
  const int b = blockIdx.x, h = blockIdx.y, d = threadIdx.x;
  const int G = HQ / H;
  load_queries(q, (size_t)b * HQ + h * G, G, qs, qsum, red);

  float m[GMAX], l[GMAX], acc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
    acc[g] = 0.f;
  }

  Chunk ring;
  ring.k = ring_k + ((size_t)b * H + h) * DH * W;
  ring.prm = ring_prm + ((size_t)b * 4 * H + h) * W;
  ring.plane_stride = (size_t)H * W;
  ring.v = ring_v + ((size_t)b * H + h) * W * D;
  ring.L = W;
  attend_chunk<true>(ring, G, qs, qsum, pw, red, sm_scale, row, n_hot[b], m, l, acc);

  attend_pages(k_pages, params, v_pages, page_table + (size_t)b * max_pages, seq_lens[b], H, h, S, max_pages, G,
               qs, qsum, pw, red, sm_scale, m, l, acc);

#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
    out[((size_t)b * HQ + h * G + g) * D + d] = __float2bfloat16_rn(__fdiv_rn(acc[g], fmaxf(l[g], 1e-20f)));
  }
}

// K11: pages only.  Block (b, h, tile) owns query rows [tile*GMAX, ...) of the
// HQ / H rows of kv head h (q is kv-head-major).
__global__ void __launch_bounds__(D)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_pages,
                    const __nv_bfloat16* __restrict__ params, const int8_t* __restrict__ v_pages,
                    const int* __restrict__ page_table, const int* __restrict__ seq_lens,
                    void* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                    int HQ, int H, int S, int max_pages, int out_f32, float sm_scale) {
  extern __shared__ float pw[];  // [GMAX][S]
  __shared__ float qs[GMAX][D];
  __shared__ float qsum[GMAX];
  __shared__ BlockRed red;
  const int b = blockIdx.x, h = blockIdx.y, d = threadIdx.x;
  const int rows_per_head = HQ / H;
  const int g0 = blockIdx.z * GMAX;
  const int G = min(GMAX, rows_per_head - g0);
  const size_t row0 = (size_t)b * HQ + (size_t)h * rows_per_head + g0;  // first query row of the tile
  load_queries(q, row0, G, qs, qsum, red);

  float m[GMAX], l[GMAX], acc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
    acc[g] = 0.f;
  }

  attend_pages(k_pages, params, v_pages, page_table + (size_t)b * max_pages, seq_lens[b], H, h, S, max_pages, G,
               qs, qsum, pw, red, sm_scale, m, l, acc);

#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) break;
    const float o = __fdiv_rn(acc[g], fmaxf(l[g], 1e-20f));
    if (out_f32)
      static_cast<float*>(out)[(row0 + g) * D + d] = o;
    else
      static_cast<__nv_bfloat16*>(out)[(row0 + g) * D + d] = __float2bfloat16_rn(o);
    if (d == 0) {
      m_out[row0 + g] = m[g];
      l_out[row0 + g] = l[g];
    }
  }
}

__global__ void __launch_bounds__(256)
flush_kernel(const int8_t* __restrict__ k_flush, const __nv_bfloat16* __restrict__ prm_flush,
             const int8_t* __restrict__ v_flush, const int* __restrict__ page_a,
             const int* __restrict__ page_b, const int* __restrict__ slot0, const int* __restrict__ o,
             const int* __restrict__ lo, const int* __restrict__ hi, int8_t* __restrict__ k_pages,
             __nv_bfloat16* __restrict__ params, int8_t* __restrict__ v_pages, int H, int S, int W,
             int Dh) {
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int dhalf = Dh / 2;
  const int start = slot0[b] + o[b];  // global slot of the block's token 0
  const int g_lo = lo[b], g_hi = hi[b];
  for (int pass = 0; pass < 2; ++pass) {
    const size_t pg = (size_t)(pass ? page_b[b] : page_a[b]);
    const int lane0 = slot0[b] + pass * S;  // global slot of this page's lane 0
    for (int idx = tid; idx < dhalf * W; idx += blockDim.x) {
      const int c = idx / W, t = idx % W;
      const int gs = start + t, lane = gs - lane0;
      if (lane >= 0 && lane < S && gs >= g_lo && gs < g_hi)
        k_pages[((pg * H + h) * dhalf + c) * S + lane] = k_flush[(((size_t)b * H + h) * dhalf + c) * W + t];
    }
    for (int idx = tid; idx < 4 * W; idx += blockDim.x) {
      const int j = idx / W, t = idx % W;
      const int gs = start + t, lane = gs - lane0;
      if (lane >= 0 && lane < S && gs >= g_lo && gs < g_hi)
        params[((pg * 4 + j) * H + h) * S + lane] = prm_flush[(((size_t)b * 4 + j) * H + h) * W + t];
    }
    for (int idx = tid; idx < W * Dh; idx += blockDim.x) {
      const int t = idx / Dh, d = idx % Dh;
      const int gs = start + t, lane = gs - lane0;
      if (lane >= 0 && lane < S && gs >= g_lo && gs < g_hi) {
        const int r = lane % (S / 2);
        uint8_t* dst = reinterpret_cast<uint8_t*>(v_pages) + ((pg * H + h) * (S / 2) + r) * Dh + d;
        const uint8_t code = (uint8_t)v_flush[(((size_t)b * H + h) * W + t) * Dh + d] & 0x0F;
        *dst = lane >= S / 2 ? (uint8_t)((*dst & 0x0F) | (code << 4)) : (uint8_t)((*dst & 0xF0) | code);
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int atom_paged_ring_decode(const void* q, const void* k_pages, const void* params,
                                      const void* v_pages, const void* page_table,
                                      const void* seq_lens, const void* ring_k,
                                      const void* ring_prm, const void* ring_v, const void* n_hot,
                                      void* out, int B, int HQ, int H, int S, int W, int max_pages,
                                      int row, float sm_scale, void* stream) {
  const int G = HQ / H;
  const size_t smem = (size_t)G * (S > W ? S : W) * sizeof(float);
  paged_ring_decode_kernel<<<dim3(B, H), D, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)k_pages, (const __nv_bfloat16*)params,
      (const int8_t*)v_pages, (const int*)page_table, (const int*)seq_lens, (const int8_t*)ring_k,
      (const __nv_bfloat16*)ring_prm, (const int8_t*)ring_v, (const int*)n_hot,
      (__nv_bfloat16*)out, HQ, H, S, W, max_pages, row, sm_scale);
  return (int)cudaGetLastError();
}

extern "C" int atom_flush_hot(const void* k_flush, const void* prm_flush, const void* v_flush,
                              const void* page_a, const void* page_b, const void* slot0,
                              const void* o, const void* lo, const void* hi, void* k_pages,
                              void* params, void* v_pages, int B, int H, int S, int W, int Dh,
                              void* stream) {
  flush_kernel<<<dim3(B, H), 256, 0, (cudaStream_t)stream>>>(
      (const int8_t*)k_flush, (const __nv_bfloat16*)prm_flush, (const int8_t*)v_flush,
      (const int*)page_a, (const int*)page_b, (const int*)slot0, (const int*)o, (const int*)lo,
      (const int*)hi, (int8_t*)k_pages, (__nv_bfloat16*)params, (int8_t*)v_pages, H, S, W, Dh);
  return (int)cudaGetLastError();
}

extern "C" int atom_paged_decode(const void* q, const void* k_pages, const void* params,
                                 const void* v_pages, const void* page_table, const void* seq_lens,
                                 void* out, void* m_out, void* l_out, int B, int HQ, int H, int S,
                                 int max_pages, int out_f32, float sm_scale, void* stream) {
  const int tiles = (HQ / H + GMAX - 1) / GMAX;
  const size_t smem = (size_t)GMAX * S * sizeof(float);
  paged_decode_kernel<<<dim3(B, H, tiles), D, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)k_pages, (const __nv_bfloat16*)params,
      (const int8_t*)v_pages, (const int*)page_table, (const int*)seq_lens, out, (float*)m_out,
      (float*)l_out, HQ, H, S, max_pages, out_f32, sm_scale);
  return (int)cudaGetLastError();
}
