// Decode attention over pages + hot ring (K3), the ring -> pages flush (K4) and
// decode attention over the pages alone with its softmax state (K11).
//
// K3 replaces atom_tpu/ops/pallas_decode.py:416 paged_ring_decode_attention
// (_decode_ring_kernel :195, _decode_page_step :335).  For the G query heads
// of each kv head (GQA, kv-head-major q), over the ring's W lanes and the
// sequence's flushed page slots:
//   score = ((q . codes) * k_scale + sum(q) * k_zero) * sm_scale
//   p = exp(score - m), masked lanes p = 0
//   out = (sum_s (p * v_scale)_s * vcode_s + sum_s p * v_zero) / max(sum_s p, 1e-20)
// K and V stay 4-bit codes; their affine dequantization folds into the score
// and into p, as in the TPU kernel.  Ring lanes are valid when
// (row - col + W) % W < n_hot; page slots when pos < seq_len (the flushed
// length).  Output in bf16; a row with nothing to attend to is a zero row.
//
// What bounds it: the INT4 K/V bytes and bf16 params of each sequence's
// pages and ring, read once (~70 MB per layer at batch 32, context 512, 7B):
// memory bound, 0.021 ms at 3.35 TB/s.  Design (paged_ring_stream_kernel):
// one block of 128 threads per (sequence, kv head) walks the ring, then the
// sequence's page-table columns up to its last flushed page.  Copies are 1-D
// bulk copies into shared memory that complete on mbarriers: the ring whole,
// a page in three parts through one small buffer: K [64][S] bytes, then V
// [S/2][128] over it as soon as q.K is done with K, and the four param planes
// beside them; the next page's params are copied in once this page's p's are
// made, its K once p.V is done.  The small buffer (27 KB a block at MHA)
// keeps 8 blocks on an SM, so that batch 32 x 32 kv heads runs as one wave.
// Per chunk, from shared memory with 4-byte reads: q.K partials over slices
// of the channel rows for 4 slots a thread, the scores and one block max, p;
// then p.V with each warp on a quarter of the V rows and each lane on 4
// channels; a code becomes a float in one byte permute and one subtraction.
// A thread keeps its own shares of l, sum p * v_zero and of its warp's p.V
// partial across chunks, rescaled by the online softmax's alpha, so a chunk
// costs one block reduction (the max).  A row with nothing to attend to is
// written as zeros.  One launch, no workspace, no atomics, deterministic.
// Explicit multiply-adds (held within a tolerance, not bitwise).
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
// from L2, and each tile is latency-bound (one block walks every page in turn).

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

// ---------------------------------------------------------------------------
// K3: paged_ring_stream_kernel (see the note at the top of this file)
// ---------------------------------------------------------------------------

namespace {

constexpr int K3_THREADS = 128;
constexpr int K3_WARPS = K3_THREADS / 32;
constexpr int SLICED = 4 * K3_THREADS;   // (K3_THREADS / (L / 4)) channel slices x L slots, for any L

// G query rows padded to the width of one vector access of shared memory
__host__ __device__ constexpr int padded(int g) { return g == 1 ? 1 : g == 2 ? 2 : g <= 4 ? 4 : 8; }

// Staged bytes of a page (K [64][S] or V [S/2][128] nibble pairs in turn,
// then params [4][S] bf16) and of the ring (K [64][W], params [4][W], V
// [W][128] codes).
__host__ __device__ inline int page_bytes(int S) { return 72 * S; }
__host__ __device__ inline int ring_bytes(int W) { return 200 * W; }

// Byte offsets in the dynamic shared memory (all multiples of 16).
struct Layout {
  int pages, ring, bars, qs, part, red, total;
};

__host__ __device__ inline Layout k3_layout(int G, int S, int W) {
  const int gp = padded(G);
  Layout y;
  int o = 0;
  y.pages = o;  // one page: K [64][S], then V [S/2][128], in the same 64 S bytes; params [4][S]
  o += page_bytes(S);
  y.ring = o;
  o += ring_bytes(W);
  y.bars = o;  // mbarriers: the ring's; the page's K, params and V
  o += 32;
  y.qs = o;  // q as float [128][gp]
  o += D * gp * 4;
  // q.K partials [slices][L][gp]; slice 0 then holds the scores and p * v_scale
  // ([L][gp]); at the end the warps' p.V partials [K3_WARPS][G][128]
  y.part = o;
  o += SLICED * gp * 4;
  y.red = o;  // [2][K3_WARPS][G]
  o += (2 * K3_WARPS * G * 4 + 15) & ~15;
  y.total = o;
  return y;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void k3_mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void k3_mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void k3_mbar_wait(uint64_t* bar, int phase) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(phase) : "memory");
}

// `bytes` (a multiple of 16) from global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// The four nibble codes in the low (HI = false) or high nibbles of x's bytes
// as floats, exactly: one byte permute puts each code under the exponent of
// 2^23, one subtraction takes 2^23 off.
template <bool HI>
__device__ __forceinline__ void nibbles(uint32_t x, float (&f)[4]) {
  const uint32_t c = (HI ? x >> 4 : x) & 0x0F0F0F0Fu;
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] = __uint_as_float(__byte_perm(c, 0x4B000000u, 0x7440 + k)) - 8388608.f;
}

// The four signed int8 codes of x (the ring's V) as floats, exactly.
__device__ __forceinline__ void signed_bytes(uint32_t x, float (&f)[4]) {
  const uint32_t u = x ^ 0x80808080u;  // code + 128
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + k)) - 8388736.f;  // - 2^23 - 128
}

// N floats of shared memory (N = 1, 2, 4 or 8, 16-byte aligned where N >= 4)
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&v)[N]) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x, v[i + 1] = t.y, v[i + 2] = t.z, v[i + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void sts(float* p, const float (&v)[N]) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int i = 0; i < N; i += 4) *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

template <int G>
__global__ void __launch_bounds__(K3_THREADS)
paged_ring_stream_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_pages,
                         const __nv_bfloat16* __restrict__ params, const int8_t* __restrict__ v_pages,
                         const int* __restrict__ page_table, const int* __restrict__ seq_lens,
                         const int8_t* __restrict__ ring_k, const __nv_bfloat16* __restrict__ ring_prm,
                         const int8_t* __restrict__ ring_v, const int* __restrict__ n_hot,
                         __nv_bfloat16* __restrict__ out, int H, int S, int W, int max_pages, int row,
                         float sm_scale) {
  constexpr int GP = padded(G);
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x, h = blockIdx.y, HQ = H * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Layout y = k3_layout(G, S, W);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + y.bars);  // [0] ring, [1] K, [2] params, [3] V
  float* qs = reinterpret_cast<float*>(smem + y.qs);
  float* part = reinterpret_cast<float*>(smem + y.part);
  float* red = reinterpret_cast<float*>(smem + y.red);
  __nv_bfloat16* orow = out + ((size_t)b * HQ + h * G) * D;  // this kv head's G output rows

  // the sequence's lengths and its first page, loaded together
  const int seq_len = seq_lens[b], nh_b = n_hot[b];
  const int first_page = max_pages > 0 ? page_table[(size_t)b * max_pages] : 0;
  const int n_page = max(min((seq_len + S - 1) / S, max_pages), 0);
  if (n_page == 0 && nh_b <= 0) {  // an idle row: a zero row
    for (int e = tid; e < G * D; e += K3_THREADS) orow[e] = __float2bfloat16_rn(0.f);
    return;
  }
  // the chunks: the ring (if it holds a token), then the page-table columns
  // up to the sequence's last flushed page
  const int has_ring = nh_b > 0 ? 1 : 0;
  const int n_chunks = has_ring + n_page;

  // The pages pass through one buffer (thread 0 copies, each part on
  // its mbarrier): K, then V over it once q.K is done with K, and the params
  // beside them; the next page's params are copied in once this page's p's
  // are made, its K once p.V is done with V.  A small buffer keeps 8 blocks
  // on an SM, so that batch 32 x 32 kv heads runs as one wave.
  unsigned char* pb = smem + y.pages;
  size_t cur = (size_t)first_page;  // thread 0: the page being computed
  auto issue_k = [&](size_t p) {
    k3_mbar_expect(bars + 1, DH * S);
    bulk_copy(pb, k_pages + (p * H + h) * DH * S, DH * S, bars + 1);
  };
  auto issue_prm = [&](size_t p) {
    k3_mbar_expect(bars + 2, 8 * S);
    for (int j = 0; j < 4; ++j) bulk_copy(pb + DH * S + j * 2 * S, params + ((p * 4 + j) * H + h) * S, 2 * S, bars + 2);
  };
  auto issue_v = [&](size_t p) {
    k3_mbar_expect(bars + 3, S / 2 * D);
    bulk_copy(pb, v_pages + (p * H + h) * (S / 2) * D, S / 2 * D, bars + 3);
  };

  if (tid == 0) {
    for (int i = 0; i < 4; ++i) k3_mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (has_ring) {
      unsigned char* dst = smem + y.ring;
      k3_mbar_expect(bars, ring_bytes(W));
      bulk_copy(dst, ring_k + ((size_t)b * H + h) * DH * W, DH * W, bars);
      for (int j = 0; j < 4; ++j)
        bulk_copy(dst + DH * W + j * 2 * W, ring_prm + ((size_t)(b * 4 + j) * H + h) * W, 2 * W, bars);
      bulk_copy(dst + 72 * W, ring_v + ((size_t)b * H + h) * W * D, W * D, bars);
    }
    if (n_page > 0) {
      issue_k(first_page);
      issue_prm(first_page);
    }
  }
  // the G query rows as float [128][GP], and their channel sums, while the copies fly
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    const float x = g < G ? __bfloat162float(q[((size_t)b * HQ + h * G + g) * D + tid]) : 0.f;
    qs[tid * GP + g] = x;
    float v = x;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0 && g < G) red[warp * G + g] = v;
  }
  __syncthreads();  // q, its sums and the copies' barriers
  float qsum[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float v = red[g];
#pragma unroll
    for (int w = 1; w < K3_WARPS; ++w) v += red[w * G + g];
    qsum[g] = v;
  }
  __syncthreads();  // red is rewritten below

  // online-softmax state: m is the same in every thread; l, sum p * v_zero
  // and the p.V partial (this warp's V rows, this lane's 4 channels) are the
  // thread's own shares
  float m[G], lp[G], zp[G], acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    lp[g] = zp[g] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[g][k] = 0.f;
  }

  for (int i = 0; i < n_chunks; ++i) {
    const bool ring = has_ring && i == 0;
    const int pi = i - has_ring;  // the page-table column
    const int L = ring ? W : S, pos0 = ring ? 0 : pi * S;
    const unsigned char* cb = ring ? smem + y.ring : pb;
    const __nv_bfloat16* prm = reinterpret_cast<const __nv_bfloat16*>(cb + DH * L);
    // the next page's id, read ahead (thread 0 issues its copies)
    const bool has_next = tid == 0 && !ring && pi + 1 < n_page;
    const size_t next = has_next ? (size_t)page_table[(size_t)b * max_pages + pi + 1] : 0;
    k3_mbar_wait(ring ? bars : bars + 1, ring ? 0 : pi & 1);

    // q.K partials: thread = (slot group j of 4 slots, channel-row slice cs)
    {
      const int nsg = L / 4, rows = DH / (K3_THREADS / nsg);
      const int j = tid % nsg, cs = tid / nsg;
      float d[G][4];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int k = 0; k < 4; ++k) d[g][k] = 0.f;
#pragma unroll 4
      for (int r = 0; r < rows; ++r) {
        const int c = cs * rows + r;
        const uint32_t x = *reinterpret_cast<const uint32_t*>(cb + c * L + 4 * j);
        float lo[4], hi[4], ql[GP], qh[GP];
        nibbles<false>(x, lo);
        nibbles<true>(x, hi);
        lds<GP>(qs + c * GP, ql);
        lds<GP>(qs + (c + DH) * GP, qh);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int k = 0; k < 4; ++k) d[g][k] = __fmaf_rn(qh[g], hi[k], __fmaf_rn(ql[g], lo[k], d[g][k]));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v[GP];
#pragma unroll
        for (int g = 0; g < GP; ++g) v[g] = g < G ? d[g][k] : 0.f;
        sts<GP>(part + ((size_t)cs * L + 4 * j + k) * GP, v);
      }
    }
    __syncthreads();  // K is read
    if (tid == 0 && !ring) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the reads above before the copy's writes
      issue_v(cur);
    }
    if (!ring) k3_mbar_wait(bars + 2, pi & 1);

    // scores (dot = the sum of the partials) and the chunk's max;
    // slot s's scores overwrite its slice-0 partials ([L][GP])
    const int slices = K3_THREADS / (L / 4);
    float mx[G];
#pragma unroll
    for (int g = 0; g < G; ++g) mx[g] = NEG_INF;
    for (int s = tid; s < L; s += K3_THREADS) {
      const bool valid = ring ? ((row - s + L) % L) < nh_b : pos0 + s < seq_len;
      const float ks = __bfloat162float(prm[s]), kz = __bfloat162float(prm[L + s]);
      float a[GP], t[GP];
      lds<GP>(part + s * GP, a);
      for (int c = 1; c < slices; ++c) {
        lds<GP>(part + ((size_t)c * L + s) * GP, t);
#pragma unroll
        for (int g = 0; g < G; ++g) a[g] += t[g];
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        a[g] = valid ? __fmaf_rn(a[g], ks, qsum[g] * kz) * sm_scale : NEG_INF;
        mx[g] = fmaxf(mx[g], a[g]);
      }
      sts<GP>(part + s * GP, a);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float v = mx[g];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (lane == 0) red[warp * G + g] = v;
    }
    __syncthreads();
    float alpha[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float cm = red[g];
#pragma unroll
      for (int w = 1; w < K3_WARPS; ++w) cm = fmaxf(cm, red[w * G + g]);
      const float m_new = fmaxf(m[g], cm);
      alpha[g] = expf(m[g] - m_new);
      m[g] = m_new;
      lp[g] *= alpha[g];
      zp[g] *= alpha[g];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[g][k] *= alpha[g];
    }

    // p, and p * v_scale for the p.V pass
    for (int s = tid; s < L; s += K3_THREADS) {
      const bool valid = ring ? ((row - s + L) % L) < nh_b : pos0 + s < seq_len;
      const float vs = __bfloat162float(prm[2 * L + s]), vz = __bfloat162float(prm[3 * L + s]);
      float a[GP];
      lds<GP>(part + s * GP, a);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = valid ? expf(a[g] - m[g]) : 0.f;
        a[g] = valid ? p * vs : 0.f;
        lp[g] += p;
        zp[g] = __fmaf_rn(p, valid ? vz : 0.f, zp[g]);
      }
      sts<GP>(part + s * GP, a);
    }
    __syncthreads();  // the params are read
    if (has_next) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue_prm(next);
    }
    if (!ring) k3_mbar_wait(bars + 3, pi & 1);

    // p.V: warp w on a quarter of the V rows, lane on channels 4 lane .. 4 lane + 3
    const unsigned char* vb = (ring ? cb + 72 * L : pb) + 4 * lane;
    if (ring) {
      const int rpw = L / K3_WARPS;
#pragma unroll 4
      for (int r = warp * rpw; r < (warp + 1) * rpw; ++r) {
        float v[4], p[GP];
        signed_bytes(*reinterpret_cast<const uint32_t*>(vb + r * D), v);
        lds<GP>(part + r * GP, p);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[g][k] = __fmaf_rn(p[g], v[k], acc[g][k]);
      }
    } else {
      const int half = L / 2, rpw = half / K3_WARPS;
#pragma unroll 4
      for (int r = warp * rpw; r < (warp + 1) * rpw; ++r) {
        const uint32_t x = *reinterpret_cast<const uint32_t*>(vb + r * D);
        float lo[4], hi[4], p0[GP], p1[GP];
        nibbles<false>(x, lo);
        nibbles<true>(x, hi);
        lds<GP>(part + r * GP, p0);
        lds<GP>(part + (r + half) * GP, p1);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[g][k] = __fmaf_rn(p1[g], hi[k], __fmaf_rn(p0[g], lo[k], acc[g][k]));
      }
    }
    __syncthreads();  // V (or the ring) and the p's are read
    if (has_next) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue_k(next);
      cur = next;
    }
  }

  // l and sum p * v_zero over the block, the warps' p.V partials added in
  // warp order, sum p * v_zero added to every channel; out = acc / max(l, 1e-20)
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float a = lp[g], z = zp[g];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      z += __shfl_xor_sync(0xffffffffu, z, o);
    }
    if (lane == 0) {
      red[warp * G + g] = a;
      red[(K3_WARPS + warp) * G + g] = z;
    }
    *reinterpret_cast<float4*>(part + (warp * G + g) * D + 4 * lane) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float a = red[g], z = red[K3_WARPS * G + g], v = part[g * D + tid];
#pragma unroll
    for (int w = 1; w < K3_WARPS; ++w) {
      a += red[w * G + g];
      z += red[(K3_WARPS + w) * G + g];
      v += part[(w * G + g) * D + tid];
    }
    // a row whose every lane is masked has l = 0 and acc = 0: a zero row
    orow[g * D + tid] = __float2bfloat16_rn(__fdiv_rn(v + z, fmaxf(a, 1e-20f)));
  }
}

template <int G>
int launch_stream(const void* q, const void* k_pages, const void* params, const void* v_pages,
                  const void* page_table, const void* seq_lens, const void* ring_k, const void* ring_prm,
                  const void* ring_v, const void* n_hot, void* out, int B, int H, int S, int W, int max_pages,
                  int row, float sm_scale, cudaStream_t st) {
  auto kernel = paged_ring_stream_kernel<G>;
  const int smem = k3_layout(G, S, W).total;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  kernel<<<dim3(B, H), K3_THREADS, smem, st>>>(
      (const __nv_bfloat16*)q, (const int8_t*)k_pages, (const __nv_bfloat16*)params, (const int8_t*)v_pages,
      (const int*)page_table, (const int*)seq_lens, (const int8_t*)ring_k, (const __nv_bfloat16*)ring_prm,
      (const int8_t*)ring_v, (const int*)n_hot, (__nv_bfloat16*)out, H, S, W, max_pages, row, sm_scale);
  return (int)cudaGetLastError();
}

bool pow2_in(int x, int lo, int hi) { return x >= lo && x <= hi && (x & (x - 1)) == 0; }

}  // namespace

// K3: one block per (sequence, kv head).  HQ / H <= 8, S and W powers of two
// in [16, 512]; a shape the kernel cannot run is refused.
extern "C" int atom_paged_ring_decode(const void* q, const void* k_pages, const void* params,
                                      const void* v_pages, const void* page_table,
                                      const void* seq_lens, const void* ring_k,
                                      const void* ring_prm, const void* ring_v, const void* n_hot,
                                      void* out, int B, int HQ, int H, int S, int W, int max_pages,
                                      int row, float sm_scale, void* stream) {
  if (H < 1 || HQ % H || HQ / H > GMAX || !pow2_in(S, 16, 512) || !pow2_in(W, 16, 512) || row < 0 || row >= W)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define K3_CASE(G_)                                                                                            \
  case G_:                                                                                                     \
    return launch_stream<G_>(q, k_pages, params, v_pages, page_table, seq_lens, ring_k, ring_prm, ring_v, n_hot, \
                             out, B, H, S, W, max_pages, row, sm_scale, st);
  switch (HQ / H) {
    K3_CASE(1)
    K3_CASE(2)
    K3_CASE(3)
    K3_CASE(4)
    K3_CASE(5)
    K3_CASE(6)
    K3_CASE(7)
    K3_CASE(8)
  }
#undef K3_CASE
  return (int)cudaErrorInvalidValue;
}
