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
// takes the ring pre-rolled into position order (three rolls of the ring, one
// copy each), runs two aliased passes (first page, wrapped page) and rewrites
// whole page blocks with a select, the sink page 0 included.  Here one pass
// reads the ring in place: block token t is ring column (roll + t) mod W, with
// roll = row + 1 for the live ring and 0 for pre-rolled blocks, so no copy of
// the ring is made.  Blocks run concurrently, so each block (sequence, kv
// head: 4 warps, at most 64 registers so that batch 32 x 32 kv heads runs as
// one wave) writes only the valid tokens [lo, hi) of the sequence's block
// into its one or two pages; a token's page (page_a for lanes o + t below S,
// else page_b) and lane are decided once, by comparisons: no division by a
// runtime W, and D = 128 at compile time (a generic instance takes any
// head_dim).  Every load of a round of 32 tokens is issued before its stores:
// the K rows (a warp's lanes are the tokens: coalesced byte loads of each
// W-byte ring row, byte stores at the arbitrary lane offset o), the params
// row (2-byte lanes), and the V pieces, 16 bytes of a token's 128-byte row
// with the page row they merge into; the nibbles merge on 32-bit words
// ((old & 0xF0F0F0F0) | new below S/2, (old & 0x0F0F0F0F) | new << 4 above)
// and go out 16 bytes at a time.  A V byte holds slots r and r + S/2, and
// two tokens of one flush never share one (W <= S/2), nor do two sequences
// share a page: no synchronisation between blocks.  Inactive sequences
// return at once.  Bound: the ring read once, the page's K and params
// written, its V rows read and written once (~16 MB per layer at batch 32,
// 7B), every W-th step.

// K11 replaces :533 paged_decode_attention_rotated (_decode_kernel :74, the page
// step of :335, the finalize of :187): attention over the flushed pages alone,
// returning also the online-softmax state m, l per query row so that the caller
// merges it with a second part (the ring, or a prompt chunk's own keys).  The
// mixed step calls it twice a layer, and the C entry picks one of two kernels
// from the shapes alone (ops/decode.py::check_rotated_decode_shape states the
// rule):
//  * the decode rows (G = HQ / H <= 8 query rows per kv head): K3's kernel as a
//    compile-time variant without the ring (paged_ring_stream_kernel<G, false>),
//    writing the output in float32 or bf16 and m, l; page sizes as K3's.
//    Bound: the pages' bytes, as K3.
//  * a chunk's prefix (one sequence whose query axis holds all C queries of a
//    prompt chunk: G * C rows per kv head, 256 at 7B, 2,048 for 64 q / 8 kv
//    heads): paged_tile_kernel, flash-style tiles of 64 query rows on the bf16
//    tensor cores.  Each row meets every prefix token, 4 x 128 operations a
//    pair, against pages read once: 256 rows a kv head put it at ~960
//    operations per byte, above the ~295 where the bf16 tensor cores and not
//    the memory bound it.  A block of 8 warps owns 64 rows of one kv head
//    (16 a warp, FlashAttention-2's layout, twice: each half of the block
//    takes every other 64 slots of the walk with its own softmax state, and
//    the halves merge at the end) and walks the head's pages through a
//    double buffer of bulk copies (K [64][S], V [S/2][128], params [4][S]).
//    Per 64 slots of a page (32 of its first half and the 32 that share their
//    V bytes in the second): q.K on mma.sync m16n8k16 bf16 with float32 sums.
//    q is bf16 and a u4 code is exact in bf16 (an OR under 128's exponent and
//    one subtraction), so every product is exact and only the order of the
//    additions moves.  The k index follows the bytes: a K byte [c][s] holds
//    channels c and c + 64, one k pair of the B fragment, and q's A fragment
//    takes its channels in the same order; the n index puts 4 consecutive
//    slots in one 32-bit load (n-tile u of a 32-slot group, column n: slot
//    4n + u), which leaves each thread the scores of 8 consecutive slots a
//    group.  Online softmax per row in registers (the quad of a row shares its
//    max by shuffles), slots from seq_len on masked.  p.V: the score fragments
//    are the A fragments (a k pair: slots r and r + 4 of a group), a V byte
//    [r][d] holds slots r and r + S/2, so one byte load feeds a group and its
//    partner; p * v_scale is kept in float32 as two bf16 terms, hi and its
//    remainder, two mma's a k-step (relative error ~2^-17, where one bf16
//    rounding, 2^-9, would not hold the float32 output's tolerance).  Each
//    64 slots' p.V starts from a zero accumulator and joins the running
//    output in one multiply-add with the softmax's rescale.  sum p and
//    sum p * v_zero stay on the CUDA cores.  Against the plain version the
//    float32 output sits within ~1.5e-5 at a 1,792-token prefix, where a CPU
//    emulation of the same order with IEEE sums (tests/test_torch_decode_tile.py)
//    is within ~2e-6: the rest is the tensor cores' own float32 summation.
//    A prefix of 0 walks no page and stores out = 0, m = -1e30, l = 0.  One
//    launch, no workspace, deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int D = 128;  // head_dim
constexpr int DH = D / 2;
constexpr int GMAX = 8;  // query rows per kv head of K3 and of K11's decode rows
constexpr float NEG_INF = -1e30f;

constexpr int FLUSH_THREADS = 128;  // a block per (sequence, kv head): 4 warps
// blocks an SM must hold at once, for the register budget: 8 (64 registers)
// hold the 1,024 blocks of batch 32 x 32 kv heads in one wave (1 and 12
// measured slower: PERF.md, scripts/torch_head_flush_variants.py)
constexpr int FLUSH_MIN_BLOCKS = 8;
constexpr int FLUSH_K = 16;         // K rows a thread loads before it stores them
constexpr int FLUSH_V = 2;          // V pieces a thread loads before it stores them

__device__ __forceinline__ uint32_t merge_nibbles(uint32_t old, uint32_t code, bool high) {
  code &= 0x0F0F0F0Fu;
  return high ? (old & 0x0F0F0F0Fu) | (code << 4) : (old & 0xF0F0F0F0u) | code;
}

// DC: head_dim at compile time (128), or 0 for any head_dim (byte pieces)
template <int DC>
__global__ void __launch_bounds__(FLUSH_THREADS, FLUSH_MIN_BLOCKS)
flush_kernel(const int8_t* __restrict__ k_ring, const __nv_bfloat16* __restrict__ prm_ring,
             const int8_t* __restrict__ v_ring, const int* __restrict__ page_a, const int* __restrict__ page_b,
             const int* __restrict__ slot0, const int* __restrict__ o, const int* __restrict__ lo,
             const int* __restrict__ hi, int8_t* __restrict__ k_pages, __nv_bfloat16* __restrict__ params,
             int8_t* __restrict__ v_pages, int H, int S, int W, int d_any, int roll) {
  const int Dv = DC ? DC : d_any, DHv = Dv / 2;
  const int b = blockIdx.x, h = blockIdx.y;
  const int lane0 = o[b];              // page lane of token 0 (page_a; from S on, page_b)
  const int gs0 = slot0[b] + lane0;    // global slot of token 0
  const int pa = page_a[b], pb = page_b[b];  // loaded beside the bookkeeping, not after it
  const int t_lo = max(0, lo[b] - gs0), t_hi = min(W, hi[b] - gs0);
  if (t_lo >= t_hi) return;            // inactive, or nothing pending
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // token t: its ring column, page and lane in it
  auto col_of = [&](int t) { return roll + t < W ? roll + t : roll + t - W; };
  auto page_of = [&](int t) { return (size_t)(lane0 + t < S ? pa : pb); };
  auto lane_of = [&](int t) { return lane0 + t < S ? lane0 + t : lane0 + t - S; };
  constexpr int PB = DC ? 16 : 1;  // bytes a V piece
  const int pieces = Dv / PB;

  // rounds of 32 tokens (one at W <= 32): a warp's lanes are tokens for the K
  // rows (warp, warp + 4, ..) and the params row `warp`; the V pieces of the
  // round's tokens go round the block's threads
  for (int t0 = t_lo; t0 < t_hi; t0 += 32) {
    const int t = t0 + lane;
    const bool tok = t < t_hi;
    const int col = tok ? col_of(t) : 0;
    const int8_t* ksrc = k_ring + ((size_t)b * H + h) * DHv * W + col;
    int8_t* kdst = k_pages + (page_of(t) * H + h) * DHv * S + (tok ? lane_of(t) : 0);
    for (int r0 = warp; r0 < DHv; r0 += 4 * FLUSH_K) {
      int8_t kb[FLUSH_K];
      __nv_bfloat16 pv;
      const bool prm_row = r0 == warp && tok;  // the first batch carries the params row
      if (tok) {
#pragma unroll
        for (int i = 0; i < FLUSH_K; ++i)
          if (r0 + 4 * i < DHv) kb[i] = ksrc[(size_t)(r0 + 4 * i) * W];
      }
      if (prm_row) pv = prm_ring[(((size_t)b * 4 + warp) * H + h) * W + col];
      for (int p0 = 0; p0 < 32 * pieces; p0 += FLUSH_THREADS * FLUSH_V) {
        uint4 nw[FLUSH_V], od[FLUSH_V];
        size_t vdst[FLUSH_V];
        bool vok[FLUSH_V], high[FLUSH_V];
#pragma unroll
        for (int j = 0; j < FLUSH_V; ++j) {
          const int p = p0 + tid + j * FLUSH_THREADS, tv = t0 + p / pieces, piece = p % pieces;
          vok[j] = r0 == warp && p < 32 * pieces && tv < t_hi;  // V with the first K batch
          if (vok[j]) {
            const int ln = lane_of(tv);
            high[j] = ln >= S / 2;
            const size_t src = (((size_t)b * H + h) * W + col_of(tv)) * Dv + piece * PB;
            vdst[j] = ((page_of(tv) * H + h) * (S / 2) + (high[j] ? ln - S / 2 : ln)) * Dv + piece * PB;
            if constexpr (DC) {
              nw[j] = *reinterpret_cast<const uint4*>(v_ring + src);
              od[j] = *reinterpret_cast<const uint4*>(v_pages + vdst[j]);
            } else {
              nw[j].x = (uint8_t)v_ring[src];
              od[j].x = (uint8_t)v_pages[vdst[j]];
            }
          }
        }
        if (p0 == 0 && tok) {  // every load of the batch is issued: the K rows and params go out
#pragma unroll
          for (int i = 0; i < FLUSH_K; ++i)
            if (r0 + 4 * i < DHv) kdst[(size_t)(r0 + 4 * i) * S] = kb[i];
          if (prm_row) params[((page_of(t) * 4 + warp) * H + h) * S + lane_of(t)] = pv;
        }
#pragma unroll
        for (int j = 0; j < FLUSH_V; ++j) {
          if (!vok[j]) continue;
          if constexpr (DC) {
            const uint4 m = make_uint4(merge_nibbles(od[j].x, nw[j].x, high[j]), merge_nibbles(od[j].y, nw[j].y, high[j]),
                                       merge_nibbles(od[j].z, nw[j].z, high[j]), merge_nibbles(od[j].w, nw[j].w, high[j]));
            *reinterpret_cast<uint4*>(v_pages + vdst[j]) = m;
          } else {
            v_pages[vdst[j]] = (int8_t)(merge_nibbles(od[j].x, nw[j].x, high[j]) & 0xFFu);
          }
        }
        if (r0 != warp) break;  // later K batches carry no V
      }
    }
  }
}

}  // namespace

// The ring [B, H, D/2, W] / [B, 4, H, W] / [B, H, W, D] -> pages, block token
// t from ring column (roll + t) mod W (roll in [0, W)).
extern "C" int atom_flush_hot(const void* k_ring, const void* prm_ring, const void* v_ring,
                              const void* page_a, const void* page_b, const void* slot0,
                              const void* o, const void* lo, const void* hi, void* k_pages,
                              void* params, void* v_pages, int B, int H, int S, int W, int Dh,
                              int roll, void* stream) {
  if (B < 1 || H < 1 || W < 1 || 2 * W > S || Dh < 2 || Dh % 2 || roll < 0 || roll >= W)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, H);
  const auto kernel = Dh == D ? flush_kernel<D> : flush_kernel<0>;
  kernel<<<grid, FLUSH_THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)k_ring, (const __nv_bfloat16*)prm_ring, (const int8_t*)v_ring, (const int*)page_a,
      (const int*)page_b, (const int*)slot0, (const int*)o, (const int*)lo, (const int*)hi, (int8_t*)k_pages,
      (__nv_bfloat16*)params, (int8_t*)v_pages, H, S, W, Dh, roll);
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

// RING: K3 (the ring, then the pages; bf16 out).  Without: K11's decode rows
// (the pages alone; float32 or bf16 out, and the softmax state m, l).
template <int G, bool RING>
__global__ void __launch_bounds__(K3_THREADS)
paged_ring_stream_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_pages,
                         const __nv_bfloat16* __restrict__ params, const int8_t* __restrict__ v_pages,
                         const int* __restrict__ page_table, const int* __restrict__ seq_lens,
                         const int8_t* __restrict__ ring_k, const __nv_bfloat16* __restrict__ ring_prm,
                         const int8_t* __restrict__ ring_v, const int* __restrict__ n_hot,
                         void* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out, int out_f32,
                         int H, int S, int W, int max_pages, int row, float sm_scale) {
  constexpr int GP = padded(G);
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x, h = blockIdx.y, HQ = H * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Layout y = k3_layout(G, S, W);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + y.bars);  // [0] ring, [1] K, [2] params, [3] V
  float* qs = reinterpret_cast<float*>(smem + y.qs);
  float* part = reinterpret_cast<float*>(smem + y.part);
  float* red = reinterpret_cast<float*>(smem + y.red);
  const size_t row0 = (size_t)b * HQ + h * G;  // this kv head's first output row
  const bool f32 = !RING && out_f32;
  auto store = [&](int g, int d, float v) {
    if (f32)
      static_cast<float*>(out)[(row0 + g) * D + d] = v;
    else
      static_cast<__nv_bfloat16*>(out)[(row0 + g) * D + d] = __float2bfloat16_rn(v);
  };

  // the sequence's lengths and its first page, loaded together
  const int seq_len = seq_lens[b], nh_b = RING ? n_hot[b] : 0;
  const int first_page = max_pages > 0 ? page_table[(size_t)b * max_pages] : 0;
  const int n_page = max(min((seq_len + S - 1) / S, max_pages), 0);
  if (n_page == 0 && nh_b <= 0) {  // an idle row: a zero row (and m = -1e30, l = 0)
    for (int e = tid; e < G * D; e += K3_THREADS) store(e / D, e % D, 0.f);
    if (!RING && tid < G) {
      m_out[row0 + tid] = NEG_INF;
      l_out[row0 + tid] = 0.f;
    }
    return;
  }
  // the chunks: the ring (if it holds a token), then the page-table columns
  // up to the sequence's last flushed page
  const int has_ring = RING && nh_b > 0 ? 1 : 0;
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
    store(g, tid, __fdiv_rn(v + z, fmaxf(a, 1e-20f)));
    if (!RING && tid == 0) {
      m_out[row0 + g] = m[g];
      l_out[row0 + g] = a;
    }
  }
}

template <int G, bool RING>
int launch_stream(const void* q, const void* k_pages, const void* params, const void* v_pages,
                  const void* page_table, const void* seq_lens, const void* ring_k, const void* ring_prm,
                  const void* ring_v, const void* n_hot, void* out, void* m_out, void* l_out, int out_f32, int B,
                  int H, int S, int W, int max_pages, int row, float sm_scale, cudaStream_t st) {
  auto kernel = paged_ring_stream_kernel<G, RING>;
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
      (const int8_t*)ring_v, (const int*)n_hot, out, (float*)m_out, (float*)l_out, out_f32, H, S, W, max_pages, row,
      sm_scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K11's chunk-prefix path: paged_tile_kernel (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int TQ = 64;             // query rows of a tile: 4 warps x 16, twice
constexpr int TILE_THREADS = 256;  // two halves of 4 warps, each on every other 64 slots
constexpr int MERGE_FLOATS = 70;   // a thread's state handed to the other half: o [16][4], m, l, z [2]

// One page in a buffer: K [64][S] bytes, V [S/2][128] bytes, params [4][S]
// bf16; two buffers, the halves' merge over them at the end, the barriers.
__host__ __device__ inline int tile_page_bytes(int S) { return 136 * S; }
__host__ __device__ inline int tile_bars(int S) {
  return 2 * tile_page_bytes(S) > MERGE_FLOATS * 128 * 4 ? 2 * tile_page_bytes(S) : MERGE_FLOATS * 128 * 4;
}
__host__ __device__ inline int tile_smem(int S) { return tile_bars(S) + 16; }

// 8 bf16 from shared memory (16-byte aligned) as floats
__device__ __forceinline__ void lds8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Block (b, h, tile): query rows [64 tile, 64 tile + 64) of the HQ / H rows of
// kv head h (q is kv-head-major); warp w its rows 16 (w % 4) .. + 15, a thread
// rows gid and gid + 8 of those (the mma fragments' rows).  The warps w < 4
// (half 0) take the page walk's even 64-slot chunks, w >= 4 (half 1) the odd
// ones, each with its own online-softmax state, merged at the end: two warps
// a row tile keep the tensor cores busier than one where the grid has a
// block an SM (a 7B chunk's 32 kv heads x 4 tiles).
__global__ void __launch_bounds__(TILE_THREADS)
paged_tile_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k_pages,
                  const __nv_bfloat16* __restrict__ params, const int8_t* __restrict__ v_pages,
                  const int* __restrict__ page_table, const int* __restrict__ seq_lens, void* __restrict__ out,
                  float* __restrict__ m_out, float* __restrict__ l_out, int HQ, int H, int S, int max_pages,
                  int out_f32, float sm_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x, h = blockIdx.y, R = HQ / H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int half = warp >> 2;
  const int rw = blockIdx.z * TQ + (warp & 3) * 16;    // the warp's first row in the head
  const size_t hrow0 = (size_t)b * HQ + (size_t)h * R;  // the head's row 0 in q, out, m, l
  const int seq_len = seq_lens[b];
  const int n_page = max(min((seq_len + S - 1) / S, max_pages), 0);
  const int PB = tile_page_bytes(S);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + tile_bars(S));
  const int* table = page_table + (size_t)b * max_pages;

  // thread 0 copies page i of the walk into buffer i & 1, completing on its mbarrier
  auto issue = [&](int i) {
    const size_t p = (size_t)table[i];
    unsigned char* dst = smem + (i & 1) * PB;
    uint64_t* bar = bars + (i & 1);
    k3_mbar_expect(bar, PB);
    bulk_copy(dst, k_pages + (p * H + h) * DH * S, DH * S, bar);
    bulk_copy(dst + DH * S, v_pages + (p * H + h) * (S / 2) * D, S / 2 * D, bar);
    for (int j = 0; j < 4; ++j) bulk_copy(dst + 128 * S + j * 2 * S, params + ((p * 4 + j) * H + h) * S, 2 * S, bar);
  };
  if (tid == 0) {
    k3_mbar_init(bars, 1);
    k3_mbar_init(bars + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < min(n_page, 2); ++i) issue(i);
  }

  // q's A fragments (k-step kk: a k pair is channels (8 kk + j, 8 kk + j + 64),
  // the K bytes' order) and the rows' channel sums, while the copies fly
  uint32_t qa[8][4];
  float qsum[2] = {0.f, 0.f};
  {
    const unsigned short* qb = reinterpret_cast<const unsigned short*>(q);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t x[2][4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = rw + gid + 8 * rr;
        const unsigned short* qr = qb + (hrow0 + r) * D + 8 * kk + tig;
        const bool live = r < R;
        const int off[4] = {0, 64, 4, 68};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[rr][j] = live ? qr[off[j]] : 0u;
          qsum[rr] += __uint_as_float(x[rr][j] << 16);  // bf16 -> float
        }
      }
      qa[kk][0] = x[0][0] | (x[0][1] << 16);
      qa[kk][1] = x[1][0] | (x[1][1] << 16);
      qa[kk][2] = x[0][2] | (x[0][3] << 16);
      qa[kk][3] = x[1][2] | (x[1][3] << 16);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      qsum[rr] += __shfl_xor_sync(0xffffffffu, qsum[rr], 1);
      qsum[rr] += __shfl_xor_sync(0xffffffffu, qsum[rr], 2);
    }
  }
  __syncthreads();  // the barriers' init

  // state of rows gid, gid + 8: m the same in a row's quad, l and sum p * v_zero
  // this thread's shares; o[4 D + u][2 rr + e]: channel 32 D + 8 tig + 4 e + u
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, z[2] = {0.f, 0.f};
  float o[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;

  const int groups = S / 64;  // 32-slot groups of a page's first half
  for (int i = 0; i < n_page; ++i) {
    k3_mbar_wait(bars + (i & 1), (i >> 1) & 1);
    const unsigned char* kb = smem + (i & 1) * PB;
    const unsigned char* vb = kb + DH * S;
    const __nv_bfloat16* prm = reinterpret_cast<const __nv_bfloat16*>(kb + 128 * S);
    const int pos0 = i * S;
    // 64 slots at a time: group t of the page's first half (hg 0) and its
    // partner S/2 on (hg 1), whose V codes share bytes; chunk i * groups + t
    // of the walk to the half of its parity
    for (int t = (half + i * groups) & 1; t < groups; t += 2) {
      if (pos0 + 32 * t >= seq_len) break;  // the rest of the page lies past the prefix
      // scores: n-tile 4 hg + u, column n = slot 4 n + u of the group
      float sc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int hg = 0; hg < 2; ++hg) {
          const unsigned char* kc = kb + (hg ? S / 2 : 0) + 32 * t + 4 * gid;
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(kc + (8 * kk + tig) * S);
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(kc + (8 * kk + 4 + tig) * S);
          const uint32_t l0 = w0 & 0x0F0F0F0Fu, h0 = (w0 >> 4) & 0x0F0F0F0Fu;
          const uint32_t l1 = w1 & 0x0F0F0F0Fu, h1 = (w1 >> 4) & 0x0F0F0F0Fu;
          mma_bf16(sc[4 * hg + 0], qa[kk], code_pair<0>(l0, h0), code_pair<0>(l1, h1));
          mma_bf16(sc[4 * hg + 1], qa[kk], code_pair<1>(l0, h0), code_pair<1>(l1, h1));
          mma_bf16(sc[4 * hg + 2], qa[kk], code_pair<2>(l0, h0), code_pair<2>(l1, h1));
          mma_bf16(sc[4 * hg + 3], qa[kk], code_pair<3>(l0, h0), code_pair<3>(l1, h1));
        }
      // the thread's 8 slots of a group, 8 tig + 4 e + u: scores and the chunk's max
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int hg = 0; hg < 2; ++hg) {
        const int s0 = (hg ? S / 2 : 0) + 32 * t + 8 * tig;
        float ks[8], kz[8];
        lds8(prm + s0, ks);
        lds8(prm + S + s0, kz);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 4 * e + u;
            const bool valid = pos0 + s0 + k < seq_len;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              float& x = sc[4 * hg + u][2 * rr + e];
              x = valid ? __fmul_rn(__fmaf_rn(x, ks[k], __fmul_rn(qsum[rr], kz[k])), sm_scale) : NEG_INF;
              mx[rr] = fmaxf(mx[rr], x);
            }
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
      for (int hg = 0; hg < 2; ++hg) {
        const int s0 = (hg ? S / 2 : 0) + 32 * t + 8 * tig;
        float vs[8], vz[8];
        lds8(prm + 2 * S + s0, vs);
        lds8(prm + 3 * S + s0, vz);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 4 * e + u;
            const bool valid = pos0 + s0 + k < seq_len;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              float& x = sc[4 * hg + u][2 * rr + e];
              const float p = valid ? expf(__fsub_rn(x, m[rr])) : 0.f;
              l[rr] = __fadd_rn(l[rr], p);
              z[rr] = __fmaf_rn(p, vz[k], z[rr]);
              x = __fmul_rn(p, vs[k]);
            }
          }
      }
      // p.V: channel quad cq (channels 32 cq + 4 gid + u: n-tile 4 cq + u); V
      // rows 32 t + 8 tig + j, their low nibbles the group's slots, their high
      // nibbles the partner's; k-step (hg, kp) takes the scores' n-tiles 2 kp
      // and 2 kp + 1: rows 2 kp + {0, 4} (b0) and 2 kp + 1 + {0, 4} (b1).
      // The chunk's products go into a fresh accumulator, which joins the
      // running output in one multiply-add with the softmax's rescale alpha.
      uint32_t a[2][2][2][4];  // [kp][hg][hi, lo][fragment register]
#pragma unroll
      for (int kp = 0; kp < 2; ++kp)
#pragma unroll
        for (int hg = 0; hg < 2; ++hg) {
          const float(&c0)[4] = sc[4 * hg + 2 * kp];
          const float(&c1)[4] = sc[4 * hg + 2 * kp + 1];
          split_pair(c0[0], c0[1], a[kp][hg][0][0], a[kp][hg][1][0]);
          split_pair(c0[2], c0[3], a[kp][hg][0][1], a[kp][hg][1][1]);
          split_pair(c1[0], c1[1], a[kp][hg][0][2], a[kp][hg][1][2]);
          split_pair(c1[2], c1[3], a[kp][hg][0][3], a[kp][hg][1][3]);
        }
#pragma unroll
      for (int cq = 0; cq < 4; ++cq) {
        float pv[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[u][e] = 0.f;
#pragma unroll
        for (int kp = 0; kp < 2; ++kp) {
          const unsigned char* vr = vb + (32 * t + 8 * tig + 2 * kp) * D + 32 * cq + 4 * gid;
          const uint32_t w[4] = {*reinterpret_cast<const uint32_t*>(vr), *reinterpret_cast<const uint32_t*>(vr + D),
                                 *reinterpret_cast<const uint32_t*>(vr + 4 * D),
                                 *reinterpret_cast<const uint32_t*>(vr + 5 * D)};  // rows 2kp, +1, +4, +5
#pragma unroll
          for (int hg = 0; hg < 2; ++hg) {
            uint32_t x[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) x[j] = (hg ? w[j] >> 4 : w[j]) & 0x0F0F0F0Fu;
            const uint32_t b0[4] = {code_pair<0>(x[0], x[2]), code_pair<1>(x[0], x[2]), code_pair<2>(x[0], x[2]),
                                    code_pair<3>(x[0], x[2])};
            const uint32_t b1[4] = {code_pair<0>(x[1], x[3]), code_pair<1>(x[1], x[3]), code_pair<2>(x[1], x[3]),
                                    code_pair<3>(x[1], x[3])};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              mma_bf16(pv[u], a[kp][hg][0], b0[u], b1[u]);
              mma_bf16(pv[u], a[kp][hg][1], b0[u], b1[u]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[4 * cq + u][e] = __fmaf_rn(o[4 * cq + u][e], alpha[e >> 1], pv[u][e]);
      }
    }
    __syncthreads();  // buffer i & 1 is read
    if (tid == 0 && i + 2 < n_page) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the reads above before the copy's writes
      issue(i + 2);
    }
  }

  // half 1 hands its state to the same thread of half 0 (the page buffers
  // are free: every copy has landed and been read), which merges the two
  float* xs = reinterpret_cast<float*>(smem) + (tid & 127);
  __syncthreads();
  if (half) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(4 * i + e) * 128] = o[i][e];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      xs[(64 + rr) * 128] = m[rr];
      xs[(66 + rr) * 128] = l[rr];
      xs[(68 + rr) * 128] = z[rr];
    }
  }
  __syncthreads();
  if (half) return;
  {
    float a0[2], a1[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float m1 = xs[(64 + rr) * 128], m_new = fmaxf(m[rr], m1);
      a0[rr] = expf(__fsub_rn(m[rr], m_new));
      a1[rr] = expf(__fsub_rn(m1, m_new));
      m[rr] = m_new;
      l[rr] = __fmaf_rn(xs[(66 + rr) * 128], a1[rr], __fmul_rn(l[rr], a0[rr]));
      z[rr] = __fmaf_rn(xs[(68 + rr) * 128], a1[rr], __fmul_rn(z[rr], a0[rr]));
    }
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[i][e] = __fmaf_rn(xs[(4 * i + e) * 128], a1[e >> 1], __fmul_rn(o[i][e], a0[e >> 1]));
  }

  // l and sum p * v_zero over the row's quad; out = (acc + z) / max(l, 1e-20)
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l[rr] = __fadd_rn(l[rr], __shfl_xor_sync(0xffffffffu, l[rr], x));
      z[rr] = __fadd_rn(z[rr], __shfl_xor_sync(0xffffffffu, z[rr], x));
    }
    const int r = rw + gid + 8 * rr;
    if (r >= R) continue;
    const size_t gr = hrow0 + r;
    const float den = fmaxf(l[rr], 1e-20f);
#pragma unroll
    for (int cq = 0; cq < 4; ++cq) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e) v[4 * e + u] = __fdiv_rn(__fadd_rn(o[4 * cq + u][2 * rr + e], z[rr]), den);
      const size_t off = gr * D + 32 * cq + 8 * tig;
      if (out_f32) {
        float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + off);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + off) =
            make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]), bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
      }
    }
    if (tig == 0) {
      m_out[gr] = m[rr];
      l_out[gr] = l[rr];
    }
  }
}

int launch_tile(const void* q, const void* k_pages, const void* params, const void* v_pages, const void* page_table,
                const void* seq_lens, void* out, void* m_out, void* l_out, int B, int HQ, int H, int S, int max_pages,
                int out_f32, float sm_scale, cudaStream_t st) {
  const int smem = tile_smem(S);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(paged_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const int tiles = (HQ / H + TQ - 1) / TQ;
  paged_tile_kernel<<<dim3(B, H, tiles), TILE_THREADS, smem, st>>>(
      (const __nv_bfloat16*)q, (const int8_t*)k_pages, (const __nv_bfloat16*)params, (const int8_t*)v_pages,
      (const int*)page_table, (const int*)seq_lens, out, (float*)m_out, (float*)l_out, HQ, H, S, max_pages, out_f32,
      sm_scale);
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
    return launch_stream<G_, true>(q, k_pages, params, v_pages, page_table, seq_lens, ring_k, ring_prm, ring_v,   \
                                   n_hot, out, nullptr, nullptr, 0, B, H, S, W, max_pages, row, sm_scale, st);
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

// K11: the pages alone, with the softmax state.  Up to 8 query rows per kv
// head K3's kernel without the ring (S a power of two in [16, 512]); above,
// the tile kernel (S a power of two in [64, 512]).  Anything else is refused.
extern "C" int atom_paged_decode(const void* q, const void* k_pages, const void* params, const void* v_pages,
                                 const void* page_table, const void* seq_lens, void* out, void* m_out, void* l_out,
                                 int B, int HQ, int H, int S, int max_pages, int out_f32, float sm_scale,
                                 void* stream) {
  if (H < 1 || HQ % H || HQ == 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int G = HQ / H;
  if (G > GMAX) {
    if (!pow2_in(S, 64, 512)) return (int)cudaErrorInvalidValue;
    return launch_tile(q, k_pages, params, v_pages, page_table, seq_lens, out, m_out, l_out, B, HQ, H, S, max_pages,
                       out_f32, sm_scale, st);
  }
  if (!pow2_in(S, 16, 512)) return (int)cudaErrorInvalidValue;
#define K11_CASE(G_)                                                                                        \
  case G_:                                                                                                  \
    return launch_stream<G_, false>(q, k_pages, params, v_pages, page_table, seq_lens, nullptr, nullptr,    \
                                    nullptr, nullptr, out, m_out, l_out, out_f32, B, H, S, 0, max_pages, 0, \
                                    sm_scale, st);
  switch (G) {
    K11_CASE(1)
    K11_CASE(2)
    K11_CASE(3)
    K11_CASE(4)
    K11_CASE(5)
    K11_CASE(6)
    K11_CASE(7)
    K11_CASE(8)
  }
#undef K11_CASE
  return (int)cudaErrorInvalidValue;
}
