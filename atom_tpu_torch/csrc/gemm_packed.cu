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
// The float32 order (every kernel here, and the plain versions): each group's
// int32 dot is exact; its term is fmul(fmul(float(dot), sa), sw).  Up to 112
// body groups (KBLK_THRESHOLD, the TPU kernel's _KBLK_THRESHOLD) one chain per
// output element adds the terms group by group from 0, the keeper's last.
// Above it (the 30B / 70B MLP down projections) the TPU kernel's K-blocked
// order: partial chains of 16 groups (KBLK_G), each added to the output in
// turn, and at the last block the keeper's term before that block's partial.
// The files build with --fmad=false and the float math uses _rn intrinsics,
// so nothing is contracted and the results equal the plain versions bit for bit.
//
// What bounds them on the H100: at decode M = 32 the product is 32 x K x N int8
// MACs against K*N/2 bytes of 4-bit weights, 64 MACs per weight byte, far below
// the ~590 int8 ops per byte where the tensor cores become the limit: the
// weight stream from HBM (plus the weight scales, K/128 x N x 4 bytes) bounds
// every decode call.  At prefill (M up to 1024) the int8 tensor-core rate does
// (and the float chain: see the prefill GEMM below).
//
// The decode core (M <= 64; ops/gemm_packed.py::packed_w4_plan picks the
// launch and the kernel takes it as it is).  A block owns tile_m (16, 32 or
// 64) rows x tile_n (32, 64 or 128) columns and walks all of K: the float
// chain forbids a split of K at <= 112 groups, so the parallelism is the
// column tiles (64 columns: N 4096 gives 64) and, where those leave SMs idle,
// row tiles of 16 that read the same weights (the second read mostly from L2).
// Warp 0 is the producer: one lane keeps a ring of `stages` (4) group slots in
// flight.  A slot holds a group's weight planes (one TMA box of 64 byte rows x
// tile_n, with TMA's 64- or 128-byte swizzle at those widths), its activation
// tile (tile_m x 128 int8, TMA with a 128-byte swizzle; rows past M read as
// zeros) and its weight scale row (bulk copy), and completes on a `full`
// mbarrier by its bytes; the consumers release it on an `empty` one.  The
// keeper takes two slots (its 128 int8 rows), its activation tile in the
// first.  While the ring fills, the consumers stage the block rows'
// activation scales (at most 22 KB at M = 64 and 86 groups).
//
// The consumer warps each own 16 weight columns x the block's rows for the
// whole of K and keep their float chains in registers: no merge through
// shared memory and no block barrier per group.  A warp issues group j + 1's
// loads and products before group j's float chain (software pipelining).  The
// int32 dot runs on the tensor cores as mma.sync m16n8k32 s8 of
// out^T = W^T . a^T: the weights are the A operand (the mma's 16 rows are the
// warp's columns, 2*gid and 2*gid + 1 as its rows gid and gid + 8), the
// activation rows the B operand (8 per mma), read with ldmatrix from the
// swizzled tile in their natural order.  mma.sync rather than wgmma: a warp
// owning its 16 columns keeps its accumulators, and its float chain, to itself
// across every group, and at 64 MACs per weight byte the instruction's rate
// does not bound the call.  The k-steps of a group follow the nibble planes:
// byte row r holds code r in its low nibble and code r + 64 in its high one,
// so 32 byte rows of one plane are 32 consecutive codes and the activation
// chunk is read as it lies.  A lane reads its 2 columns (16 bits) from 4 byte
// rows; the 4 lanes of a column read the rows in an order rotated by their
// index, so each load of the warp hits 16 distinct banks (with the swizzle at
// 64 and 128 columns), and two byte permutes with selectors that undo the
// rotation give the 4 rows of each column as one word.  Low plane:
// (x << 4) & 0xF0F0F0F0, high plane: x & 0xF0F0F0F0, each byte 16 x the
// signed code; the 1/16 is folded into the staged activation scales of the
// body groups (a power of two: the term's rounding is unchanged).  The
// keeper's int8 rows go in unmasked.  float(dot) is two full-rate
// instructions (small_int_to_float), exact below 2^22.
//
// Measured and left out (PERF.md section 6): activation tiles multicast over a
// cluster of 2 or 4 column tiles (slower: the cluster's blocks wait on each
// other's slots), cp.async copies by one or more producer warps, a 16-column
// weight box per consumer warp, deeper rings (3 to 35 slots read within a
// few per cent), and a split of K over a cluster of 2-8 blocks a column tile
// whose float chain is handed on in order through distributed shared memory
// (bitwise, but slower at every split: the extra blocks on an SM do not raise
// its rate and each handoff adds latency).
//
// Known limits (later work): at N = 4096 the grid has ~one block an SM and
// each block's ring delivers a slot every ~0.3-0.5 us whatever its depth or
// width, so o_proj and down run at 5-6x their byte bound; the weight
// fragments are rebuilt by every warp (8 loads, 8 permutes and 12 masks a
// group per 16 columns) and each element's float chain is 5 instructions a
// group; s4 x s4 mma on activations packed in the nibble-plane order would
// halve the products and drop the masks.
//
// The prefill GEMM (M > 64: prefill, the mixed step; and every K7 launch):
// gemm_prefill_kernel, on the same ring and the same weight fragments, with
// the int8 tensor cores' wgmma.  At M = 1024 the product is 1024 MACs per
// weight byte against the ~590 ops per byte where the tensor cores become the
// limit: the int8 operations bound it, and the float chain the TPU order
// forces (5 instructions per output element and group, 4 of them on the
// FP32 pipe) costs about as much as the tensor cores' own time, so the fold
// of one unit must run while the tensor cores work on the next.  A block
// owns tile_n (64 or 128) weight columns x tile_m (64 or 128) activation rows
// and walks all of K; ops/gemm_packed.py::packed_w4_plan picks the tiles.
// One consumer warpgroup per 64 columns computes out^T = W^T . a^T with
// wgmma.mma_async m64n64k32 s8: A, the weights, from registers (a warp's 16
// columns are its 16 rows of the warpgroup's 64, built from the nibble
// planes exactly as the decode core builds its mma.sync fragments: 8-bit
// wgmma takes K-major operands only, and the planes are N-major, so the
// transpose happens in the byte permutes), B, the activations, from the
// ring's 128-byte-swizzled tile by a shared-memory descriptor (K-major, 8-row
// atoms 1024 bytes apart, the k-step's 32 bytes by the start address).  A
// unit is one group's 4 k-steps over 64 activation rows (one or two a
// group); its int32 products go into one of two accumulator sets, and the
// warpgroup issues unit u + 1 (commit, wait_group 1) before it folds unit u
// into its float chains, so the fold overlaps the tensor cores.  The weights
// are read once per tile_m rows, the activations once per tile_n columns.
// Two row tiles of the K-blocked order (70B depth) would hold 64 more chain
// registers than a thread has: it runs 64-row blocks.  Columns past N (the
// last tile of an N not a multiple of tile_n) read zeros by TMA and are not
// stored; rows past M likewise.
//
// Measured and left out (PERF.md section 6): setmaxnreg to lift a
// two-warpgroup block's consumers above ptxas's 168 registers (ptxas then
// serialized the wgmmas and the launches failed on the card; the 128 x 128
// block spills 40-150 bytes instead), and a pipeline whose last group was a
// run-time branch inside the loop (ptxas injected waits there).  Known
// limits: a unit takes ~0.6 us of a block's time, several times its
// instruction issue, and at 1,024 rows the blocks re-read the activations
// from L2 once per column tile.
//
// The s8 mma and the per-head u4 quantizer live in int8_mma.cuh.
//
// K14, the grouped int8 GEMMs on int8-carrier weights, replaces
// atom_tpu/ops/pallas_gemm.py:77 grouped_int8_gemm (K14a, _gemm_kernel :47)
// and :203 grouped_int8_gemm_o4 (K14b, _gemm_o4_kernel :157): K1's function
// on other bytes, w int8 [(ng + 1) * 128, N] with the keeper as its last
// group, so both kernels above run it in an int8-weight form (template
// parameter I8; false is the K1 family's form).  Every group's 128 int8 rows
// take one ring slot, one TMA box of 128 rows x tile_n, and its fragments are
// built as the keeper's, by the same loads and permutes, no nibble masks; the activation scales are staged as they are (the codes
// enter the product unscaled), and the chain is never K-blocked: the TPU
// kernel adds every group to its output in order at any depth, so K14 takes
// the unblocked order at 223 groups too (ops/gemm.py::grouped_int8_plan; at
// K 28,672 in 128-row tiles the staged scales take 115 KB).  Bound: at
// decode rows the weight stream (K*N bytes, twice K1's), at 1,024 rows the
// int8 tensor cores.  K14b is two launches, as K7: K14a's product into an
// f32 scratch, then head_codes_kernel, K7's per-head quantizer without RoPE.
//
// K2 runs as two launches on one stream: the RMSNorm + dual-path quantization
// prologue (every output tile needs the whole quantized row, so it finishes
// before any GEMM block starts), then the core with the ring epilogue: a block
// owns one 128-column head (tile_n 128, 8 consumer warps, at most 32 rows a
// block), so the RoPE pairs (d, d +- 64) and the per-head max / min are in
// its shared memory; its f32 tile goes there beside the rows' cos and sin
// (staged while the ring fills), and a warp per row rotates q and k in f32,
// quantizes post-RoPE K and V per head (asymmetric u4: ops/reference.py
// quantize_kv_asym) and writes q in bf16 and ring column `row` in place.  K8
// is the same kernel on the caller's quantized activation.  K7 is the prefill
// GEMM into an f32 [M, N] scratch, then an epilogue with the same per-head
// arithmetic (head_rope_quant, a block per row and head) that writes one byte
// per code and float32 params, the layout prefill appends to the pages from.
// The TPU kernels pad M to their tile; these guard row < M instead.  NaN note:
// the TPU kernel's bf16 rounding is integer bit math that turns a NaN into
// Inf; here __float2bfloat16_rn keeps NaN.
//
// K9 replaces :540 packed_w4_gemm_fused_in (_gemm_fused_in_kernel :494,
// _quant_prologue :438): two launches, the prologue above (its norm optional;
// rstd always comes from outside, as on the TPU, so the statistic is the one
// the unfused chain uses; given the layer's reorder index it reads y[m, idx[k]]
// for channel k, the gather the TPU program fuses into its neighbours, so the
// caller launches no gather of its own) and the GEMM with the epilogue
// out = bf16(resid + bf16(acc)): the GEMM output is rounded to bf16 before the
// add, then the sum once more, which is what x + quant_gemm(...) does, so K9
// equals the unfused chain bit for bit.  A float32 residual gives a float32
// output, resid + acc unrounded (the TPU kernel's out dtype is the residual's;
// the same holds for K10's down epilogue), on separate epilogue instances, so
// the bf16 ones are unchanged.  Bound: the weight stream, as K1.
//
// K10 replaces atom_tpu/ops/pallas_mlp.py:238 fused_mlp_packed (_fused_mlp_kernel
// :84).  On the TPU one sequential grid runs prologue, gate/up tiles and down
// tiles in turn with the act codes in VMEM, each gate tile paired with its up
// tile in one grid step.  Here blocks run in parallel and the down product
// needs every act code of a row, so the phases are launches on one stream.
// Up to 64 rows, three: (1) the prologue (the reorder gather folded in, as
// K9's), (2) the gate/up GEMM on the core with the SiLU-quant epilogue, (3) the
// down GEMM with the residual epilogue (or resid + row_scale * acc, the MoE
// form, without the bf16 pin, as the TPU kernel has it; on a float32 residual
// the float32 forms).  In (2) a block pairs as the TPU kernel does: its tile of
// t gate columns [c, c + t) and the matching up columns [inter + c, ...), read
// from the one gate/up weight the unfused path and the prefill GEMM read; a
// ring slot takes them as one 3D TMA box of a [rows][gate, up][inter] view
// (and the scale rows likewise), so a slot is three copies as in the unpaired
// core, with L2 promotion to 128 bytes: a box row is t bytes of each half, and
// a cluster's blocks read the rest of those 128 bytes.  Each column's float
// chain is the core's, unchanged; after it the block's tile goes into its
// ring (every slot read by then), and each row's 2 tile_n / tile_m
// consecutive consumer threads take act = SiLU(g) * u over the block's t
// channels in turn and the row's partial |max| by shuffles.  A 128-channel
// requantization group spans 128 / t blocks, launched as one thread-block
// cluster (t = 32: 4 blocks of 64 weight columns, the unpaired grid; t = 64: 2
// of 128, slower: its 288-thread blocks fit one an SM by registers, 132 of 172
// at once): each block stores its rows' partial maxima into every rank's
// shared memory through distributed shared memory, and after one cluster
// barrier reads them locally, takes the group's max (exact in any order) and
// quantizes its own channels as quant_group_store does (the last 128 of inter
// the INT8 keeper without clip, every other group INT4 with the clip),
// writing the act codes and, at the cluster's rank 0, the scale straight into
// the down GEMM's input.  No block reads a partner's memory after the
// barrier, so none waits to exit.  No f32 gate/up scratch, no SiLU launch.
// The producer warp passes the barrier too.  Measured at 7B (PERF.md section
// 6): two boxes a slot for weights and scales were no slower than one; a
// warp a row over its channels and a pull of the partners' maxima (two
// barriers) cost ~4 us more; without the L2 promotion ~2 us more.
// Above 64 rows (the prefill GEMM) four launches: the prologue, the gate/up GEMM
// into an f32 [M, 2*inter] scratch, silu_mul_quant_kernel (the same SiLU and
// requantization a warp per group), the down GEMM.  SiLU is x / (1 + expf(-x))
// with IEEE division, the formula of PyTorch's CUDA silu, in both forms, so
// the act codes of the two are equal bit for bit and equal the plain
// version's.  Bound: the two weight streams (gate/up 45 MB + down 22.5 MB at
// 7B): memory.  K9's and K10's GEMMs run on the core at M <= 64 and on the
// prefill GEMM above.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int GROUP = 128;
constexpr int HALF = 64;
constexpr int HEAD = 128;  // head_dim of the qkv epilogues
constexpr int KBLK_THRESHOLD = 112;  // body groups above which the sum is K-blocked
constexpr int KBLK_G = 16;           // groups of a K-blocked partial
constexpr int MAX_CONSUMERS = 8;     // core: consumer warps of a block
constexpr int HT = HEAD + 4;         // core: row stride of the head epilogue's f32 tile

// Epilogues of the GEMM: the f32 product (K1, K7's qkv scratch);
// bf16(resid + bf16(acc)), resid optional (K9, K10); bf16(resid + row_scale *
// acc) (K10 with a per-row output scale); the head ring epilogue (K2, K8: core
// only); and on a float32 residual, into float32, resid + acc and resid +
// row_scale * acc (K9, K10: the TPU kernels' output takes the residual's type,
// and their pinned rounding _rp does nothing at 32 bits); and K10's gate/up
// epilogue, SiLU(gate) * up requantized over a cluster (core only, paired tiles).
enum Epilogue {
  EPI_F32 = 0, EPI_RESID = 1, EPI_ROW_SCALE = 2, EPI_RING = 3, EPI_RESID_F32 = 4, EPI_ROW_SCALE_F32 = 5,
  EPI_SILU_QUANT = 6
};

__host__ __device__ constexpr bool f32_out(int epi) { return epi == EPI_F32 || epi == EPI_RESID_F32 || epi == EPI_ROW_SCALE_F32; }

// One output element's running sum in the TPU kernel's order (see the note):
// add(t) per body group, keeper(t) once at the end.
struct Chain {
  float out = 0.f, part = 0.f;
  __device__ __forceinline__ void add(float t, bool kblk) {
    if (kblk)
      part = __fadd_rn(part, t);
    else
      out = __fadd_rn(out, t);
  }
  __device__ __forceinline__ void block_end() {  // a K-blocked partial that is not the last
    out = __fadd_rn(out, part);
    part = 0.f;
  }
  __device__ __forceinline__ void keeper(float t, bool kblk) {
    out = __fadd_rn(out, t);
    if (kblk) out = __fadd_rn(out, part);
  }
};

__device__ __forceinline__ float epi_value(int epi, float acc, const void* resid, const float* row_scale, size_t o,
                                           int row) {
  const __nv_bfloat16* rb = static_cast<const __nv_bfloat16*>(resid);
  const float* rf = static_cast<const float*>(resid);
  if (epi == EPI_RESID) return resid != nullptr ? __fadd_rn(__bfloat162float(rb[o]), bf16_round(acc)) : acc;
  if (epi == EPI_ROW_SCALE) return __fadd_rn(__bfloat162float(rb[o]), __fmul_rn(row_scale[row], acc));
  if (epi == EPI_RESID_F32) return __fadd_rn(rf[o], acc);
  return __fadd_rn(rf[o], __fmul_rn(row_scale[row], acc));  // EPI_ROW_SCALE_F32
}

// ---------------------------------------------------------------------------
// The decode core (M <= 64, and the ring epilogue at any M)
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits for the phase of parity `phase`; traps after ~2^34 cycles (seconds)
// rather than hang the card if a slot never completes.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  const unsigned a = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(phase) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// A consumer warp gives a ring slot back once its reads of the slot are done.
// Those are generic-proxy loads; the slot's next fill is a TMA write (the
// async proxy), which the mbarrier's release does not order after them: the
// proxy fence does.  Without it a weight-scale load still in flight at the
// release now and then read the slot's next group (fault C3, found by
// scripts/torch_c3_bisect.py: the decode core in 32- or 64-row blocks over
// more than 64 rows).
__device__ __forceinline__ void release_slot(uint64_t* bar, int lane) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// A 2D box of the tensor map at (x, y) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* tm, int x, int y, uint64_t* bar) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
               ::"r"(smem_u32(dst)), "l"((uint64_t)tm), "r"(x), "r"(y), "r"(smem_u32(bar)) : "memory");
}

// A 3D box of the tensor map at (x, y, z) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* tm, int x, int y, int z, uint64_t* bar) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
               ::"r"(smem_u32(dst)), "l"((uint64_t)tm), "r"(x), "r"(y), "r"(z), "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(smem_u32(dst)), "l"((uint64_t)src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// Columns c and c + 1 of 4 byte rows of a weight slot, each column's 4 rows
// as one word in row order: u[i] is the 16-bit load at off[i], the row
// 4*tig + ((i + tig) & 3) of a 4-row step (so the 4 lanes of a column hit 4
// banks); sel0 / sel1 undo the rotation while they transpose.
__device__ __forceinline__ void load_cols(const unsigned char* w, const uint32_t (&off)[4], uint32_t sel0,
                                          uint32_t sel1, uint32_t& t0, uint32_t& t1) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = *reinterpret_cast<const uint16_t*>(w + off[i]);
  const uint32_t x = __byte_perm(u[0], u[1], 0x5410), y = __byte_perm(u[2], u[3], 0x5410);
  t0 = __byte_perm(x, y, sel0);
  t1 = __byte_perm(x, y, sel1);
}

// float(d) for |d| < 2^22, exactly, in two full-rate instructions: the bits
// of 1.5 * 2^23 + d, less 1.5 * 2^23.  Every int32 group dot here is below
// 2^22 (16 x 128 x 8 x 128 for a nibble group, 128^3 for the keeper).
__device__ __forceinline__ float small_int_to_float(int d) {
  return __fsub_rn(__int_as_float(d + 0x4B400000), 12582912.f);
}

// The weight slot's layout: rows tile_n bytes apart, TMA's swizzle for that
// width (none at 32 bytes, 64- or 128-byte at 64 or 128): bits [4, 4 + b) of
// the offset take bits [7, 7 + b) by exclusive or.  The paired slot
// (EPI_SILU_QUANT) is one 3D box, [64 rows][gate, up][tile_n / 2 bytes], so
// its rows are tile_n bytes too, under the swizzle of its tile_n / 2-byte
// inner dimension (32- or 64-byte: b = 1 or 2).
__device__ __forceinline__ uint32_t w_offset(int row, int col, int tile_n, bool paired = false) {
  const uint32_t off = row * tile_n + col;
  const uint32_t mask = paired ? (tile_n == 128 ? 3u : 1u) : tile_n == 128 ? 7u : tile_n == 64 ? 3u : 0u;
  return off ^ (((off >> 7) & mask) << 4);
}

// The launch's operands and geometry.
struct CoreParams {
  const float* sa;
  const float* sw;
  void* out;
  const void* resid;  // bf16, or float32 for the *_F32 epilogues
  const float* row_scale;
  const float* cosv;
  const float* sinv;
  __nv_bfloat16* q;
  int8_t* ring_k;
  __nv_bfloat16* ring_prm;
  int8_t* ring_v;
  int8_t* act;        // EPI_SILU_QUANT: the down GEMM's input codes [M, inter]
  float* act_scales;  // and its scales [M, inter / 128]
  int M, N, ng, tile_m, tile_n, stages;
  int n_q, H, W, row;
  int inter, abits;
  float a_clip;
};

// Dynamic shared memory of a core block (ops/gemm_packed.py::core_smem); paired
// (EPI_SILU_QUANT): the partial maxima of up to 4 cluster ranks, MAX_RANKS x tile_m floats;
// wrows: weight byte rows a slot (128 for K14's one-slot int8 groups).
constexpr int MAX_RANKS = 4;
__host__ __device__ constexpr int core_smem(int tile_m, int tile_n, int stages, int ng, bool head, bool paired = false,
                                            int wrows = HALF) {
  return 1024 + stages * (tile_m * GROUP + tile_n * wrows + tile_n * 4 + 16) + (ng + 1) * tile_m * 4 +
         (head ? tile_m * (HT + 2 * HEAD) * 4 : 0) + (paired ? MAX_RANKS * tile_m * 4 : 0);
}

// The ring epilogue of one row m of the block's head hb, by one warp: lane
// holds channels d = lane + 32 i.  x, cs, sn: the row's product, cos and sin
// in shared memory.  The arithmetic of head_rope_quant below.
__device__ __forceinline__ void ring_row(const float* __restrict__ x, const float* __restrict__ cs,
                                         const float* __restrict__ sn, const CoreParams& p, int m, int hb, int lane) {
  const int nqh = p.n_q / HEAD;
  const bool is_q = hb < nqh, is_k = !is_q && hb < nqh + p.H;
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = x[lane + 32 * i];
  if (is_q || is_k) {
    float r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = lane + 32 * i;
      const float rot = i < 2 ? -v[i + 2] : v[i - 2];
      r[i] = __fadd_rn(__fmul_rn(v[i], cs[d]), __fmul_rn(rot, sn[d]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = r[i];
  }
  if (is_q) {
#pragma unroll
    for (int i = 0; i < 4; ++i) p.q[(size_t)m * p.n_q + (size_t)hb * HEAD + lane + 32 * i] = __float2bfloat16_rn(v[i]);
    return;
  }
  float mx = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
  float mn = fmaxf(fmaxf(-v[0], -v[1]), fmaxf(-v[2], -v[3]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    mn = fmaxf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
  }
  const KvQuant kq = kv_quant_params(mx, -mn);
  int code[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) code[i] = kv_quant_code(v[i], kq);
  const int h = is_k ? hb - nqh : hb - nqh - p.H;
  if (is_k) {
    int8_t* k = p.ring_k + (((size_t)m * p.H + h) * (HEAD / 2) + lane) * p.W + p.row;
    k[0] = (int8_t)(code[0] | (code[2] << 4));
    k[(size_t)32 * p.W] = (int8_t)(code[1] | (code[3] << 4));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p.ring_v[(((size_t)m * p.H + h) * p.W + p.row) * HEAD + lane + 32 * i] = (int8_t)code[i];
  }
  if (lane == 0) {
    const int plane = is_k ? 0 : 2;
    p.ring_prm[(((size_t)m * 4 + plane) * p.H + h) * p.W + p.row] = __float2bfloat16_rn(kq.scale);
    p.ring_prm[(((size_t)m * 4 + plane + 1) * p.H + h) * p.W + p.row] = __float2bfloat16_rn(kq.zero_val);
  }
}

// The SiLU-quant epilogue's f32 tile (tile_m rows of tile_n columns, stride
// tile_n + 4) reuses the ring, which holds it at every plan: the largest tile
// in the shallowest ring.
static_assert(64 * (128 + 4) * 4 <= 3 * (64 * GROUP + 128 * HALF), "the SiLU-quant tile fits a ring of 3 slots");

// NT: n-tiles of 8 activation rows; a block's rows, tile_m = 8 * NT, are
// every consumer warp's rows.  KBLK: the K-blocked order (ng > 112).
// EPI_SILU_QUANT pairs the tiles: a slot's weights are one 3D box of tile_n / 2
// gate columns n0.. and as many up columns inter + n0.. (tmW, tmK viewed as
// [rows][2][inter]), its weight scales one more (tmS, [ng + 1][2][inter]
// float32), so a slot still takes three copies; the block is one rank of a
// cluster of 256 / tile_n (see the K10 note).  tmS is unused otherwise.
// I8 (K14): tmW maps the whole int8 w [(ng + 1) * 128, N] in boxes of 128 rows,
// a group a slot, every group read as the keeper is (tmK unused), the one
// unblocked chain.
template <int NT, int EPI, bool KBLK, bool I8 = false>
__global__ void __launch_bounds__(32 * (1 + MAX_CONSUMERS), 1)
gemm_core_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmW,
                 const __grid_constant__ CUtensorMap tmK, const __grid_constant__ CUtensorMap tmS,
                 const CoreParams p) {
  static_assert(!I8 || (EPI == EPI_F32 && !KBLK), "K14: the unblocked chain, f32 out");
  constexpr int BM = 8 * NT;
  constexpr int WR = I8 ? GROUP : HALF;  // weight byte rows a slot
  constexpr bool PAIRED = EPI == EPI_SILU_QUANT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const int S = p.stages, BN = p.tile_n, ng = p.ng;
  const int BW = PAIRED ? BN / 2 : BN;  // the block's output columns: the tile, or its gate (and up) channels
  const int consumers = BN / 16;
  unsigned char* ringA = base;                                     // S x BM x 128, 128-byte swizzle
  unsigned char* ringW = ringA + S * BM * GROUP;                   // S x WR rows x BN, swizzled (w_offset)
  float* ringS = reinterpret_cast<float*>(ringW + S * BN * WR);    // S x BN weight scales
  float* sa_s = ringS + S * BN;                                    // (ng + 1) x BM activation scales
  float* ht = sa_s + (ng + 1) * BM;                                // BM x HT (ring epilogue)
  float* cos_s = ht + BM * HT;                                     // BM x 128 each (ring epilogue)
  float* sin_s = cos_s + BM * HEAD;
  uint64_t* full = reinterpret_cast<uint64_t*>(ht + (EPI == EPI_RING ? BM * (HT + 2 * HEAD) : 0));
  uint64_t* empty = full + S;
  float* pmax = reinterpret_cast<float*>(empty + S);  // paired: MAX_RANKS x BM, the ranks' partial maxima of the rows
  const int n0 = blockIdx.x * BW, m0 = blockIdx.y * BM;  // paired: the block's first gate column
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr bool kblk = KBLK;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, consumers);
    }
    if constexpr (PAIRED) asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // producer: slot j < ng body group j, slot ng the keeper's rows 0-63 with
    // its activation tile and scale row, slot ng + 1 its rows 64-127; paired,
    // the weights and the scale row as the gate and the up columns' 3D boxes;
    // I8: slot j group j's 128 rows (the keeper the last) with its
    // activation tile and scale row
    if constexpr (I8) {
      if (lane == 0) {
        for (int j = 0, s = 0, ph = 0; j < ng + 1; ++j, s = s + 1 == S ? 0 : s + 1, ph ^= s == 0) {
          if (j >= S) mbar_wait(empty + s, ph ^ 1);
          mbar_expect(full + s, BN * GROUP + BM * GROUP + BN * 4);
          tma_load(ringW + s * BN * GROUP, &tmW, n0, j * GROUP, full + s);
          tma_load(ringA + s * BM * GROUP, &tmA, j * GROUP, m0, full + s);
          bulk_load(ringS + s * BN, p.sw + (size_t)j * p.N + n0, BN * 4, full + s);
        }
      }
      return;
    }
    if (lane == 0) {
      for (int j = 0, s = 0, ph = 0; j < ng + 2; ++j, s = s + 1 == S ? 0 : s + 1, ph ^= s == 0) {
        if (j >= S) mbar_wait(empty + s, ph ^ 1);
        const bool act = j <= ng;
        mbar_expect(full + s, BN * HALF + (act ? BM * GROUP + BN * 4 : 0));
        if constexpr (PAIRED)
          tma_load_3d(ringW + s * BN * HALF, j < ng ? &tmW : &tmK, n0, 0, (j < ng ? j : j - ng) * HALF, full + s);
        else
          tma_load(ringW + s * BN * HALF, j < ng ? &tmW : &tmK, n0, (j < ng ? j : j - ng) * HALF, full + s);
        if (act) {
          tma_load(ringA + s * BM * GROUP, &tmA, j * GROUP, m0, full + s);
          if constexpr (PAIRED)
            tma_load_3d(ringS + s * BN, &tmS, n0, 0, j, full + s);
          else
            bulk_load(ringS + s * BN, p.sw + (size_t)j * p.N + n0, BN * 4, full + s);
        }
      }
    }
    if constexpr (PAIRED) {  // the epilogue's cluster barrier counts every thread of the cluster
      __syncwarp();
      cg::this_cluster().sync();
    }
    return;
  }
  // while the ring fills, the consumers stage the block rows' activation
  // scales, group-major, the body groups' times 1/16 (their codes enter the
  // product as 16 x code), exactly (I8: every group's as it is); and for the
  // ring epilogue the rows' RoPE tables.  Loads first, then stores, so their
  // latencies overlap.
  {
    constexpr int PER = 8;
    const int ct = tid - 32, nct = consumers * 32, total = BM * (ng + 1);
    for (int i0 = ct; i0 < total; i0 += PER * nct) {
      float v[PER];
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int i = i0 + u * nct, r = i / (ng + 1);
        v[u] = i < total && m0 + r < p.M ? p.sa[(size_t)m0 * (ng + 1) + i] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int i = i0 + u * nct, r = i / (ng + 1), g = i % (ng + 1);
        if (i < total) sa_s[g * BM + r] = !I8 && g < ng ? __fmul_rn(v[u], 0.0625f) : v[u];
      }
    }
    if (EPI == EPI_RING)
      for (int i0 = ct; i0 < BM * HEAD; i0 += PER * nct) {
        float c[PER], sn[PER];
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          const int i = i0 + u * nct;
          const bool live = i < BM * HEAD && m0 + i / HEAD < p.M;
          c[u] = live ? p.cosv[(size_t)m0 * HEAD + i] : 0.f;
          sn[u] = live ? p.sinv[(size_t)m0 * HEAD + i] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          const int i = i0 + u * nct;
          if (i < BM * HEAD) {
            cos_s[i] = c[u];
            sin_s[i] = sn[u];
          }
        }
      }
    asm volatile("bar.sync 1, %0;\n" ::"r"(nct) : "memory");
  }
  const int wc = warp - 1;
  const int gid = lane >> 2, tig = lane & 3;
  const int c0 = wc * 16 + 2 * gid;  // this thread's weight columns in the tile: c0, c0 + 1
  uint32_t sel0 = 0, sel1 = 0;       // see load_cols
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const uint32_t k = (jj - tig) & 3;
    sel0 |= (2 * k) << (4 * jj);
    sel1 |= (2 * k + 1) << (4 * jj);
  }
  // offsets of this thread's 16-bit weight loads in a slot: 4-row step q
  // (rows 16q + 4tig + ..), load i
  uint32_t woff[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) woff[q][i] = w_offset(16 * q + 4 * tig + ((i + tig) & 3), c0, BN, PAIRED);
  // ldmatrix: lane l addresses row (l & 7) + 8 * (l >> 4) of its matrix pair,
  // 16-byte chunk +((l >> 3) & 1): matrices (rows 0-7, chunk q), (rows 0-7,
  // q + 1), (rows 8-15, q), (rows 8-15, q + 1) = b0, b1 of two n-tiles
  const int lrow = (lane & 7) + ((lane >> 4) << 3), lchunk = (lane >> 3) & 1;
  auto b_addr = [&](unsigned tile, int r, int chunk) {
    return tile + r * GROUP + (((chunk + lchunk) ^ (r & 7)) << 4);
  };

  // slot j's int32 dots into d, its scales into w2 / s2, then the slot is
  // released: body group j's k-step (plane, sh) takes weight rows sh*32..
  // (4-row steps 2sh, 2sh + 1) and activation chunks plane*4 + sh*2, +1.
  // I8: group j from its slot, each k-step st its int8 rows 32 st .. as the
  // keeper's below
  int fs = 0, fph = 0;  // ring stage and phase of the next slot fetch reads
  auto fetch = [&](int j, int (&d)[NT][4], float2& w2, float2 (&s2)[NT]) {
    const int s = fs;
    mbar_wait(full + s, fph);
    if (++fs == S) {
      fs = 0;
      fph ^= 1;
    }
    const unsigned char* ws = ringW + s * BN * WR;
    const unsigned at = smem_u32(ringA + s * BM * GROUP);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[nt][e] = 0;
    if constexpr (I8) {
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const unsigned char* wst = ws + (st >> 1) * HALF * BN;
        uint32_t a[4];
        load_cols(wst, woff[2 * (st & 1)], sel0, sel1, a[0], a[1]);
        load_cols(wst, woff[2 * (st & 1) + 1], sel0, sel1, a[2], a[3]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b, b_addr(at, np * 16 + lrow, 2 * st));
          mma_s8(d[2 * np], a, b[0], b[1]);
          mma_s8(d[2 * np + 1], a, b[2], b[3]);
        }
      }
    } else {
#pragma unroll
      for (int sh = 0; sh < 2; ++sh) {
        uint32_t t[4];  // a0..a3 of the k-step: columns c0, c0 + 1 of rows 4tig.., then of rows 16 + 4tig..
        load_cols(ws, woff[2 * sh], sel0, sel1, t[0], t[1]);
        load_cols(ws, woff[2 * sh + 1], sel0, sel1, t[2], t[3]);
#pragma unroll
        for (int plane = 0; plane < 2; ++plane) {
          uint32_t a[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) a[q] = plane ? (t[q] & 0xF0F0F0F0u) : ((t[q] << 4) & 0xF0F0F0F0u);
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t b[4];
            ldsm_x4(b, b_addr(at, np * 16 + lrow, plane * 4 + sh * 2));
            mma_s8(d[2 * np], a, b[0], b[1]);
            mma_s8(d[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
    }
    w2 = *reinterpret_cast<const float2*>(ringS + s * BN + c0);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s2[nt] = *reinterpret_cast<const float2*>(sa_s + j * BM + nt * 8 + 2 * tig);
    release_slot(empty + s, lane);
  };
  Chain acc[NT][4];
  auto chain = [&](const int (&d)[NT][4], const float2& w2, const float2 (&s2)[NT], int j) {
    const bool block_end = kblk && (j + 1) % KBLK_G == 0 && j + 1 < ng;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[nt][e].add(__fmul_rn(__fmul_rn(small_int_to_float(d[nt][e]), (e & 1) ? s2[nt].y : s2[nt].x),
                                 (e & 2) ? w2.y : w2.x),
                       kblk);
        if (block_end) acc[nt][e].block_end();
      }
  };
  // software pipeline: group j + 1's dots are issued before group j's float
  // chain (I8: over every group, the keeper the last: unblocked, its term is
  // one more add)
  const int nfetch = I8 ? ng + 1 : ng;
  int dA[NT][4], dB[NT][4];
  float2 wA, wB, sA[NT], sB[NT];
  fetch(0, dA, wA, sA);
  for (int j = 0; j < nfetch; j += 2) {
    if (j + 1 < nfetch) fetch(j + 1, dB, wB, sB);
    chain(dA, wA, sA, j);
    if (j + 1 >= nfetch) break;
    if (j + 2 < nfetch) fetch(j + 2, dA, wA, sA);
    chain(dB, wB, sB, j + 1);
  }
  if constexpr (!I8) {  // the keeper: int8 rows 0-63 in slot ng, 64-127 in slot ng + 1
    const int s0 = fs, s1 = fs + 1 == S ? 0 : fs + 1;
    mbar_wait(full + s0, fph);
    mbar_wait(full + s1, fph ^ (s1 == 0));
    const unsigned at = smem_u32(ringA + s0 * BM * GROUP);
    int d[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[nt][e] = 0;
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      const unsigned char* ws = ringW + (st < 2 ? s0 : s1) * BN * HALF;
      uint32_t a[4];
      load_cols(ws, woff[2 * (st & 1)], sel0, sel1, a[0], a[1]);
      load_cols(ws, woff[2 * (st & 1) + 1], sel0, sel1, a[2], a[3]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, b_addr(at, np * 16 + lrow, 2 * st));
        mma_s8(d[2 * np], a, b[0], b[1]);
        mma_s8(d[2 * np + 1], a, b[2], b[3]);
      }
    }
    const float2 w2 = *reinterpret_cast<const float2*>(ringS + s0 * BN + c0);
    float2 s2[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s2[nt] = *reinterpret_cast<const float2*>(sa_s + ng * BM + nt * 8 + 2 * tig);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[nt][e].keeper(__fmul_rn(__fmul_rn(small_int_to_float(d[nt][e]), (e & 1) ? s2[nt].y : s2[nt].x),
                                    (e & 2) ? w2.y : w2.x),
                          kblk);
  }
  // element e of n-tile nt: activation row nt*8 + 2tig + (e & 1), weight column c0 + (e >> 1)
  const int rows_here = min(BM, p.M - m0);
  if constexpr (PAIRED) {
    cg::cluster_group cluster = cg::this_cluster();
    // every consumer has read its last slot (and every copy has landed): the
    // f32 tile goes into the ring, gate columns [0, BW), up columns [BW, BN)
    const int ets = BN + 4;
    float* et = reinterpret_cast<float*>(ringA);
    asm volatile("bar.sync 2, %0;\n" ::"r"(consumers * 32) : "memory");
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(et + (nt * 8 + 2 * tig + h) * ets + c0) =
            make_float2(acc[nt][h].out, acc[nt][2 + h].out);
    asm volatile("bar.sync 2, %0;\n" ::"r"(consumers * 32) : "memory");
    // each row's tpr = 2 BN / BM consecutive consumer threads (2-16) take its
    // BW channels in turn (cpt = BW / tpr each, 4-16): act = SiLU(g) * u with
    // silu_mul_quant_kernel's arithmetic, then the row's partial |max| over
    // the block's channels by shuffles, stored into every rank's pmax at this
    // block's rank (its own included): after the one barrier each block reads
    // its own shared memory only, and none touches a partner's again
    const int ct = tid - 32, tpr = 2 * BN / BM, cpt = BW / tpr, r = ct / tpr, part = ct % tpr;
    const int ranks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
    float* row = et + r * ets;
    float mx = 0.f;
#pragma unroll 4
    for (int i = 0; i < cpt; ++i) {
      const int c = part + i * tpr;
      const float g = row[c], u = row[BW + c];
      const float v = __fmul_rn(__fdiv_rn(g, __fadd_rn(1.f, expf(-g))), u);
      row[c] = v;
      mx = fmaxf(mx, fabsf(v));
    }
    for (int o = tpr / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    for (int q = part; q < ranks; q += tpr) *cluster.map_shared_rank(pmax + rank * BM + r, q) = mx;
    cluster.sync();  // every rank's partial maxima have landed
    // the group's max over the ranks (exact in any order), then each thread
    // quantizes its channels with quant_group_store's arithmetic
    const int nblk = p.inter / GROUP, grp = n0 / GROUP;
    const bool keeper = grp == nblk - 1;
    const int qmax = keeper ? 127 : (1 << (p.abits - 1)) - 1;
    float pm[MAX_RANKS];
#pragma unroll
    for (int q = 0; q < MAX_RANKS; ++q) pm[q] = q < ranks ? pmax[q * BM + r] : 0.f;
    float amax = fmaxf(fmaxf(fmaxf(0.f, pm[0]), fmaxf(pm[1], pm[2])), pm[3]);
    amax = fmaxf(amax, 1e-5f);
    if (!keeper && p.a_clip < 1.f) amax = __fmul_rn(amax, p.a_clip);
    const float scale = __fdiv_rn(amax, (float)qmax);
    if (r < rows_here) {
      int8_t* codes = p.act + (size_t)(m0 + r) * p.inter + n0;
#pragma unroll 4
      for (int i = 0; i < cpt; ++i) {
        const int c = part + i * tpr;
        codes[c] = (signed char)fminf(fmaxf(rintf(__fdiv_rn(row[c], scale)), (float)(-qmax - 1)), (float)qmax);
      }
      if (part == 0 && rank == 0) p.act_scales[(size_t)(m0 + r) * nblk + grp] = scale;
    }
    return;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = nt * 8 + 2 * tig + h;
      const float v0 = acc[nt][h].out, v1 = acc[nt][2 + h].out;
      if (EPI == EPI_RING) {
        ht[r * HT + c0] = v0;
        ht[r * HT + c0 + 1] = v1;
        continue;
      }
      if (r >= rows_here) continue;
      const size_t o = (size_t)(m0 + r) * p.N + n0 + c0;
      if (EPI == EPI_F32) {
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) = make_float2(v0, v1);
      } else if (f32_out(EPI)) {
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) = make_float2(
            epi_value(EPI, v0, p.resid, p.row_scale, o, m0 + r), epi_value(EPI, v1, p.resid, p.row_scale, o + 1, m0 + r));
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + o) = __floats2bfloat162_rn(
            epi_value(EPI, v0, p.resid, p.row_scale, o, m0 + r), epi_value(EPI, v1, p.resid, p.row_scale, o + 1, m0 + r));
      }
    }
  if (EPI == EPI_RING) {
    asm volatile("bar.sync 2, %0;\n" ::"r"(consumers * 32) : "memory");  // the consumers' tile is whole
    for (int r = wc; r < rows_here; r += consumers)
      ring_row(ht + r * HT, cos_s + r * HEAD, sin_s + r * HEAD, p, m0 + r, blockIdx.x, lane);
  }
}

// ---------------------------------------------------------------------------
// The prefill GEMM (M > 64, and K7)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of these registers across a
// wgmma fence or wait (the wgmmas in flight read or write them)
template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) asm volatile("" : "+r"(d[j])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(a[k][q])::"memory");
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row atoms 1024 bytes apart
__device__ __forceinline__ uint64_t swizzle128_desc(const void* smem) {
  const uint64_t addr = smem_u32(smem);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d[64 x 64] (+)= a[64 x 32] (registers, s8) x b[32 x 64] (shared memory, s8, descriptor), int32
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// One group's A operand for a consumer thread: k-step j's four registers
// (its columns c0 and c0 + 1 as rows gid and gid + 8 of its warp's 16), the
// group's weight scales of those columns and the ring stage of its activation tile.
struct Frag {
  uint32_t a[4][4];
  float2 w2;
  int s;
};

// H: 64-row halves of a block (tile_m = 64 H); NWG: consumer warpgroups, one
// per 64 columns (tile_n = 64 NWG); KBLK: the K-blocked order (ng > 112).
// Warps 0 .. 4 NWG - 1 consume, warp 4 NWG is the producer (a warpgroup's
// warps must be 4 aligned ones).  Unit (g, h): group g (ng the keeper) on rows
// 64h .. 64h + 63 of the block; the units run in order g-major.  I8 (K14):
// as the core's, a group a 128-row slot, every group built as the keeper is.
template <int H, int NWG, int EPI, bool KBLK, bool I8 = false>
__global__ void __launch_bounds__(128 * NWG + 32, 1)
gemm_prefill_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmW,
                    const __grid_constant__ CUtensorMap tmK, const CoreParams p) {
  constexpr int BM = 64 * H, BN = 64 * NWG, CW = 4 * NWG;
  constexpr int WR = I8 ? GROUP : HALF;  // weight byte rows a slot
  static_assert(!(KBLK && H > 1), "the K-blocked order's partial chains fit registers at 64 rows");
  static_assert(!I8 || (EPI == EPI_F32 && !KBLK), "K14: the unblocked chain, f32 out");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const int S = p.stages, ng = p.ng;
  unsigned char* ringA = base;                                     // S x BM x 128, 128-byte swizzle
  unsigned char* ringW = ringA + S * BM * GROUP;                   // S x WR rows x BN, swizzled (w_offset)
  float* ringS = reinterpret_cast<float*>(ringW + S * BN * WR);    // S x BN weight scales
  float* sa_s = ringS + S * BN;                                    // (ng + 1) x BM activation scales
  uint64_t* full = reinterpret_cast<uint64_t*>(sa_s + (ng + 1) * BM);
  uint64_t* empty = full + S;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CW);
    }
  }
  __syncthreads();

  if (warp == CW) {
    // producer: slot j < ng body group j, slot ng the keeper's rows 0-63 with
    // its activation tile and scale row, slot ng + 1 its rows 64-127; I8 as
    // the core's producer
    if constexpr (I8) {
      if (lane == 0) {
        const int sw_bytes = min(BN, p.N - n0) * 4;
        for (int j = 0, s = 0, ph = 0; j < ng + 1; ++j, s = s + 1 == S ? 0 : s + 1, ph ^= s == 0) {
          if (j >= S) mbar_wait(empty + s, ph ^ 1);
          mbar_expect(full + s, BN * GROUP + BM * GROUP + sw_bytes);
          tma_load(ringW + s * BN * GROUP, &tmW, n0, j * GROUP, full + s);
          tma_load(ringA + s * BM * GROUP, &tmA, j * GROUP, m0, full + s);
          bulk_load(ringS + s * BN, p.sw + (size_t)j * p.N + n0, sw_bytes, full + s);
        }
      }
      return;
    }
    if (lane == 0) {
      const int sw_bytes = min(BN, p.N - n0) * 4;
      for (int j = 0, s = 0, ph = 0; j < ng + 2; ++j, s = s + 1 == S ? 0 : s + 1, ph ^= s == 0) {
        if (j >= S) mbar_wait(empty + s, ph ^ 1);
        const bool act = j <= ng;
        mbar_expect(full + s, BN * HALF + (act ? BM * GROUP + sw_bytes : 0));
        tma_load(ringW + s * BN * HALF, j < ng ? &tmW : &tmK, n0, (j < ng ? j : j - ng) * HALF, full + s);
        if (act) {
          tma_load(ringA + s * BM * GROUP, &tmA, j * GROUP, m0, full + s);
          bulk_load(ringS + s * BN, p.sw + (size_t)j * p.N + n0, sw_bytes, full + s);
        }
      }
    }
    return;
  }
  // while the ring fills, the consumers stage the block rows' activation
  // scales, group-major, the body groups' times 1/16 (as the decode core;
  // I8: every group's as it is)
  {
    constexpr int PER = 8, nct = CW * 32;
    const int total = BM * (ng + 1);
    for (int i0 = tid; i0 < total; i0 += PER * nct) {
      float v[PER];
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int i = i0 + u * nct, r = i / (ng + 1);
        v[u] = i < total && m0 + r < p.M ? p.sa[(size_t)m0 * (ng + 1) + i] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const int i = i0 + u * nct, r = i / (ng + 1), g = i % (ng + 1);
        if (i < total) sa_s[g * BM + r] = !I8 && g < ng ? __fmul_rn(v[u], 0.0625f) : v[u];
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"r"(nct) : "memory");
  }
  const int gid = lane >> 2, tig = lane & 3;
  const int c0 = warp * 16 + 2 * gid;  // this thread's weight columns in the tile: c0, c0 + 1
  uint32_t sel0 = 0, sel1 = 0;         // see load_cols
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const uint32_t k = (jj - tig) & 3;
    sel0 |= (2 * k) << (4 * jj);
    sel1 |= (2 * k + 1) << (4 * jj);
  }
  // offsets of this thread's 16-bit weight loads in the 4-row step 0 (rows
  // 4tig + ..); step q adds q * 16 rows (the swizzle repeats every 8 rows)
  uint32_t wb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) wb[i] = w_offset(4 * tig + ((i + tig) & 3), c0, BN);
  auto woff = [&](int q, uint32_t (&o)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = wb[i] + q * 16 * BN;
  };

  int fs = 0, fph = 0;  // ring stage and phase of the next slot to wait for
  auto next_full = [&]() {
    const int s = fs;
    mbar_wait(full + s, fph);
    if (++fs == S) {
      fs = 0;
      fph ^= 1;
    }
    return s;
  };
  // group g's fragments from its slot (the keeper's from its two): body k-step
  // j = 2 plane + sh takes weight rows 32 sh .. (4-row steps 2sh, 2sh + 1) in
  // the plane's nibble and activation bytes 32 j ..; the keeper's k-step st
  // its rows 32 st .. (slot st / 2)
  auto build = [&](int g, Frag& F) {
    const int s = next_full();
    F.s = s;
    uint32_t o0[4], o1[4];
    if constexpr (I8) {  // every group as the keeper below
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const unsigned char* ws = ringW + s * BN * GROUP + (st >> 1) * HALF * BN;
        woff(2 * (st & 1), o0);
        woff(2 * (st & 1) + 1, o1);
        load_cols(ws, o0, sel0, sel1, F.a[st][0], F.a[st][1]);
        load_cols(ws, o1, sel0, sel1, F.a[st][2], F.a[st][3]);
      }
    } else if (g < ng) {
      const unsigned char* ws = ringW + s * BN * HALF;
#pragma unroll
      for (int sh = 0; sh < 2; ++sh) {
        uint32_t t[4];
        woff(2 * sh, o0);
        woff(2 * sh + 1, o1);
        load_cols(ws, o0, sel0, sel1, t[0], t[1]);
        load_cols(ws, o1, sel0, sel1, t[2], t[3]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          F.a[sh][q] = (t[q] << 4) & 0xF0F0F0F0u;  // 16 x code r
          F.a[2 + sh][q] = t[q] & 0xF0F0F0F0u;     // 16 x code r + 64
        }
      }
    } else {
      const int s1 = next_full();
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        const unsigned char* ws = ringW + (st < 2 ? s : s1) * BN * HALF;
        woff(2 * (st & 1), o0);
        woff(2 * (st & 1) + 1, o1);
        load_cols(ws, o0, sel0, sel1, F.a[st][0], F.a[st][1]);
        load_cols(ws, o1, sel0, sel1, F.a[st][2], F.a[st][3]);
      }
    }
    F.w2 = *reinterpret_cast<const float2*>(ringS + s * BN + c0);
  };
  int rs = 0;  // ring stage of the next slot to release
  auto release = [&]() {
    release_slot(empty + rs, lane);
    if (++rs == S) rs = 0;
  };
  const uint64_t desc0 = swizzle128_desc(ringA);
  auto issue = [&](const Frag& F, int h, int (&d)[32]) {
    const uint64_t desc = desc0 + (uint64_t)((F.s * BM * GROUP + h * 64 * GROUP) >> 4);
    wgmma_fence();
    fence_regs(d);
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_s8_n64(d, F.a[j], desc + 2 * j, j);  // k-step j: 32 bytes on
    wgmma_commit();
  };
  // element j of a unit: activation row 8 (j >> 2) + 2 tig + (j & 1) of its
  // 64, weight column c0 + ((j >> 1) & 1)
  Chain ch[H][32];
  auto fold = [&](const int (&d)[32], int g, int h, float2 w2, bool keeper) {
    const bool block_end = KBLK && !keeper && (g + 1) % KBLK_G == 0 && g + 1 < ng;
    const float* sas = sa_s + g * BM + h * 64 + 2 * tig;
    float2 s2[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s2[i] = *reinterpret_cast<const float2*>(sas + 8 * i);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float t = __fmul_rn(__fmul_rn(small_int_to_float(d[j]), (j & 1) ? s2[j >> 2].y : s2[j >> 2].x),
                                (j & 2) ? w2.y : w2.x);
      if (keeper) {
        ch[h][j].keeper(t, KBLK);
      } else {
        ch[h][j].add(t, KBLK);
        if (block_end) ch[h][j].block_end();
      }
    }
  };
  // unit (g, h) of the group whose fragments are F is in flight into d: issue
  // the next unit into dn (the group's next half, or group g + 1's first, its
  // fragments built into Fn), wait for (g, h) and fold it; a body group's slot
  // is released after its last unit.  Straight-line from the issue to the
  // fold, so that ptxas sees which accumulator set the wait has finished.
  auto step = [&](int g, int h, int (&d)[32], int (&dn)[32], Frag& F, Frag& Fn) {
    if (h + 1 < H) {
      issue(F, h + 1, dn);
    } else {
      build(g + 1, Fn);
      issue(Fn, 0, dn);
    }
    wgmma_wait<1>();
    fence_regs(d);
    if (h + 1 == H) {
      fence_regs(F.a);  // the finished wgmmas read these until the wait
      release();
    }
    fold(d, g, h, F.w2, false);
  };
  // the keeper's units, the last ones: (ng, 0) is in flight into d
  auto last = [&](int (&d)[32], int (&dn)[32], Frag& F) {
    if constexpr (H == 2) {
      issue(F, 1, dn);
      wgmma_wait<1>();
      fence_regs(d);
      fold(d, ng, 0, F.w2, true);
      wgmma_wait<0>();
      fence_regs(dn);
      fold(dn, ng, 1, F.w2, true);
    } else {
      wgmma_wait<0>();
      fence_regs(d);
      fold(d, ng, 0, F.w2, true);
    }
  };
  int dA[32], dB[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) dA[j] = dB[j] = 0;
  Frag F0, F1;
  build(0, F0);
  issue(F0, 0, dA);
  int g = 0;
  for (; g + 2 <= ng; g += 2) {  // two body groups, a third group after them
    if constexpr (H == 2) {
      step(g, 0, dA, dB, F0, F1);
      step(g, 1, dB, dA, F0, F1);
      step(g + 1, 0, dA, dB, F1, F0);
      step(g + 1, 1, dB, dA, F1, F0);
    } else {
      step(g, 0, dA, dB, F0, F1);
      step(g + 1, 0, dB, dA, F1, F0);
    }
  }
  if (g < ng) {  // the last body group, then the keeper
    if constexpr (H == 2) {
      step(g, 0, dA, dB, F0, F1);
      step(g, 1, dB, dA, F0, F1);
      last(dA, dB, F1);
    } else {
      step(g, 0, dA, dB, F0, F1);
      last(dB, dA, F1);
    }
  } else {
    last(dA, dB, F0);
  }
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (j & 2) continue;  // j and j + 2: columns c0 and c0 + 1 of one row
      const int row = m0 + h * 64 + 8 * (j >> 2) + 2 * tig + (j & 1);
      if (row >= p.M || n0 + c0 >= p.N) continue;
      const float v0 = ch[h][j].out, v1 = ch[h][j + 2].out;
      const size_t o = (size_t)row * p.N + n0 + c0;
      if (EPI == EPI_F32) {
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) = make_float2(v0, v1);
      } else if (f32_out(EPI)) {
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + o) = make_float2(
            epi_value(EPI, v0, p.resid, p.row_scale, o, row), epi_value(EPI, v1, p.resid, p.row_scale, o + 1, row));
      } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + o) = __floats2bfloat162_rn(
            epi_value(EPI, v0, p.resid, p.row_scale, o, row), epi_value(EPI, v1, p.resid, p.row_scale, o + 1, row));
      }
    }
}

// ---------------------------------------------------------------------------
// Prologue, SiLU, the prefill epilogue
// ---------------------------------------------------------------------------

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

// Prologue of K2, K9 and K10: block (m, b) quantizes groups 8b .. 8b + 7 of
// token row m, a warp each (all of a row's loads in flight at once).  With a
// norm weight: xn = bf16(y * rstd); v = bf16(xn * wg); without (wg null):
// v = y.  Then per 128-group symmetric quantization (INT4 body with clip, the
// last group an INT8 keeper without clip).  GATHER (K9 and K10): channel k is
// y[m, idx[k]], the layer's reorder gather read in place (wg is already
// gathered, and rstd, the row's statistic, does not depend on the order);
// K2's instance reads y[m, k].
template <bool GATHER>
__global__ void __launch_bounds__(256)
quant_prologue_kernel(const __nv_bfloat16* __restrict__ y, const int* __restrict__ idx,
                      const __nv_bfloat16* __restrict__ wg, const float* __restrict__ rstd, int8_t* __restrict__ a,
                      float* __restrict__ sa, int K, int ng, int abits, float a_clip) {
  const int m = blockIdx.x, g = blockIdx.y * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const bool norm = wg != nullptr;
  const float r = norm ? rstd[m] : 1.f;
  if (g <= ng) {
    const int k0 = g * GROUP + lane * 4;
    int src[4] = {k0, k0 + 1, k0 + 2, k0 + 3};
    if constexpr (GATHER) {
      const int4 i4 = *reinterpret_cast<const int4*>(idx + k0);
      src[0] = i4.x;
      src[1] = i4.y;
      src[2] = i4.z;
      src[3] = i4.w;
    }
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = __bfloat162float(y[(size_t)m * K + src[i]]);
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
// Block (m, b) takes 128-channel blocks 8b .. 8b + 7 of row m, a warp each.
__global__ void __launch_bounds__(256)
silu_mul_quant_kernel(const float* __restrict__ gu, int8_t* __restrict__ a, float* __restrict__ sa,
                      int inter, int abits, float a_clip) {
  const int m = blockIdx.x, blk = blockIdx.y * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int nblk = inter / GROUP;
  const float* row = gu + (size_t)m * 2 * inter;
  if (blk < nblk) {
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

// The per-head arithmetic of the prefill epilogue (K7), for block (m, head
// column block hb) with one thread per channel d (ring_row is the same
// arithmetic a warp per row).  Column blocks [0, n_q/128) are q heads, then H
// k heads, then H v heads.  q and k are rotated (RoPE) in float32; k (after
// RoPE) and v get the per-head asymmetric u4 quantization of
// ops/reference.py quantize_kv_asym: scale = bf16((max - min, at least 1e-5) /
// 15), zero = clamp(rint(-min / scale), 0, 15), code = clamp(rint(x / scale) +
// zero, 0, 15), and the stored zero value is bf16(-zero * scale).
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

// K14b's second launch: the per-head asymmetric u4 quantization of the f32
// product x [M, N] (head_rope_quant without RoPE, a block per row and head),
// one byte per code [M, N] and float32 params [M, N / 128, 2] = (scale, zero
// value), both bf16-rounded.
__global__ void __launch_bounds__(HEAD)
head_codes_kernel(const float* __restrict__ x, int8_t* __restrict__ codes, float* __restrict__ prm, int N) {
  __shared__ float red[4];
  const int m = blockIdx.x, hb = blockIdx.y, d = threadIdx.x;
  const size_t o = (size_t)m * N + (size_t)hb * HEAD;
  const HeadValue hv = head_rope_quant(x + o, nullptr, nullptr, m, d, false, true, red);
  codes[o + d] = (int8_t)hv.code;
  if (d == 0) {
    float* pr = prm + ((size_t)m * (N / HEAD) + hb) * 2;
    pr[0] = hv.scale;
    pr[1] = hv.zero_val;
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

// The launch plan of ops/gemm_packed.py::PackedW4Plan.args(): the decode core
// (1) or the prefill GEMM (0), block rows and columns, ring stages.
struct Plan {
  int core, tile_m, tile_n, stages;
};

Plan plan_of(const int* v) { return Plan{v[0], v[1], v[2], v[3]}; }

// A 2D int8 tensor map over [outer, inner] (row stride `inner` bytes), boxes
// of box_outer x box_inner; rows past `outer` read as zeros.
int encode_map(CUtensorMap* tm, const void* ptr, int inner, int outer, int box_inner, int box_outer,
               CUtensorMapSwizzle swizzle) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &q);
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess || !encode) return (int)cudaErrorNotSupported;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer}, elem[2] = {1, 1};
  const CUresult r = encode(tm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The cluster launch of the SiLU-quant epilogue: 256 / tile_n blocks (one
// 128-channel group of t = tile_n / 2 channels each) a cluster along x.
cudaLaunchConfig_t silu_cluster_config(const Plan& pl, int M, int N, int smem, cudaStream_t st,
                                       cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / pl.tile_n, (M + pl.tile_m - 1) / pl.tile_m, 1);
  cfg.blockDim = dim3(32 * (1 + pl.tile_n / 16), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2 * GROUP / pl.tile_n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// A 3D tensor map over a [outer][2][inner] view of a [outer, row_bytes] array
// whose halves start `inner` elements apart (K10's gate and up columns), boxes
// of box_inner x 2 x box_outer, with L2 promotion to 128 bytes.
int encode_map_3d(CUtensorMap* tm, CUtensorMapDataType type, const void* ptr, int inner, int outer, int row_bytes,
                  int box_inner, int box_outer, CUtensorMapSwizzle swizzle) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &q);
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess || !encode) return (int)cudaErrorNotSupported;
  }
  const int elem_bytes = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 1;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, 2, (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * elem_bytes, (cuuint64_t)row_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, 2, (cuuint32_t)box_outer}, elem[3] = {1, 1, 1};
  const CUresult r = encode(tm, type, 3, const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NT, int EPI>
int launch_core_nt(const CUtensorMap& ta, const CUtensorMap& tw, const CUtensorMap& tk, const CUtensorMap& ts,
                   const CoreParams& p, const Plan& pl, int smem, cudaStream_t st) {
  const bool kblk = p.ng > KBLK_THRESHOLD;
  auto kernel = kblk ? gemm_core_kernel<NT, EPI, true> : gemm_core_kernel<NT, EPI, false>;
  static bool ready[2] = {false, false};
  if (!ready[kblk]) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return (int)err;
    ready[kblk] = true;
  }
  if constexpr (EPI == EPI_SILU_QUANT) {
    // the cluster's blocks must fit at once: refuse a layout the card cannot co-schedule
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = silu_cluster_config(pl, p.M, p.N, smem, st, attr);
    static int checked_smem[2] = {0, 0};
    if (checked_smem[kblk] != smem) {
      int clusters = 0;
      const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
      checked_smem[kblk] = smem;
    }
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, ta, tw, tk, ts, p);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  const dim3 grid(p.N / pl.tile_n, (p.M + pl.tile_m - 1) / pl.tile_m, 1);
  kernel<<<grid, 32 * (1 + pl.tile_n / 16), smem, st>>>(ta, tw, tk, ts, p);
  return (int)cudaGetLastError();
}

// The core on a [M, (ng + 1) * 128] int8 activation, with the epilogue's
// operands in p (its inputs and geometry filled here).  A plan the kernel
// cannot run is refused.
template <int EPI>
int launch_core(const void* a, const void* wp, const void* wk, const void* sa, const void* sw, CoreParams p,
                int M, int N, int ng, const Plan& pl, cudaStream_t st) {
  const bool paired = EPI == EPI_SILU_QUANT;  // N = 2 * inter, 256 / tile_n blocks a 128-channel group
  const bool shape_ok = ng >= 1 && (pl.tile_m == 16 || pl.tile_m == 32 || pl.tile_m == 64) &&
                        (pl.tile_n == 32 || pl.tile_n == 64 || pl.tile_n == 128) && N % pl.tile_n == 0 &&
                        pl.stages >= 3 && (EPI != EPI_RING || (pl.tile_n == HEAD && pl.tile_m <= 32)) &&
                        (!paired || (pl.tile_n >= 64 && N == 2 * p.inter && p.inter % GROUP == 0));
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  const int smem = core_smem(pl.tile_m, pl.tile_n, pl.stages, ng, EPI == EPI_RING, paired);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tw, tk, ts = {};
  int e = encode_map(&ta, a, (ng + 1) * GROUP, M, GROUP, pl.tile_m, CU_TENSOR_MAP_SWIZZLE_128B);
  if (paired) {  // [rows][gate, up][inter] views; boxes of tile_n / 2 columns of each half
    const int t = pl.tile_n / 2;
    const CUtensorMapSwizzle psw = t == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
    if (!e) e = encode_map_3d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, wp, p.inter, ng * HALF, N, t, HALF, psw);
    if (!e) e = encode_map_3d(&tk, CU_TENSOR_MAP_DATA_TYPE_UINT8, wk, p.inter, GROUP, N, t, HALF, psw);
    if (!e) e = encode_map_3d(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sw, p.inter, ng + 1, N * 4, t, 1,
                              CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    const CUtensorMapSwizzle wsw = pl.tile_n == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : pl.tile_n == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE;
    if (!e) e = encode_map(&tw, wp, N, ng * HALF, pl.tile_n, HALF, wsw);
    if (!e) e = encode_map(&tk, wk, N, GROUP, pl.tile_n, HALF, wsw);
  }
  if (e) return e;
  p.sa = (const float*)sa;
  p.sw = (const float*)sw;
  p.M = M;
  p.N = N;
  p.ng = ng;
  p.tile_m = pl.tile_m;
  p.tile_n = pl.tile_n;
  p.stages = pl.stages;
  switch (pl.tile_m) {
    case 16: return launch_core_nt<2, EPI>(ta, tw, tk, ts, p, pl, smem, st);
    case 32: return launch_core_nt<4, EPI>(ta, tw, tk, ts, p, pl, smem, st);
  }
  return launch_core_nt<8, EPI>(ta, tw, tk, ts, p, pl, smem, st);
}

template <int H, int NWG, int EPI, bool KBLK, bool I8 = false>
int launch_prefill_k(const CUtensorMap& ta, const CUtensorMap& tw, const CUtensorMap& tk, const CoreParams& p,
                     int smem, cudaStream_t st) {
  auto kernel = gemm_prefill_kernel<H, NWG, EPI, KBLK, I8>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const dim3 grid((p.M + 64 * H - 1) / (64 * H), (p.N + 64 * NWG - 1) / (64 * NWG), 1);
  kernel<<<grid, 128 * NWG + 32, smem, st>>>(ta, tw, tk, p);
  return (int)cudaGetLastError();
}

template <int H, int NWG, int EPI>
int launch_prefill_hn(const CUtensorMap& ta, const CUtensorMap& tw, const CUtensorMap& tk, const CoreParams& p,
                      int smem, cudaStream_t st) {
  if (p.ng <= KBLK_THRESHOLD) return launch_prefill_k<H, NWG, EPI, false>(ta, tw, tk, p, smem, st);
  if constexpr (H == 1) return launch_prefill_k<1, NWG, EPI, true>(ta, tw, tk, p, smem, st);
  return (int)cudaErrorInvalidValue;  // the K-blocked order runs 64-row blocks
}

// The prefill GEMM on a [M, (ng + 1) * 128] int8 activation, with the
// epilogue's operands in p (its inputs and geometry filled here).  A plan the
// kernel cannot run is refused.
template <int EPI>
int launch_prefill(const void* a, const void* wp, const void* wk, const void* sa, const void* sw, CoreParams p,
                   int M, int N, int ng, const Plan& pl, cudaStream_t st) {
  const bool shape_ok = ng >= 0 && (pl.tile_m == 64 || pl.tile_m == 128) && (pl.tile_n == 64 || pl.tile_n == 128) &&
                        N % 32 == 0 && pl.stages >= 3 && (ng <= KBLK_THRESHOLD || pl.tile_m == 64);
  if (!shape_ok) return (int)cudaErrorInvalidValue;
  const int smem = core_smem(pl.tile_m, pl.tile_n, pl.stages, ng, false);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tw, tk;
  const CUtensorMapSwizzle wsw = pl.tile_n == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  int e = encode_map(&ta, a, (ng + 1) * GROUP, M, GROUP, pl.tile_m, CU_TENSOR_MAP_SWIZZLE_128B);
  // no body group (K = 128): the body map is never read; it maps the keeper
  if (!e) e = ng ? encode_map(&tw, wp, N, ng * HALF, pl.tile_n, HALF, wsw) : encode_map(&tw, wk, N, GROUP, pl.tile_n, HALF, wsw);
  if (!e) e = encode_map(&tk, wk, N, GROUP, pl.tile_n, HALF, wsw);
  if (e) return e;
  p.sa = (const float*)sa;
  p.sw = (const float*)sw;
  p.M = M;
  p.N = N;
  p.ng = ng;
  p.tile_m = pl.tile_m;
  p.tile_n = pl.tile_n;
  p.stages = pl.stages;
  if (pl.tile_m == 64)
    return pl.tile_n == 64 ? launch_prefill_hn<1, 1, EPI>(ta, tw, tk, p, smem, st)
                           : launch_prefill_hn<1, 2, EPI>(ta, tw, tk, p, smem, st);
  return pl.tile_n == 64 ? launch_prefill_hn<2, 1, EPI>(ta, tw, tk, p, smem, st)
                         : launch_prefill_hn<2, 2, EPI>(ta, tw, tk, p, smem, st);
}

// The GEMM with an F32 / RESID / ROW_SCALE epilogue on the plan's kernel.
template <int EPI>
int launch_gemm(const void* a, const void* wp, const void* wk, const void* sa, const void* sw, void* out,
                const void* resid, const void* row_scale, int M, int N, int ng, const Plan& pl, cudaStream_t st) {
  CoreParams p = {};
  p.out = out;
  p.resid = resid;
  p.row_scale = (const float*)row_scale;
  if (!pl.core) return launch_prefill<EPI>(a, wp, wk, sa, sw, p, M, N, ng, pl, st);
  return launch_core<EPI>(a, wp, wk, sa, sw, p, M, N, ng, pl, st);
}

// The qkv GEMM with the ring epilogue (K2's second launch, K8).
int launch_ring(const void* a, const void* wp, const void* wk, const void* sa, const void* sw, const void* cosv,
                const void* sinv, void* q, void* ring_k, void* ring_prm, void* ring_v, int M, int ng, int n_q, int H,
                int W, int row, const Plan& pl, cudaStream_t st) {
  if (!pl.core) return (int)cudaErrorInvalidValue;
  CoreParams p = {};
  p.cosv = (const float*)cosv;
  p.sinv = (const float*)sinv;
  p.q = (__nv_bfloat16*)q;
  p.ring_k = (int8_t*)ring_k;
  p.ring_prm = (__nv_bfloat16*)ring_prm;
  p.ring_v = (int8_t*)ring_v;
  p.n_q = n_q;
  p.H = H;
  p.W = W;
  p.row = row;
  return launch_core<EPI_RING>(a, wp, wk, sa, sw, p, M, n_q + 2 * H * HEAD, ng, pl, st);
}

// idx null: y read as it lies (K2); else the gathered instance (K9, K10).
cudaError_t launch_prologue(const void* y, const void* idx, const void* wg, const void* rstd, void* a, void* sa,
                            int M, int K, int abits, float a_clip, cudaStream_t st) {
  auto kernel = idx != nullptr ? quant_prologue_kernel<true> : quant_prologue_kernel<false>;
  kernel<<<dim3(M, (K / GROUP + 7) / 8), 256, 0, st>>>((const __nv_bfloat16*)y, (const int*)idx,
                                                     (const __nv_bfloat16*)wg, (const float*)rstd, (int8_t*)a,
                                                     (float*)sa, K, K / GROUP - 1, abits, a_clip);
  return cudaGetLastError();
}

// K10's down GEMM on the act codes, with the epilogue its residual and row scale select.
int launch_down(const void* act, const void* act_scales, const void* wp, const void* wk, const void* sw,
                const void* resid, const void* row_scale, void* out, int M, int D, int inter, int resid_f32,
                const Plan& pl, cudaStream_t st) {
  const int nga = inter / GROUP - 1;
  if (resid_f32 && row_scale != nullptr)
    return launch_gemm<EPI_ROW_SCALE_F32>(act, wp, wk, act_scales, sw, out, resid, row_scale, M, D, nga, pl, st);
  if (resid_f32)
    return launch_gemm<EPI_RESID_F32>(act, wp, wk, act_scales, sw, out, resid, nullptr, M, D, nga, pl, st);
  if (row_scale != nullptr)
    return launch_gemm<EPI_ROW_SCALE>(act, wp, wk, act_scales, sw, out, resid, row_scale, M, D, nga, pl, st);
  return launch_gemm<EPI_RESID>(act, wp, wk, act_scales, sw, out, resid, nullptr, M, D, nga, pl, st);
}

// K10's gate/up GEMM on the core with the SiLU-quant epilogue (a paired plan).
int launch_gate_up_silu(const void* a, const void* wp, const void* wk, const void* sa, const void* sw, void* act,
                        void* act_scales, int M, int D, int inter, int abits, float a_clip, const Plan& pl,
                        cudaStream_t st) {
  if (!pl.core) return (int)cudaErrorInvalidValue;
  CoreParams p = {};
  p.act = (int8_t*)act;
  p.act_scales = (float*)act_scales;
  p.inter = inter;
  p.abits = abits;
  p.a_clip = a_clip;
  return launch_core<EPI_SILU_QUANT>(a, wp, wk, sa, sw, p, M, 2 * inter, D / GROUP - 1, pl, st);
}

// K14: the core's int8-weight form in blocks of 8 NT rows (tmW as tmK and tmS: unused there).
template <int NT>
int launch_core_i8(const CUtensorMap& ta, const CUtensorMap& tw, const CoreParams& p, int smem, cudaStream_t st) {
  auto kernel = gemm_core_kernel<NT, EPI_F32, false, true>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const dim3 grid(p.N / p.tile_n, (p.M + p.tile_m - 1) / p.tile_m, 1);
  kernel<<<grid, 32 * (1 + p.tile_n / 16), smem, st>>>(ta, tw, tw, tw, p);
  return (int)cudaGetLastError();
}

// K14a on the plan's kernel (the core or the prefill GEMM, ops/gemm.py::grouped_int8_plan):
// a int8 [M, (ng + 1) * 128], w int8 [(ng + 1) * 128, N] a group a slot, sa f32 [M, ng + 1],
// sw f32 [ng + 1, N] -> out f32 [M, N], the unblocked order at any ng.  A plan the kernels
// cannot run is refused.
int launch_int8(const void* a, const void* w, const void* sa, const void* sw, void* out, int M, int N, int ng,
                const Plan& pl, cudaStream_t st) {
  const bool core_ok = (pl.tile_m == 16 || pl.tile_m == 32 || pl.tile_m == 64) &&
                       (pl.tile_n == 32 || pl.tile_n == 64 || pl.tile_n == 128) && N % pl.tile_n == 0;
  const bool prefill_ok = (pl.tile_m == 64 || pl.tile_m == 128) && (pl.tile_n == 64 || pl.tile_n == 128) &&
                          N % 32 == 0;
  if (ng < 0 || pl.stages < 3 || !(pl.core ? core_ok : prefill_ok)) return (int)cudaErrorInvalidValue;
  const int smem = core_smem(pl.tile_m, pl.tile_n, pl.stages, ng, false, false, GROUP);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const CUtensorMapSwizzle wsw = pl.tile_n == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                : pl.tile_n == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap ta, tw;
  int e = encode_map(&ta, a, (ng + 1) * GROUP, M, GROUP, pl.tile_m, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!e) e = encode_map(&tw, w, N, (ng + 1) * GROUP, pl.tile_n, GROUP, wsw);
  if (e) return e;
  CoreParams p = {};
  p.out = out;
  p.sa = (const float*)sa;
  p.sw = (const float*)sw;
  p.M = M;
  p.N = N;
  p.ng = ng;
  p.tile_m = pl.tile_m;
  p.tile_n = pl.tile_n;
  p.stages = pl.stages;
  if (pl.core) {
    switch (pl.tile_m) {
      case 16: return launch_core_i8<2>(ta, tw, p, smem, st);
      case 32: return launch_core_i8<4>(ta, tw, p, smem, st);
    }
    return launch_core_i8<8>(ta, tw, p, smem, st);
  }
  if (pl.tile_m == 64)
    return pl.tile_n == 64 ? launch_prefill_k<1, 1, EPI_F32, false, true>(ta, tw, tw, p, smem, st)
                           : launch_prefill_k<1, 2, EPI_F32, false, true>(ta, tw, tw, p, smem, st);
  return pl.tile_n == 64 ? launch_prefill_k<2, 1, EPI_F32, false, true>(ta, tw, tw, p, smem, st)
                         : launch_prefill_k<2, 2, EPI_F32, false, true>(ta, tw, tw, p, smem, st);
}

template <int NT>
int silu_max_clusters_nt(const Plan& pl, int ng, int* clusters) {
  auto kernel = ng > KBLK_THRESHOLD ? gemm_core_kernel<NT, EPI_SILU_QUANT, true>
                                    : gemm_core_kernel<NT, EPI_SILU_QUANT, false>;
  const int smem = core_smem(pl.tile_m, pl.tile_n, pl.stages, ng, false, true);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = silu_cluster_config(pl, pl.tile_m, 2 * GROUP * 132, smem, 0, attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

}  // namespace

// Every entry point takes the launch plan(s) of ops/gemm_packed.py as four
// ints each (PackedW4Plan.args()) and returns a CUDA error code.

// K1: out f32 [M, N].
extern "C" int atom_gemm_packed(const void* a, const void* wp, const void* wk, const void* sa,
                                const void* sw, void* out, int M, int N, int ng, const int* plan, void* stream) {
  return launch_gemm<EPI_F32>(a, wp, wk, sa, sw, out, nullptr, nullptr, M, N, ng, plan_of(plan), (cudaStream_t)stream);
}

// K2: prologue (norm + activation quantization), then the core with the ring epilogue.
extern "C" int atom_qkv_ring_fused(const void* y, const void* wg, const void* rstd, const void* wp,
                                   const void* wk, const void* sw, const void* cosv,
                                   const void* sinv, void* a_scratch, void* sa_scratch, void* q,
                                   void* ring_k, void* ring_prm, void* ring_v, int M, int K, int n_q, int H,
                                   int W, int row, int abits, float a_clip, const int* plan, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = launch_prologue(y, nullptr, wg, rstd, a_scratch, sa_scratch, M, K, abits, a_clip, st);
  if (err != cudaSuccess) return (int)err;
  return launch_ring(a_scratch, wp, wk, sa_scratch, sw, cosv, sinv, q, ring_k, ring_prm, ring_v, M, K / GROUP - 1,
                     n_q, H, W, row, plan_of(plan), st);
}

// K8: the core with the ring epilogue on the caller's quantized activation.
extern "C" int atom_qkv_ring(const void* a, const void* wp, const void* wk, const void* sa,
                             const void* sw, const void* cosv, const void* sinv, void* q, void* ring_k,
                             void* ring_prm, void* ring_v, int M, int ng, int n_q, int H, int W, int row,
                             const int* plan, void* stream) {
  return launch_ring(a, wp, wk, sa, sw, cosv, sinv, q, ring_k, ring_prm, ring_v, M, ng, n_q, H, W, row,
                     plan_of(plan), (cudaStream_t)stream);
}

// K7: the prefill GEMM (its plan), then q / K codes / V codes / params in the prefill layout.
extern "C" int atom_qkv_codes(const void* a, const void* wp, const void* wk, const void* sa,
                              const void* sw, const void* cosv, const void* sinv, void* qkv_scratch,
                              void* q, void* k_codes, void* k_prm, void* v_codes, void* v_prm,
                              int M, int ng, int n_q, int H, const int* plan, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int N = n_q + 2 * H * HEAD;
  const int e = launch_gemm<EPI_F32>(a, wp, wk, sa, sw, qkv_scratch, nullptr, nullptr, M, N, ng, plan_of(plan), st);
  if (e) return e;
  qkv_codes_epilogue_kernel<<<dim3(M, N / HEAD), HEAD, 0, st>>>(
      (const float*)qkv_scratch, (const float*)cosv, (const float*)sinv, (__nv_bfloat16*)q,
      (int8_t*)k_codes, (float*)k_prm, (int8_t*)v_codes, (float*)v_prm, n_q, H);
  return (int)cudaGetLastError();
}

// K9: prologue (norm optional: wg and rstd null without it; idx, the reorder
// index, optional: null reads y as it lies), then the GEMM with the residual
// epilogue into bf16 (resid null: bf16(acc)) or, with out_f32, into float32:
// resid + acc on a float32 residual, else the plain product.
extern "C" int atom_gemm_fused_in(const void* y, const void* idx, const void* wg, const void* rstd, const void* wp,
                                  const void* wk, const void* sw, const void* resid,
                                  void* a_scratch, void* sa_scratch, void* out, int M, int K, int N,
                                  int abits, int out_f32, float a_clip, const int* plan, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int ng = K / GROUP - 1;
  const Plan pl = plan_of(plan);
  const cudaError_t err = launch_prologue(y, idx, wg, rstd, a_scratch, sa_scratch, M, K, abits, a_clip, st);
  if (err != cudaSuccess) return (int)err;
  if (out_f32 && resid != nullptr)
    return launch_gemm<EPI_RESID_F32>(a_scratch, wp, wk, sa_scratch, sw, out, resid, nullptr, M, N, ng, pl, st);
  if (out_f32)
    return launch_gemm<EPI_F32>(a_scratch, wp, wk, sa_scratch, sw, out, nullptr, nullptr, M, N, ng, pl, st);
  return launch_gemm<EPI_RESID>(a_scratch, wp, wk, sa_scratch, sw, out, resid, nullptr, M, N, ng, pl, st);
}

// K10: prologue (idx as K9's), then with gu_silu (a paired core plan) the
// gate/up GEMM with the SiLU-quant epilogue over clusters (gu_scratch unused),
// else the gate/up GEMM into gu_scratch and SiLU * up + requantization; then
// the down GEMM with the residual epilogue (row_scale null) or resid +
// row_scale * acc; resid_f32: the residual and the output are float32.
extern "C" int atom_fused_mlp(const void* y, const void* idx, const void* wg, const void* rstd, const void* gu_wp,
                              const void* gu_wk, const void* gu_sw, const void* dn_wp,
                              const void* dn_wk, const void* dn_sw, const void* resid,
                              const void* row_scale, void* a_scratch, void* sa_scratch,
                              void* gu_scratch, void* act, void* act_scales, void* out, int M, int D,
                              int inter, int abits, int resid_f32, int gu_silu, float a_clip, const int* gu_plan,
                              const int* dn_plan, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_prologue(y, idx, wg, rstd, a_scratch, sa_scratch, M, D, abits, a_clip, st);
  if (err != cudaSuccess) return (int)err;
  if (gu_silu) {
    const int e = launch_gate_up_silu(a_scratch, gu_wp, gu_wk, sa_scratch, gu_sw, act, act_scales, M, D, inter, abits,
                                      a_clip, plan_of(gu_plan), st);
    if (e) return e;
  } else {
    const int e = launch_gemm<EPI_F32>(a_scratch, gu_wp, gu_wk, sa_scratch, gu_sw, gu_scratch, nullptr, nullptr, M,
                                       2 * inter, D / GROUP - 1, plan_of(gu_plan), st);
    if (e) return e;
    silu_mul_quant_kernel<<<dim3(M, (inter / GROUP + 7) / 8), 256, 0, st>>>((const float*)gu_scratch, (int8_t*)act,
                                                                           (float*)act_scales, inter, abits, a_clip);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return launch_down(act, act_scales, dn_wp, dn_wk, dn_sw, resid, row_scale, out, M, D, inter, resid_f32,
                     plan_of(dn_plan), st);
}

// The most clusters of K10's SiLU-quant gate/up launch the card holds at once
// under a paired plan at ng body groups (cudaOccupancyMaxActiveClusters), into *clusters.
extern "C" int atom_silu_quant_max_clusters(const int* plan, int ng, int* clusters) {
  const Plan pl = plan_of(plan);
  switch (pl.tile_m) {
    case 16: return silu_max_clusters_nt<2>(pl, ng, clusters);
    case 32: return silu_max_clusters_nt<4>(pl, ng, clusters);
  }
  return silu_max_clusters_nt<8>(pl, ng, clusters);
}

// K14a: a int8 [M, (ng + 1) * 128] x w int8 [(ng + 1) * 128, N] (body groups, then the keeper),
// sa f32 [M, ng + 1], sw f32 [ng + 1, N] -> out f32 [M, N] on the plan's kernel.
extern "C" int atom_grouped_int8_gemm(const void* a, const void* w, const void* sa, const void* sw, void* out, int M,
                                      int N, int ng, const int* plan, void* stream) {
  return launch_int8(a, w, sa, sw, out, M, N, ng, plan_of(plan), (cudaStream_t)stream);
}

// K14b: K14a into scratch f32 [M, N], then per 128-column head the u4 codes int8 [M, N] in
// [0, 15] and params f32 [M, N / 128, 2].
extern "C" int atom_grouped_int8_gemm_o4(const void* a, const void* w, const void* sa, const void* sw, void* scratch,
                                         void* codes, void* params, int M, int N, int ng, const int* plan,
                                         void* stream) {
  if (N % HEAD) return (int)cudaErrorInvalidValue;
  const int e = atom_grouped_int8_gemm(a, w, sa, sw, scratch, M, N, ng, plan, stream);
  if (e) return e;
  head_codes_kernel<<<dim3(M, N / HEAD), HEAD, 0, (cudaStream_t)stream>>>((const float*)scratch, (int8_t*)codes,
                                                                         (float*)params, N);
  return (int)cudaGetLastError();
}
