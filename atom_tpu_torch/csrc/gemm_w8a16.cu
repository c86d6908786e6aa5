// Weight-only INT8 GEMM with bf16 activations (K5), the serving lm_head.
//
// Replaces atom_tpu/ops/pallas_gemm_w4a16.py:203 w8a16_gemm (_w8a16_kernel
// :184): out f32 [M,N] = (sum_k bf16(a[m,k]) * codes[k,n]) * scale[n], float32
// accumulation, the per-column scale applied once after the whole sum.
//
// What bounds it on the H100: the head runs at M <= 33 rows (the decode batch,
// the mixed step's batch and chunk row, or the one last row of a prefill), so
// the product does 2*M operations per weight byte, against the ~295 where the
// bf16 tensor cores become the limit.  The one read of the int8 weight (132 MB
// at K 4096, N 32256) from HBM bounds every call: ~0.040 ms at 3.35 TB/s.
//
// Design: a weight stream.  A block owns 256 weight columns (126 blocks at the
// 7B head's N = 32,256: one wave on 132 SMs) and walks all of K for up to 64
// activation rows, so a launch of at most 64 rows streams the weight once.
// Above 64 rows, the plan (ops/gemm_w4a16.py::w8a16_plan) launches passes of 64
// rows.  A producer warp keeps a ring of stages in flight by TMA (4-6 stages of
// 128 K rows, 40-48 KB each, 160-200 KB a block): per stage two weight boxes of
// 128 K rows x 128 columns with the 128-byte swizzle, and the activations' two
// 64-wide K halves of the block's rows (bf16, 128-byte swizzle, rows past M
// and K past the end zero-filled by TMA).  The activations are read once per
// 256 columns.
//
// Two consumer warpgroups compute out^T = W^T . a^T with wgmma: the converted
// weights are the register-sourced A operand (a warpgroup's 128 columns as two
// 64-row accumulator tiles), the activations the shared-memory B operand (N =
// 8, 16, 32, 40, 48 or 64 rows, the fewest that hold M).  Conversion without
// conversion-unit instructions: a code c = 16 h + l, l = c & 15, h = c >> 4
// (arithmetic, in [-8, 7]).  A thread reads 4 neighbouring columns (4 bytes)
// of the K rows 2tig, 2tig+1, 2tig+8, 2tig+9 of a 16-row step (conflict-free
// under the swizzle); one prmt gathers a column's bytes of two rows into bytes
// 0 and 2 of a word; then l is (x & 0x000F000F) | 0x43004300 (bf16 128 + l)
// less 128, and 16h is ((x >> 4) & 0x000F000F) ^ 0x43084308 (bf16 136 + h)
// through one bf16x2 fma(v, 16, -2176): every step is exact.  Each K step runs
// two wgmma terms per tile, a . 16h then a . l, into the same float32
// accumulator; a product of a bf16 and an integer below 2^8 in magnitude is
// exact in float32, so only the order of the float32 additions differs from
// the TPU kernel and the plain version (within W8A16_RTOL of the largest
// output; no partial sum is rounded to bf16).  In SASS a word of two codes
// costs PRMT, LOP3, HADD2 (l) and SHF, LOP3, HFMA2 (16h), 3 instructions a
// code beside one 4-byte LDS per 4 codes, and no I2F, I2FP, F2F or F2FP.  A step's
// conversion overlaps the previous step's wgmmas (one group in flight; deeper
// pipelines measured no faster).  Where the time goes (patched copies of this
// file, scripts/torch_head_flush_variants.py): the weight stream alone, TMA
// stages waited for and released, takes ~85% of a launch; the conversion
// and the wgmmas the rest.
// Then the scale multiplies once (--fmad=false), and each thread stores 4
// neighbouring columns of a row as one float4.  One launch, no workspace, no
// atomics: deterministic.  A ragged last column tile is zero-filled by TMA
// (its second box skipped when wholly past N) and masked at the store.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TN = 256;                   // weight columns a block
constexpr int BOX_N = 128;                // a weight box's columns: one warpgroup's, the 128-byte swizzle's span
constexpr int KC = 128;                   // K rows a stage
constexpr int W_BYTES = KC * TN;          // a stage's two weight boxes
constexpr int CONSUMERS = 256;            // two warpgroups
constexpr int THREADS = CONSUMERS + 32;   // and the producer warp
constexpr int MAX_SMEM = 232448;          // dynamic shared memory of one block
constexpr int MAX_STAGES = 6;
// the consumers' pipeline: NBUF fragment buffers, K steps converted AHEAD of
// the wgmmas, INFLIGHT wgmma groups left pending at a step's wait (deeper
// settings measured no faster: PERF.md)
constexpr int NBUF = 2, AHEAD = 1, INFLIGHT = 1;

// a stage's activation boxes: two 64-wide K halves of NA rows of 128 bytes
__host__ __device__ constexpr int act_bytes(int na) { return 2 * na * 128; }
__host__ __device__ constexpr int stage_bytes(int na) { return W_BYTES + act_bytes(na); }
// as many stages as fit beside the 1024-byte alignment and the barriers, at most 6
__host__ __device__ constexpr int stages(int na) {
  return (MAX_SMEM - 1024 - 2 * MAX_STAGES * 8) / stage_bytes(na) < MAX_STAGES
             ? (MAX_SMEM - 1024 - 2 * MAX_STAGES * 8) / stage_bytes(na)
             : MAX_STAGES;
}
__host__ __device__ constexpr int smem_bytes(int na) { return stages(na) * stage_bytes(na) + 1024 + 2 * stages(na) * 8; }

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits for the phase of parity `phase`; traps after ~2^34 cycles (seconds)
// rather than hang the card if a stage never completes.
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

// A consumer warp gives a stage back once its reads are done: the weight
// loads are generic-proxy reads and the stage's next fill a TMA (async-proxy)
// write, which the proxy fence orders after them (fault C3 of the K1 family).
__device__ __forceinline__ void release_stage(uint64_t* bar, int lane) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// A 2D box of the tensor map at (x, y) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* tm, int x, int y, uint64_t* bar) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
               ::"r"(smem_u32(dst)), "l"((uint64_t)tm), "r"(x), "r"(y), "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of the accumulators across a wgmma fence or wait
template <int ND>
__device__ __forceinline__ void fence_operands(float (&d)[ND]) {
#pragma unroll
  for (int j = 0; j < ND; ++j) asm volatile("" : "+f"(d[j])::"memory");
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row atoms 1024 bytes apart
__device__ __forceinline__ uint64_t swizzle128_desc(const void* smem) {
  const uint64_t addr = (uint64_t)__cvta_generic_to_shared(smem);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d[64 x NA] (+)= a[64 x 16] (registers) x b[16 x NA] (shared memory, descriptor)
template <int NA>
__device__ void wgmma_rs(float (&d)[NA / 2], const uint32_t (&a)[4], uint64_t desc, int scale_d);
template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_rs<40>(float (&d)[20], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// (a & b) | c and (a & b) ^ c as one LOP3 each (ptxas splits them otherwise)
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// bf16x2 of the low nibbles l of bytes 0 and 2 of x: 128 + l, less 128
__device__ __forceinline__ uint32_t low_term(uint32_t x) {
  uint32_t v = and_or(x, 0x000F000Fu, 0x43004300u);
  const uint32_t c128 = 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   *reinterpret_cast<const __nv_bfloat162*>(&c128));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// bf16x2 of 16 h for the signed high nibbles h of bytes 0 and 2 of x:
// 136 + h (the nibble's sign bit flipped into the mantissa of 128), then 16 v - 2176
__device__ __forceinline__ uint32_t high_term(uint32_t x) {
  uint32_t v = and_xor(x >> 4, 0x000F000Fu, 0x43084308u);
  const uint32_t c16 = 0x41804180u, cneg = 0xC508C508u;  // bf16x2 {16, 16}, {-2176, -2176}
  const __nv_bfloat162 r = __hfma2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   *reinterpret_cast<const __nv_bfloat162*>(&c16),
                                   *reinterpret_cast<const __nv_bfloat162*>(&cneg));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The fragments of K step kk (rows 16 kk ..) of a warpgroup's weight box
// (128 K rows x 128 columns, 128-byte swizzle: row r's 16-byte chunk j sits
// at chunk j ^ (r % 8)).  The thread's columns x .. x + 3: tile 0 takes x
// (accumulator row gid) and x + 1 (row gid + 8), tile 1 x + 2 and x + 3.
__device__ __forceinline__ void convert(const unsigned char* box, int kk, int x, int tig, uint32_t (&f)[2][2][4]) {
  const int r0 = kk * 16 + 2 * tig;
  const int rows[4] = {r0, r0 + 1, r0 + 8, r0 + 9};
  uint32_t v[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = rows[q];
    v[q] = *reinterpret_cast<const uint32_t*>(box + r * BOX_N + ((((x >> 4) ^ (r & 7)) << 4) | (x & 15)));
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const unsigned sel = 0x4400u + 0x1111u * (2 * t + c);  // column byte 2t + c of two rows -> bytes 0 and 2
      const uint32_t lo = __byte_perm(v[0], v[1], sel);      // K slots 2tig, 2tig + 1
      const uint32_t hi = __byte_perm(v[2], v[3], sel);      // K slots 2tig + 8, 2tig + 9
      f[t][0][c] = high_term(lo);
      f[t][0][2 + c] = high_term(hi);
      f[t][1][c] = low_term(lo);
      f[t][1][2 + c] = low_term(hi);
    }
}

// NA activation rows (from blockIdx.y * NA) by 256 weight columns a block, all of K
template <int NA>
__global__ void __launch_bounds__(THREADS, 1)
gemm_w8a16_kernel(const __grid_constant__ CUtensorMap tmW, const __grid_constant__ CUtensorMap tmA,
                  const float* __restrict__ scale, float* __restrict__ out, int M, int N, int K) {
  constexpr int ND = NA / 2, ST = stages(NA), SB = stage_bytes(NA);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ST * SB);  // per stage: its boxes have landed
  uint64_t* empty = full + ST;                                  // per stage: the consumers are done with it
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * NA;
  const int nch = (K + KC - 1) / KC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // producer
    if (lane == 0) {
      const bool second = n0 + BOX_N < N;  // the second weight box holds columns below N
      const int bytes = (second ? 2 : 1) * KC * BOX_N + act_bytes(NA);
      for (int i = 0, s = 0, ph = 0; i < nch; ++i) {
        if (i >= ST) mbar_wait(empty + s, ph ^ 1);
        unsigned char* st = smem + s * SB;
        mbar_expect(full + s, bytes);
        tma_load(st, &tmW, n0, i * KC, full + s);
        if (second) tma_load(st + KC * BOX_N, &tmW, n0 + BOX_N, i * KC, full + s);
        tma_load(st + W_BYTES, &tmA, i * KC, m0, full + s);
        tma_load(st + W_BYTES + NA * 128, &tmA, i * KC + 64, m0, full + s);
        if (++s == ST) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  const int g = warp >> 2, gid = lane >> 2, tig = lane & 3;
  const int x = 32 * (warp & 3) + 4 * gid;  // the thread's 4 columns in its warpgroup's box
  float acc0[ND], acc1[ND];                 // tile 0: columns x, x + 1; tile 1: x + 2, x + 3
#pragma unroll
  for (int j = 0; j < ND; ++j) acc0[j] = acc1[j] = 0.f;
  // K step k's fragments ([tile][term: 16h, l][4]) live in fr[k % NBUF];
  // step k + AHEAD is converted once at most INFLIGHT groups are pending,
  // which frees the buffer it takes
  uint32_t fr[NBUF][2][2][4];
  constexpr int STEPS = KC / 16;
  if (nch > 0) {
    mbar_wait(full, 0);
#pragma unroll
    for (int kk = 0; kk < AHEAD; ++kk) convert(smem + g * (KC * BOX_N), kk, x, tig, fr[kk]);
  }
  for (int i = 0; i < nch; ++i) {
    const unsigned char* st = smem + (i % ST) * SB;
    const uint64_t desc0 = swizzle128_desc(st + W_BYTES);  // the stage's activations; a step adds its offset / 16
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk) {
      uint32_t(&cur)[2][2][4] = fr[kk % NBUF];
      const uint64_t desc = desc0 + (((kk >> 2) * (NA * 128) + (kk & 3) * 32) >> 4);
      wgmma_fence();
      fence_operands(acc0);
      fence_operands(acc1);
      wgmma_rs<NA>(acc0, cur[0][0], desc, 1);  // a . 16h
      wgmma_rs<NA>(acc0, cur[0][1], desc, 1);  // a . l
      wgmma_rs<NA>(acc1, cur[1][0], desc, 1);
      wgmma_rs<NA>(acc1, cur[1][1], desc, 1);
      wgmma_commit();
      wgmma_wait<INFLIGHT>();  // groups up to this step's INFLIGHT-th before are done
      const int nk = kk + AHEAD;  // the step converted now: this stage's, or the next one's
      uint32_t(&nxt)[2][2][4] = fr[nk % NBUF];
      if (kk == INFLIGHT - 1 && i > 0) release_stage(empty + (i - 1) % ST, lane);  // its last group is done
      if (nk < STEPS) {
        convert(st + g * (KC * BOX_N), nk, x, tig, nxt);
      } else if (i + 1 < nch) {
        const int s1 = (i + 1) % ST;
        if (nk == STEPS) mbar_wait(full + s1, ((i + 1) / ST) & 1);
        convert(smem + s1 * SB + g * (KC * BOX_N), nk - STEPS, x, tig, nxt);
      }
    }
  }
  wgmma_wait<0>();
  fence_operands(acc0);
  fence_operands(acc1);

  // accumulator element j: activation row (j >> 2) * 8 + 2 tig + (j & 1),
  // column x + 2 tile + ((j >> 1) & 1): a row's 4 columns are one float4
  const int col = n0 + g * BOX_N + x;
  if (col < N) {
    const float4 sc = *reinterpret_cast<const float4*>(scale + col);
#pragma unroll
    for (int q = 0; q < ND / 4; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + q * 8 + 2 * tig + e, j = q * 4 + e;
        if (m < M) {
          const float4 v = make_float4(__fmul_rn(acc0[j], sc.x), __fmul_rn(acc0[j + 2], sc.y),
                                       __fmul_rn(acc1[j], sc.z), __fmul_rn(acc1[j + 2], sc.w));
          *reinterpret_cast<float4*>(out + (size_t)m * N + col) = v;
        }
      }
  }
}

// A 2D tensor map: `outer` rows of `inner` elements, `row_bytes` apart; boxes
// of box_inner x box_outer with the 128-byte swizzle; out of bounds reads zero.
int tensor_map(CUtensorMap* tm, CUtensorMapDataType type, const void* base, int inner, int outer, size_t row_bytes,
               int box_inner, int box_outer) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &q);
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess || !encode) return (int)cudaErrorNotSupported;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer}, elem[2] = {1, 1};
  const CUresult r = encode(tm, type, 2, const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NA>
int launch(const void* a, const void* codes, const void* scale, void* out, int M, int N, int K, dim3 grid,
           cudaStream_t st) {
  constexpr int SMEM = smem_bytes(NA);
  static_assert(SMEM <= MAX_SMEM, "shared memory of one block");
  static_assert(stages(NA) >= 3, "a stage lands while the one before is multiplied");
  static bool ready = false;
  cudaError_t err;
  if (!ready) {
    err = cudaFuncSetAttribute(gemm_w8a16_kernel<NA>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  CUtensorMap tw = {}, ta = {};  // K = 0: no stage is loaded and the maps are not read
  if (K > 0) {
    int e = tensor_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, codes, N, K, (size_t)N, BOX_N, KC);
    if (e) return e;
    e = tensor_map(&ta, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a, K, M, (size_t)K * 2, 64, NA);
    if (e) return e;
  }
  gemm_w8a16_kernel<NA><<<grid, THREADS, SMEM, st>>>(tw, ta, (const float*)scale, (float*)out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// a bf16 [M, K], codes int8 [K, N], scale f32 [N] -> out f32 [M, N], launched
// as the wrapper's plan (ops/gemm_w4a16.py::w8a16_plan) says: blocks of
// `rows` activation rows (8, 16, 32, 40, 48 or 64, at least M unless 64) by
// 256 columns, grid grid_x x grid_y (column tiles, row passes).  N % 64 == 0,
// K % 16 == 0; a and codes 16-byte aligned.  A plan the kernel cannot run is
// refused.
extern "C" int atom_gemm_w8a16(const void* a, const void* codes, const void* scale, void* out, int M, int N, int K,
                               int rows, int grid_x, int grid_y, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || N < 1 || N % 64 || K < 0 || K % 16) return (int)cudaErrorInvalidValue;
  if ((rows < 64 && M > rows) || grid_x != (N + TN - 1) / TN || grid_y != (M + rows - 1) / rows)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x, grid_y, 1);
  switch (rows) {
    case 8: return launch<8>(a, codes, scale, out, M, N, K, grid, st);
    case 16: return launch<16>(a, codes, scale, out, M, N, K, grid, st);
    case 32: return launch<32>(a, codes, scale, out, M, N, K, grid, st);
    case 40: return launch<40>(a, codes, scale, out, M, N, K, grid, st);
    case 48: return launch<48>(a, codes, scale, out, M, N, K, grid, st);
    case 64: return launch<64>(a, codes, scale, out, M, N, K, grid, st);
  }
  return (int)cudaErrorInvalidValue;
}
