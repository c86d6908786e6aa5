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
// One kernel, two paths, which the wrapper picks by M (ops/gemm_w4a16.py::
// w4a16_plan).  It computes out^T = W^T . a^T with wgmma: the converted weight
// tile is the register-sourced A operand (64 weight columns per warpgroup, two
// warpgroups per block: 128 columns), the activations the shared-memory B
// operand (NA rows, K-major, 128-byte swizzle, loaded by TMA), so a group's
// float32 partial sits in the accumulator with one weight column per row and
// the group's scale multiplies rows.
//
// * Skinny path, M <= 64 (a decode step at batch 32, the head at 32 rows or
//   1): NA = 8, 16, 32 or 64 rows, the fewest that hold M.  2 * M operations
//   per 4-bit code, at most 256 per weight byte, below the ~295 where the bf16
//   tensor cores become the limit: the weight stream (K*N/2 bytes of codes +
//   K*N/32 of scales) bounds every call.  Split K: the blocks of one thread
//   block cluster (up to 8) take consecutive group ranges of the same column
//   tile, so that column tiles x split covers the 132 SMs (the wrapper's plan
//   gives the ranges and the grid, the kernel takes them); their partial tiles
//   are added through distributed shared memory, each rank adding its slice of
//   the tile over the ranks in rank order (one launch, no workspace,
//   deterministic).  The activations are read from L2 once per 128 columns:
//   at M = 32 as many bytes as the tile's weights.
// * Tile path, M > 64 (prefill): NA = 128, all of K per block.  The bf16
//   tensor cores bound it.  The weights are read once per 128 rows and the
//   activations once per 128 columns.
//
// Per group, in a ring of 4 stages (3 for the tile path, whose output sum,
// 64 KB, lives in shared memory): the activations' two 64-column boxes by TMA
// (an mbarrier counts their bytes), the weight planes (64 byte rows x 128
// columns, rows padded by 16 bytes against bank conflicts) and scales by
// 16-byte cp.async.  While a group's 8 wgmmas (K 16 each) run, the next
// group's copies are waited for, the ring is refilled and the next group's
// weights are converted into a second set of fragment registers.  The
// conversion: a thread reads 2 neighbouring columns (2 bytes) from each of the
// byte rows 2tig, 2tig+1, 2tig+8, 2tig+9 of a 16-row step; a prmt gathers one
// column's byte of two rows into the two halves of one word; one lop3,
// (x & 0x000F000F) ^ 0x43084308, turns the low nibble pair into bf16x2
// 128 + (code + 8) (exact: the bf16 ulp at 128 is 1), and one bf16x2
// subtraction of 136 leaves the code, exact for every code in [-8, 7]; the
// high nibbles take a shift first.  The group's float32 partial is then
// multiplied by its scale and added to a block sum, which is added to the
// output sum every KBLK = 8 groups (--fmad=false: no contraction): the TPU
// kernel's and the plain version's order.  Products of bf16 and a 4-bit code
// are exact in float32, so only the order of the float32 additions inside a
// group's partial (the tensor cores') and, under a split, across the ranks
// differs from the TPU kernel and the plain version.  Rows
// past M load zeros (TMA) and are not stored; columns past N (N is a multiple
// of 32) are neither loaded nor stored; K is whole groups.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int GROUP = 128;
constexpr int HALF = 64;
constexpr int KBLK = 8;  // groups whose scaled partials the TPU kernel adds before adding them to the output

constexpr int COLS = 128;            // weight columns per block (two warpgroups of 64)
constexpr int W_STRIDE = COLS + 16;  // bytes per weight byte row in shared memory
constexpr int RS = COLS + 4;         // row stride of the output tile in shared memory

// A block of NA activation rows: its ring stages (4, or 3 for the 128-row
// tile, whose output sum lives in shared memory beside the ring), the bytes
// of a stage (two 64-wide K halves of 128-byte activation rows, the weight
// planes, the scales; 1024-byte aligned for the swizzle) and of that sum.
__host__ __device__ constexpr int stages(int na) { return na == 128 ? 3 : 4; }
__host__ __device__ constexpr int stage_bytes(int na) {
  return (2 * na * 128 + HALF * W_STRIDE + COLS * 4 + 1023) / 1024 * 1024;
}
__host__ __device__ constexpr int sum_bytes(int na) { return na == 128 ? na / 2 * 256 * 4 : 0; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((unsigned)__cvta_generic_to_shared(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// bf16x2 of the two signed codes in the low nibbles of bytes 0 and 2 of x.
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t x) {
  uint32_t v = (x & 0x000F000Fu) ^ 0x43084308u;  // bf16 128 + (code + 8), one lop3
  const uint32_t magic = 0x43084308u;            // bf16x2 {136, 136}
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   *reinterpret_cast<const __nv_bfloat162*>(&magic));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keeps the compiler from moving reads or writes of the accumulators across a wgmma fence or wait
template <int ND>
__device__ __forceinline__ void fence_operands(float (&d)[ND]) {
#pragma unroll
  for (int j = 0; j < ND; ++j) asm volatile("" : "+f"(d[j])::"memory");
}

__device__ __forceinline__ void keep_alive(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(a[k][q]));
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row atoms 1024 bytes apart
__device__ __forceinline__ uint64_t swizzle128_desc(const void* smem) {
  const uint64_t addr = (uint64_t)__cvta_generic_to_shared(smem);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d[64 x NA] (+)= a[64 x 16] (registers) x b[16 x NA] (shared memory, descriptor)
template <int NA>
__device__ void wgmma_rs(float (&d)[NA / 2], const uint32_t (&a)[4], uint64_t desc, int accumulate);
template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"((unsigned)__cvta_generic_to_shared(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"((unsigned)__cvta_generic_to_shared(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(a), "r"(phase) : "memory");
}

// one box of the activations (64 columns x NA rows, 128-byte swizzle) into
// shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* tm, int k, int m, uint64_t* bar) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
               ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"((uint64_t)tm), "r"(k), "r"(m),
               "r"((unsigned)__cvta_generic_to_shared(bar)) : "memory");
}

// The wrapper's split of the groups: cluster rank r sums groups
// [start[r], start[r + 1]).
struct GroupStarts {
  int start[9];
};

// NA activation rows by 128 weight columns per block; the blocks of a cluster
// split the groups (a cluster of one: all of K) and add their tiles in rank order
template <int NA, bool OUT_BF16>
__global__ void __launch_bounds__(256, NA <= 32 ? 2 : 1)
gemm_w4a16_kernel(const __grid_constant__ CUtensorMap tmA, const int8_t* __restrict__ Wp,
                     const float* __restrict__ scale, void* __restrict__ out, int M, int N, const GroupStarts gs) {
  constexpr int ND = NA / 2, SB = stage_bytes(NA), ACT = 2 * NA * 128, STAGES = stages(NA);
  constexpr bool SMEM_SUM = NA == 128;  // the output sum in shared memory: registers hold the block sum
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (unsigned)__cvta_generic_to_shared(smem_raw) % 1024) % 1024);
  // the output sum of the 128-row tile: element j of thread t at [j * 256 + t]
  float* osum = reinterpret_cast<float*>(smem + STAGES * SB);
  static_assert(!SMEM_SUM || sum_bytes(NA) == ND * 256 * 4, "one float per accumulator element and thread");
  // per stage: its activation boxes have landed
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * SB + sum_bytes(NA));
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / split) * COLS, m0 = blockIdx.y * NA;
  const int g0 = gs.start[rank], ngl = gs.start[rank + 1] - g0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int c0 = (warp >> 2) * 64 + (warp & 3) * 16 + 2 * gid;  // tile columns of accumulator rows gid, gid + 8: c0, c0 + 1

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(full + st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // local group i (group g0 + i) into ring stage i % STAGES
  auto load_stage = [&](int i) {
    const int st = i % STAGES, g = g0 + i;
    unsigned char* sa = smem + st * SB;
    unsigned char* sw = sa + ACT;
    unsigned char* ss = sw + HALF * W_STRIDE;
    if (tid == 0) {
      mbar_expect(full + st, ACT);
      tma_load(sa, &tmA, g * GROUP, m0, full + st);
      tma_load(sa + NA * 128, &tmA, g * GROUP + 64, m0, full + st);
    }
    for (int j = tid; j < HALF * (COLS / 16); j += 256) {
      const int r = j / (COLS / 16), c = j % (COLS / 16);
      if (n0 + c * 16 < N) cp_async16(sw + r * W_STRIDE + c * 16, Wp + (size_t)(g * HALF + r) * N + n0 + c * 16);
    }
    for (int c = tid; c < COLS / 4; c += 256)
      if (n0 + c * 4 < N) cp_async16(ss + c * 16, scale + (size_t)g * N + n0 + c * 4);
  };

  // the scaled group partials are added into blk, KBLK groups at a time (as
  // the TPU kernel and the plain version add them), then blk into the output sum
  float acc[SMEM_SUM ? 1 : ND], blk[ND], part[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    blk[j] = part[j] = 0.f;
    if constexpr (SMEM_SUM)
      osum[j * 256 + tid] = 0.f;
    else
      acc[j] = 0.f;
  }

  // A fragments of a group's 8 K steps from its weight planes: step h*4 + s
  // holds code rows h*64 + s*16 ..
  auto convert = [&](int i, uint32_t (&af)[8][4]) {
    const unsigned char* sw = smem + (i % STAGES) * SB + ACT;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const unsigned char* wr = sw + (s * 16 + 2 * tig) * W_STRIDE + c0;
      const uint32_t v0 = *reinterpret_cast<const uint16_t*>(wr);
      const uint32_t v1 = *reinterpret_cast<const uint16_t*>(wr + W_STRIDE);
      const uint32_t v8 = *reinterpret_cast<const uint16_t*>(wr + 8 * W_STRIDE);
      const uint32_t v9 = *reinterpret_cast<const uint16_t*>(wr + 9 * W_STRIDE);
      const uint32_t p[4] = {__byte_perm(v0, v1, 0x4400), __byte_perm(v0, v1, 0x5511),   // column c0 / c0 + 1,
                             __byte_perm(v8, v9, 0x4400), __byte_perm(v8, v9, 0x5511)};  // K slots 2tig.. / 2tig+8..
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        af[s][q] = codes_bf16x2(p[q]);
        af[4 + s][q] = codes_bf16x2(p[q] >> 4);
      }
    }
  };
  // local group i: its wgmmas run while the next group's copies are waited
  // for, the ring refilled and the next group's fragments converted; then
  // its partial is scaled into the running sum
  auto step = [&](int i, uint32_t (&cur)[8][4], uint32_t (&nxt)[8][4]) {
    const unsigned char* sa = smem + (i % STAGES) * SB;
    mbar_wait(full + i % STAGES, (i / STAGES) & 1);
    wgmma_fence();
    fence_operands(part);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs<NA>(part, cur[kk], swizzle128_desc(sa + (kk >> 2) * (NA * 128) + (kk & 3) * 32), kk > 0);
    wgmma_commit();
    if (i + 1 < ngl) {
      cp_async_wait<STAGES - 3>();  // the weights of group i + 1 have landed
      __syncthreads();              // for every thread; stage (i - 1) is free
      if (i + STAGES - 1 < ngl) load_stage(i + STAGES - 1);
      cp_async_commit();
      convert(i + 1, nxt);
    }
    wgmma_wait0();
    fence_operands(part);
    keep_alive(cur);  // the in-flight wgmmas read these registers until the wait
    const float* ss = reinterpret_cast<const float*>(sa + ACT + HALF * W_STRIDE);
    const float sc0 = ss[c0], sc1 = ss[c0 + 1];
#pragma unroll
    for (int j = 0; j < ND; ++j) blk[j] = __fadd_rn(blk[j], __fmul_rn(part[j], (j & 2) ? sc1 : sc0));
    if ((g0 + i + 1) % KBLK == 0 || i + 1 == ngl) {
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        if constexpr (SMEM_SUM)
          osum[j * 256 + tid] = __fadd_rn(osum[j * 256 + tid], blk[j]);
        else
          acc[j] = __fadd_rn(acc[j], blk[j]);
        blk[j] = 0.f;
      }
    }
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < ngl) load_stage(i);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  uint32_t af0[8][4], af1[8][4];
  convert(0, af0);
  for (int i = 0; i < ngl; i += 2) {
    step(i, af0, af1);
    if (i + 1 < ngl) step(i + 1, af1, af0);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the block's tile, transposed back, into its shared memory:
  // red[activation row][weight column]; then each rank adds its slice of
  // the tile over the cluster's ranks in rank order
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    float v;
    if constexpr (SMEM_SUM)
      v = osum[j * 256 + tid];
    else
      v = acc[j];
    red[((j >> 2) * 8 + 2 * tig + (j & 1)) * RS + c0 + ((j >> 1) & 1)] = v;
  }
  cluster.sync();
  // in 4-column pieces (N and the tile are whole 32 columns); the peers'
  // loads of a piece are issued together
  const float* peer[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) peer[q] = cluster.map_shared_rank(red, q < split ? q : 0);
  const int rows = min(NA, M - m0), cols4 = min(COLS, N - n0) / 4, total = rows * cols4;
  for (int e = rank * total / split + tid; e < (rank + 1) * total / split; e += 256) {
    const int r = e / cols4, col = 4 * (e % cols4);
    float4 v4[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < split) v4[q] = *reinterpret_cast<const float4*>(peer[q] + r * RS + col);
    float4 v = v4[0];
#pragma unroll
    for (int q = 1; q < 8; ++q)
      if (q < split) {
        v.x = __fadd_rn(v.x, v4[q].x);
        v.y = __fadd_rn(v.y, v4[q].y);
        v.z = __fadd_rn(v.z, v4[q].z);
        v.w = __fadd_rn(v.w, v4[q].w);
      }
    const size_t o = (size_t)(m0 + r) * N + n0 + col;
    if (OUT_BF16) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 pk;
      pk.x = *reinterpret_cast<const uint32_t*>(&lo);
      pk.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + o) = pk;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + o) = v;
    }
  }
  cluster.sync();  // peers read this block's tile until here
}

// The activations' tensor map: [M, K] bf16, boxes of 64 columns x `rows`
// rows, 128-byte swizzle, rows past M read as zeros.
int activation_map(CUtensorMap* tm, const void* a, int M, int K, int rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (!encode) {
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &q);
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess || !encode) return (int)cudaErrorNotSupported;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)rows}, elem[2] = {1, 1};
  const CUresult r = encode(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(a), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NA>
int launch(const void* a, const void* packed, const void* scale, void* out, int M, int N, int ng, int out_bf16,
              int split, const GroupStarts& gs, dim3 grid, cudaStream_t st) {
  constexpr int STAGES = stages(NA);
  // the ring, its alignment to 1024 bytes, the 128-row tile's output sum, the stages' barriers
  constexpr int SMEM = STAGES * stage_bytes(NA) + 1024 + sum_bytes(NA) + STAGES * 8;
  static_assert(STAGES * stage_bytes(NA) >= NA * RS * 4, "the output tile reuses the ring");
  static_assert(STAGES >= 3, "the next group lands while the current one multiplies");
  static_assert(SMEM <= 232448, "shared memory of one block");
  auto kernel = out_bf16 ? gemm_w4a16_kernel<NA, true> : gemm_w4a16_kernel<NA, false>;
  static bool ready[2] = {false, false};
  cudaError_t err;
  if (!ready[out_bf16]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    ready[out_bf16] = true;
  }
  CUtensorMap tm;
  const int e = activation_map(&tm, a, M, ng * GROUP, NA);
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(256, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tm, (const int8_t*)packed, (const float*)scale, out, M, N, gs);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// a bf16 [M, ng*128], packed int8 [ng*64, N], scale f32 [ng, N] -> out [M, N]
// (bf16 if out_bf16, else f32), N % 32 == 0, launched as the wrapper's plan
// (ops/gemm_w4a16.py::w4a16_plan) says: block rows tile_m, `split` blocks
// per cluster, rank r summing groups [starts[r], starts[r + 1]), grid
// grid_x x grid_y (column tiles x split, row tiles).  Skinny path: tile_m 8,
// 16, 32 or 64 (at least M), split 1-8; tile path: tile_m 128, split 1.  A
// plan the kernel cannot run is refused.
extern "C" int atom_gemm_w4a16(const void* a, const void* packed, const void* scale, void* out, int M, int N, int ng,
                               int out_bf16, int tile_m, int split, const int* starts, int grid_x, int grid_y,
                               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (N % 32 || ng < 1 || split < 1 || split > 8 || (tile_m == 128 && split != 1)) return (int)cudaErrorInvalidValue;
  if ((tile_m < 128 && M > tile_m) || grid_x != (N + COLS - 1) / COLS * split || grid_y != (M + tile_m - 1) / tile_m)
    return (int)cudaErrorInvalidValue;
  GroupStarts gs = {};
  for (int r = 0; r <= split; ++r) gs.start[r] = starts[r];
  if (gs.start[0] != 0 || gs.start[split] != ng) return (int)cudaErrorInvalidValue;
  for (int r = 0; r < split; ++r)
    if (gs.start[r + 1] <= gs.start[r]) return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x, grid_y, 1);
  switch (tile_m) {
    case 8: return launch<8>(a, packed, scale, out, M, N, ng, out_bf16, split, gs, grid, st);
    case 16: return launch<16>(a, packed, scale, out, M, N, ng, out_bf16, split, gs, grid, st);
    case 32: return launch<32>(a, packed, scale, out, M, N, ng, out_bf16, split, gs, grid, st);
    case 64: return launch<64>(a, packed, scale, out, M, N, ng, out_bf16, split, gs, grid, st);
    case 128: return launch<128>(a, packed, scale, out, M, N, ng, out_bf16, 1, gs, grid, st);
  }
  return (int)cudaErrorInvalidValue;
}
