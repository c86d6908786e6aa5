// Token-embedding row fetch (K6).
//
// Replaces atom_tpu/ops/pallas_misc.py:30 embed_gather (_gather_kernel :20),
// which fetches the 8-row block holding each id and sums a one-hot select in
// f32.  Here the rows are copied bitwise with 16-byte loads and stores.  The
// one difference: the TPU's f32 select-sum turns -0.0 into +0.0; this copy
// keeps -0.0.  Ids are clamped into [0, V), as the plain version does.
//
// Bound: 2 x B x D x 2 bytes (read the rows, write the output), a few hundred
// KB: the time is the launch and two dependent loads (the id, then the row).
// So every warp owns one 512-byte chunk of one output row: lane 0 reads the
// id, a shuffle hands it to the warp, and each lane issues one 16-byte load
// and one store.  No block barrier; B x D / 8 threads in all, every load in
// flight at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 32;  // 16-byte vectors per warp: one per lane

__global__ void __launch_bounds__(THREADS)
embed_gather_kernel(const uint4* __restrict__ embed, const int* __restrict__ ids, uint4* __restrict__ out, int B,
                    int V, int row_vecs, int chunks) {
  const int warp = (int)((blockIdx.x * (unsigned)THREADS + threadIdx.x) >> 5), lane = threadIdx.x & 31;
  const int b = warp / chunks;
  if (b >= B) return;  // whole warps only: the shuffle below has every lane of a live warp
  int id = 0;
  if (lane == 0) id = min(max(__ldg(ids + b), 0), V - 1);
  id = __shfl_sync(0xffffffffu, id, 0);
  const int i = (warp % chunks) * CHUNK + lane;
  if (i < row_vecs) out[(size_t)b * row_vecs + i] = __ldg(embed + (size_t)id * row_vecs + i);
}

}  // namespace

// embed: bf16 [V, D] with D % 8 == 0; ids: int32 [B]; out: bf16 [B, D].
extern "C" int atom_embed_gather(const void* embed, const void* ids, void* out, int B, int V, int D,
                                 void* stream) {
  const int row_vecs = D * 2 / 16, chunks = (row_vecs + CHUNK - 1) / CHUNK;
  const long long warps = (long long)B * chunks;
  const int blocks = (int)((warps * 32 + THREADS - 1) / THREADS);
  embed_gather_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)embed, (const int*)ids, (uint4*)out, B, V, row_vecs, chunks);
  return (int)cudaGetLastError();
}
