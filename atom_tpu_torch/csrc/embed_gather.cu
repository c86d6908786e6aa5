// Token-embedding row fetch (K6).
//
// Replaces atom_tpu/ops/pallas_misc.py:30 embed_gather (_gather_kernel :20),
// which fetches the 8-row block holding each id and sums a one-hot select in
// f32.  Here one block per id copies the row bitwise with 16-byte loads and
// stores.  The one difference: the TPU's f32 select-sum turns -0.0 into +0.0;
// this copy keeps -0.0.  Ids are clamped into [0, V), as the plain version
// does.  Bound: 2 x B x D x 2 bytes (read the rows, write the output), a few
// hundred KB: launch latency dominates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
embed_gather_kernel(const uint4* __restrict__ embed, const int* __restrict__ ids,
                    uint4* __restrict__ out, int V, int row_vecs) {
  const int b = blockIdx.x;
  const int id = min(max(ids[b], 0), V - 1);
  const uint4* src = embed + (size_t)id * row_vecs;
  uint4* dst = out + (size_t)b * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) dst[i] = src[i];
}

}  // namespace

// embed: bf16 [V, D] with D % 8 == 0; ids: int32 [B]; out: bf16 [B, D].
extern "C" int atom_embed_gather(const void* embed, const void* ids, void* out, int B, int V, int D,
                                 void* stream) {
  embed_gather_kernel<<<B, 256, 0, (cudaStream_t)stream>>>(
      (const uint4*)embed, (const int*)ids, (uint4*)out, V, D * 2 / 16);
  return (int)cudaGetLastError();
}
