"""Serving stack (port of ``atom_tpu/serving``): paged-KV pool, quantized
serving model (prefill and decode), continuous batcher.

The scheduler and the page allocator are host-side Python; every per-step
computation is PyTorch around hand-written CUDA kernels, and the KV cache
lives in the nibble-plane layout the decode-attention kernel reads.
"""
from atom_tpu_torch.serving.engine import TextGenConfig, TextGenEngine
from atom_tpu_torch.serving.kvpool import KvPool, SeqKvCache
from atom_tpu_torch.serving.model import (
    decode_step,
    init_serving_params,
    make_serving_state,
    make_step_fns,
    prefill_step,
    quantize_lm_head,
)
from atom_tpu_torch.serving.workload import RequestSet, synth_requests
