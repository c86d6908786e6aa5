"""Serving stack (port of ``atom_tpu/serving``): paged-KV pool, quantized
serving model (prefill, decode and the mixed prefill+decode step),
continuous batcher with serial or mixed prefill.

The scheduler and the page allocator are host-side Python; every per-step
computation is PyTorch around hand-written CUDA kernels, and the KV cache
lives in the nibble-plane layout the decode-attention kernel reads.
"""
from atom_tpu_torch.serving.engine import TextGenConfig, TextGenEngine
from atom_tpu_torch.serving.kvpool import KvPool, SeqKvCache
from atom_tpu_torch.serving.model import (
    decode_step,
    init_serving_params,
    make_mixed_step_fns,
    make_serving_state,
    make_step_fns,
    mixed_step,
    prefill_step,
    quantize_lm_head,
)
from atom_tpu_torch.serving.workload import RequestSet, synth_requests
