"""Serving stack (port of ``atom_tpu/serving``): paged-KV pool, quantized
serving model (prefill, decode and the mixed prefill+decode step), the MoE
(Mixtral) serving model on one device or expert-parallel, multi-adapter
LoRA serving, continuous batcher with serial or mixed prefill, and the
parallel forms over ranks: tensor parallel (``parallel.py``), sequence
parallel prefill (``sp.py``) and data parallel groups (``dp.py``).

The scheduler and the page allocator run on the host, in Python or (with
``TextGenEngine(native=True)``) in the C++ scheduler of
``atom_tpu_torch/native``; every per-step computation is PyTorch around
hand-written CUDA kernels, and the KV cache
lives in the nibble-plane layout the decode-attention kernel reads.
"""
from atom_tpu_torch.serving.dp import make_dp_tp_engines, run_data_parallel, split_requests
from atom_tpu_torch.serving.engine import TextGenConfig, TextGenEngine
from atom_tpu_torch.serving.kvpool import KvPool, SeqKvCache
from atom_tpu_torch.serving.lora import (
    LlamaLora,
    LoraManager,
    LoraSite,
    add_lora,
    init_llama_lora,
    lora_decode_burst,
    lora_decode_step,
    lora_prefill_step,
    make_lora_step_fns,
)
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
from atom_tpu_torch.serving.moe import (
    decode_burst_moe,
    decode_step_moe,
    init_moe_serving_params,
    make_moe_ep_step_fns,
    make_moe_step_fns,
    prefill_step_moe,
    shard_moe_serving_params,
)
from atom_tpu_torch.serving.parallel import make_state_sharded, make_tp_step_fns, shard_serving_params
from atom_tpu_torch.serving.sp import make_sp_prefill_fn, make_sp_tp_prefill_fn
from atom_tpu_torch.serving.workload import RequestSet, synth_requests
