"""PyTorch + CUDA port of ``atom_tpu`` for one NVIDIA H100.

The port mirrors the JAX package's layout and names.  Plain tensor code is
PyTorch; every Pallas kernel on a ported path is a hand-written CUDA kernel
under ``csrc/``, built for ``sm_90a`` at first use (``ops/_build.py``).

Device policy: entry points run on ``cuda`` unless the caller passes
``device="cpu"``.  A kernel wrapper given CPU tensors computes its plain
PyTorch version; given CUDA tensors it launches its kernel or raises.

Ported so far: the W4A4 serving stack (prefill with an optional flash-prefill
kernel, decode with an optional fused post-attention configuration, the mixed
prefill+decode step, the KV pool and the continuous-batching engine with
serial or mixed prefill, the bf16, W8A16 and W4A16 heads, LoRA adapters and
the native scheduler), MoE serving on one device, the baseline stacks bf16,
W8A8 and W4A16 in the same engine (``serving/baselines.py``), the grouped
int8 GEMMs (``ops/gemm.py``), and the accuracy pipeline (``main.py``: the
Llama, OPT and Mixtral models, calibration, evaluation, the serving exports)
with the fixture trainer (``utils/train.py``), and parallelism on
``torch.distributed`` (``parallel/``; tensor-, expert-, sequence- and
data-parallel serving in ``serving/``).  Every Pallas kernel of the JAX
package has its CUDA counterpart.

The package imports neither ``jax`` nor anything of ``atom_tpu``.
"""
