"""PyTorch + CUDA port of ``atom_tpu`` for one NVIDIA H100.

The port mirrors the JAX package's layout and names.  Plain tensor code is
PyTorch; every Pallas kernel on a ported path is a hand-written CUDA kernel
under ``csrc/``, built for ``sm_90a`` at first use (``ops/_build.py``).

Device policy: entry points run on ``cuda`` unless the caller passes
``device="cpu"``.  A kernel wrapper given CPU tensors computes its plain
PyTorch version; given CUDA tensors it launches its kernel or raises.

The package imports neither ``jax`` nor anything of ``atom_tpu``.
"""
