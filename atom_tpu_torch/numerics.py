"""Numerics pins of the bf16 dtype contract (``atom_tpu/numerics.py``).

PyTorch runs eagerly, so a float32 -> bfloat16 -> float32 round trip is never
elided; ``rp_bf16`` is that round trip, kept as a named function so the call
sites read like their JAX counterparts.
"""
from __future__ import annotations

import torch


def rp_bf16(x32: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bfloat16 precision (nearest even), staying f32."""
    return x32.to(torch.bfloat16).to(torch.float32)


def rms_rstd(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm reciprocal std [..., 1], float32 statistics over the last axis."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return torch.rsqrt(var + eps)
