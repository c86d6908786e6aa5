"""Shared building blocks (``atom_tpu/models/nn.py``): bf16 tensors, f32 math."""
from __future__ import annotations

import torch

from atom_tpu_torch.numerics import rms_rstd


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Llama RMSNorm: f32 statistics, normalised value rounded to x's dtype,
    then multiplied by the weight in the weight's dtype."""
    xn = x.to(torch.float32) * rms_rstd(x, eps)
    return xn.to(x.dtype) * weight


def rope_tables(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., head_dim] f32; frequencies over pairs
    (i, i + head_dim/2), duplicated across both halves (HF Llama)."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv_freq = 1.0 / (theta**exps)
    angles = positions[..., None].to(torch.float32) * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotary embedding on the last axis, cos/sin broadcastable against x."""
    x32 = x.to(torch.float32)
    return (x32 * cos + rotate_half(x32) * sin).to(x.dtype)


def repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[b, kv_heads, s, d] -> [b, kv_heads * groups, s, d] (GQA broadcast)."""
    if groups == 1:
        return x
    b, h, s, d = x.shape
    return x[:, :, None].expand(b, h, groups, s, d).reshape(b, h * groups, s, d)


def causal_mask(q_len: int, kv_len: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[1, 1, q_len, kv_len] additive causal mask (0 / the dtype's lowest)."""
    q_ids = torch.arange(q_len, device=device)[:, None] + (kv_len - q_len)
    kv_ids = torch.arange(kv_len, device=device)[None, :]
    mask = torch.where(kv_ids <= q_ids, 0.0, torch.finfo(dtype).min)
    return mask[None, None].to(dtype)
