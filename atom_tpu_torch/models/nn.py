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


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Standard LayerNorm (OPT) with f32 statistics (population variance)."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * weight + bias


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Plain attention of the accuracy path: [b, h, s, d] inputs, f32 scores
    (q.k in f32 over the inputs' values) scaled by 1/sqrt(d), the mask added,
    an f32 softmax, the probabilities rounded to v's dtype, p.v in f32, the
    result in v's dtype."""
    d = q.shape[-1]
    scores = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    scores = scores / torch.sqrt(torch.tensor(d, dtype=torch.float32, device=q.device))
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return out.to(v.dtype)
