"""Plain PyTorch versions of the serving ops (``atom_tpu/ops/reference.py``).

Only the ops the ported paths need: the dual-path GEMM oracle and its k/v
variant with the output quantized per head, the KV quantizer and the fused
quantize epilogues' glue.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from atom_tpu_torch.config import QuantSpec
from atom_tpu_torch.models.nn import rmsnorm
from atom_tpu_torch.numerics import rp_bf16
from atom_tpu_torch.ops.formats import (
    PackedWeight,
    QuantizedActivation,
    quantize_activation_packed,
)
from atom_tpu_torch.quant.core import div_exact


def _int_dot(a: torch.Tensor, b: torch.Tensor, eq: str) -> torch.Tensor:
    """Exact integer einsum of int8 operands, returned as float32.

    Products are summed in float64, exact for |sum| < 2**53, which also makes
    this run on CUDA tensors (no integer matmul there).
    """
    return torch.einsum(eq, a.to(torch.float64), b.to(torch.float64)).to(torch.float32)


def quant_gemm(
    qa: QuantizedActivation, pw: PackedWeight, out_dtype=torch.bfloat16
) -> torch.Tensor:
    """D[T, N] = dequant(A_i4 . W_i4) + dequant(A_i8 . W_i8): integer dot per
    128-group with the scale product applied to the partial sums."""
    t = qa.codes.shape[0]
    kb, n = pw.body.shape
    ng = pw.body_scale.shape[0]
    g = kb // ng
    acc = _int_dot(qa.codes[:, :kb].reshape(t, ng, g), pw.body.reshape(ng, g, n), "tgi,gio->tgo")
    body = torch.einsum("tgo,tg,go->to", acc, qa.scales[:, :ng], pw.body_scale)
    kacc = _int_dot(qa.codes[:, kb:], pw.keeper, "ti,io->to")
    keeper = kacc * (qa.scales[:, ng:] * pw.keeper_scale[None, :])
    return (body + keeper).to(out_dtype)


class KVQuant(NamedTuple):
    """Asymmetric INT4 codes + per-(token, head) affine params.

    ``codes``: int8 [T, H, D] in [0, 15]; ``params``: f32 [T, H, 2] =
    (scale, zero_val); dequant = codes * scale + zero_val.
    """

    codes: torch.Tensor
    params: torch.Tensor


def quantize_kv_asym(x: torch.Tensor, clip_ratio: float = 1.0) -> KVQuant:
    """Per-(token, head) asym INT4 over head_dim.  Scale and zero_val are
    rounded to bf16 at the source, as the paged cache stores them."""
    x32 = x.to(torch.float32)
    xmax = x32.amax(dim=-1, keepdim=True) * clip_ratio
    xmin = x32.amin(dim=-1, keepdim=True) * clip_ratio
    scale = rp_bf16(div_exact(torch.clamp_min(xmax - xmin, 1e-5), 15.0))
    zero = torch.clamp(torch.round(-xmin / scale), 0, 15)
    codes = torch.clamp(torch.round(x32 / scale) + zero, 0, 15).to(torch.int8)
    zero_val = rp_bf16(-zero * scale)
    return KVQuant(codes=codes, params=torch.cat([scale, zero_val], dim=-1))


def dequantize_kv(codes: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """codes [..., D] int, params [..., 2] -> f32 values."""
    return codes.to(torch.float32) * params[..., 0:1] + params[..., 1:2]


def quant_gemm_o4(qa: QuantizedActivation, pw: PackedWeight, head_dim: int = 128) -> KVQuant:
    """``quant_gemm`` with the asymmetric per-``head_dim`` u4 re-quantization
    of its output (the k/v projection feeding the INT4 KV cache) -> codes
    [T, N // head_dim, head_dim], params [T, N // head_dim, 2]."""
    out = quant_gemm(qa, pw, out_dtype=torch.float32)
    t, n = out.shape
    return quantize_kv_asym(out.reshape(t, n // head_dim, head_dim))


def rmsnorm_reorder_quant(
    x: torch.Tensor,
    norm_weight: torch.Tensor,
    reorder_idx: torch.Tensor,
    spec: QuantSpec,
    eps: float = 1e-5,
) -> QuantizedActivation:
    """RMSNorm -> channel gather -> dual-path dynamic quant."""
    y = rmsnorm(x, norm_weight, eps)
    return quantize_activation_packed(torch.index_select(y, -1, reorder_idx), spec)


def reorder_quant(
    x: torch.Tensor, reorder_idx: torch.Tensor, spec: QuantSpec
) -> QuantizedActivation:
    """Channel gather -> dual-path dynamic quant."""
    return quantize_activation_packed(torch.index_select(x, -1, reorder_idx), spec)
