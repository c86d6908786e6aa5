"""Plain PyTorch versions of the serving ops (``atom_tpu/ops/reference.py``).

The dual-path GEMM oracle and its k/v variant with the output quantized per
head, the KV quantizer, the fused quantize epilogues' glue, and the plain
paged INT4 KV cache of the reference layout (``make_kv_pages``, the decode
and prefill appends, ``gather_kv``) with its decode attention
(``batch_decode``): the oracles that the kernel layouts of ``kv_layout`` are
held against.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from atom_tpu_torch.config import QuantSpec
from atom_tpu_torch.models.nn import rmsnorm, rope_tables
from atom_tpu_torch.numerics import rp_bf16
from atom_tpu_torch.ops.formats import (
    PackedWeight,
    QuantizedActivation,
    quantize_activation_packed,
)
from atom_tpu_torch.ops.runtime import resolve_device
from atom_tpu_torch.quant.core import div_exact
from atom_tpu_torch.quant.packing import pack_uint4, unpack_uint4


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


def silu_mul_quant(gate: torch.Tensor, up: torch.Tensor, spec: QuantSpec) -> QuantizedActivation:
    """quant(SiLU(gate) * up) in float32: the MLP epilogue (no reorder: gate
    and up were out-reordered at calibration into down_proj's input order)."""
    return quantize_activation_packed(F.silu(gate.to(torch.float32)) * up.to(torch.float32), spec)


# ---------------------------------------------------------------------------
# Paged INT4 KV cache, reference layout
# ---------------------------------------------------------------------------
#
#   pages  int8 [n_pages, kv_heads, page_size, head_dim // 2] (two u4 codes a
#          byte, packed along head_dim: ``pack_uint4``)
#   params f32  [n_pages, kv_heads, page_size, 2] (scale, zero_val)
# A sequence's pages come from a padded page table [B, max_pages] with its
# lengths [B].  The appends return new tensors and leave their inputs alone.


def make_kv_pages(n_pages: int, kv_heads: int, page_size: int, head_dim: int,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = resolve_device(device)
    pages = torch.zeros((n_pages, kv_heads, page_size, head_dim // 2), dtype=torch.int8, device=dev)
    params = torch.zeros((n_pages, kv_heads, page_size, 2), dtype=torch.float32, device=dev)
    return pages, params


def append_kv_decode(pages: torch.Tensor, params: torch.Tensor, kv: KVQuant, page_idx: torch.Tensor,
                     slot: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One new token a sequence (codes [B, H, D], params [B, H, 2]) into
    page ``page_idx[b]``, slot ``slot[b]``."""
    pages, params = pages.clone(), params.clone()
    pi, si = page_idx.long(), slot.long()
    pages[pi, :, si] = pack_uint4(kv.codes).view(torch.int8)
    params[pi, :, si] = kv.params.to(params.dtype)
    return pages, params


def append_kv_prefill(pages: torch.Tensor, params: torch.Tensor, kv: KVQuant, page_table_row: torch.Tensor,
                      page_size: int, start_pos: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """A whole sequence (codes [T, H, D]) into its pages from ``start_pos``."""
    t = kv.codes.shape[0]
    positions = torch.arange(t, device=pages.device) + start_pos
    page_of = page_table_row.long()[positions // page_size]
    slot_of = positions % page_size
    pages, params = pages.clone(), params.clone()
    pages[page_of, :, slot_of] = pack_uint4(kv.codes).view(torch.int8)
    params[page_of, :, slot_of] = kv.params.to(params.dtype)
    return pages, params


def gather_kv(pages: torch.Tensor, params: torch.Tensor, page_table_row: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A sequence's pages -> codes [max_pages * page_size, H, D] and params
    [max_pages * page_size, H, 2], in position order."""
    pk = pages[page_table_row.long()]  # [P, H, S, D/2]
    pp = params[page_table_row.long()]  # [P, H, S, 2]
    p, h, s, dh = pk.shape
    codes = unpack_uint4(pk).permute(0, 2, 1, 3).reshape(p * s, h, dh * 2)
    return codes, pp.permute(0, 2, 1, 3).reshape(p * s, h, 2)


def batch_decode(
    q: torch.Tensor,  # [B, num_heads, head_dim], RoPE applied
    k_pages: torch.Tensor,
    k_params: torch.Tensor,
    v_pages: torch.Tensor,
    v_params: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages]
    seq_lens: torch.Tensor,  # [B] tokens a sequence, the current one included
    rope_theta: float = 10000.0,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Decode attention over the reference-layout pages: K is stored before
    RoPE, so each key is dequantized and rotated at its absolute position,
    then a masked float32 softmax against V -> [B, num_heads, head_dim]."""
    b, num_heads, head_dim = q.shape
    groups = num_heads // k_pages.shape[1]
    max_t = page_table.shape[1] * k_pages.shape[2]
    positions = torch.arange(max_t, device=q.device)
    cos, sin = rope_tables(positions, head_dim, rope_theta)  # [T, D]
    half = head_dim // 2
    outs = []
    for i in range(b):
        k = dequantize_kv(*gather_kv(k_pages, k_params, page_table[i]))  # [T, Hkv, D] f32
        v = dequantize_kv(*gather_kv(v_pages, v_params, page_table[i]))
        k_rot = k * cos[:, None, :] + torch.cat([-k[..., half:], k[..., :half]], dim=-1) * sin[:, None, :]
        k_rep = torch.repeat_interleave(k_rot, groups, dim=1)  # [T, H, D]
        v_rep = torch.repeat_interleave(v, groups, dim=1)
        scores = torch.einsum("hd,thd->ht", q[i].to(torch.float32), k_rep)
        scores = scores / torch.sqrt(torch.tensor(head_dim, dtype=torch.float32, device=q.device))
        scores = torch.where((positions < seq_lens[i])[None, :], scores, torch.finfo(torch.float32).min)
        outs.append(torch.einsum("ht,thd->hd", torch.softmax(scores, dim=-1), v_rep))
    return torch.stack(outs).to(out_dtype)
