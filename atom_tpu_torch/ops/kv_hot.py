"""Hot KV ring: decode appends land here, pages get bulk flushes
(``atom_tpu/ops/kv_hot.py``).

Every decode step writes all sequences' new (K, V, params) into ring column
``row`` (from inside the fused qkv kernels, or with ``write_hot`` off their
geometry); attention covers the flushed
pages plus the ring's valid suffix; once per ring wrap every sequence's
pending block moves to its page(s).  The ring uses the page layouts with W
lanes in place of S:

    k_codes [B, H, D/2, W]  channel-plane bytes (low nibble = channel d,
                            high = d + D/2)
    prm     [B, 4, H, W]    bf16 k_scale / k_zero / v_scale / v_zero
    v_codes [B, H, W, D]    unpacked u4 codes

The port updates the ring in place (the JAX version donates it).

``hot_attention`` and ``merge_attention`` are the two-part form of decode
attention that the mixed prefill+decode step uses: the pages-only kernel
(``decode.paged_decode_attention_rotated``) returns a normalised output with
its softmax state, the ring part an unnormalised one, and the merge joins
them.  Both are plain tensor code in the JAX package, so plain PyTorch here.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

HOT_W = 32


class HotKV(NamedTuple):
    """Dense decode ring for one layer."""

    k_codes: torch.Tensor  # int8 [B, H, D/2, W]
    prm: torch.Tensor  # bf16 [B, 4, H, W]
    v_codes: torch.Tensor  # int8 [B, H, W, D]

    @property
    def window(self) -> int:
        return self.k_codes.shape[3]


def make_hot(batch: int, kv_heads: int, head_dim: int, device, w: int = HOT_W) -> HotKV:
    return HotKV(
        k_codes=torch.zeros((batch, kv_heads, head_dim // 2, w), dtype=torch.int8, device=device),
        prm=torch.zeros((batch, 4, kv_heads, w), dtype=torch.bfloat16, device=device),
        v_codes=torch.zeros((batch, kv_heads, w, head_dim), dtype=torch.int8, device=device),
    )


def hot_flush_blocks(hot: HotKV, row_now: int):
    """Ring contents in position order (oldest token first), shaped for
    ``decode.flush_hot``: the roll of the ring axis by ``-(row_now + 1)``."""
    shift = -(row_now + 1)
    return (
        torch.roll(hot.k_codes, shift, dims=3),
        torch.roll(hot.prm, shift, dims=3),
        torch.roll(hot.v_codes, shift, dims=2),
    )


def write_hot(hot: HotKV, row: int, k, v) -> HotKV:
    """Write this step's tokens (``KVQuant`` codes [B, H, D], params
    [B, H, 2]) into ring column ``row``, in place.  The path of geometries
    the fused qkv -> ring kernels do not take."""
    d = hot.v_codes.shape[3]
    kc = k.codes.to(torch.int16)
    packed = (kc[:, :, : d // 2] & 0x0F) | ((kc[:, :, d // 2 :] & 0x0F) << 4)
    hot.k_codes[:, :, :, row] = packed.to(torch.uint8).view(torch.int8)
    rows = torch.cat([k.params.transpose(1, 2), v.params.transpose(1, 2)], dim=1)  # [B, 4, H]
    hot.prm[:, :, :, row] = rows.to(torch.bfloat16)
    hot.v_codes[:, :, row, :] = v.codes.to(torch.int8)
    return hot


def hot_attention(q: torch.Tensor, hot: HotKV, n_valid: torch.Tensor, row_now: int, sm_scale: float):
    """Dense attention over the ring suffix -> (out f32 [B, HQ, D]
    unnormalised, m [B, HQ], l [B, HQ]) for merging with the paged kernel's
    part.  Affine-code math, the codes never dequantized:
    ``q.k = (q.codes) * scale + sum(q) * zero``,
    ``p.v = (p * v_scale).codes + sum(p * v_zero)``."""
    b, h, dh, w = hot.k_codes.shape
    hq = q.shape[1]
    groups = hq // h
    qf = q.to(torch.float32)

    def rep(x):  # [B, H, ...] -> [B, HQ, ...]
        return x.repeat_interleave(groups, dim=1) if groups > 1 else x

    ku = hot.k_codes.to(torch.int32) & 0xFF
    k_full = torch.cat([ku & 0x0F, ku >> 4], dim=2).to(torch.float32)  # [B, H, D, W]
    dot = torch.einsum("bhd,bhdw->bhw", qf, rep(k_full))
    prm = hot.prm.to(torch.float32)  # [B, 4, H, W]
    q_sum = qf.sum(-1, keepdim=True)  # [B, HQ, 1]
    scores = (dot * rep(prm[:, 0]) + q_sum * rep(prm[:, 1])) * sm_scale  # [B, HQ, W]

    cols = torch.arange(w, device=q.device)
    age = (row_now - cols) % w  # ring age of each column (0 = the current token)
    valid = (age[None, :] < n_valid[:, None])[:, None, :]  # [B, 1, W]
    scores = torch.where(valid, scores, -1e30)

    m = scores.amax(-1)  # [B, HQ]
    p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    l = p.sum(-1)
    out = torch.einsum("bhw,bhwd->bhd", p * rep(prm[:, 2]), rep(hot.v_codes.to(torch.float32)))
    out = out + (p * rep(prm[:, 3])).sum(-1, keepdim=True)
    return out, m, l


def merge_attention(out1, m1, l1, out2, m2, l2, out_dtype=torch.bfloat16):
    """Two-part online-softmax merge: part 1 (the paged kernel) is normalised
    by ``l1``, part 2 unnormalised.  An empty part 1 (``m1 = -1e30, l1 = 0,
    out1 = 0``: nothing flushed yet, or a prompt's first chunk) drops out."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m) * l1
    a2 = torch.exp(m2 - m)
    l = torch.clamp_min(a1 + a2 * l2, 1e-20)
    out = (out1.to(torch.float32) * a1[..., None] + out2 * a2[..., None]) / l[..., None]
    return out.to(out_dtype)
