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
