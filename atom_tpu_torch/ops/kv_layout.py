"""Paged INT4 KV cache layout (``atom_tpu/ops/kv_layout.py``), byte for byte.

  * ``k_pages``  int8 [P, H, D/2, S]: byte (c, s) holds channels ``c`` (low
    nibble) and ``c + D/2`` (high) of slot ``s``.
  * ``v_pages``  int8 [P, H, S/2, D]: byte (r, d) holds slots ``r`` (low)
    and ``r + S/2`` (high) of channel ``d``.
  * ``params``   bf16 [P, 4, H, S]: rows k_scale, k_zero_val, v_scale,
    v_zero_val; dequant ``x = code * scale + zero_val``.

Pages receive no per-token writes: decode tokens go to the hot ring
(``kv_hot``) and land here in bulk (``decode.flush_hot``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class KVPages(NamedTuple):
    """One layer's paged quantized KV cache."""

    k_pages: torch.Tensor  # int8 [P, H, D//2, S]
    v_pages: torch.Tensor  # int8 [P, H, S//2, D]
    params: torch.Tensor  # bf16 [P, 4, H, S]

    @property
    def n_pages(self) -> int:
        return self.k_pages.shape[0]

    @property
    def kv_heads(self) -> int:
        return self.k_pages.shape[1]

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def head_dim(self) -> int:
        return self.k_pages.shape[2] * 2


def make_kv_pages_kernel(
    n_pages: int, kv_heads: int, page_size: int, head_dim: int, device
) -> KVPages:
    if page_size % 2 or head_dim % 2:
        raise ValueError("page_size and head_dim must be even")
    return KVPages(
        k_pages=torch.zeros((n_pages, kv_heads, head_dim // 2, page_size), dtype=torch.int8, device=device),
        v_pages=torch.zeros((n_pages, kv_heads, page_size // 2, head_dim), dtype=torch.int8, device=device),
        params=torch.zeros((n_pages, 4, kv_heads, page_size), dtype=torch.bfloat16, device=device),
    )


def _pack_planes(codes: torch.Tensor, dim: int) -> torch.Tensor:
    n = codes.shape[dim]
    lo = codes.narrow(dim, 0, n // 2).to(torch.int16) & 0x0F
    hi = codes.narrow(dim, n // 2, n // 2).to(torch.int16) & 0x0F
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def pack_channel_planes(codes: torch.Tensor) -> torch.Tensor:
    """u4 codes [..., D, S] -> channel-plane bytes [..., D/2, S]."""
    return _pack_planes(codes, -2)


def pack_slot_planes(codes: torch.Tensor) -> torch.Tensor:
    """u4 codes [..., S, D] -> slot-plane bytes [..., S/2, D]."""
    return _pack_planes(codes, -2)
