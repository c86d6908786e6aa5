"""Paged INT4 KV cache layout (``atom_tpu/ops/kv_layout.py``), byte for byte.

  * ``k_pages``  int8 [P, H, D/2, S]: byte (c, s) holds channels ``c`` (low
    nibble) and ``c + D/2`` (high) of slot ``s``.
  * ``v_pages``  int8 [P, H, S/2, D]: byte (r, d) holds slots ``r`` (low)
    and ``r + S/2`` (high) of channel ``d``.
  * ``params``   bf16 [P, 4, H, S]: rows k_scale, k_zero_val, v_scale,
    v_zero_val; dequant ``x = code * scale + zero_val``.

Pages receive no per-token writes: decode tokens go to the hot ring
(``kv_hot``) and land here in bulk (``decode.flush_hot``); a prefill writes
whole pages (``append_kv_prefill_kernel``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from atom_tpu_torch.quant.packing import unpack_uint4


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


def _unpack_planes(pb: torch.Tensor) -> torch.Tensor:
    """Plane bytes [..., X/2, Y] -> u4 codes [..., X, Y] (int8 in [0, 15])."""
    b = pb.view(torch.uint8) if pb.dtype == torch.int8 else pb.to(torch.uint8)
    return torch.cat([(b & 0x0F).to(torch.int8), (b >> 4).to(torch.int8)], dim=-2)


def merge_params(k_prm: torch.Tensor, v_prm: torch.Tensor) -> torch.Tensor:
    """(k_prm [..., H, 2, S], v_prm [..., H, 2, S]) -> merged bf16 [..., 4, H, S]."""
    rows = torch.stack(
        [k_prm[..., :, 0, :], k_prm[..., :, 1, :], v_prm[..., :, 0, :], v_prm[..., :, 1, :]], dim=-3
    )
    return rows.to(torch.bfloat16)


def append_kv_prefill_kernel(pages: KVPages, k, v, page_table_row: torch.Tensor) -> KVPages:
    """Write a whole fresh prefill sequence a page at a time, in place.

    ``k``, ``v``: ``KVQuant`` (codes [T, H, D], params [T, H, 2]) of one fresh
    sequence; ``page_table_row``: int32 [max_pages].  Every page touched is
    fully overwritten, tail slots zeroed, so this is for fresh sequences only.
    Table entries past the allocation are 0, the sink page.  (XLA glue in the
    JAX package, so plain PyTorch here: one ``index_copy_`` per array.)
    """
    t, h, d = k.codes.shape
    s_size = pages.page_size
    n_full = -(-t // s_size)

    def paged(x):  # [T, H, X] -> [n_full, S, H, X], zero tail
        return F.pad(x, (0, 0, 0, 0, 0, n_full * s_size - t)).reshape(n_full, s_size, h, x.shape[-1])

    kc, vc = paged(k.codes), paged(v.codes)
    kp, vp = paged(k.params), paged(v.params)
    k_bytes = pack_channel_planes(kc.permute(0, 2, 3, 1))  # [n, H, D/2, S]
    v_bytes = pack_slot_planes(vc.permute(0, 2, 1, 3))  # [n, H, S/2, D]
    prm = merge_params(kp.permute(0, 2, 3, 1), vp.permute(0, 2, 3, 1))  # [n, 4, H, S]
    dest = page_table_row[:n_full].long()
    # The pages are distinct, except that several entries may name the sink
    # page 0, where the JAX loop's last write wins: every sink entry copies
    # the last one's content, so the result does not depend on write order.
    idx = torch.arange(n_full, device=dest.device)
    sink = dest == 0
    src = torch.where(sink, torch.where(sink, idx, -1).max(), idx)
    pages.k_pages.index_copy_(0, dest, k_bytes.index_select(0, src))
    pages.v_pages.index_copy_(0, dest, v_bytes.index_select(0, src))
    pages.params.index_copy_(0, dest, prm.index_select(0, src))
    return pages


# ---------------------------------------------------------------------------
# Converters to and from the reference layout (``ops.reference``)
# ---------------------------------------------------------------------------


def kv_pages_from_reference(k_pages_ref: torch.Tensor, k_params_ref: torch.Tensor, v_pages_ref: torch.Tensor,
                            v_params_ref: torch.Tensor) -> KVPages:
    """Reference-layout pages (int8 [P, H, S, D/2] packed along D, f32 params
    [P, H, S, 2]) -> the kernel layout."""
    k_codes = unpack_uint4(k_pages_ref)  # [P, H, S, D]
    v_codes = unpack_uint4(v_pages_ref)
    return KVPages(
        k_pages=pack_channel_planes(k_codes.transpose(-1, -2)),
        v_pages=pack_slot_planes(v_codes),
        params=merge_params(k_params_ref.transpose(-1, -2), v_params_ref.transpose(-1, -2)),
    )


def kv_codes_from_kernel(pages: KVPages):
    """Kernel layout -> (k_codes [P, H, S, D], k_params [P, H, S, 2], v_codes, v_params)."""
    k_codes = _unpack_planes(pages.k_pages).transpose(-1, -2)
    v_codes = _unpack_planes(pages.v_pages)
    prm = pages.params.to(torch.float32)  # [P, 4, H, S]
    k_params = torch.stack([prm[:, 0], prm[:, 1]], dim=-1)
    v_params = torch.stack([prm[:, 2], prm[:, 3]], dim=-1)
    return k_codes, k_params, v_codes, v_params
