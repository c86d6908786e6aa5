"""INT4 <-> INT8 carrier packing (``atom_tpu/quant/packing.py``).

Element ``2*i`` occupies the LOW nibble of byte ``i``, element ``2*i + 1``
the HIGH nibble; signed values are two's-complement nibbles.
"""
from __future__ import annotations

import torch


def _interleave(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*lo.shape[:-1], lo.shape[-1] * 2)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Signed int4 codes (int8 in [-8, 7]) [..., N] -> int8 [..., N // 2]."""
    if codes.shape[-1] % 2:
        raise ValueError("pack_int4 needs an even last dim")
    u = codes.to(torch.int16) & 0x0F
    return (u[..., 0::2] | (u[..., 1::2] << 4)).to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: int8 [..., N // 2] -> int8 [..., N]."""
    b = packed.to(torch.int8)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(b, 4), 4)
    hi = torch.bitwise_right_shift(b, 4)
    return _interleave(lo, hi)


def pack_uint4(codes: torch.Tensor) -> torch.Tensor:
    """Unsigned int4 codes (values in [0, 15]) [..., N] -> uint8 [..., N // 2]."""
    if codes.shape[-1] % 2:
        raise ValueError("pack_uint4 needs an even last dim")
    u = codes.to(torch.int16) & 0x0F
    return (u[..., 0::2] | (u[..., 1::2] << 4)).to(torch.uint8)


def unpack_uint4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_uint4`: values in [0, 15], dtype int8."""
    b = packed.view(torch.uint8) if packed.dtype == torch.int8 else packed.to(torch.uint8)
    lo = (b & 0x0F).to(torch.int8)
    hi = (b >> 4).to(torch.int8)
    return _interleave(lo, hi)
