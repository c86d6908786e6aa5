"""Token-embedding row fetch (``atom_tpu/ops/pallas_misc.py``), kernel K6.

``embed_gather`` launches ``csrc/embed_gather.cu`` on CUDA tensors and runs
``embed_gather_plain`` on CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from atom_tpu_torch.ops import _build
from atom_tpu_torch.ops.runtime import check_kernel_input, on_cpu

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _kernel():
    fn = _build.load("embed_gather").atom_embed_gather
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def embed_gather_plain(embed: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """rows ``embed[ids]`` with ids clamped into [0, V)."""
    return embed[ids.long().clamp(0, embed.shape[0] - 1)]


def embed_gather(embed: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """rows ``embed[ids]`` -> [B, D] in embed's dtype (ids int32 [B])."""
    if on_cpu(embed, ids):
        return embed_gather_plain(embed, ids)
    v, d = embed.shape
    (b,) = ids.shape
    check_kernel_input(embed, "embed", torch.bfloat16)
    check_kernel_input(ids, "ids", torch.int32)
    if d % 8:
        raise ValueError(f"embed_gather: hidden size {d} must be a multiple of 8")
    out = torch.empty((b, d), dtype=embed.dtype, device=embed.device)
    if b:
        _build.check(
            _kernel()(embed.data_ptr(), ids.data_ptr(), out.data_ptr(), b, v, d, _build.stream()),
            "embed_gather",
        )
        embed_gather.launches += 1
    return out


embed_gather.launches = 0
