"""Quantization primitives (``atom_tpu/quant/core.py``), in float32 math.

Rounding is round-half-to-even (``torch.round``), as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-5


def div_exact(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded as one IEEE division.  PyTorch's CUDA division by a
    Python scalar multiplies by the scalar's reciprocal, which rounds
    differently; dividing by a tensor on x's device does not."""
    return x / torch.full_like(x, c)


class GroupQuant(NamedTuple):
    """Integer codes + affine params for last-axis group quantization.

    ``scale`` and ``zero`` keep the reduced axis (size 1); ``zero`` is all
    zeros for symmetric quantization.
    """

    codes: torch.Tensor  # int8 (int16 for asym 8-bit), same shape as input
    scale: torch.Tensor  # float32 [..., 1]
    zero: torch.Tensor  # float32 [..., 1]


def compute_scale_sym(w32: torch.Tensor, bits: int, clip_ratio: float) -> torch.Tensor:
    """Symmetric absmax scale along the last axis."""
    qmax = 2 ** (bits - 1) - 1
    wmax = torch.clamp_min(w32.abs().amax(dim=-1, keepdim=True), _EPS)
    if clip_ratio < 1.0:
        wmax = wmax * clip_ratio
    return div_exact(wmax, qmax)


def compute_scale_asym(
    w32: torch.Tensor, bits: int, clip_ratio: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Asymmetric min/max scale + zero point along the last axis."""
    qmax = 2**bits - 1
    wmax = w32.amax(dim=-1, keepdim=True)
    wmin = w32.amin(dim=-1, keepdim=True)
    if clip_ratio < 1.0:
        wmax = wmax * clip_ratio
        wmin = wmin * clip_ratio
    scale = div_exact(torch.clamp_min(wmax - wmin, _EPS), qmax)
    zero = torch.clamp(torch.round(-wmin / scale), 0, qmax)
    return scale, zero


def quantize_groups(
    w: torch.Tensor, bits: int, sym: bool, clip_ratio: float = 1.0
) -> GroupQuant:
    """Quantize along the last axis into integer codes.

    Symmetric:  codes in [-2^(b-1), 2^(b-1)-1],  x ~ codes * scale.
    Asymmetric: codes in [0, 2^b - 1],           x ~ (codes - zero) * scale.
    """
    w32 = w.to(torch.float32)
    if sym:
        qmin, qmax = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
        scale = compute_scale_sym(w32, bits, clip_ratio)
        zero = torch.zeros_like(scale)
        codes = torch.clamp(torch.round(w32 / scale), qmin, qmax)
    else:
        qmin, qmax = 0, 2**bits - 1
        scale, zero = compute_scale_asym(w32, bits, clip_ratio)
        codes = torch.clamp(torch.round(w32 / scale) + zero, qmin, qmax)
    code_dtype = torch.int8 if (sym or bits <= 7) else torch.int16
    return GroupQuant(codes.to(code_dtype), scale, zero)
