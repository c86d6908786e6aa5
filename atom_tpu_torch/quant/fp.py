"""Floating-point mini-format fake casts (``atom_tpu/quant/fp.py``): FP8
(E5M2 / E4M3) and FP4.

  * FP8: a round trip through ``torch.float8_e5m2`` / ``torch.float8_e4m3fn``
    (round to nearest even).  E4M3 is the ``fn`` variant, max 448, as in the
    JAX package.
  * FP4: the bitsandbytes FP4 codebook, 16 values; nearest code by counting
    the midpoints below each magnitude.
"""
from __future__ import annotations

import numpy as np
import torch

# The FP4 code magnitudes {0, 0.0625, 2, 3, 4, 6, 8, 12} / 12 and the midpoints
# between neighbours, as float32 constants (each one IEEE float32 operation).
_FP4_MAGNITUDES_NP = np.array([0.0, 0.0625, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0], np.float32) / np.float32(12.0)
_FP4_MIDPOINTS_NP = (_FP4_MAGNITUDES_NP[1:] + _FP4_MAGNITUDES_NP[:-1]) / np.float32(2.0)


def _const(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


def fake_cast_e5m2(x: torch.Tensor) -> torch.Tensor:
    """Round trip through FP8 E5M2 (keeper precision 1)."""
    return x.to(torch.float8_e5m2).to(x.dtype)


def fake_cast_e4m3(x: torch.Tensor) -> torch.Tensor:
    """Round trip through FP8 E4M3fn (keeper precision 2)."""
    return x.to(torch.float8_e4m3fn).to(x.dtype)


def fp4_round_normalized(v: torch.Tensor) -> torch.Tensor:
    """Values in [-1, 1] -> the nearest FP4 code value (float32); magnitudes
    above 1 clamp to the last code."""
    mag = v.abs().to(torch.float32)
    idx = (mag[..., None] > _const(_FP4_MIDPOINTS_NP, v.device)).sum(dim=-1)
    code = _const(_FP4_MAGNITUDES_NP, v.device)[idx]
    return torch.sign(v) * code


def fake_quantize_fp4(w: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """FP4 fake quantization with one absmax scale per block along ``dim``:
    normalise to [-1, 1], round to the codebook, rescale."""
    w32 = w.to(torch.float32)
    absmax = torch.clamp_min(w32.abs().amax(dim=dim, keepdim=True), 1e-12)
    return (fp4_round_normalized(w32 / absmax) * absmax).to(w.dtype)
