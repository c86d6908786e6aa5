"""Weight-only INT8 GEMM with bf16 activations
(``atom_tpu/ops/pallas_gemm_w4a16.py``, its W8A16 half), kernel K5.

``w8a16_gemm``: ``out f32 [M, N] = (sum_k bf16(a[m, k]) * codes[k, n]) *
scale[n]`` with float32 accumulation; the per-column scale multiplies once,
after the whole sum.  It is the serving lm_head's default precision.  int8
codes are exact in bf16, so every product is exact in float32 and only the
order of the float32 additions differs between implementations: the TPU
kernel adds K blocks of 1024, the CUDA kernel (``csrc/gemm_w8a16.cu``)
16-wide tensor-core steps split over 8 warps, the plain version whatever
``torch.mm`` does.  They are held to each other within ``W8A16_RTOL`` of the
largest output: no partial sum is ever rounded to bf16, which would cost
2**-9.

The weight-only INT4 half of the JAX module (kernel K13) is not ported yet.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from atom_tpu_torch.ops import _build
from atom_tpu_torch.ops.runtime import check_kernel_input, on_cpu
from atom_tpu_torch.quant.core import div_exact

# kernel vs plain version: |diff| <= W8A16_RTOL * max|out| (float32 sums of
# exact products taken in another order; a bf16-rounded partial sum would
# show as ~2e-3)
W8A16_RTOL = 1e-4
_TN = 64  # output columns per CUDA block
_TK = 16  # K step of the tensor-core instruction

_P, _I = ctypes.c_void_p, ctypes.c_int


class W8A16Weight(NamedTuple):
    """Per-output-column symmetric INT8 weight-only matrix.

    ``codes``: int8 [K, N]; ``scale``: f32 [1, N]; ``w ~ codes * scale``.
    """

    codes: torch.Tensor
    scale: torch.Tensor


def quantize_w8a16(w: torch.Tensor) -> W8A16Weight:
    w32 = w.to(torch.float32)
    scale = div_exact(torch.clamp_min(w32.abs().amax(dim=0, keepdim=True), 1e-8), 127.0)
    codes = torch.clamp(torch.round(w32 / scale), -128, 127).to(torch.int8)
    return W8A16Weight(codes=codes, scale=scale)


def dequantize_w8a16(wq: W8A16Weight) -> torch.Tensor:
    return wq.codes.to(torch.float32) * wq.scale


@functools.cache
def _kernel():
    fn = _build.load("gemm_w8a16").atom_gemm_w8a16
    fn.argtypes = [_P] * 4 + [_I] * 3 + [_P]
    fn.restype = _I
    return fn


def w8a16_gemm_plain(a: torch.Tensor, wq: W8A16Weight) -> torch.Tensor:
    """Plain version of K5: bf16 operands, float32 sums, scale at the end."""
    ab = a.to(torch.bfloat16)
    if ab.is_cuda:
        acc = torch.mm(ab, wq.codes.to(torch.bfloat16), out_dtype=torch.float32)
    else:
        acc = ab.to(torch.float32) @ wq.codes.to(torch.float32)
    return acc * wq.scale


def w8a16_gemm(a: torch.Tensor, wq: W8A16Weight) -> torch.Tensor:
    """Kernel K5: bf16/f32 ``a`` [M, K] x W8A16 weight -> f32 [M, N]."""
    if on_cpu(a, wq.codes, wq.scale):
        return w8a16_gemm_plain(a, wq)
    m, k = a.shape
    n = wq.codes.shape[1]
    if k % _TK or n % _TN:
        raise ValueError(f"w8a16_gemm: K={k} must be a multiple of {_TK}, N={n} of {_TN}")
    ab = a.to(torch.bfloat16).contiguous()
    check_kernel_input(ab, "a", torch.bfloat16)
    check_kernel_input(wq.codes, "codes", torch.int8, (k, n))
    check_kernel_input(wq.scale, "scale", torch.float32, (1, n))
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m:
        _build.check(
            _kernel()(ab.data_ptr(), wq.codes.data_ptr(), wq.scale.data_ptr(), out.data_ptr(), m, n, k, _build.stream()),
            "w8a16_gemm",
        )
        w8a16_gemm.launches += 1
    return out


w8a16_gemm.launches = 0
