"""Quantization primitives (``atom_tpu/quant/core.py``), in float32 math:
the integer-code quantizers of the serving path and the fake quantizers
(quantize-dequantize round trips) of the accuracy pipeline.

Rounding is round-half-to-even (``torch.round``), as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from atom_tpu_torch.config import KeeperPrecision, QuantSpec, QuantType
from atom_tpu_torch.quant.fp import fake_cast_e4m3, fake_cast_e5m2, fake_quantize_fp4

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


def dequantize_groups(q: GroupQuant, dtype=torch.float32) -> torch.Tensor:
    return ((q.codes.to(torch.float32) - q.zero) * q.scale).to(dtype)


def _fake_quantize_exponential(w32: torch.Tensor, bits: int, sym: bool) -> torch.Tensor:
    """Exponent-only (power-of-two) fake quantization; no clip ratio."""
    q_max = float(2 ** (2 ** (bits - 1) - 1))
    if sym:
        scales = torch.clamp_min(w32.abs().amax(dim=-1, keepdim=True), _EPS)
        base = torch.zeros_like(scales)
    else:
        wmax = w32.amax(dim=-1, keepdim=True)
        wmin = w32.amin(dim=-1, keepdim=True)
        scales = (wmax - wmin) * 0.5
        base = (wmax + wmin) * 0.5
    scales = div_exact(scales, q_max)
    centered = w32 - base
    sign = torch.sign(centered)
    log_w = torch.log2(torch.clamp(centered.abs() / scales, 1.0, q_max))
    e = torch.floor(log_w)
    e = e + (log_w - e > torch.log2(torch.tensor(1.5, device=w32.device))).to(e.dtype)
    return torch.exp2(e) * sign * scales + base


def fake_quantize_tensor(
    w: torch.Tensor,
    bits: int,
    group_size: int,
    sym: bool,
    clip_ratio: float = 1.0,
    exponential: bool = False,
    quant_type: QuantType = QuantType.INT,
) -> torch.Tensor:
    """Quantize-dequantize round trip over groups of ``group_size`` along the
    last axis (0: the whole axis), in ``w``'s dtype."""
    if bits >= 16:
        return w
    orig_shape, orig_dtype = w.shape, w.dtype
    if group_size > 0:
        if orig_shape[-1] % group_size:
            raise ValueError(f"last dim {orig_shape[-1]} not divisible by group size {group_size}")
        w = w.reshape(*orig_shape[:-1], orig_shape[-1] // group_size, group_size)
    if quant_type == QuantType.FP:
        out = fake_quantize_fp4(w, dim=-1)
    elif exponential:
        out = _fake_quantize_exponential(w.to(torch.float32), bits, sym)
    else:
        out = dequantize_groups(quantize_groups(w, bits, sym, clip_ratio))
    return out.reshape(orig_shape).to(orig_dtype)


def quantize_weight_grouped(
    w: torch.Tensor,
    bits: int,
    group_size: int,
    sym: bool,
    channel_group: int = 1,
    clip_ratio: float = 1.0,
    exponential: bool = False,
    quant_type: QuantType = QuantType.INT,
) -> torch.Tensor:
    """Fake-quantize an [out, in] weight, ``channel_group`` adjacent output
    channels sharing each group's scale (``group_size`` 0: per output
    channel, the channel group ignored)."""
    if bits >= 16:
        return w
    out_ch, in_ch = w.shape
    if group_size == 0:
        return fake_quantize_tensor(w, bits, 0, sym, clip_ratio, exponential, quant_type)
    cg = channel_group
    if cg > 1:
        n_groups = in_ch // group_size
        wv = w.reshape(out_ch // cg, cg, n_groups, group_size)
        wv = wv.transpose(1, 2).reshape(out_ch // cg, n_groups, cg * group_size)
        wq = fake_quantize_tensor(wv, bits, 0, sym, clip_ratio, exponential, quant_type)
        wq = wq.reshape(out_ch // cg, n_groups, cg, group_size)
        return wq.transpose(1, 2).reshape(out_ch, in_ch)
    return fake_quantize_tensor(w, bits, group_size, sym, clip_ratio, exponential, quant_type)


def quantize_keeper(x: torch.Tensor, precision: KeeperPrecision) -> torch.Tensor:
    """The keeper (outlier) block at its precision; INT8 is symmetric per row."""
    if precision == KeeperPrecision.FLOAT:
        return x
    if precision == KeeperPrecision.FP8_E5M2:
        return fake_cast_e5m2(x)
    if precision == KeeperPrecision.FP8_E4M3:
        return fake_cast_e4m3(x)
    return fake_quantize_tensor(x, bits=8, group_size=0, sym=True)


def quantize_weight(w: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Atom weight fake quantization of an [out, in] matrix: the last
    ``keeper`` input channels at keeper precision, the rest (keeper block
    zeroed) group-quantized at ``wbits``, then the keeper block restored."""
    if not spec.quantize_weights:
        return w
    k = spec.keeper
    if k > 0:
        saved = quantize_keeper(w[:, -k:], spec.keeper_precision)
        w = w.clone()
        w[:, -k:] = 0
    wq = quantize_weight_grouped(
        w,
        bits=spec.wbits,
        group_size=spec.weight_group_size,
        sym=spec.w_sym,
        channel_group=spec.weight_channel_group,
        clip_ratio=spec.w_clip_ratio,
        exponential=spec.exponential,
        quant_type=spec.quant_type,
    )
    if k > 0:
        wq = wq.clone()
        wq[:, -k:] = saved.to(wq.dtype)
    return wq


def quantize_activation(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Dynamic per-token activation fake quantization with the keeper split:
    the last ``keeper`` channels at keeper precision, the body (keeper
    zeroed) group-quantized at ``abits``."""
    if not spec.quantize_acts:
        return x
    orig_shape, orig_dtype = x.shape, x.dtype
    d = orig_shape[-1]
    x2 = x.reshape(-1, d)
    k = spec.keeper
    if k > 0:
        saved = quantize_keeper(x2[:, -k:], spec.keeper_precision)
        x2 = x2.clone()
        x2[:, -k:] = 0
    xq = fake_quantize_tensor(
        x2,
        bits=spec.abits,
        group_size=spec.act_group_size,
        sym=spec.a_sym,
        clip_ratio=spec.a_clip_ratio,
        exponential=False,
        quant_type=spec.quant_type,
    )
    if k > 0:
        xq = xq.clone()
        xq[:, -k:] = saved.to(xq.dtype)
    return xq.reshape(orig_shape).to(orig_dtype)


def quantize_kv_head(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Per-(token, head) asymmetric KV fake quantization over head_dim at
    ``abits`` with ``kv_clip_ratio`` (independent of ``a_sym``)."""
    if not (spec.kv_cache and spec.quantize_acts):
        return x
    return fake_quantize_tensor(x, bits=spec.abits, group_size=0, sym=False, clip_ratio=spec.kv_clip_ratio)


def quantize_kv_head_real(x: torch.Tensor, spec: QuantSpec) -> GroupQuant:
    """Integer-code variant of :func:`quantize_kv_head`."""
    return quantize_groups(x, bits=spec.abits, sym=False, clip_ratio=spec.kv_clip_ratio)
