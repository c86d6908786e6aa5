"""Packed tensor formats of the serving path (``atom_tpu/ops/formats.py``).

Scale semantics (symmetric body / keeper, the canonical Atom config):
    x ~ codes_i4 * scale_group        (body, per 128-group)
    x ~ codes_i8 * keeper_scale       (keeper block, per row/token)
Weight scales are shared across ``weight_channel_group`` adjacent output
channels but stored expanded to [n_groups, out].
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from atom_tpu_torch.config import KeeperPrecision, QuantSpec
from atom_tpu_torch.quant.core import _EPS, compute_scale_sym, quantize_groups


class PackedWeight(NamedTuple):
    """W4A4 dual-path [in, out] weight with unpacked int4 codes.

      * ``body``: int8 [in - keeper, out]; ``body_scale``: f32 [n_groups, out]
      * ``keeper``: int8 [keeper, out];    ``keeper_scale``: f32 [out]
    """

    body: torch.Tensor
    body_scale: torch.Tensor
    keeper: torch.Tensor
    keeper_scale: torch.Tensor


class QuantizedActivation(NamedTuple):
    """Dynamically quantized activation in the layout the GEMMs read: the
    INT8 keeper block is one more 128-group after the INT4 body groups.

      * ``codes``:  int8 [tokens, d]             (body codes, then keeper codes)
      * ``scales``: f32 [tokens, n_groups + 1]   (body group scales, then the
        per-token keeper scale)
    """

    codes: torch.Tensor
    scales: torch.Tensor


class KernelPackedWeight(NamedTuple):
    """Device layout of a 4-bit weight (nibble planes), read by the GEMMs.

    For each 128-wide group g, byte row r in [0, 64):
        low  nibble of ``body_packed[g*64 + r, n]`` = code[g*128 + r,      n]
        high nibble of ``body_packed[g*64 + r, n]`` = code[g*128 + 64 + r, n]

      * ``body_packed``: int8 [(in - keeper) // 2, out]
      * ``keeper``:      int8 [keeper, out]
      * ``scales``:      f32 [n_groups + 1, out]  (body group scales, then
        the keeper scale, merged once at pack time)
    """

    body_packed: torch.Tensor
    keeper: torch.Tensor
    scales: torch.Tensor


def quantize_weight_packed(w: torch.Tensor, spec: QuantSpec) -> PackedWeight:
    """RTN-quantize a [in, out] weight into the packed dual-path format."""
    if not spec.w_sym or spec.keeper_precision != KeeperPrecision.INT8:
        raise NotImplementedError(
            "packed serving path implements the canonical symmetric INT8-keeper config"
        )
    in_f, out_f = w.shape
    k = spec.keeper
    g = spec.weight_group_size
    body_w = w[: in_f - k].T.to(torch.float32)  # [out, in-k]
    keep_w = w[in_f - k :].T.to(torch.float32)  # [out, k]

    cg = spec.weight_channel_group
    n_groups = (in_f - k) // g
    bw = body_w.reshape(out_f // cg, cg, n_groups, g)
    bw_merged = bw.transpose(1, 2).reshape(out_f // cg, n_groups, cg * g)
    scale = compute_scale_sym(bw_merged, spec.wbits, spec.w_clip_ratio)  # [out/cg, ng, 1]
    scale_exp = scale[:, :, 0].T[:, :, None].repeat_interleave(cg, dim=2)
    scale_exp = scale_exp.reshape(n_groups, out_f).contiguous()

    qmin, qmax = -(2 ** (spec.wbits - 1)), 2 ** (spec.wbits - 1) - 1
    grouped = body_w.reshape(out_f, n_groups, g)
    codes = torch.clamp(
        torch.round(grouped / scale_exp.T[:, :, None]), qmin, qmax
    ).to(torch.int8)
    body = codes.reshape(out_f, in_f - k).T.contiguous()

    kq = quantize_groups(keep_w, bits=8, sym=True)
    return PackedWeight(
        body=body,
        body_scale=scale_exp,
        keeper=kq.codes.T.contiguous(),
        keeper_scale=kq.scale[:, 0].contiguous(),
    )


def quantize_dual_path(x: torch.Tensor, abits: int, a_clip: float, group: int = 128) -> QuantizedActivation:
    """Symmetric per-group quantization of [tokens, d]: the first groups to
    ``abits`` with clipping ``a_clip``, the last (the keeper block) to INT8
    unclipped, in one pass straight into the GEMM layout."""
    t, d = x.shape
    ng = d // group - 1
    xg = x.to(torch.float32).reshape(t, ng + 1, group)
    qmax = torch.full((ng + 1, 1), 2 ** (abits - 1) - 1, dtype=torch.float32, device=x.device)
    qmax[ng] = 127
    amax = torch.clamp_min(xg.abs().amax(dim=-1, keepdim=True), _EPS)
    if a_clip < 1.0:
        amax[:, :ng] *= a_clip
    scale = amax / qmax  # one IEEE division, as ``compute_scale_sym``
    codes = torch.clamp(torch.round(xg / scale), -qmax - 1, qmax).to(torch.int8)
    return QuantizedActivation(codes.reshape(t, d), scale.reshape(t, ng + 1))


def quantize_activation_packed(x: torch.Tensor, spec: QuantSpec) -> QuantizedActivation:
    """Dynamically quantize [tokens, d] activations into the dual-path format:
    symmetric per-128-group INT4 body + per-token INT8 keeper."""
    if not spec.a_sym or spec.keeper != spec.act_group_size:
        raise NotImplementedError(
            "packed serving path quantizes activations symmetrically, with a keeper of one group"
        )
    return quantize_dual_path(x, spec.abits, spec.a_clip_ratio, spec.act_group_size)


def pack_for_kernel(pw: PackedWeight, group: int = 128) -> KernelPackedWeight:
    """PackedWeight (unpacked codes) -> nibble-plane 4-bit kernel layout."""
    kb, n = pw.body.shape
    ng = kb // group
    codes = pw.body.reshape(ng, group, n).to(torch.int16)
    lo = codes[:, : group // 2] & 0x0F
    hi = codes[:, group // 2 :] & 0x0F
    packed = (lo | (hi << 4)).to(torch.uint8).view(torch.int8)
    return KernelPackedWeight(
        body_packed=packed.reshape(kb // 2, n).contiguous(),
        keeper=pw.keeper,
        scales=torch.cat([pw.body_scale, pw.keeper_scale[None, :]], dim=0),
    )
