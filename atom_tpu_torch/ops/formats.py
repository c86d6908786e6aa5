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

from atom_tpu_torch.config import KeeperPrecision, QuantSpec, QuantType
from atom_tpu_torch.quant.core import _EPS, compute_scale_sym, quantize_groups
from atom_tpu_torch.quant.packing import pack_int4, unpack_int4


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


def pack_gptq_output(w_fake: torch.Tensor, gptq_scales: torch.Tensor, spec: QuantSpec) -> PackedWeight:
    """GPTQ fake-quantized [in, out] weight + its exported group scales
    [n_groups, out // channel_group] -> packed.  The codes are recovered
    exactly by re-rounding on the exported grid; the INT8 keeper's grid
    (absmax / 127, no clip) re-derives from the fake values."""
    if spec.quant_type != QuantType.INT or not spec.w_sym or spec.keeper_precision != KeeperPrecision.INT8:
        raise NotImplementedError("the packed serving path takes symmetric INT4 bodies and INT8 keepers")
    in_f, out_f = w_fake.shape
    k, g, cg = spec.keeper, spec.weight_group_size, spec.weight_channel_group
    if (in_f - k) % g:
        raise ValueError(
            f"serving pack needs (in_features - keeper) % group == 0, got ({in_f} - {k}) % {g}; "
            "the packed kernels consume whole 128-groups"
        )
    n_groups = (in_f - k) // g
    if tuple(gptq_scales.shape) != (n_groups, out_f // cg):
        raise ValueError(f"gptq_scales: expected {(n_groups, out_f // cg)}, got {tuple(gptq_scales.shape)}")
    scale_exp = gptq_scales.to(torch.float32).repeat_interleave(cg, dim=1)  # [ng, out]
    qmin, qmax = -(2 ** (spec.wbits - 1)), 2 ** (spec.wbits - 1) - 1
    grouped = w_fake[: in_f - k].to(torch.float32).T.reshape(out_f, n_groups, g)
    codes = torch.clamp(torch.round(grouped / scale_exp.T[:, :, None]), qmin, qmax).to(torch.int8)
    kq = quantize_groups(w_fake[in_f - k :].to(torch.float32).T, bits=8, sym=True)
    return PackedWeight(
        body=codes.reshape(out_f, in_f - k).T.contiguous(),
        body_scale=scale_exp.contiguous(),
        keeper=kq.codes.T.contiguous(),
        keeper_scale=kq.scale[:, 0].contiguous(),
    )


def concat_packed_out(pws: list) -> PackedWeight:
    """Concatenate PackedWeights along the output axis (the fused wide GEMMs):
    every scale is per output channel (group), and no channel group straddles
    two pieces."""
    return PackedWeight(
        body=torch.cat([p.body for p in pws], dim=1),
        body_scale=torch.cat([p.body_scale for p in pws], dim=1),
        keeper=torch.cat([p.keeper for p in pws], dim=1),
        keeper_scale=torch.cat([p.keeper_scale for p in pws], dim=0),
    )


def dequantize_activation(qa: QuantizedActivation, dtype=torch.bfloat16) -> torch.Tensor:
    """[tokens, d]: each 128-group's codes times its scale (the keeper last)."""
    t, d = qa.codes.shape
    g = d // qa.scales.shape[1]
    out = qa.codes.reshape(t, -1, g).to(torch.float32) * qa.scales[..., None]
    return out.reshape(t, d).to(dtype)


def dequantize_weight(pw: PackedWeight, dtype=torch.bfloat16) -> torch.Tensor:
    """Back to a logical [in, out] float weight (test utility)."""
    n_groups, out_f = pw.body_scale.shape
    g = pw.body.shape[0] // n_groups
    body = (pw.body.T.reshape(out_f, n_groups, g).to(torch.float32) * pw.body_scale.T[:, :, None]).reshape(out_f, -1).T
    keep = pw.keeper.to(torch.float32) * pw.keeper_scale[None, :]
    return torch.cat([body, keep], dim=0).to(dtype)


def unpack_from_kernel(kw: KernelPackedWeight, group: int = 128) -> PackedWeight:
    """Inverse of :func:`pack_for_kernel` (the merged scales split again)."""
    half, n = kw.body_packed.shape
    ng = half // (group // 2)
    pb = kw.body_packed.reshape(ng, group // 2, n)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(pb, 4), 4)  # arithmetic: sign-extends
    hi = torch.bitwise_right_shift(pb, 4)
    codes = torch.cat([lo, hi], dim=1).reshape(ng * group, n)
    return PackedWeight(body=codes, body_scale=kw.scales[:ng], keeper=kw.keeper, keeper_scale=kw.scales[ng])


def pack_weight_storage(pw: PackedWeight) -> dict:
    """2-per-byte packed form for checkpoints (int4 packed along the input axis)."""
    return {
        "body_packed": pack_int4(pw.body.T).T,
        "body_scale": pw.body_scale.to(torch.bfloat16),
        "keeper": pw.keeper,
        "keeper_scale": pw.keeper_scale.to(torch.bfloat16),
    }


def unpack_weight_storage(d: dict) -> PackedWeight:
    return PackedWeight(
        body=unpack_int4(d["body_packed"].T).T,
        body_scale=d["body_scale"].to(torch.float32),
        keeper=d["keeper"],
        keeper_scale=d["keeper_scale"].to(torch.float32),
    )
