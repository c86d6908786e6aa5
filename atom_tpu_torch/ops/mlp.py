"""The whole quantized MLP block as one fused function
(``atom_tpu/ops/pallas_mlp.py``), kernel K10.

``fused_mlp_packed`` computes ``resid + down(quant(silu(gate(quant(y))) *
up(quant(y))))``: the dual-path quantization of the (optionally normed)
input, the gate and up GEMMs, SiLU(gate) * up in float32, its requantization
per 128 channels (the last 128 channels of the intermediate the INT8 keeper,
every other block INT4 with the clip), the down GEMM and the residual add
``bf16(resid + bf16(acc))``, or ``resid + row_scale * acc`` for a caller that
weights the block's output per row (MoE routing).  The residual is bf16 or
float32 and sets the output's type; a float32 one takes ``resid + acc``
unrounded, as the TPU kernel's epilogue does (MoE's chain over the experts
on a float32 accumulator).  Given the layer's ``reorder`` index it takes
the ungathered hidden and its prologue reads the gather in place.  It
launches ``csrc/gemm_packed.cu`` on CUDA tensors and runs its plain version
on CPU tensors: up to ``CORE_MAX_M`` rows three launches (the prologue, the
gate/up GEMM with SiLU * up and the requantization in its epilogue over a
thread-block cluster, the down GEMM), above them four (the gate/up product
into a float32 scratch, then a SiLU launch).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from atom_tpu_torch.numerics import rms_rstd
from atom_tpu_torch.ops import _build
from atom_tpu_torch.ops.formats import KernelPackedWeight, quantize_dual_path
from atom_tpu_torch.ops.gemm_packed import (
    CORE_MAX_M,
    GROUP,
    HALF,
    _lib,
    check_fused_in_inputs,
    check_resid,
    packed_w4_gemm_plain,
    packed_w4_plan,
    plan_arg,
    quant_prologue_plain,
    resid_epilogue_plain,
)
from atom_tpu_torch.ops.runtime import check_kernel_input, on_cpu


def fused_mlp_supported(d: int, inter: int, keeper: int, group: int) -> bool:
    """Geometry gate of the fused MLP (the JAX package's, so that both
    packages take the fused branch for the same models): 128-wide groups and
    keeper, hidden a multiple of 512, intermediate a multiple of 256 with at
    most 112 body groups."""
    return (
        keeper == GROUP
        and group == GROUP
        and d % 512 == 0
        and inter % 256 == 0
        and (inter - GROUP) // GROUP <= 112
    )


def fused_mlp_act_plain(y, gu: KernelPackedWeight, norm_w=None, rstd=None, abits=4, a_clip=1.0, eps=1e-5,
                        reorder=None):
    """First half of the plain version: input quantization, gate/up product,
    SiLU(gate) * up, requantization -> (act codes int8 [M, inter], scales f32
    [M, inter / 128]) in the down GEMM's input layout."""
    if reorder is not None:
        y = torch.index_select(y, -1, reorder)
    if norm_w is not None and rstd is None:
        rstd = rms_rstd(y, eps)
    a, sa = quant_prologue_plain(y, norm_w, rstd, abits, a_clip)
    prod = packed_w4_gemm_plain(a, gu.body_packed, gu.keeper, sa, gu.scales)
    inter = prod.shape[1] // 2
    act = F.silu(prod[:, :inter]) * prod[:, inter:]
    qa = quantize_dual_path(act, abits, a_clip, GROUP)
    return qa.codes, qa.scales


def fused_mlp_down_plain(act, act_scales, resid, dn: KernelPackedWeight, row_scale=None):
    """Second half of the plain version: down product and the residual epilogue."""
    acc = packed_w4_gemm_plain(act, dn.body_packed, dn.keeper, act_scales, dn.scales)
    return resid_epilogue_plain(acc, resid, row_scale)


def fused_mlp_packed_plain(y, resid, gu, dn, norm_w=None, rstd=None, row_scale=None, abits=4, a_clip=1.0, eps=1e-5,
                           reorder=None):
    """Plain version of K10 (same signature as the kernel's wrapper)."""
    act, act_scales = fused_mlp_act_plain(y, gu, norm_w, rstd, abits, a_clip, eps, reorder)
    return fused_mlp_down_plain(act, act_scales, resid, dn, row_scale)


FOUR_LAUNCH = "four_launch"


def fused_mlp_packed_stages(y, resid, gu, dn, norm_w=None, rstd=None, row_scale=None, abits=4, a_clip=1.0, eps=1e-5,
                            reorder=None, path=None, gu_tile_n=None):
    """Kernel K10, also returning what its phases hand on: (out, act codes,
    act scales).  For checks that hold the two halves to their plain
    versions separately.  ``path`` (private, for holding the two forms
    against each other on the card): ``FOUR_LAUNCH`` runs the four-launch
    form at any row count; ``gu_tile_n`` (64 or 128) the SiLU-quant gate/up
    launch's block columns, for measuring both cluster layouts."""
    tensors = [t for t in (y, resid, *gu, *dn, norm_w, rstd, row_scale, reorder) if t is not None]
    if on_cpu(*tensors):
        act, act_scales = fused_mlp_act_plain(y, gu, norm_w, rstd, abits, a_clip, eps, reorder)
        return fused_mlp_down_plain(act, act_scales, resid, dn, row_scale), act, act_scales
    if path not in (None, FOUR_LAUNCH):
        raise ValueError(f"fused_mlp_packed: path {path!r} is neither None nor {FOUR_LAUNCH!r}")
    m, d = y.shape
    inter = gu.body_packed.shape[1] // 2
    if not fused_mlp_supported(d, inter, GROUP, GROUP):
        raise ValueError(f"fused_mlp_packed: geometry D={d}, inter={inter} is outside fused_mlp_supported")
    rstd = check_fused_in_inputs("fused_mlp_packed", y, gu, norm_w, rstd, eps, reorder)
    nga = inter // GROUP - 1
    check_resid(resid, "fused_mlp_packed", (m, d))
    check_kernel_input(dn.body_packed, "down body_packed", torch.int8, (nga * HALF, d))
    check_kernel_input(dn.keeper, "down keeper", torch.int8, (GROUP, d))
    check_kernel_input(dn.scales, "down scales", torch.float32, (nga + 1, d))
    if row_scale is not None:
        row_scale = row_scale.to(torch.float32).reshape(m).contiguous()
    cluster = m <= CORE_MAX_M and path != FOUR_LAUNCH  # the SiLU-quant epilogue: no f32 gate/up scratch
    gu_plan = packed_w4_plan(m, d, 2 * inter, paired=True, tile_n=gu_tile_n) if cluster else packed_w4_plan(m, d, 2 * inter)
    dev = y.device
    a = torch.empty((m, d), dtype=torch.int8, device=dev)
    sa = torch.empty((m, d // GROUP), dtype=torch.float32, device=dev)
    prod = None if cluster else torch.empty((m, 2 * inter), dtype=torch.float32, device=dev)
    act = torch.empty((m, inter), dtype=torch.int8, device=dev)
    act_scales = torch.empty((m, inter // GROUP), dtype=torch.float32, device=dev)
    out = torch.empty((m, d), dtype=resid.dtype, device=dev)
    if m:
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        _build.check(
            _lib().atom_fused_mlp(
                y.data_ptr(), ptr(reorder), ptr(norm_w), ptr(rstd), gu.body_packed.data_ptr(), gu.keeper.data_ptr(),
                gu.scales.data_ptr(), dn.body_packed.data_ptr(), dn.keeper.data_ptr(), dn.scales.data_ptr(),
                resid.data_ptr(), ptr(row_scale), a.data_ptr(), sa.data_ptr(), ptr(prod), act.data_ptr(),
                act_scales.data_ptr(), out.data_ptr(), m, d, inter, abits, int(resid.dtype == torch.float32),
                int(cluster), a_clip, plan_arg(gu_plan), plan_arg(packed_w4_plan(m, inter, d)), _build.stream(),
            ),
            "fused_mlp_packed",
        )
        fused_mlp_packed.launches += 1
        fused_mlp_packed.launches_by_path["cluster" if cluster else FOUR_LAUNCH] += 1
    return out, act, act_scales


def fused_mlp_packed(
    y: torch.Tensor,  # bf16 [M, D] — mlp-reordered hidden unless `reorder` is given (normed here iff norm_w is)
    resid: torch.Tensor,  # bf16 or f32 [M, D] — also the output's type
    gu: KernelPackedWeight,  # K = D, N = 2 * inter (gate columns, then up)
    dn: KernelPackedWeight,  # K = inter, N = D
    norm_w: torch.Tensor | None = None,  # bf16 [D] — gathered mlp norm weight
    rstd: torch.Tensor | None = None,  # f32 [M, 1] — the norm's reciprocal std
    row_scale: torch.Tensor | None = None,  # f32 [M] — scales the down output
    abits: int = 4,
    a_clip: float = 1.0,
    eps: float = 1e-5,
    reorder: torch.Tensor | None = None,  # int32 [D] — the layer's mlp_reorder, gathered in the prologue
) -> torch.Tensor:
    """Kernel K10 -> [M, D] in the residual's type; see the module docstring.
    With ``reorder``, ``y`` is the ungathered hidden and the result is that
    of ``torch.index_select(y, -1, reorder)`` without it, bit for bit."""
    return fused_mlp_packed_stages(y, resid, gu, dn, norm_w, rstd, row_scale, abits, a_clip, eps, reorder)[0]


fused_mlp_packed.launches = 0
fused_mlp_packed.launches_by_path = {"cluster": 0, FOUR_LAUNCH: 0}
