"""The JAX package's serving params (Llama and MoE) and state and its
baseline stacks' params and dense KV, as numpy trees, -> the port's.

Byte layouts are identical in both packages (nibble-plane weights, KV pages,
hot ring), so the same integer codes flow through both.  The input is any
tree with the JAX field names whose leaves are numpy arrays, such as
``jax.tree_util.tree_map(np.asarray, params)``; bfloat16 arrays (numpy's
``ml_dtypes.bfloat16``) are carried over bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from atom_tpu_torch.ops.formats import KernelPackedWeight
from atom_tpu_torch.ops.gemm_w4a16 import W4A16Weight, W8A16Weight
from atom_tpu_torch.ops.kv_hot import HotKV
from atom_tpu_torch.ops.kv_layout import KVPages
from atom_tpu_torch.ops.runtime import resolve_device
from atom_tpu_torch.serving import baselines as bl
from atom_tpu_torch.serving.model import ServingLayerParams, ServingParams, ServingState
from atom_tpu_torch.serving.moe import MoEServingLayerParams, MoEServingParams


def tensor_from_numpy(a, device) -> torch.Tensor:
    """numpy array (bfloat16 included) -> tensor on ``device``, bitwise."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _kpw(kw, dev) -> KernelPackedWeight:
    """The JAX package keeps body and keeper scales apart; the port merges
    them, keeper scale last, on the group axis: axis 0 of one weight's
    [ng, N] body scales, axis 1 of stacked experts' [E, ng, N]."""
    scales = np.concatenate([kw.body_scale, np.asarray(kw.keeper_scale)[..., None, :]], axis=-2)
    return KernelPackedWeight(
        body_packed=tensor_from_numpy(kw.body_packed, dev),
        keeper=tensor_from_numpy(kw.keeper, dev),
        scales=tensor_from_numpy(scales, dev),
    )


def serving_params_from_numpy(params, device=None) -> ServingParams:
    """Numpy tree of the JAX ``ServingParams`` -> the port's.  The head is a
    bf16 array, a W8A16 weight (``codes`` int8, ``scale`` f32) or a W4A16
    weight (``packed`` int8, ``scale`` f32), carried across bit for bit."""
    dev = resolve_device(device)
    head = params.lm_head
    if hasattr(head, "packed"):
        lm_head = W4A16Weight(tensor_from_numpy(head.packed, dev), tensor_from_numpy(head.scale, dev))
    elif hasattr(head, "codes"):
        lm_head = W8A16Weight(tensor_from_numpy(head.codes, dev), tensor_from_numpy(head.scale, dev))
    else:
        lm_head = tensor_from_numpy(head, dev)
    layers = []
    for lp in params.layers:
        fields = {}
        for f in ServingLayerParams._fields:
            v = getattr(lp, f)
            fields[f] = _kpw(v, dev) if f.startswith("w") else tensor_from_numpy(v, dev)
        layers.append(ServingLayerParams(**fields))
    return ServingParams(
        embed=tensor_from_numpy(params.embed, dev),
        final_norm=tensor_from_numpy(params.final_norm, dev),
        lm_head=lm_head,
        layers=layers,
    )


def moe_serving_params_from_numpy(params, device=None) -> MoEServingParams:
    """Numpy tree of the JAX ``MoEServingParams`` -> the port's, bit for bit
    (the stacked expert weights' scales merged per expert), with
    ``ln_attn_g = ln_attn[attn_reorder]``, which the JAX package takes at
    call time."""
    dev = resolve_device(device)
    layers = []
    for lp in params.layers:
        fields = {}
        for f in MoEServingLayerParams._fields[:-1]:
            v = getattr(lp, f)
            fields[f] = _kpw(v, dev) if f.startswith("w") else tensor_from_numpy(v, dev)
        fields["ln_attn_g"] = tensor_from_numpy(np.asarray(lp.ln_attn)[np.asarray(lp.attn_reorder)], dev)
        layers.append(MoEServingLayerParams(**fields))
    return MoEServingParams(
        embed=tensor_from_numpy(params.embed, dev),
        final_norm=tensor_from_numpy(params.final_norm, dev),
        lm_head=tensor_from_numpy(params.lm_head, dev),
        layers=layers,
    )


def serving_state_from_numpy(state, device=None) -> ServingState:
    """Numpy tree of the JAX ``ServingState`` -> the port's."""
    dev = resolve_device(device)
    return ServingState(
        pages=[KVPages(*(tensor_from_numpy(getattr(p, f), dev) for f in KVPages._fields)) for p in state.pages],
        hot=[HotKV(*(tensor_from_numpy(getattr(h, f), dev) for f in HotKV._fields)) for h in state.hot],
        row=int(state.row),
        flushed=tensor_from_numpy(state.flushed, dev).to(torch.int32),
    )


def baseline_params_from_numpy(params, device=None):
    """Numpy tree of a JAX baseline stack's params (``Bf16Params``,
    ``W8Params`` or ``W4A16Params``, told apart by their weights' fields) ->
    the port's, bit for bit."""
    dev = resolve_device(device)
    wq = params.layers[0].wq
    if hasattr(wq, "packed"):
        layer_cls, params_cls = bl.W4A16Layer, bl.W4A16Params
    elif hasattr(wq, "codes"):
        layer_cls, params_cls = bl.W8Layer, bl.W8Params
    else:
        layer_cls, params_cls = bl.Bf16Layer, bl.Bf16Params

    def leaf(v):
        if hasattr(v, "packed"):
            return W4A16Weight(tensor_from_numpy(v.packed, dev), tensor_from_numpy(v.scale, dev))
        if hasattr(v, "codes"):
            return bl.W8Weight(bl.column_major(tensor_from_numpy(v.codes, dev)), tensor_from_numpy(v.scale, dev))
        return tensor_from_numpy(v, dev)

    return params_cls(
        embed=tensor_from_numpy(params.embed, dev),
        final_norm=tensor_from_numpy(params.final_norm, dev),
        lm_head=tensor_from_numpy(params.lm_head, dev),
        layers=[layer_cls(*(leaf(getattr(lp, f)) for f in layer_cls._fields)) for lp in params.layers],
    )


def dense_kv_from_numpy(kvs, device=None) -> list:
    """List of the JAX package's ``DenseKV`` as numpy -> the port's: the same
    values and shape [B, maxT, H, Dh], in head-major storage."""
    dev = resolve_device(device)

    def head_major(a):
        return tensor_from_numpy(a, dev).transpose(1, 2).contiguous().transpose(1, 2)

    return [bl.DenseKV(head_major(kv.k), head_major(kv.v)) for kv in kvs]
