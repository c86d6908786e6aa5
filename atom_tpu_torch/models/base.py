"""Stacked-layer parameter helpers (``atom_tpu/models/base.py``).

A model's ``params["layers"]`` is a dict of tensors with the layer on the
leading axis.  ``set_layer`` is functional, as in the JAX package: it returns
new stacks and leaves the given params untouched.  ``params_from_numpy``
carries any accuracy model's JAX params across (Llama, OPT, Mixtral).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from atom_tpu_torch.ops.runtime import resolve_device

Params = Dict[str, Any]


def stack_layers(layers: List[Params]) -> Params:
    return {k: torch.stack([lp[k] for lp in layers]) for k in layers[0]}


def get_layer(params: Params, i: int) -> Params:
    return {k: v[i] for k, v in params["layers"].items()}


def set_layer(params: Params, i: int, lp: Params) -> Params:
    new_layers = {}
    for k, stack in params["layers"].items():
        new = stack.clone()
        new[i] = lp[k]
        new_layers[k] = new
    return {**params, "layers": new_layers}


def params_from_numpy(params, device=None) -> Params:
    """An accuracy model's JAX params as numpy arrays (``jax.tree.map(np.asarray,
    params)``) -> the port's, bit for bit (bfloat16 included): top-level
    tensors and the ``layers`` dict of stacked tensors."""
    from atom_tpu_torch.serving.convert import tensor_from_numpy

    dev = resolve_device(device)
    out = {k: tensor_from_numpy(v, dev) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: tensor_from_numpy(v, dev) for k, v in params["layers"].items()}
    return out
