"""Stacked-layer parameter helpers (``atom_tpu/models/base.py``).

A model's ``params["layers"]`` is a dict of tensors with the layer on the
leading axis.  ``set_layer`` is functional, as in the JAX package: it returns
new stacks and leaves the given params untouched.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

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
