"""Parameter shardings of the accuracy models: Megatron-style tensor
parallelism, data parallelism and expert parallelism as DTensor placements
(``atom_tpu/parallel/shardings.py``).

The layout is the JAX package's, over the same stacked layer layout (every
``layers`` tensor leads with [num_layers]):

  * q/k/v, gate/up (OPT: fc1) column-parallel: ``Shard`` on the output axis;
  * o and down (OPT: fc2) row-parallel: ``Shard`` on the input axis, so a
    product leaves a partial sum that DTensor reduces where it meets the
    residual stream;
  * norms, biases of row-parallel products, reorder indices and the router
    replicated;
  * Mixtral's stacked experts [L, E, in, out] sharded on E over ``tp``
    (expert parallelism); its attention as Llama's;
  * activations (the token ids) sharded on the batch over ``dp``.

A spec maps each tensor to one placement per mesh axis (``Shard(d)`` where
the JAX ``PartitionSpec`` names the axis at tensor dim ``d``, else
``Replicate()``), for a mesh whose axes are ``axis_names``.  ``shard_params``
distributes a parameter tree with ``distribute_tensor``; the accuracy
forwards then run unchanged on the sharded tree and sharded ids, under
``torch.distributed.tensor.experimental.implicit_replication`` (their
position tables and masks are plain tensors, which it treats as replicated).

DTensor gaps the forwards meet, both in the activation quantizer
(``quant/core.py::quantize_activation``: ``x2 = x2.clone(); x2[:, -k:] = 0``
zeroes the keeper columns in place, and the keeper is written back the same
way):

  * ``aten.fill_.Tensor`` has no sharding rule;
  * an in-place write through a slice of a dim that is sharded is lost: the
    slice of a sharded dim is a replicated copy, not a view, so the write
    lands in the copy (silently; the gated up / down activations of the TP
    forwards are sharded on their last dim, and came out wrong).

``register_rules`` registers a rule for ``aten.fill_.Tensor`` (the filled
tensor keeps its placement, the value is replicated) and one for
``aten.clone.default`` that keeps any placement but a shard of the last dim,
which it replicates: the clone the quantizer writes into is then whole along
the columns it slices.  ``shard_params`` calls it; a rank that builds
DTensors another way calls it first.  Both rules touch DTensor's dispatcher
for the whole process: every clone of a last-dim shard then all-gathers.
Dropping clone's pointwise rule reaches into a private table, so
``register_rules`` raises where it is gone, and ``check_rules`` (called by
``shard_params``) holds the write on a small DTensor.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement, Replicate, Shard, distribute_tensor

_AXES = ("dp", "tp")


def _p(axis_names: Sequence[str], *dims) -> list[Placement]:
    """The placements of ``PartitionSpec(*dims)`` on a mesh with ``axis_names``."""
    return [Shard(dims.index(a)) if a in dims else Replicate() for a in axis_names]


def _llama_layer_specs(ax) -> Dict[str, list]:
    col, row, rep = _p(ax, None, None, "tp"), _p(ax, None, "tp", None), _p(ax)
    return {
        "input_ln": rep, "post_ln": rep,
        "wq": col, "wk": col, "wv": col, "wo": row,
        "wgate": col, "wup": col, "wdown": row,
        "attn_ln_idx": rep, "mlp_ln_idx": rep, "attn_out_idx": rep,
    }


def llama_param_specs(axis_names: Sequence[str] = _AXES) -> Dict[str, Any]:
    ax = tuple(axis_names)
    return {"embed": _p(ax, None, "tp"), "final_norm": _p(ax), "lm_head": _p(ax, None, "tp"),
            "layers": _llama_layer_specs(ax)}


def opt_param_specs(axis_names: Sequence[str] = _AXES) -> Dict[str, Any]:
    ax = tuple(axis_names)
    col, row, rep = _p(ax, None, None, "tp"), _p(ax, None, "tp", None), _p(ax)
    bias_col = _p(ax, None, "tp")
    layer = {
        "attn_ln_w": rep, "attn_ln_b": rep, "final_ln_w": rep, "final_ln_b": rep,
        "wq": col, "bq": bias_col, "wk": col, "bk": bias_col, "wv": col, "bv": bias_col,
        "wo": row, "bo": rep,
        "fc1_w": col, "fc1_b": bias_col, "fc2_w": row, "fc2_b": rep,
        "attn_ln_idx": rep, "mlp_ln_idx": rep, "attn_out_idx": rep,
    }
    return {"embed": _p(ax, None, "tp"), "pos_embed": _p(ax, None, "tp"), "final_ln_w": rep, "final_ln_b": rep,
            "layers": layer}


def mixtral_param_specs(axis_names: Sequence[str] = _AXES) -> Dict[str, Any]:
    ax = tuple(axis_names)
    col, row, rep = _p(ax, None, None, "tp"), _p(ax, None, "tp", None), _p(ax)
    experts = _p(ax, None, "tp", None, None)  # stacked [L, E, in, out] on E
    layer = {
        "input_ln": rep, "post_ln": rep,
        "wq": col, "wk": col, "wv": col, "wo": row,
        "router": rep, "w1": experts, "w3": experts, "w2": experts,
        "attn_ln_idx": rep, "mlp_ln_idx": rep, "attn_out_idx": rep,
    }
    return {"embed": _p(ax, None, "tp"), "final_norm": rep, "lm_head": _p(ax, None, "tp"), "layers": layer}


_RULES = []


def register_rules() -> None:
    """Register the DTensor sharding rules of the module docstring (once per
    process): ``aten.fill_.Tensor`` keeps the filled tensor's placement with
    a replicated value; ``aten.clone.default`` keeps any placement but a
    shard of the last dim, which it replicates."""
    if _RULES:
        return
    import torch.distributed.tensor._ops  # noqa: F401  (the default rules first, or they replace these)
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.fill_.Tensor)
    def _fill_tensor(self, value):
        rules = [([Replicate()], [Replicate(), Replicate()])]
        return rules + [([Shard(d)], [Shard(d), Replicate()]) for d in range(self.ndim)]

    @register_sharding(torch.ops.aten.clone.default)
    def _clone(self, memory_format=None):
        rules = [([Replicate()], [Replicate(), None])]
        return rules + [([Shard(d)], [Shard(d), None]) for d in range(self.ndim - 1)]

    # clone also has DTensor's pointwise single-dim rule (a private table, there in torch 2.13), which takes
    # precedence over a registered strategy: while it stays, the rule above is never consulted
    from torch.distributed.tensor import DTensor

    single_dim = DTensor._op_dispatcher.sharding_propagator.op_single_dim_strategy_funcs
    if single_dim.pop(torch.ops.aten.clone.default, None) is None:
        raise RuntimeError(f"register_rules: torch {torch.__version__} has no single-dim rule for aten.clone to "
                           "drop; check that the clone rule still takes effect before serving sharded forwards")
    _RULES.extend([_fill_tensor, _clone])


_CHECKED = set()


def check_rules(mesh: DeviceMesh) -> None:
    """Fail unless a slice write into the clone of a last-dim-sharded DTensor
    lands in the clone, as ``quant/core.py::quantize_activation`` needs (once
    per mesh; every rank of the mesh calls it, as it all-gathers)."""
    if id(mesh) in _CHECKED:
        return
    n = 2 * mesh.size()
    x = distribute_tensor(torch.ones((2, n), device=mesh.device_type), mesh, [Shard(1)] * mesh.ndim).clone()
    x[:, -1:] = 0
    if x.full_tensor()[:, -1].ne(0).any():
        raise RuntimeError(f"register_rules: on torch {torch.__version__} a slice write into a clone of a "
                           "last-dim-sharded DTensor is lost; the sharded accuracy forwards would run wrong")
    _CHECKED.add(id(mesh))


def shard_params(params, specs, mesh: DeviceMesh):
    """Distribute a parameter tree (dicts of tensors) by a spec tree of the
    same keys: each tensor becomes a ``DTensor`` with its placements."""
    register_rules()
    check_rules(mesh)
    if isinstance(params, dict):
        return {k: shard_params(v, specs[k], mesh) for k, v in params.items()}
    return distribute_tensor(params, mesh, specs)


def data_sharding(axis_names: Sequence[str] = _AXES) -> list[Placement]:
    """Activations: the batch on ``dp`` (``P("dp", None)``)."""
    return _p(tuple(axis_names), "dp", None)
