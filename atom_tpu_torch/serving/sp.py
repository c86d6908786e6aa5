"""Sequence-parallel prefill (``atom_tpu/serving/sp.py``): a long prompt's
tokens split over the ``sp`` axis of a rank mesh.

  * Every GEMM and quantizer is row-parallel in tokens: each rank runs the
    single-device layer code on its T/sp rows, RoPE and the causal mask at
    the rows' global positions.
  * Attention needs every earlier key: the just-quantized K/V (u4 codes in
    int8 carriers and their bf16 params, about a quarter of bf16 K/V's
    bytes) are all-gathered along the token axis.
  * The page writes run on the gathered codes on every rank, so the pages
    stay whole on every rank of the axis and decode continues as on one
    device (or on ``serving.parallel.make_tp_step_fns`` over the tp axis of
    the 2-D form).

``make_sp_tp_prefill_fn`` adds tensor parallelism (sp x tp): tokens over
``sp``, heads and columns over ``tp`` (``serving/parallel.py``'s column
scheme and its head-split pages).  The last true row's hidden lives on one
sp rank, which broadcasts it (the JAX package sums it in with zeros from
the other ranks: the same values).
"""
from __future__ import annotations

import torch

import atom_tpu_torch.serving.model as _model
from atom_tpu_torch.config import QuantSpec
from atom_tpu_torch.models.configs import ModelConfig
from atom_tpu_torch.ops import reference as R
from atom_tpu_torch.parallel.mesh import (
    all_gather_cols,
    all_gather_rows,
    axis_index,
    axis_size,
    broadcast_from,
)
from atom_tpu_torch.serving.model import ServingState, _lm_head_logits


def _gather_kv(kq: R.KVQuant, group) -> R.KVQuant:
    """All-gather a token shard of K or V codes and params along the token axis."""
    return R.KVQuant(codes=all_gather_rows(kq.codes, group), params=all_gather_rows(kq.params, group))


def sp_prefill_hidden(params, pages, ids_local, table_row, cfg: ModelConfig, spec: QuantSpec, mesh,
                      axis: str = "sp", gather=None):
    """This rank's token rows of a prefill -> (final-norm hidden [T/sp, D],
    pages): ``model.prefill_hidden`` on the local rows at their global
    positions, attending to (and writing the pages with) every rank's K/V.
    Row for row the single-device ops in their order (only the products' row
    count differs).  ``gather`` is the tensor-parallel hook of
    ``model._post_attn`` (``cfg`` then holds the per-rank head counts)."""
    group = mesh.get_group(axis)
    t_loc = ids_local.shape[0]
    positions = axis_index(mesh, axis) * t_loc + torch.arange(t_loc, device=ids_local.device)
    return _model.prefill_hidden(params, pages, ids_local, table_row, cfg, spec, gather=gather, positions=positions,
                                 kv_gather=lambda kq: _gather_kv(kq, group))


def _last_row(x_local, true_len: int, mesh, axis: str):
    """The hidden of the prompt's last true row, from the sp rank that holds it."""
    t_loc = x_local.shape[0]
    idx = max(true_len - 1, 0)
    owner = idx // t_loc
    row = x_local[idx - owner * t_loc] if axis_index(mesh, axis) == owner else torch.empty_like(x_local[0])
    return broadcast_from(row.contiguous(), owner, mesh.get_group(axis))


def _local_ids(ids, mesh, axis: str):
    sp = axis_size(mesh, axis)
    if ids.shape[0] % sp:
        raise ValueError(f"a prefill of {ids.shape[0]} tokens does not split over {sp} ranks")
    t_loc = ids.shape[0] // sp
    i = axis_index(mesh, axis)
    return ids[i * t_loc : (i + 1) * t_loc]


def make_sp_prefill_fn(params, cfg: ModelConfig, spec: QuantSpec, mesh, axis: str = "sp"):
    """Engine-convention prefill over the ``sp`` axis: ``prefill_fn(state,
    ids [T], table_row, true_len, slot)`` with the whole bucket on every
    rank (``T`` a multiple of the axis size); the state's pages end as a
    single-device prefill leaves them.  The tp-less case of
    ``make_sp_tp_prefill_fn``."""
    return make_sp_tp_prefill_fn(params, cfg, spec, mesh, sp_axis=axis, tp_axis=None)


def make_sp_tp_prefill_fn(params_sharded, cfg: ModelConfig, spec: QuantSpec, mesh, sp_axis: str = "sp",
                          tp_axis: str | None = "tp"):
    """2-D long-context prefill: tokens over ``sp``, heads and columns over
    ``tp``.  ``params_sharded`` is ``serving.parallel.shard_serving_params``
    over ``tp_axis`` and the state ``serving.parallel.make_state_sharded``
    over it (pages split by head over tp, whole over sp); decode can go on
    with ``serving.parallel.make_tp_step_fns`` over the same tp axis.
    ``tp_axis`` None: whole params and state (``make_sp_prefill_fn``)."""
    from atom_tpu_torch.serving.parallel import _tp_shard_cfg, shard_argmax

    if tp_axis is None:
        shard_cfg, gather = cfg, None
    else:
        tp_group = mesh.get_group(tp_axis)
        shard_cfg = _tp_shard_cfg(cfg, axis_size(mesh, tp_axis))

        def gather(x):
            return all_gather_cols(x, tp_group)

    def prefill_fn(state: ServingState, ids, table_row, true_len: int, slot: int):
        x, pages = sp_prefill_hidden(params_sharded, state.pages, _local_ids(ids, mesh, sp_axis), table_row,
                                     shard_cfg, spec, mesh, sp_axis, gather=gather)
        last = _last_row(x, true_len, mesh, sp_axis)[None]
        if tp_axis is None:
            tok = torch.argmax(_lm_head_logits(last, params_sharded.lm_head, cfg.vocab_size)[0]).to(torch.int32)
        else:
            tok = shard_argmax(_lm_head_logits(last, params_sharded.lm_head), tp_group)[0]
        flushed = state.flushed.clone()
        flushed[slot] = true_len
        return tok, ServingState(pages=pages, hot=state.hot, row=state.row, flushed=flushed)

    return prefill_fn
