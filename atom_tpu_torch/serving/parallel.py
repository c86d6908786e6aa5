"""Tensor-parallel serving: the W4A4 prefill and decode steps over the ``tp``
axis of a rank mesh (``atom_tpu/serving/parallel.py``).

Column-parallel everywhere, as in the JAX package (Atom's dual-path format
makes a row-parallel split awkward: the INT8 keeper block is the last 128
channels of the whole reordered input):

  * ``wqkv``, ``wo``, ``wgateup``, ``wdown`` and the bf16 ``lm_head`` are
    split by output column; each rank computes its [T, N/tp] slice from the
    whole quantized activation, then all-gathers it (``model._post_attn``'s
    ``gather`` hook).  ``wqkv`` is split by head (this rank's q heads, then
    its k heads, then its v heads); ``wgateup`` keeps each rank's gate and up
    halves adjacent, so SiLU * up stays local.
  * KV pages and the hot ring are split by kv head; attention needs no
    communication.
  * The quantizers always run on whole gathered rows, so group boundaries
    and the keeper block are the single device's: tokens, pages and ring are
    bitwise the single-device step's (the head's products are the one place
    where a rank's column slice may reduce in another order: see
    ``make_tp_step_fns``).

The JAX package stacks every rank's shard on a leading [tp] axis of one
array placed over the mesh; the port's ranks are processes, so
``shard_serving_params`` returns this rank's shard and ``make_state_sharded``
this rank's heads.  Every rank runs the same engine loop: the sampled token
is gathered to every rank, so the host schedulers stay in lockstep.
"""
from __future__ import annotations

from typing import List

import torch

from atom_tpu_torch.config import QuantSpec
from atom_tpu_torch.models.configs import ModelConfig
from atom_tpu_torch.ops.formats import KernelPackedWeight
from atom_tpu_torch.ops.kv_hot import HOT_W
from atom_tpu_torch.parallel.mesh import all_gather_cols, all_gather_rows, axis_index, axis_size
from atom_tpu_torch.serving.model import (
    ServingParams,
    ServingState,
    _lm_head_logits,
    decode_hidden,
    make_serving_state,
    prefill_hidden,
)


def _slice_cols(kw: KernelPackedWeight, lo: int, hi: int) -> KernelPackedWeight:
    return KernelPackedWeight(*(t[:, lo:hi].contiguous() for t in kw))


def _cat_w(parts: List[KernelPackedWeight]) -> KernelPackedWeight:
    return KernelPackedWeight(*(torch.cat(ts, dim=1) for ts in zip(*parts)))


def _shard_cols(kw: KernelPackedWeight, tp: int, i: int) -> KernelPackedWeight:
    n = kw.body_packed.shape[1]
    return _slice_cols(kw, i * n // tp, (i + 1) * n // tp)


def _shard_qkv(kw: KernelPackedWeight, cfg: ModelConfig, tp: int, i: int) -> KernelPackedWeight:
    n_q = cfg.num_heads * cfg.head_dim
    n_kv = cfg.num_kv_heads * cfg.head_dim
    return _cat_w([
        _slice_cols(kw, i * n_q // tp, (i + 1) * n_q // tp),
        _slice_cols(kw, n_q + i * n_kv // tp, n_q + (i + 1) * n_kv // tp),
        _slice_cols(kw, n_q + n_kv + i * n_kv // tp, n_q + n_kv + (i + 1) * n_kv // tp),
    ])


def _shard_gateup(kw: KernelPackedWeight, tp: int, i: int) -> KernelPackedWeight:
    inter = kw.body_packed.shape[1] // 2
    return _cat_w([
        _slice_cols(kw, i * inter // tp, (i + 1) * inter // tp),
        _slice_cols(kw, inter + i * inter // tp, inter + (i + 1) * inter // tp),
    ])


def _shard_head(lm_head, tp: int, i: int) -> torch.Tensor:
    if not isinstance(lm_head, torch.Tensor):
        raise ValueError(f"tensor-parallel serving splits a bf16 lm_head by column, got {type(lm_head).__name__}")
    v = lm_head.shape[1]
    if v % tp:
        raise ValueError(f"the vocabulary {v} does not split over {tp} ranks")
    return lm_head[:, i * v // tp : (i + 1) * v // tp].contiguous()


def _tp_shard_cfg(cfg: ModelConfig, tp: int) -> ModelConfig:
    if cfg.num_heads % tp or cfg.num_kv_heads % tp or cfg.intermediate_size % tp:
        raise ValueError(f"heads {cfg.num_heads}/{cfg.num_kv_heads} and inter {cfg.intermediate_size} "
                         f"must split over {tp} ranks")
    return cfg.replace(num_heads=cfg.num_heads // tp, num_kv_heads=cfg.num_kv_heads // tp,
                       intermediate_size=cfg.intermediate_size // tp)


def shard_serving_params(params: ServingParams, cfg: ModelConfig, mesh, axis: str = "tp") -> ServingParams:
    """This rank's tensor-parallel shard: its columns of every projection and
    of the head (contiguous copies); norms, reorder indices and the
    embedding are shared with ``params``."""
    tp, i = axis_size(mesh, axis), axis_index(mesh, axis)
    _tp_shard_cfg(cfg, tp)
    layers = [
        lp._replace(
            wqkv=_shard_qkv(lp.wqkv, cfg, tp, i),
            wo=_shard_cols(lp.wo, tp, i),
            wgateup=_shard_gateup(lp.wgateup, tp, i),
            wdown=_shard_cols(lp.wdown, tp, i),
        )
        for lp in params.layers
    ]
    return params._replace(lm_head=_shard_head(params.lm_head, tp, i), layers=layers)


def make_state_sharded(n_layers: int, n_pages: int, batch: int, kv_heads: int, page_size: int, head_dim: int, mesh,
                       axis: str = "tp", device=None) -> ServingState:
    """Serving state holding this rank's kv heads of the pages and the ring."""
    tp = axis_size(mesh, axis)
    if kv_heads % tp:
        raise ValueError(f"{kv_heads} kv heads do not split over {tp} ranks")
    return make_serving_state(n_layers, n_pages, batch, kv_heads // tp, page_size, head_dim, device=device)


def shard_argmax(logits_local: torch.Tensor, group) -> torch.Tensor:
    """argmax over a vocabulary split by column over ``group``'s ranks ->
    int32 [...]: the first index of the largest logit, as ``torch.argmax`` of
    the whole row (ranks hold the columns in rank order, so the first rank
    holding the maximum holds its first index)."""
    vshard = logits_local.shape[-1]
    local_max = torch.amax(logits_local, dim=-1)
    local_arg = torch.argmax(logits_local, dim=-1)  # the first index of the maximum
    me = torch.distributed.get_rank(group)
    # one gather: float64 holds a float32 logit and an index exactly
    packed = torch.stack([local_max.to(torch.float64), (local_arg + me * vshard).to(torch.float64)])
    every = all_gather_rows(packed.reshape(1, 2, -1), group)  # [tp, 2, rows]
    winner = torch.argmax(every[:, 0], dim=0)  # first rank on ties
    tok = torch.gather(every[:, 1], 0, winner[None])[0]
    return tok.to(torch.int32).reshape(local_max.shape)


def make_tp_step_fns(params_sharded: ServingParams, cfg: ModelConfig, spec: QuantSpec, mesh, axis: str = "tp"):
    """(prefill_fn, decode_fn) with the engine's calling convention, running
    the single-device layer code on this rank's heads and columns with the
    all-gathers at the column cuts (``model._post_attn``'s ``gather``).

    ``decode_fn`` counts its calls and flushes the ring on every W-th, as
    ``model.make_step_fns`` does.  The head is this rank's column slice of
    the bf16 ``lm_head``, a ``torch.mm`` into float32 on the card; a slice
    may reduce in another order than the whole head's product, so a logit
    can differ in its last bits and a token only where two logits all but
    tie."""
    group = mesh.get_group(axis)
    shard_cfg = _tp_shard_cfg(cfg, axis_size(mesh, axis))

    def gather(x):
        return all_gather_cols(x, group)

    def prefill_fn(state: ServingState, ids, table_row, true_len: int, slot: int):
        x, pages = prefill_hidden(params_sharded, state.pages, ids, table_row, shard_cfg, spec, gather=gather)
        logits = _lm_head_logits(x[max(true_len - 1, 0)][None], params_sharded.lm_head)
        flushed = state.flushed.clone()
        flushed[slot] = true_len
        return shard_argmax(logits, group)[0], ServingState(pages=pages, hot=state.hot, row=state.row,
                                                              flushed=flushed)

    counter = {"n": 0}

    def decode_fn(state: ServingState, ids, page_table, seq_lens):
        counter["n"] += 1
        x, new_state = decode_hidden(params_sharded, state, ids, page_table, seq_lens, shard_cfg, spec,
                                     flush=counter["n"] % HOT_W == 0, gather=gather)
        return shard_argmax(_lm_head_logits(x, params_sharded.lm_head), group), new_state

    return prefill_fn, decode_fn
