"""Quantized serving Mixtral (``atom_tpu/serving/moe.py``): top-2 MoE layers
on the W4A4 serving path, on one device or expert-parallel over ranks.

Per layer: attention exactly as the Llama serving step (``serving/model.py``:
K2 storing K/V into the hot ring, the ring flush K4, paged + ring attention
K3 on decode; K7, the page append and the code attention on prefill), then
``_moe_mlp``: o_proj with its residual (K1), the post-attention RMSNorm
reordered by the expert-0 order (``mlp_reorder``, shared by every expert) and
fed unquantized to a float router, ONE activation quantization for all
experts, and per expert gate/up (K1) -> SiLU * up -> requantization -> down
(K1), weighted by the renormalised top-k routing weights and summed in
float32, expert by expert.

Dense routing: every expert runs over every token and the routing weights
enter as a [T, E] matrix (zero where a token is not routed), so decode
batches read each expert's weights once, as gather-based routing would at
those batch sizes.  Prefills of ``MOE_ROUTED_THRESHOLD`` tokens or more take
``_moe_mlp_routed``: each expert's tokens gathered into a static
``[capacity]`` table and the products run at that height, in the same
float32 order (bitwise the dense path when no expert overflows).

With ``ATOM_TPU_FUSED_MLP=1`` a decode batch of at most 32 rows runs o_proj
as K9 (the o_reorder gather in its prologue) and each expert as one K10 on
the reordered hidden, chained on a float32 accumulator with the expert's
routing weights as ``row_scale``.

Expert parallelism (``shard_moe_serving_params``, ``make_moe_ep_step_fns``):
the experts and the attention heads split over one mesh axis (``ep``).  Each
rank holds E/ep experts and its heads' columns of q/k/v and o_proj (the
column scheme of ``serving/parallel.py``); the routing weights come from the
whole (gathered) hidden on every rank, each rank sums its experts' weighted
outputs, and one ``psum`` adds the ranks' partial sums.  Top-2 routing
leaves two non-zero terms a token, and adding exact zeros changes nothing,
so the sum is bitwise the single device's whatever the order of the ranks.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from atom_tpu_torch.config import QuantSpec
from atom_tpu_torch.models.configs import ModelConfig
from atom_tpu_torch.models.nn import rmsnorm, rope_tables
from atom_tpu_torch.ops import reference as R
from atom_tpu_torch.ops.decode import flush_hot_ring, paged_ring_decode_attention
from atom_tpu_torch.ops.formats import KernelPackedWeight, QuantizedActivation, quantize_activation_packed
from atom_tpu_torch.ops.gemm_packed import packed_w4_gemm_fused_in, quant_gemm_packed
from atom_tpu_torch.ops.kv_hot import HOT_W
from atom_tpu_torch.ops.kv_layout import append_kv_prefill_kernel
from atom_tpu_torch.ops.mlp import fused_mlp_packed, fused_mlp_supported
from atom_tpu_torch.ops.runtime import resolve_device
from atom_tpu_torch.parallel.mesh import all_gather_cols, axis_index, axis_size
from atom_tpu_torch.parallel.mesh import psum as mesh_psum
from atom_tpu_torch.serving.model import (
    ServingState,
    _attn_block_common,
    _attn_block_decode_ring,
    _embed_lookup,
    _flush_plan,
    _fused_mlp_enabled,
    _fused_spec_ok,
    _lm_head_logits,
    _rand_packed,
    causal_code_attention,
)


class MoEServingLayerParams(NamedTuple):
    """One MoE layer's weights.  The expert weights are one
    ``KernelPackedWeight`` each whose three tensors lead with [E]; expert
    ``e`` is ``expert(w, e)``, contiguous views."""

    ln_attn: torch.Tensor  # bf16 [D]
    ln_mlp: torch.Tensor  # bf16 [D]
    attn_reorder: torch.Tensor  # int32 [D]
    o_reorder: torch.Tensor  # int32 [n_q]
    mlp_reorder: torch.Tensor  # int32 [D]: expert-0 input order, shared by all experts
    wqkv: KernelPackedWeight  # [D, n_q + 2 * n_kv]
    wo: KernelPackedWeight  # [n_q, D]
    router: torch.Tensor  # bf16 [D, E], rows in mlp_reorder order
    wgateup: KernelPackedWeight  # [E] x [D, 2 * inter]
    wdown: KernelPackedWeight  # [E] x [inter, D]
    ln_attn_g: torch.Tensor  # bf16 [D] = ln_attn[attn_reorder], read by the ring-fused qkv kernel (K2)


class MoEServingParams(NamedTuple):
    embed: torch.Tensor  # bf16 [V, D]
    final_norm: torch.Tensor  # bf16 [D]
    lm_head: torch.Tensor  # bf16 [D, V]
    layers: List[MoEServingLayerParams]


def expert(w: KernelPackedWeight, e: int) -> KernelPackedWeight:
    """Expert ``e`` of stacked expert weights: views, no copy."""
    return KernelPackedWeight(*(t[e] for t in w))


def _stack_experts(parts: List[KernelPackedWeight]) -> KernelPackedWeight:
    return KernelPackedWeight(*(torch.stack(ts) for ts in zip(*parts)))


@torch.no_grad()
def init_moe_serving_params(cfg: ModelConfig, spec: QuantSpec, seed: int = 0, device=None) -> MoEServingParams:
    """Random-weight MoE serving model from a seeded ``torch.Generator``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.hidden_size
    n_q = cfg.num_heads * cfg.head_dim
    n_kv = cfg.num_kv_heads * cfg.head_dim
    inter = cfg.intermediate_size
    e = cfg.num_experts

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev).to(torch.bfloat16) * 0.02

    embed = normal((cfg.vocab_size, d))
    lm_head = normal((d, cfg.vocab_size))
    ones = torch.ones((d,), dtype=torch.bfloat16, device=dev)
    ident = torch.arange(d, dtype=torch.int32, device=dev)
    layers = []
    for _ in range(cfg.num_layers):
        wqkv = _rand_packed(gen, d, n_q + 2 * n_kv, spec, dev)
        wo = _rand_packed(gen, n_q, d, spec, dev)
        router = (torch.randn((d, e), generator=gen, dtype=torch.float32, device=dev) * 0.02).to(torch.bfloat16)
        layers.append(MoEServingLayerParams(
            ln_attn=ones,
            ln_mlp=ones,
            attn_reorder=ident,
            o_reorder=torch.arange(n_q, dtype=torch.int32, device=dev),
            mlp_reorder=ident,
            wqkv=wqkv,
            wo=wo,
            router=router,
            wgateup=_stack_experts([_rand_packed(gen, d, 2 * inter, spec, dev) for _ in range(e)]),
            wdown=_stack_experts([_rand_packed(gen, inter, d, spec, dev) for _ in range(e)]),
            ln_attn_g=ones,
        ))
    return MoEServingParams(embed=embed, final_norm=ones, lm_head=lm_head, layers=layers)


def _route_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Dense [T, E] renormalised top-k routing weights of float32 logits,
    zero where a token is not routed.  Of equal probabilities the lower
    expert index ranks first, as ``jax.lax.top_k`` orders them (a stable
    sort; ``torch.topk`` leaves the order of ties open)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top_vals, top_idx = (t[..., :k] for t in torch.sort(probs, dim=-1, descending=True, stable=True))
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    return torch.zeros_like(probs).scatter_(-1, top_idx, top_vals)


def _router_logits(h_r: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """bf16 products, exact in float32, summed in float32 -> [T, E]."""
    return h_r.to(torch.bfloat16).to(torch.float32) @ router.to(torch.float32)


def _o_proj_and_route(x, attn_out, lp: MoEServingLayerParams, cfg: ModelConfig, spec: QuantSpec, fused: bool,
                      gather=None):
    """o_proj and its residual (K9 when ``fused``, else the reorder-quant
    chain and K1; ``gather`` all-gathers the local heads' attention output
    and o_proj's column slice), then the reordered post-attention norm and
    the routing weights -> (x, h_r bf16 [T, D], weights f32 [T, E])."""
    g = gather or (lambda v: v)
    if fused:
        x = packed_w4_gemm_fused_in(attn_out, lp.wo, resid=x, abits=spec.abits, a_clip=spec.a_clip_ratio,
                                    reorder=lp.o_reorder)
    else:
        x = x + g(quant_gemm_packed(R.reorder_quant(g(attn_out), lp.o_reorder, spec), lp.wo))
    h_r = torch.index_select(rmsnorm(x, lp.ln_mlp, cfg.norm_eps), -1, lp.mlp_reorder)
    return x, h_r, _route_top_k(_router_logits(h_r, lp.router), cfg.num_experts_per_tok)


def _local_experts(lp: MoEServingLayerParams, cfg: ModelConfig, expert_slice):
    """(leaf index, global expert) of each expert this layer runs.
    ``expert_slice`` (e0, n_local): experts e0 .. e0 + n_local - 1, whose
    leaves are the layer's first n_local when it holds only those (an
    expert-parallel shard), else at their global index."""
    e0, n_local = expert_slice if expert_slice is not None else (0, cfg.num_experts)
    base = e0 if lp.wgateup.body_packed.shape[0] == cfg.num_experts else 0
    return [(base + j, e0 + j) for j in range(n_local)]


def _expert_mlp(a_q: QuantizedActivation, lp: MoEServingLayerParams, e: int, spec: QuantSpec) -> torch.Tensor:
    """One expert (leaf ``e``) on quantized rows: gate/up (K1) -> SiLU * up ->
    requantization -> down (K1) -> float32 [rows, D]."""
    gu = quant_gemm_packed(a_q, expert(lp.wgateup, e), out_dtype=torch.float32)
    inter = gu.shape[1] // 2
    act = F.silu(gu[:, :inter]) * gu[:, inter:]
    return quant_gemm_packed(quantize_activation_packed(act, spec), expert(lp.wdown, e), out_dtype=torch.float32)


def _moe_mlp(x, attn_out, lp: MoEServingLayerParams, cfg: ModelConfig, spec: QuantSpec, gather=None,
             expert_slice=None, psum=None) -> torch.Tensor:
    """o_proj + router + dense-routed expert MLP -> new residual stream.

    Under expert parallelism ``gather`` all-gathers the column-sharded
    attention half, ``expert_slice`` names this rank's experts and ``psum``
    adds the ranks' partial sums (the routing weights come from the whole
    hidden, so the sum is bitwise the single device's dense one)."""
    fused_o = gather is None and _fused_expert_ok(attn_out.shape, lp, spec)
    x, h_r, weights = _o_proj_and_route(x, attn_out, lp, cfg, spec, fused_o, gather)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    if _fused_expert_ok(h_r.shape, lp, spec):
        # one K10 per expert: the input quantization, gate/up, SiLU * up, the requantization, down and
        # acc + w_e * out_e in float32; the norm stays outside (the float router reads h_r)
        for leaf, e in _local_experts(lp, cfg, expert_slice):
            acc = fused_mlp_packed(h_r, acc, expert(lp.wgateup, leaf), expert(lp.wdown, leaf), row_scale=weights[:, e],
                                   abits=spec.abits, a_clip=spec.a_clip_ratio)
    else:
        a_q = quantize_activation_packed(h_r.to(torch.float32), spec)
        for leaf, e in _local_experts(lp, cfg, expert_slice):
            acc = acc + weights[:, e : e + 1] * _expert_mlp(a_q, lp, leaf, spec)
    if psum is not None:
        acc = psum(acc)
    return x + acc.to(x.dtype)


def _fused_expert_ok(h_shape, lp: MoEServingLayerParams, spec: QuantSpec) -> bool:
    """Gate of the fused kernels of the MoE block (decode batches only), the
    JAX package's: switched on, at most 32 rows, the activation scheme K9's
    and K10's prologues implement, and a geometry ``fused_mlp_supported``
    takes, with ``h_shape``'s width as the hidden (the o_proj gate passes the
    attention output's shape)."""
    m, d = h_shape
    inter = lp.wgateup.body_packed.shape[-1] // 2
    return (
        _fused_mlp_enabled()
        and m <= 32
        and _fused_spec_ok(spec)
        and fused_mlp_supported(d, inter, spec.keeper, spec.act_group_size)
    )


def _moe_mlp_routed(x, attn_out, lp: MoEServingLayerParams, cfg: ModelConfig, spec: QuantSpec,
                    capacity: int, gather=None, expert_slice=None, psum=None) -> torch.Tensor:
    """Routed expert MLP for prefill token counts.

    Each routed (token, expert) pair's rank within its expert comes from a
    cumulative sum over the [T, E] routing mask; the ranks scatter the token
    ids into a static [E, capacity] table (overflow past ``capacity`` and the
    unrouted go to one dead slot, dropped).  Each expert runs on its table's
    rows of the already-quantized activation (row T is a zero pad row) and
    each token gathers its row back, accumulated in the dense path's
    expert-major float32 order, so the two are bitwise equal when no expert
    overflows.  A token past an expert's capacity loses that expert's
    contribution only.  ``gather``, ``expert_slice`` and ``psum`` as in
    ``_moe_mlp``: the table covers every expert, a rank runs its own."""
    x, h_r, weights = _o_proj_and_route(x, attn_out, lp, cfg, spec, False, gather)
    a_q = quantize_activation_packed(h_r.to(torch.float32), spec)

    t = x.shape[0]
    n_exp = cfg.num_experts
    dev = x.device
    routed = weights > 0.0  # [T, E]
    pos = torch.cumsum(routed.to(torch.int32), dim=0, dtype=torch.int32) - 1  # rank in its expert
    valid = routed & (pos < capacity)
    flat = torch.where(valid, torch.arange(n_exp, device=dev)[None, :] * capacity + pos, n_exp * capacity)
    tok_tbl = torch.full((n_exp * capacity + 1,), t, dtype=torch.int64, device=dev)
    tok_tbl[flat.reshape(-1).long()] = torch.arange(t, device=dev).repeat_interleave(n_exp)
    tok_tbl = tok_tbl[:-1].reshape(n_exp, capacity)
    a_pad = QuantizedActivation(*(F.pad(t, (0, 0, 0, 1)) for t in a_q))

    acc = torch.zeros(x.shape, dtype=torch.float32, device=dev)
    for leaf, e in _local_experts(lp, cfg, expert_slice):
        rows = tok_tbl[e]
        out_e = _expert_mlp(QuantizedActivation(*(t[rows] for t in a_pad)), lp, leaf, spec)  # [capacity, D]
        back = torch.where(valid[:, e : e + 1], out_e[pos[:, e].clamp(0, capacity - 1).long()], 0.0)
        acc = acc + weights[:, e : e + 1] * back
    if psum is not None:
        acc = psum(acc)
    return x + acc.to(x.dtype)


# Dense expert execution below this prefill length (every expert is hit by
# nearly every batch anyway and the dispatch would be pure overhead); from it
# on the routed path runs about E/k times fewer expert products.
MOE_ROUTED_THRESHOLD = 512


def _moe_capacity(t: int, cfg: ModelConfig, slack: float = 2.0) -> int:
    """Per-expert token capacity: the mean load times ``slack``, a multiple
    of 128, at most ``t``."""
    per_expert = t * cfg.num_experts_per_tok / cfg.num_experts
    return min(t, int(-(-per_expert * slack // 128)) * 128)


@torch.no_grad()
def decode_hidden_moe(
    params: MoEServingParams,
    state: ServingState,
    ids: torch.Tensor,  # int32 [B]
    page_table: torch.Tensor,  # int32 [B, max_pages]
    seq_lens: torch.Tensor,  # int32 [B] — including the incoming token
    cfg: ModelConfig,
    spec: QuantSpec,
    flush: bool = False,
    gather=None,
    expert_slice=None,
    psum=None,
):
    """MoE layer stack of one decode step -> (final-norm hidden [B, D],
    state): ``serving.model.decode_hidden`` with ``_moe_mlp`` after the
    attention.  Under expert parallelism ``cfg`` holds the per-rank head
    counts; ``gather``, ``expert_slice`` and ``psum`` go to ``_moe_mlp``."""
    b = ids.shape[0]
    dh = cfg.head_dim
    x = _embed_lookup(params.embed, ids)
    pos = torch.clamp_min(seq_lens - 1, 0)
    cos, sin = rope_tables(pos, dh, cfg.rope_theta)

    w = state.hot[0].window
    row = state.row
    flush_args, flushed_new = _flush_plan(state, page_table, seq_lens, flush)
    n_hot = seq_lens - flushed_new

    for l, lp in enumerate(params.layers):
        hot = state.hot[l]
        q = _attn_block_decode_ring(x, lp, cfg, spec, (cos, sin), hot, row)
        if flush:
            flush_hot_ring(state.pages[l], hot, row, *flush_args)
        attn = paged_ring_decode_attention(q, state.pages[l], page_table, flushed_new, hot, n_hot, row)
        x = _moe_mlp(x, attn.reshape(b, cfg.num_heads * dh), lp, cfg, spec, gather, expert_slice, psum)

    new_state = ServingState(pages=state.pages, hot=state.hot, row=(row + 1) % w, flushed=flushed_new)
    return rmsnorm(x, params.final_norm, cfg.norm_eps), new_state


@torch.no_grad()
def decode_step_moe(params, state, ids, page_table, seq_lens, cfg: ModelConfig, spec: QuantSpec, flush: bool = False):
    """One continuous-batching MoE decode step -> (next_ids int32 [B], state)."""
    x, new_state = decode_hidden_moe(params, state, ids, page_table, seq_lens, cfg, spec, flush=flush)
    logits = _lm_head_logits(x, params.lm_head, cfg.vocab_size)
    return torch.argmax(logits, dim=-1).to(torch.int32), new_state


@torch.no_grad()
def prefill_hidden_moe(params: MoEServingParams, pages, ids, table_row, cfg: ModelConfig, spec: QuantSpec,
                       gather=None, expert_slice=None, psum=None):
    """MoE layer stack of a prefill -> (final-norm hidden [T, D], pages):
    the K/V land in the sequence's pages (in place), attention runs over the
    just-quantized codes, and the experts run routed from
    ``MOE_ROUTED_THRESHOLD`` tokens on; the parallel arguments as in
    ``decode_hidden_moe``."""
    t = ids.shape[0]
    dh = cfg.head_dim
    x = _embed_lookup(params.embed, ids)
    cos, sin = rope_tables(torch.arange(t, device=ids.device), dh, cfg.rope_theta)
    cap = _moe_capacity(t, cfg) if t >= MOE_ROUTED_THRESHOLD else 0
    for l, lp in enumerate(params.layers):
        q, kq, vq = _attn_block_common(x, lp, cfg, spec, (cos, sin))
        append_kv_prefill_kernel(pages[l], kq, vq, table_row)
        attn = causal_code_attention(q, kq, vq, cfg.kv_groups, dh**-0.5)
        del q, kq, vq
        if cap:
            x = _moe_mlp_routed(x, attn, lp, cfg, spec, cap, gather, expert_slice, psum)
        else:
            x = _moe_mlp(x, attn, lp, cfg, spec, gather, expert_slice, psum)
    return rmsnorm(x, params.final_norm, cfg.norm_eps), pages


@torch.no_grad()
def prefill_step_moe(params, state: ServingState, ids, table_row, true_len: int, slot: int, cfg: ModelConfig,
                     spec: QuantSpec):
    """Prefill one fresh sequence -> (first generated token, 0-dim int32 on
    the device; state), as ``serving.model.prefill_step``."""
    x, pages = prefill_hidden_moe(params, state.pages, ids, table_row, cfg, spec)
    logits = _lm_head_logits(x[max(true_len - 1, 0)][None], params.lm_head, cfg.vocab_size)[0]
    flushed = state.flushed.clone()
    flushed[slot] = true_len
    new_state = ServingState(pages=pages, hot=state.hot, row=state.row, flushed=flushed)
    return torch.argmax(logits).to(torch.int32), new_state


def make_moe_step_fns(params: MoEServingParams, cfg: ModelConfig, spec: QuantSpec):
    """(prefill_fn, decode_fn) closures with the engine's calling convention.
    ``decode_fn`` counts its calls: every W-th one flushes the ring."""

    def prefill_fn(state, ids, table_row, true_len, slot):
        return prefill_step_moe(params, state, ids, table_row, true_len, slot, cfg, spec)

    counter = {"n": 0}

    def decode_fn(state, ids, page_table, seq_lens):
        counter["n"] += 1
        return decode_step_moe(params, state, ids, page_table, seq_lens, cfg, spec, flush=counter["n"] % HOT_W == 0)

    return prefill_fn, decode_fn


@torch.no_grad()
def decode_burst_moe(params, state, ids, page_table, seq_lens, n_windows: int, cfg: ModelConfig, spec: QuantSpec):
    """``n_windows`` whole ring windows of W MoE decode steps each, the last
    step of each window flushing.  ``seq_lens`` excludes ``ids``;
    ``page_table`` must cover the burst.  Returns (ids, state, seq_lens)."""
    w = state.hot[0].window
    for _ in range(n_windows):
        for i in range(w):
            seq_lens = seq_lens + 1
            ids, state = decode_step_moe(params, state, ids, page_table, seq_lens, cfg, spec, flush=i == w - 1)
    return ids, state, seq_lens


# ---------------------------------------------------------------------------
# Expert parallelism (experts and attention heads split over one mesh axis)
# ---------------------------------------------------------------------------


def shard_moe_serving_params(params: MoEServingParams, cfg: ModelConfig, mesh, axis: str = "ep") -> MoEServingParams:
    """This rank's expert-parallel shard: its E/ep experts (contiguous
    copies), its heads' columns of q/k/v and o_proj and its columns of the
    bf16 head, as ``serving.parallel.shard_serving_params``; norms, reorder
    indices, the router and the embedding are shared with ``params``."""
    from atom_tpu_torch.serving.parallel import _shard_cols, _shard_head, _shard_qkv

    ep, i = axis_size(mesh, axis), axis_index(mesh, axis)
    _ep_shard_cfg(cfg, ep)
    n = cfg.num_experts // ep

    def experts(w):
        return KernelPackedWeight(*(t[i * n : (i + 1) * n].clone() for t in w))

    layers = [
        lp._replace(wqkv=_shard_qkv(lp.wqkv, cfg, ep, i), wo=_shard_cols(lp.wo, ep, i),
                    wgateup=experts(lp.wgateup), wdown=experts(lp.wdown))
        for lp in params.layers
    ]
    return params._replace(lm_head=_shard_head(params.lm_head, ep, i), layers=layers)


def _ep_shard_cfg(cfg: ModelConfig, ep: int) -> ModelConfig:
    if cfg.num_experts % ep or cfg.num_heads % ep or cfg.num_kv_heads % ep:
        raise ValueError(f"{cfg.num_experts} experts and heads {cfg.num_heads}/{cfg.num_kv_heads} must split over "
                         f"{ep} ranks")
    return cfg.replace(num_heads=cfg.num_heads // ep, num_kv_heads=cfg.num_kv_heads // ep)


def make_moe_ep_step_fns(params_sharded: MoEServingParams, cfg: ModelConfig, spec: QuantSpec, mesh, axis: str = "ep"):
    """(prefill_fn, decode_fn) with the engine's calling convention: the
    attention head-sharded and the experts sharded over the same axis, the
    single-device layer code with ``gather``, ``expert_slice`` and ``psum``;
    tokens, pages and ring bitwise the single-device MoE step's (the head as
    in ``serving.parallel.make_tp_step_fns``).  ``decode_fn`` flushes the
    ring on every W-th call.  The state is ``serving.parallel.make_state_sharded``
    over the same axis."""
    from atom_tpu_torch.serving.parallel import shard_argmax

    group = mesh.get_group(axis)
    ep, i = axis_size(mesh, axis), axis_index(mesh, axis)
    shard_cfg = _ep_shard_cfg(cfg, ep)
    n = cfg.num_experts // ep
    par = dict(gather=lambda v: all_gather_cols(v, group), expert_slice=(i * n, n),
               psum=lambda v: mesh_psum(v, group))

    def prefill_fn(state: ServingState, ids, table_row, true_len: int, slot: int):
        x, pages = prefill_hidden_moe(params_sharded, state.pages, ids, table_row, shard_cfg, spec, **par)
        logits = _lm_head_logits(x[max(true_len - 1, 0)][None], params_sharded.lm_head)
        flushed = state.flushed.clone()
        flushed[slot] = true_len
        return shard_argmax(logits, group)[0], ServingState(pages=pages, hot=state.hot, row=state.row,
                                                              flushed=flushed)

    counter = {"n": 0}

    def decode_fn(state: ServingState, ids, page_table, seq_lens):
        counter["n"] += 1
        x, new_state = decode_hidden_moe(params_sharded, state, ids, page_table, seq_lens, shard_cfg, spec,
                                         flush=counter["n"] % HOT_W == 0, **par)
        return shard_argmax(_lm_head_logits(x, params_sharded.lm_head), group), new_state

    return prefill_fn, decode_fn
