"""Quantized serving Mixtral (``atom_tpu/serving/moe.py``, its single-device
half): top-2 MoE layers on the W4A4 serving path.

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

The expert-parallel half of the JAX module (``shard_moe_serving_params``,
``make_moe_ep_step_fns``) is not ported yet.
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


def _o_proj_and_route(x, attn_out, lp: MoEServingLayerParams, cfg: ModelConfig, spec: QuantSpec, fused: bool):
    """o_proj and its residual (K9 when ``fused``, else the reorder-quant
    chain and K1), then the reordered post-attention norm and the routing
    weights -> (x, h_r bf16 [T, D], weights f32 [T, E])."""
    if fused:
        x = packed_w4_gemm_fused_in(attn_out, lp.wo, resid=x, abits=spec.abits, a_clip=spec.a_clip_ratio,
                                    reorder=lp.o_reorder)
    else:
        x = x + quant_gemm_packed(R.reorder_quant(attn_out, lp.o_reorder, spec), lp.wo)
    h_r = torch.index_select(rmsnorm(x, lp.ln_mlp, cfg.norm_eps), -1, lp.mlp_reorder)
    return x, h_r, _route_top_k(_router_logits(h_r, lp.router), cfg.num_experts_per_tok)


def _expert_mlp(a_q: QuantizedActivation, lp: MoEServingLayerParams, e: int, spec: QuantSpec) -> torch.Tensor:
    """One expert on quantized rows: gate/up (K1) -> SiLU * up ->
    requantization -> down (K1) -> float32 [rows, D]."""
    gu = quant_gemm_packed(a_q, expert(lp.wgateup, e), out_dtype=torch.float32)
    inter = gu.shape[1] // 2
    act = F.silu(gu[:, :inter]) * gu[:, inter:]
    return quant_gemm_packed(quantize_activation_packed(act, spec), expert(lp.wdown, e), out_dtype=torch.float32)


def _moe_mlp(x, attn_out, lp: MoEServingLayerParams, cfg: ModelConfig, spec: QuantSpec) -> torch.Tensor:
    """o_proj + router + dense-routed expert MLP -> new residual stream."""
    x, h_r, weights = _o_proj_and_route(x, attn_out, lp, cfg, spec, _fused_expert_ok(attn_out.shape, lp, spec))
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    if _fused_expert_ok(h_r.shape, lp, spec):
        # one K10 per expert: the input quantization, gate/up, SiLU * up, the requantization, down and
        # acc + w_e * out_e in float32; the norm stays outside (the float router reads h_r)
        for e in range(cfg.num_experts):
            acc = fused_mlp_packed(h_r, acc, expert(lp.wgateup, e), expert(lp.wdown, e), row_scale=weights[:, e],
                                   abits=spec.abits, a_clip=spec.a_clip_ratio)
        return x + acc.to(x.dtype)
    a_q = quantize_activation_packed(h_r.to(torch.float32), spec)
    for e in range(cfg.num_experts):
        acc = acc + weights[:, e : e + 1] * _expert_mlp(a_q, lp, e, spec)
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
                    capacity: int) -> torch.Tensor:
    """Routed expert MLP for prefill token counts.

    Each routed (token, expert) pair's rank within its expert comes from a
    cumulative sum over the [T, E] routing mask; the ranks scatter the token
    ids into a static [E, capacity] table (overflow past ``capacity`` and the
    unrouted go to one dead slot, dropped).  Each expert runs on its table's
    rows of the already-quantized activation (row T is a zero pad row) and
    each token gathers its row back, accumulated in the dense path's
    expert-major float32 order, so the two are bitwise equal when no expert
    overflows.  A token past an expert's capacity loses that expert's
    contribution only."""
    x, h_r, weights = _o_proj_and_route(x, attn_out, lp, cfg, spec, False)
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
    for e in range(n_exp):
        rows = tok_tbl[e]
        out_e = _expert_mlp(QuantizedActivation(*(t[rows] for t in a_pad)), lp, e, spec)  # [capacity, D]
        back = torch.where(valid[:, e : e + 1], out_e[pos[:, e].clamp(0, capacity - 1).long()], 0.0)
        acc = acc + weights[:, e : e + 1] * back
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
):
    """MoE layer stack of one decode step -> (final-norm hidden [B, D],
    state): ``serving.model.decode_hidden`` with ``_moe_mlp`` after the
    attention."""
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
        x = _moe_mlp(x, attn.reshape(b, cfg.num_heads * dh), lp, cfg, spec)

    new_state = ServingState(pages=state.pages, hot=state.hot, row=(row + 1) % w, flushed=flushed_new)
    return rmsnorm(x, params.final_norm, cfg.norm_eps), new_state


@torch.no_grad()
def decode_step_moe(params, state, ids, page_table, seq_lens, cfg: ModelConfig, spec: QuantSpec, flush: bool = False):
    """One continuous-batching MoE decode step -> (next_ids int32 [B], state)."""
    x, new_state = decode_hidden_moe(params, state, ids, page_table, seq_lens, cfg, spec, flush=flush)
    logits = _lm_head_logits(x, params.lm_head, cfg.vocab_size)
    return torch.argmax(logits, dim=-1).to(torch.int32), new_state


@torch.no_grad()
def prefill_hidden_moe(params: MoEServingParams, pages, ids, table_row, cfg: ModelConfig, spec: QuantSpec):
    """MoE layer stack of a prefill -> (final-norm hidden [T, D], pages):
    the K/V land in the sequence's pages (in place), attention runs over the
    just-quantized codes, and the experts run routed from
    ``MOE_ROUTED_THRESHOLD`` tokens on."""
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
        x = _moe_mlp_routed(x, attn, lp, cfg, spec, cap) if cap else _moe_mlp(x, attn, lp, cfg, spec)
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
