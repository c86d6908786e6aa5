"""Quantized serving Llama, decode half (``atom_tpu/serving/model.py``).

One decode step for B sequences: embedding row fetch (K6) -> per layer the
fused qkv kernel storing K/V into the hot ring (K2), on every W-th step the
ring flush into the pages (K4), paged + ring decode attention (K3), then
o_proj, the MLP and their dynamic quantization around three 4-bit GEMMs
(K1) -> final norm -> bf16 head with f32 logits -> argmax.

The ring and the pages are updated in place (the JAX version donates them).
Prefill, the KV pool, the engine and the W8A16 head are the next slice of
the port; a geometry or spec off the fused decode path raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from atom_tpu_torch.config import KeeperPrecision, QuantSpec, QuantType
from atom_tpu_torch.models.configs import ModelConfig
from atom_tpu_torch.models.nn import rmsnorm, rope_tables
from atom_tpu_torch.numerics import rms_rstd
from atom_tpu_torch.ops import reference as R
from atom_tpu_torch.ops.decode import flush_hot, paged_ring_decode_attention
from atom_tpu_torch.ops.formats import (
    KernelPackedWeight,
    pack_for_kernel,
    quantize_activation_packed,
    quantize_weight_packed,
)
from atom_tpu_torch.ops.gemm_packed import packed_w4_gemm_qkv_ring_fused, quant_gemm_packed
from atom_tpu_torch.ops.kv_hot import HotKV, hot_flush_blocks, make_hot
from atom_tpu_torch.ops.kv_layout import KVPages, make_kv_pages_kernel
from atom_tpu_torch.ops.misc import embed_gather
from atom_tpu_torch.ops.runtime import resolve_device

NEXT_SLICE = "the next slice of the port (prefill, the unfused qkv kernels, the W8A16 head)"


class ServingLayerParams(NamedTuple):
    """One layer's weights; q/k/v and gate/up are fused into wide GEMMs."""

    ln_attn: torch.Tensor  # bf16 [D]
    ln_mlp: torch.Tensor  # bf16 [D]
    attn_reorder: torch.Tensor  # int32 [D]  (q/k/v input order)
    o_reorder: torch.Tensor  # int32 [n_q] (attn-out order before o_proj)
    mlp_reorder: torch.Tensor  # int32 [D]  (gate/up input order)
    wqkv: KernelPackedWeight  # [D, n_q + 2 * n_kv]
    wo: KernelPackedWeight  # [n_q, D]
    wgateup: KernelPackedWeight  # [D, 2 * inter]
    wdown: KernelPackedWeight  # [inter, D]
    ln_attn_g: torch.Tensor  # bf16 [D] = ln_attn[attn_reorder]
    ln_mlp_g: torch.Tensor  # bf16 [D] = ln_mlp[mlp_reorder]


class ServingParams(NamedTuple):
    embed: torch.Tensor  # bf16 [V, D]
    final_norm: torch.Tensor  # bf16 [D]
    lm_head: torch.Tensor  # bf16 [D, V]
    layers: List[ServingLayerParams]


def _rand_packed(gen, in_f: int, out_f: int, spec: QuantSpec, device) -> KernelPackedWeight:
    w = torch.randn((in_f, out_f), generator=gen, dtype=torch.float32, device=device) * in_f**-0.5
    return pack_for_kernel(quantize_weight_packed(w, spec))


@torch.no_grad()
def init_serving_params(cfg: ModelConfig, spec: QuantSpec, seed: int = 0, device=None) -> ServingParams:
    """Random-weight serving model from a seeded ``torch.Generator``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.hidden_size
    n_q = cfg.num_heads * cfg.head_dim
    n_kv = cfg.num_kv_heads * cfg.head_dim
    inter = cfg.intermediate_size

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev).to(torch.bfloat16) * 0.02

    embed = normal((cfg.vocab_size, d))
    lm_head = normal((d, cfg.vocab_size))
    ones = torch.ones((d,), dtype=torch.bfloat16, device=dev)
    ident = torch.arange(d, dtype=torch.int32, device=dev)
    layers = [
        ServingLayerParams(
            ln_attn=ones,
            ln_mlp=ones,
            attn_reorder=ident,
            o_reorder=torch.arange(n_q, dtype=torch.int32, device=dev),
            mlp_reorder=ident,
            wqkv=_rand_packed(gen, d, n_q + 2 * n_kv, spec, dev),
            wo=_rand_packed(gen, n_q, d, spec, dev),
            wgateup=_rand_packed(gen, d, 2 * inter, spec, dev),
            wdown=_rand_packed(gen, inter, d, spec, dev),
            ln_attn_g=ones,
            ln_mlp_g=ones,
        )
        for _ in range(cfg.num_layers)
    ]
    return ServingParams(embed=embed, final_norm=ones, lm_head=lm_head, layers=layers)


def _embed_lookup(embed: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows of the decode batch (kernel K6)."""
    return embed_gather(embed, ids).to(torch.bfloat16)


def _lm_head_logits(x: torch.Tensor, lm_head: torch.Tensor, vocab: int | None = None) -> torch.Tensor:
    """bf16 head matmul with f32 logits (f32 accumulation of bf16 products),
    so near-tie argmax decisions match the JAX head."""
    xb = x.to(torch.bfloat16)
    if xb.is_cuda:
        out = torch.mm(xb, lm_head, out_dtype=torch.float32)
    else:
        out = xb.to(torch.float32) @ lm_head.to(torch.float32)
    if vocab is not None and out.shape[-1] != vocab:
        out = out[..., :vocab]
    return out


def _rms_rstd(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm reciprocal std, passed into the fused qkv kernel's prologue."""
    return rms_rstd(x, eps)


def _post_attn(x, attn_out, lp: ServingLayerParams, spec: QuantSpec):
    """reorder+quant -> o_proj -> residual; then the MLP block (unfused)."""
    a_in = R.reorder_quant(attn_out, lp.o_reorder, spec)
    x = x + quant_gemm_packed(a_in, lp.wo)
    m_in = R.rmsnorm_reorder_quant(x, lp.ln_mlp, lp.mlp_reorder, spec)
    gu = quant_gemm_packed(m_in, lp.wgateup, out_dtype=torch.float32)
    inter = gu.shape[1] // 2
    act = F.silu(gu[:, :inter]) * gu[:, inter:]
    d_in = quantize_activation_packed(act, spec)
    return x + quant_gemm_packed(d_in, lp.wdown)


def _fused_spec_ok(spec: QuantSpec) -> bool:
    """The activation scheme the fused qkv prologue implements: symmetric
    INT4 128-groups + INT8 128-keeper."""
    return (
        spec.fused_serving
        and spec.a_sym
        and spec.quant_type == QuantType.INT
        and not spec.exponential
        and spec.abits == 4
        and spec.act_group_size == 128
        and spec.keeper == 128
        and spec.keeper_precision == KeeperPrecision.INT8
    )


def _attn_block_decode_ring(x, lp: ServingLayerParams, cfg: ModelConfig, spec: QuantSpec, rope, hot: HotKV, row: int):
    """Fused qkv kernel (K2) storing K/V straight into the hot ring at
    column ``row`` -> q [B, heads, dh]."""
    n_q = cfg.num_heads * cfg.head_dim
    n_kv = cfg.num_kv_heads * cfg.head_dim
    dh = cfg.head_dim
    b, d = x.shape
    fused_geometry = n_q % 512 == 0 and n_kv % 512 == 0 and dh == 128 and b % 32 == 0
    if not (fused_geometry and _fused_spec_ok(spec) and d % 128 == 0 and (d - 128) // 128 <= 112):
        raise NotImplementedError(
            f"decode qkv off the fused path (n_q={n_q}, n_kv={n_kv}, head_dim={dh}, batch={b}, "
            f"hidden={d}, fused_spec={_fused_spec_ok(spec)}) is {NEXT_SLICE}"
        )
    cos, sin = rope
    y = torch.index_select(x, -1, lp.attn_reorder)
    q = packed_w4_gemm_qkv_ring_fused(
        y, lp.ln_attn_g, lp.wqkv.body_packed, lp.wqkv.keeper, lp.wqkv.scales,
        cos, sin, hot.k_codes, hot.prm, hot.v_codes, row,
        n_q=n_q, n_kv=n_kv, head_dim=dh, abits=spec.abits, a_clip=spec.a_clip_ratio,
        rstd=_rms_rstd(x),
    )
    return q.reshape(b, cfg.num_heads, dh)


class ServingState(NamedTuple):
    """Decode state: pages and ring per layer (updated in place), the ring
    write column ``row`` shared by all layers, and each sequence's
    page-resident token count ``flushed``."""

    pages: List[KVPages]
    hot: List[HotKV]
    row: int  # in [0, W)
    flushed: torch.Tensor  # int32 [B]


def make_serving_state(
    n_layers: int, n_pages: int, batch: int, kv_heads: int, page_size: int, head_dim: int, device=None
) -> ServingState:
    dev = resolve_device(device)
    return ServingState(
        pages=[make_kv_pages_kernel(n_pages, kv_heads, page_size, head_dim, dev) for _ in range(n_layers)],
        hot=[make_hot(batch, kv_heads, head_dim, dev) for _ in range(n_layers)],
        row=0,
        flushed=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


@torch.no_grad()
def decode_hidden(
    params: ServingParams,
    state: ServingState,
    ids: torch.Tensor,  # int32 [B]
    page_table: torch.Tensor,  # int32 [B, max_pages]
    seq_lens: torch.Tensor,  # int32 [B] — including the incoming token
    cfg: ModelConfig,
    spec: QuantSpec,
    flush: bool = False,
):
    """Layer stack of one decode step -> (final-norm hidden [B, D], state).

    ``flush`` must be True exactly when the ring wraps this step: every
    active sequence's pending block [flushed, lens) then moves to its pages.
    """
    b = ids.shape[0]
    dh = cfg.head_dim
    x = _embed_lookup(params.embed, ids)
    pos = torch.clamp_min(seq_lens - 1, 0)
    cos, sin = rope_tables(pos, dh, cfg.rope_theta)

    w = state.hot[0].window
    s_page = state.pages[0].page_size
    row = state.row
    max_pg = page_table.shape[1]
    if flush:
        active = (seq_lens > 0) & (seq_lens > state.flushed)
        page_lo = torch.div(seq_lens - w, s_page, rounding_mode="floor")  # may be negative
        slot0 = page_lo * s_page
        o_lane = seq_lens - w - slot0  # in [0, S)

        def tbl(idx):
            return torch.gather(page_table, 1, idx.clamp(0, max_pg - 1)[:, None].long())[:, 0]

        pg_a = torch.where(active & (page_lo >= 0), tbl(page_lo), 0)
        pg_b = torch.where(active & ((page_lo + 1) * s_page < seq_lens), tbl(page_lo + 1), 0)
        lo, hi = state.flushed, seq_lens
        flushed_new = torch.where(active, seq_lens, state.flushed)
    else:
        flushed_new = state.flushed
    n_hot = seq_lens - flushed_new  # ring-resident suffix per sequence

    for l, lp in enumerate(params.layers):
        hot = state.hot[l]
        q = _attn_block_decode_ring(x, lp, cfg, spec, (cos, sin), hot, row)
        if flush:
            flush_hot(state.pages[l], *hot_flush_blocks(hot, row), pg_a, pg_b, slot0, o_lane, lo, hi)
        attn = paged_ring_decode_attention(q, state.pages[l], page_table, flushed_new, hot, n_hot, row)
        x = _post_attn(x, attn.reshape(b, cfg.num_heads * dh), lp, spec)

    new_state = ServingState(pages=state.pages, hot=state.hot, row=(row + 1) % w, flushed=flushed_new)
    return rmsnorm(x, params.final_norm, cfg.norm_eps), new_state


@torch.no_grad()
def decode_step(params, state, ids, page_table, seq_lens, cfg: ModelConfig, spec: QuantSpec, flush: bool = False):
    """One continuous-batching decode step -> (next_ids int32 [B], state)."""
    x, new_state = decode_hidden(params, state, ids, page_table, seq_lens, cfg, spec, flush=flush)
    logits = _lm_head_logits(x, params.lm_head, cfg.vocab_size)
    return torch.argmax(logits, dim=-1).to(torch.int32), new_state


@torch.no_grad()
def decode_burst(params, state, ids, page_table, seq_lens, n_windows: int, cfg: ModelConfig, spec: QuantSpec):
    """``n_windows`` whole ring windows of W decode steps each, the last step
    of each window flushing.  ``seq_lens`` excludes ``ids``; ``page_table``
    must cover the burst.  Returns (ids, state, seq_lens)."""
    w = state.hot[0].window
    for _ in range(n_windows):
        for i in range(w):
            seq_lens = seq_lens + 1
            ids, state = decode_step(params, state, ids, page_table, seq_lens, cfg, spec, flush=i == w - 1)
    return ids, state, seq_lens
