"""Quantized serving Llama (``atom_tpu/serving/model.py``): prefill, decode and
the mixed prefill+decode step.

``prefill_step``: one fresh sequence [T] (bucket-padded): embedding rows (K6)
-> per layer the qkv projection with RoPE and K/V quantization (K7), whole
pages appended, causal attention over the just-quantized codes (plain
PyTorch), o_proj and the MLP around three 4-bit GEMMs (K1) -> final norm ->
head on the last true row -> first generated token.

``decode_step``: one token for each of B sequences: embedding rows (K6) -> per
layer the fused qkv kernel storing K/V into the hot ring (K2; K8 for a spec
its prologue does not implement; K7 + ``write_hot`` off its geometry), on
every W-th step the ring flush into the pages (K4), paged + ring decode
attention (K3), then o_proj and the MLP (K1) -> final norm -> head -> argmax.

``mixed_step``: one decode step for the whole batch plus one page-size chunk
of an admitted prompt, its rows concatenated onto the decode batch's for the
GEMMs (K7, K1).  Decode rows attend their pages (K11) and the ring
(``hot_attention``), merged; chunk rows attend the prompt's page-resident
prefix (K11, all chunk queries as one sequence's query rows) and the chunk
itself (dense causal), merged; the chunk's K/V land as one whole page.

With ``ATOM_TPU_FUSED_MLP=1`` a decode step's post-attention half runs as two
fused kernels: o_proj with its activation quantization and residual add (K9)
and the whole MLP block (K10).  With ``PREFILL_KERNEL_THRESHOLD`` lowered,
prefill attention runs as one flash kernel over the codes (K12).

The head is bf16 or, after ``quantize_lm_head``, weight-only INT8 (K5) or
INT4 with 128-row groups (``bits=4``, K13); all steps share it.  The ring
and the pages are updated in place (the JAX version donates them).
``decode_hidden`` and ``prefill_hidden`` take the JAX package's block hooks
(``attn_block_fn``, ``post_attn_fn``), through which ``serving/lora.py``
serves adapters, and the tensor-parallel ``gather`` (``serving/parallel.py``).
"""
from __future__ import annotations

import os
from typing import List, NamedTuple, Union

import torch
import torch.nn.functional as F

from atom_tpu_torch.config import KeeperPrecision, QuantSpec, QuantType
from atom_tpu_torch.models.configs import ModelConfig
from atom_tpu_torch.models.nn import apply_rope, rmsnorm, rope_tables
from atom_tpu_torch.numerics import rms_rstd
from atom_tpu_torch.ops import reference as R
from atom_tpu_torch.ops.decode import flush_hot_ring, paged_decode_attention_rotated, paged_ring_decode_attention
from atom_tpu_torch.ops.formats import (
    KernelPackedWeight,
    pack_for_kernel,
    quantize_activation_packed,
    quantize_weight_packed,
)
from atom_tpu_torch.ops.gemm_packed import (
    packed_w4_gemm_fused_in,
    packed_w4_gemm_qkv,
    packed_w4_gemm_qkv_ring,
    packed_w4_gemm_qkv_ring_fused,
    quant_gemm_packed,
)
from atom_tpu_torch.ops.gemm_w4a16 import (
    W4A16Weight,
    W8A16Weight,
    quantize_w4a16,
    quantize_w8a16,
    w4a16_gemm,
    w8a16_gemm,
)
from atom_tpu_torch.ops.kv_hot import (
    HOT_W,
    HotKV,
    hot_attention,
    make_hot,
    merge_attention,
    write_hot,
)
from atom_tpu_torch.ops.kv_layout import KVPages, append_kv_prefill_kernel, make_kv_pages_kernel
from atom_tpu_torch.ops.misc import embed_gather
from atom_tpu_torch.ops.mlp import fused_mlp_packed, fused_mlp_supported
from atom_tpu_torch.ops.prefill import flash_code_attention
from atom_tpu_torch.ops.runtime import resolve_device


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
    lm_head: Union[torch.Tensor, W8A16Weight, W4A16Weight]  # bf16 [D, V], or a weight-only form (padded)
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


def quantize_lm_head(params: ServingParams, bits: int = 8) -> ServingParams:
    """Weight-only-quantized lm_head for serving: INT8 per output column
    (``bits=8``, W8A16, the default) or INT4 with one scale per 128-row group
    and column (any other ``bits``, as in the JAX package: W4A16, opt-in and
    coarser, see its ``tests/test_serving.py::test_w4a16_head_logits_delta``).

    The head is padded before quantization, K to a multiple of 1024 and N to
    a multiple of 512, as the JAX package does for its kernels' tile grid:
    padded columns quantize to zero codes and ``_lm_head_logits`` slices the
    logits back to the true vocabulary.  Prefill and decode share the head,
    so a decode continuation stays consistent with a prefill.
    """
    w = params.lm_head.to(torch.float32)
    pk = (-w.shape[0]) % 1024
    pn = (-w.shape[1]) % 512
    if pk or pn:
        w = F.pad(w, (0, pn, 0, pk))
    return params._replace(lm_head=quantize_w8a16(w) if bits == 8 else quantize_w4a16(w))


def _lm_head_logits(x: torch.Tensor, lm_head, vocab: int | None = None) -> torch.Tensor:
    """Head matmul with f32 logits (f32 accumulation of bf16 products), so
    near-tie argmax decisions match the JAX head.  A ``W8A16Weight`` head
    runs the weight-only INT8 kernel (K5), a ``W4A16Weight`` head the INT4
    one (K13); ``vocab`` slices off their pad columns.  Weight rows past the
    hidden size are K padding and are left out (K13 cuts the groups itself)."""
    xb = x.to(torch.bfloat16)
    if isinstance(lm_head, W8A16Weight):
        if lm_head.codes.shape[0] > xb.shape[1]:
            lm_head = W8A16Weight(lm_head.codes[: xb.shape[1]], lm_head.scale)
        out = w8a16_gemm(xb, lm_head)
    elif isinstance(lm_head, W4A16Weight):
        out = w4a16_gemm(xb, lm_head, out_dtype=torch.float32)
    elif xb.is_cuda:
        out = torch.mm(xb, lm_head, out_dtype=torch.float32)
    else:
        out = xb.to(torch.float32) @ lm_head.to(torch.float32)
    if vocab is not None and out.shape[-1] != vocab:
        out = out[..., :vocab]
    return out


def _attn_block_common(x, lp: "ServingLayerParams", cfg: ModelConfig, spec: QuantSpec, rope):
    """norm + reorder + quant -> qkv projection, shared by prefill and the
    decode fallback -> (q bf16 [T, heads, dh], K ``KVQuant``, V ``KVQuant``).

    K is rotated in f32 before its asymmetric u4 quantization: the cache
    stores post-RoPE codes.  On the fused geometry RoPE and the per-head
    quantization run in the GEMM's epilogue (K7)."""
    n_q = cfg.num_heads * cfg.head_dim
    n_kv = cfg.num_kv_heads * cfg.head_dim
    dh = cfg.head_dim
    cos, sin = rope  # [T, dh]
    h_in = R.rmsnorm_reorder_quant(x, lp.ln_attn, lp.attn_reorder, spec)
    t = x.shape[0]

    if n_q % 512 == 0 and n_kv % 512 == 0 and dh == 128:
        q, kc, kp, vc, vp = packed_w4_gemm_qkv(
            h_in.codes, lp.wqkv.body_packed, lp.wqkv.keeper, h_in.scales, lp.wqkv.scales,
            cos, sin, n_q=n_q, n_kv=n_kv, head_dim=dh,
        )
        return q.reshape(t, cfg.num_heads, dh), R.KVQuant(kc, kp), R.KVQuant(vc, vp)

    qkv = quant_gemm_packed(h_in, lp.wqkv, out_dtype=torch.float32)
    q = apply_rope(qkv[:, :n_q].reshape(t, cfg.num_heads, dh), cos[:, None, :], sin[:, None, :])
    k = apply_rope(qkv[:, n_q : n_q + n_kv].reshape(t, cfg.num_kv_heads, dh), cos[:, None, :], sin[:, None, :])
    kq = R.quantize_kv_asym(k)
    vq = R.quantize_kv_asym(qkv[:, n_q + n_kv :].reshape(t, cfg.num_kv_heads, dh))
    return q.to(torch.bfloat16), kq, vq


def _rms_rstd(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm reciprocal std, passed into the fused qkv kernel's prologue."""
    return rms_rstd(x, eps)


def _post_attn(x, attn_out, lp: ServingLayerParams, spec: QuantSpec, gather=None):
    """reorder+quant -> o_proj -> residual; then the MLP block.

    ``gather``: under tensor parallelism, the all-gather of every
    column-sharded product and of the local heads' attention output
    (identity when None).  The quantizers always see whole rows, so group
    boundaries and the keeper block are the single device's and the TP
    result is bitwise the single device's; the fused kernels run only when
    ``gather`` is None.

    Behind ``_fused_oproj_ok`` the half-layer runs as fused kernels and only
    the norm statistic stays outside them: o_proj with the reorder gather and
    the quantization in front and the residual add behind (K9), then, behind
    ``_fused_mlp_ok``, the whole MLP block (K10; its prologue gathers the
    hidden and runs the RMSNorm with the pre-gathered weight, exact because
    rms statistics do not depend on the channel order).  A geometry K10 does
    not take keeps the fused o_proj and the unfused MLP."""
    g = gather or (lambda v: v)
    if gather is None and _fused_oproj_ok(x.shape, lp, spec):
        x = packed_w4_gemm_fused_in(attn_out, lp.wo, resid=x, abits=spec.abits, a_clip=spec.a_clip_ratio,
                                    reorder=lp.o_reorder)
        if _fused_mlp_ok(x.shape, lp, spec):
            return fused_mlp_packed(
                x, x, lp.wgateup, lp.wdown, norm_w=lp.ln_mlp_g, rstd=_rms_rstd(x),
                abits=spec.abits, a_clip=spec.a_clip_ratio, reorder=lp.mlp_reorder,
            )
    else:
        a_in = R.reorder_quant(g(attn_out), lp.o_reorder, spec)
        x = x + g(quant_gemm_packed(a_in, lp.wo))
    m_in = R.rmsnorm_reorder_quant(x, lp.ln_mlp, lp.mlp_reorder, spec)
    gu = quant_gemm_packed(m_in, lp.wgateup, out_dtype=torch.float32)
    inter = gu.shape[1] // 2
    act = F.silu(gu[:, :inter]) * gu[:, inter:]  # float32, this rank's columns
    d_in = quantize_activation_packed(g(act), spec)
    return x + g(quant_gemm_packed(d_in, lp.wdown))


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


_OFF_VALUES = ("", "0", "false", "no", "off")


def _env_flag(name: str) -> bool:
    """An environment switch, parsed: unset, empty, ``0``, ``false``, ``no``
    and ``off`` (any case) are off, anything else is on."""
    return os.environ.get(name, "").strip().lower() not in _OFF_VALUES


def _fused_mlp_enabled() -> bool:
    """The fused o_proj / MLP kernels (K9, K10) are opt-in:
    ``ATOM_TPU_FUSED_MLP=1`` switches them on, ``ATOM_TPU_NO_FUSED_MLP=1``
    forces them off.  The values are parsed, so ``ATOM_TPU_FUSED_MLP=0`` (or
    empty, or ``false``) is off; the JAX package tests only whether the
    variable is set and reads ``0`` as on, which the port does not copy."""
    if _env_flag("ATOM_TPU_NO_FUSED_MLP"):
        return False
    return _env_flag("ATOM_TPU_FUSED_MLP")


def _fused_oproj_ok(x_shape, lp: ServingLayerParams, spec: QuantSpec) -> bool:
    """Gate of the fused-in o_proj GEMM (K9): switched on, a decode batch of
    at most 32 rows (above that every further 32-row tile streams the weights
    again, so prefill and the mixed step keep the unfused GEMMs), the
    activation scheme the prologue implements, and at most 112 body groups."""
    m = x_shape[0]
    n_q = 2 * lp.wo.body_packed.shape[0] + 128  # o_proj input width
    return _fused_mlp_enabled() and m <= 32 and _fused_spec_ok(spec) and (n_q - 128) // 128 <= 112


def _fused_mlp_ok(x_shape, lp: ServingLayerParams, spec: QuantSpec) -> bool:
    """Gate of the fused MLP kernel (K10): as ``_fused_oproj_ok``, on a
    geometry ``fused_mlp_supported`` takes."""
    m, d = x_shape
    inter = lp.wgateup.body_packed.shape[1] // 2
    return (
        _fused_mlp_enabled()
        and m <= 32
        and _fused_spec_ok(spec)
        and fused_mlp_supported(d, inter, spec.keeper, spec.act_group_size)
    )


def _attn_block_decode_ring(x, lp: ServingLayerParams, cfg: ModelConfig, spec: QuantSpec, rope, hot: HotKV, row: int):
    """Decode attention input block -> q [B, heads, dh], with this step's
    K/V stored into the hot ring at column ``row`` in place: from inside the
    fused qkv kernel (K2, or K8 where the spec is not the one K2's prologue
    quantizes for), or through ``_attn_block_common`` + ``write_hot`` off the
    fused geometry."""
    n_q = cfg.num_heads * cfg.head_dim
    n_kv = cfg.num_kv_heads * cfg.head_dim
    dh = cfg.head_dim
    b, d = x.shape
    if not (n_q % 512 == 0 and n_kv % 512 == 0 and dh == 128 and b % 32 == 0):
        q, kq, vq = _attn_block_common(x, lp, cfg, spec, rope)
        write_hot(hot, row, kq, vq)
        return q

    cos, sin = rope
    if _fused_spec_ok(spec) and d % 128 == 0 and (d - 128) // 128 <= 112:
        y = torch.index_select(x, -1, lp.attn_reorder)
        q = packed_w4_gemm_qkv_ring_fused(
            y, lp.ln_attn_g, lp.wqkv.body_packed, lp.wqkv.keeper, lp.wqkv.scales,
            cos, sin, hot.k_codes, hot.prm, hot.v_codes, row,
            n_q=n_q, n_kv=n_kv, head_dim=dh, abits=spec.abits, a_clip=spec.a_clip_ratio,
            rstd=_rms_rstd(x),
        )
        return q.reshape(b, cfg.num_heads, dh)

    h_in = R.rmsnorm_reorder_quant(x, lp.ln_attn, lp.attn_reorder, spec)
    q = packed_w4_gemm_qkv_ring(
        h_in.codes, lp.wqkv.body_packed, lp.wqkv.keeper, h_in.scales, lp.wqkv.scales,
        cos, sin, hot.k_codes, hot.prm, hot.v_codes, row, n_q=n_q, n_kv=n_kv, head_dim=dh,
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


def _flush_plan(state: ServingState, page_table, seq_lens, flush: bool):
    """Bookkeeping of a ring flush, shared by the decode and the mixed step ->
    (``flush_hot_ring``'s arguments after the ring and its row, or None; the new
    ``flushed`` counts).  On a flushing step every active sequence's pending
    block [flushed, lens) goes to the one or two pages it spans."""
    if not flush:
        return None, state.flushed
    w = state.hot[0].window
    s_page = state.pages[0].page_size
    max_pg = page_table.shape[1]
    active = (seq_lens > 0) & (seq_lens > state.flushed)
    page_lo = torch.div(seq_lens - w, s_page, rounding_mode="floor")  # may be negative
    slot0 = page_lo * s_page
    o_lane = seq_lens - w - slot0  # in [0, S)

    def tbl(idx):
        return torch.gather(page_table, 1, idx.clamp(0, max_pg - 1)[:, None].long())[:, 0]

    pg_a = torch.where(active & (page_lo >= 0), tbl(page_lo), 0)
    pg_b = torch.where(active & ((page_lo + 1) * s_page < seq_lens), tbl(page_lo + 1), 0)
    return (pg_a, pg_b, slot0, o_lane, state.flushed, seq_lens), torch.where(active, seq_lens, state.flushed)


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
    attn_block_fn=None,
    post_attn_fn=None,
    gather=None,
):
    """Layer stack of one decode step -> (final-norm hidden [B, D], state).

    ``flush`` must be True exactly when the ring wraps this step: every
    active sequence's pending block [flushed, lens) then moves to its pages.

    ``cfg`` holds the per-rank head counts under tensor parallelism, and
    ``gather`` all-gathers the column-sharded products (see ``_post_attn``).

    ``attn_block_fn(x, lp, layer, rope, hot, row) -> (q, hot')`` and
    ``post_attn_fn(x, attn, lp, layer, gather) -> x'`` replace the base
    blocks (LoRA serving adds its adapter deltas there, ``serving/lora.py``).
    The flush and the attention read the ring the hook returns.  None keeps
    the base path.
    """
    b = ids.shape[0]
    dh = cfg.head_dim
    x = _embed_lookup(params.embed, ids)
    pos = torch.clamp_min(seq_lens - 1, 0)
    cos, sin = rope_tables(pos, dh, cfg.rope_theta)

    w = state.hot[0].window
    row = state.row
    flush_args, flushed_new = _flush_plan(state, page_table, seq_lens, flush)
    n_hot = seq_lens - flushed_new  # ring-resident suffix per sequence

    new_hot = []
    for l, lp in enumerate(params.layers):
        if attn_block_fn is None:
            hot = state.hot[l]
            q = _attn_block_decode_ring(x, lp, cfg, spec, (cos, sin), hot, row)
        else:
            q, hot = attn_block_fn(x, lp, l, (cos, sin), state.hot[l], row)
        new_hot.append(hot)
        if flush:
            flush_hot_ring(state.pages[l], hot, row, *flush_args)
        attn = paged_ring_decode_attention(q, state.pages[l], page_table, flushed_new, hot, n_hot, row)
        attn = attn.reshape(b, cfg.num_heads * dh)
        x = _post_attn(x, attn, lp, spec, gather) if post_attn_fn is None else post_attn_fn(x, attn, lp, l, gather)

    new_state = ServingState(pages=state.pages, hot=new_hot, row=(row + 1) % w, flushed=flushed_new)
    return rmsnorm(x, params.final_norm, cfg.norm_eps), new_state


@torch.no_grad()
def decode_step(params, state, ids, page_table, seq_lens, cfg: ModelConfig, spec: QuantSpec, flush: bool = False):
    """One continuous-batching decode step -> (next_ids int32 [B], state)."""
    x, new_state = decode_hidden(params, state, ids, page_table, seq_lens, cfg, spec, flush=flush)
    logits = _lm_head_logits(x, params.lm_head, cfg.vocab_size)
    return torch.argmax(logits, dim=-1).to(torch.int32), new_state


_NEG_INF_PREFILL = -1e30

# prompts longer than this use the blocked (online-softmax) prefill attention
PREFILL_SCAN_THRESHOLD = 2048
PREFILL_KEY_BLOCK = 1024
# prompts longer than this use the flash-prefill kernel (K12) instead; off by
# default, as in the JAX package, whose tests and scripts lower it
PREFILL_KERNEL_THRESHOLD = 10**9


def causal_code_attention(
    q: torch.Tensor,  # [Tq, HQ, D] bf16/f32 (RoPE'd)
    kq,  # KVQuant over the full key range [Tk, Hkv, ...]
    vq,
    groups: int,
    sm_scale: float,
    row_pos: torch.Tensor | None = None,  # int [Tq] global query positions
    key_block: int = 0,
    kernel: bool = False,
) -> torch.Tensor:
    """Causal affine-code attention -> attn [Tq, HQ*D] bf16.

    The prefill attention core: f32 q times raw u4 K codes with the affine
    correction, f32 softmax, V dequantization folded into the probabilities:
    the numerics the decode kernel reproduces, so decode continuations match
    prefill predictions.  Plain PyTorch, as the JAX version is plain XLA.

    ``key_block == 0``: one-pass softmax materialising [HQ, Tq, Tk] scores.
    ``key_block > 0``: online softmax over key blocks, O(Tq * key_block)
    live memory.  ``kernel``: the flash kernel K12, which takes ``row_pos`` as
    contiguous by contract (its first entry + arange).  It exists for head_dim
    128 only; asked for at another head_dim this raises (the JAX package
    takes the default path there without saying so), while ``prefill_hidden``
    asks for it only at 128.
    """
    tq, hq, dh = q.shape
    tk = kq.codes.shape[0]
    dev = q.device
    if kernel and dh != 128:
        raise ValueError(f"causal_code_attention(kernel=True): the flash kernel needs head_dim 128, got {dh}")
    if kernel:
        off = 0 if row_pos is None else int(row_pos[0])
        return flash_code_attention(
            q.to(torch.bfloat16), kq.codes, kq.params, vq.codes, vq.params, groups, sm_scale,
            row_offset=off, offset_max=0 if row_pos is None else max(tk - tq, 0),
        )
    if row_pos is None:
        row_pos = torch.arange(tq, device=dev)
    qf = q.to(torch.float32)
    q_sum = qf.sum(dim=2)  # [Tq, HQ]
    k_codes = kq.codes.repeat_interleave(groups, dim=1).to(torch.float32)  # [Tk, HQ, D]
    k_prm = kq.params.repeat_interleave(groups, dim=1)  # [Tk, HQ, 2]
    v_codes = vq.codes.repeat_interleave(groups, dim=1).to(torch.float32)
    v_prm = vq.params.repeat_interleave(groups, dim=1)

    if key_block == 0 or key_block >= tk:
        dot = torch.einsum("qhd,khd->hqk", qf, k_codes)
        k_scale = k_prm[:, :, 0].T[:, None, :]  # [HQ, 1, Tk]
        k_zero = k_prm[:, :, 1].T[:, None, :]
        scores = (dot * k_scale + q_sum.T[:, :, None] * k_zero) * sm_scale
        visible = torch.arange(tk, device=dev)[None, :] <= row_pos[:, None]
        mask = torch.where(visible, 0.0, torch.finfo(torch.float32).min)[None]
        probs = torch.softmax(scores + mask, dim=-1)
        pw = probs * v_prm[:, :, 0].T[:, None, :]
        attn = torch.einsum("hqk,khd->qhd", pw, v_codes)
        attn = attn + torch.einsum("hqk,kh->qh", probs, v_prm[:, :, 1])[..., None]
        return attn.to(torch.bfloat16).reshape(tq, hq * dh)

    while tk % key_block:  # largest power-of-2 fraction that divides Tk
        key_block //= 2
        if key_block < 8:
            key_block = tk
            break

    acc = torch.zeros((hq, tq, dh), dtype=torch.float32, device=dev)
    m = torch.full((hq, tq, 1), _NEG_INF_PREFILL, dtype=torch.float32, device=dev)
    l = torch.zeros((hq, tq, 1), dtype=torch.float32, device=dev)
    for k0 in range(0, tk, key_block):
        blk = slice(k0, k0 + key_block)
        kp, vp = k_prm[blk], v_prm[blk]
        dot = torch.einsum("qhd,khd->hqk", qf, k_codes[blk])
        k_scale = kp[:, :, 0].T[:, None, :]  # [HQ, 1, kb]
        k_zero = kp[:, :, 1].T[:, None, :]
        scores = (dot * k_scale + q_sum.T[:, :, None] * k_zero) * sm_scale
        valid = ((k0 + torch.arange(key_block, device=dev))[None, :] <= row_pos[:, None])[None]
        scores = torch.where(valid, scores, _NEG_INF_PREFILL)
        m_new = torch.maximum(m, scores.amax(dim=2, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(scores - m_new), 0.0)
        l = l * alpha + p.sum(dim=2, keepdim=True)
        pv = torch.einsum("hqk,khd->hqd", p * vp[:, :, 0].T[:, None, :], v_codes[blk])
        z = torch.einsum("hqk,kh->hq", p, vp[:, :, 1])[..., None]
        acc = acc * alpha + pv + z
        m = m_new
    attn = acc / torch.clamp_min(l, 1e-20)  # [HQ, Tq, D]
    return attn.to(torch.bfloat16).transpose(0, 1).reshape(tq, hq * dh)


@torch.no_grad()
def prefill_hidden(
    params: ServingParams,
    pages: List[KVPages],
    ids: torch.Tensor,  # int32 [T]
    table_row: torch.Tensor,  # int32 [max_pages]
    cfg: ModelConfig,
    spec: QuantSpec,
    attn_block_fn=None,
    post_attn_fn=None,
    gather=None,
    positions=None,
    kv_gather=None,
):
    """Layer stack of a prefill -> (final-norm hidden [T, D], pages).

    The sequence's K/V land in its pages (in place); attention runs over the
    just-quantized post-RoPE codes with the decode kernel's numerics.
    ``attn_block_fn(x, lp, layer, rope) -> (q, kq, vq)`` and
    ``post_attn_fn(x, attn, lp, layer, gather)`` replace the base blocks and
    ``gather`` all-gathers the column-sharded products, as in
    ``decode_hidden``.  Sequence parallelism (``serving/sp.py``) passes the
    rows' global ``positions`` [T] and ``kv_gather(kq) -> kq`` over every
    rank's rows: the pages and the attention then take the gathered keys, and
    the attention's path is chosen by their count."""
    t = ids.shape[0]
    dh = cfg.head_dim
    x = _embed_lookup(params.embed, ids)  # [T, D]
    cos, sin = rope_tables(torch.arange(t, device=ids.device) if positions is None else positions, dh, cfg.rope_theta)
    for l, lp in enumerate(params.layers):
        if attn_block_fn is None:
            q, kq, vq = _attn_block_common(x, lp, cfg, spec, (cos, sin))
        else:
            q, kq, vq = attn_block_fn(x, lp, l, (cos, sin))
        if kv_gather is not None:
            kq, vq = kv_gather(kq), kv_gather(vq)
        append_kv_prefill_kernel(pages[l], kq, vq, table_row)
        tk = kq.codes.shape[0]
        key_block = PREFILL_KEY_BLOCK if tk > PREFILL_SCAN_THRESHOLD else 0
        use_kernel = tk > PREFILL_KERNEL_THRESHOLD and dh == 128
        attn = causal_code_attention(q, kq, vq, cfg.kv_groups, dh**-0.5, row_pos=positions, key_block=key_block,
                                     kernel=use_kernel)
        del q, kq, vq  # the one-pass scores and f32 code copies are per layer
        x = _post_attn(x, attn, lp, spec, gather) if post_attn_fn is None else post_attn_fn(x, attn, lp, l, gather)
    return rmsnorm(x, params.final_norm, cfg.norm_eps), pages


@torch.no_grad()
def prefill_step(
    params: ServingParams,
    state: ServingState,
    ids: torch.Tensor,  # int32 [T] — bucket-padded prompt
    table_row: torch.Tensor,  # int32 [max_pages] — this sequence's pages
    true_len: int,
    slot: int,  # this sequence's batch slot
    cfg: ModelConfig,
    spec: QuantSpec,
):
    """Prefill one fresh sequence -> (first generated token, 0-dim int32 on
    the device; state).  The whole prompt lands in pages; the slot's flushed
    count becomes the prompt length, so decode's first ring flush leaves the
    page-resident prefix alone.  The ring and ``row`` are untouched."""
    x, pages = prefill_hidden(params, state.pages, ids, table_row, cfg, spec)
    last = x[max(true_len - 1, 0)]
    logits = _lm_head_logits(last[None], params.lm_head, cfg.vocab_size)[0]
    flushed = state.flushed.clone()
    flushed[slot] = true_len
    new_state = ServingState(pages=pages, hot=state.hot, row=state.row, flushed=flushed)
    return torch.argmax(logits).to(torch.int32), new_state


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


# ---------------------------------------------------------------------------
# Mixed prefill+decode step (chunked prefill riding the decode batch)
# ---------------------------------------------------------------------------
#
# Prompts are processed in page-size chunks, each chunk concatenated onto the
# decode batch's token rows.  The GEMMs are weight-bound at decode batch
# sizes, so the chunk's rows ride the same weight reads; decode sequences
# keep stepping every iteration instead of waiting through a whole prompt.


def _chunk_prefix_attention(q_chunk, pages: KVPages, table_row, prefix_len):
    """Chunk queries against the page-resident prefix (``prefix_len``: int32
    [1] on the device) -> (out f32 [C, HQ, D] normalised, m [C, HQ], l [C, HQ]).

    All C queries share the page walk: they enter the paged kernel (K11) as
    one batch row with ``G * C`` query rows per kv head, row
    ``h * (G * C) + g * C + i`` being chunk query i of q-head ``h * G + g``."""
    c, hq, d = q_chunk.shape
    qr = q_chunk.transpose(0, 1).reshape(1, hq * c, d).contiguous()
    out, m, l = paged_decode_attention_rotated(
        qr, pages, table_row[None], prefix_len, out_dtype=torch.float32, return_state=True
    )
    return out.reshape(hq, c, d).transpose(0, 1), m.reshape(hq, c).T, l.reshape(hq, c).T


def _chunk_self_attention(q_chunk, kq, vq, chunk_len: int, groups: int, sm_scale: float):
    """Causal dense attention of the chunk over its own just-quantized K/V
    -> (out f32 [C, HQ, D] unnormalised, m [C, HQ], l [C, HQ]) for merging.
    The affine-code numerics of ``prefill_hidden``; rows and columns from
    ``chunk_len`` on are masked padding.  Plain PyTorch, as the JAX version
    is plain XLA."""
    c = q_chunk.shape[0]
    qf = q_chunk.to(torch.float32)  # [C, HQ, D]
    k_codes = kq.codes.repeat_interleave(groups, dim=1).to(torch.float32)
    k_prm = kq.params.repeat_interleave(groups, dim=1)  # [C, HQ, 2]
    dot = torch.einsum("qhd,khd->hqk", qf, k_codes)
    q_sum = qf.sum(dim=2)  # [C, HQ]
    scores = (dot * k_prm[:, :, 0].T[:, None, :] + q_sum.T[:, :, None] * k_prm[:, :, 1].T[:, None, :]) * sm_scale
    pos = torch.arange(c, device=q_chunk.device)
    causal = ((pos[None, :] <= pos[:, None]) & (pos[None, :] < chunk_len))[None]
    scores = torch.where(causal, scores, -1e30)  # [HQ, C, C]
    m = scores.amax(dim=2)  # [HQ, C]
    p = torch.where(causal, torch.exp(scores - m[:, :, None]), 0.0)
    l = p.sum(dim=2)
    v_prm = vq.params.repeat_interleave(groups, dim=1)
    v_codes = vq.codes.repeat_interleave(groups, dim=1).to(torch.float32)
    out = torch.einsum("hqk,khd->qhd", p * v_prm[:, :, 0].T[:, None, :], v_codes)
    out = out + torch.einsum("hqk,kh->qh", p, v_prm[:, :, 1])[..., None]
    return out, m.T, l.T


@torch.no_grad()
def mixed_step(
    params: ServingParams,
    state: ServingState,
    ids: torch.Tensor,  # int32 [B] — decode tokens (idle rows: 0)
    page_table: torch.Tensor,  # int32 [B, max_pages]
    seq_lens: torch.Tensor,  # int32 [B] — including the incoming token; 0 = idle
    chunk_ids: torch.Tensor,  # int32 [C] — prompt chunk, C == page_size
    chunk_table_row: torch.Tensor,  # int32 [max_pages] — the admitted sequence's pages
    pos0: int,  # chunk start, a multiple of C
    chunk_len: int,  # valid tokens in this chunk
    chunk_slot: int,  # the admitted sequence's batch slot
    cfg: ModelConfig,
    spec: QuantSpec,
    flush: bool = False,
):
    """One decode step for the whole batch plus one prefill chunk.

    Returns (next_ids int32 [B], chunk_tok 0-dim int32, state).  ``chunk_tok``
    is the argmax after the chunk's last valid token, meaningful only on the
    prompt's final chunk (the request's first generated token)."""
    b = ids.shape[0]
    dh = cfg.head_dim
    s_page = state.pages[0].page_size
    c = chunk_ids.shape[0]
    if c != s_page:
        raise ValueError(f"mixed_step: the chunk size {c} must equal the page size {s_page} (aligned appends)")
    groups = cfg.kv_groups
    sm_scale = dh**-0.5
    dev = ids.device

    x = torch.cat([_embed_lookup(params.embed, ids), _embed_lookup(params.embed, chunk_ids)])  # [B+C, D]
    pos_dec = torch.clamp_min(seq_lens - 1, 0)
    pos_all = torch.cat([pos_dec, pos0 + torch.arange(c, dtype=pos_dec.dtype, device=dev)])
    cos, sin = rope_tables(pos_all, dh, cfg.rope_theta)

    w = state.hot[0].window
    row = state.row
    flush_args, flushed_new = _flush_plan(state, page_table, seq_lens, flush)
    n_hot = seq_lens - flushed_new
    chunk_page = chunk_table_row[pos0 // s_page : pos0 // s_page + 1]
    prefix_len = torch.full((1,), pos0, dtype=torch.int32, device=dev)

    for l_i, lp in enumerate(params.layers):
        q, kq, vq = _attn_block_common(x, lp, cfg, spec, (cos, sin))
        q_dec, q_chk = q[:b], q[b:]
        kq_chk = R.KVQuant(kq.codes[b:], kq.params[b:])
        vq_chk = R.KVQuant(vq.codes[b:], vq.params[b:])

        hot_l = write_hot(state.hot[l_i], row, R.KVQuant(kq.codes[:b], kq.params[:b]),
                          R.KVQuant(vq.codes[:b], vq.params[:b]))
        pg = state.pages[l_i]
        if flush:
            flush_hot_ring(pg, hot_l, row, *flush_args)

        # decode rows: pages (K11) + ring, merged
        out1, m1, l1 = paged_decode_attention_rotated(
            q_dec.contiguous(), pg, page_table, flushed_new, out_dtype=torch.float32, return_state=True
        )
        out2, m2, l2 = hot_attention(q_dec, hot_l, n_hot, row, sm_scale)
        attn_dec = merge_attention(out1, m1, l1, out2, m2, l2).reshape(b, cfg.num_heads * dh)

        # chunk rows: page-resident prefix (K11) + the chunk itself, merged
        po, pm, pln = _chunk_prefix_attention(q_chk, pg, chunk_table_row, prefix_len)
        so, sm_, sl = _chunk_self_attention(q_chk, kq_chk, vq_chk, chunk_len, groups, sm_scale)
        attn_chk = merge_attention(po, pm, pln, so, sm_, sl).reshape(c, cfg.num_heads * dh)

        # whole-page append of the chunk's K/V (chunk == page, aligned)
        append_kv_prefill_kernel(pg, kq_chk, vq_chk, chunk_page)
        del q, kq, vq, so, sm_, sl  # the chunk's [HQ, C, C] scores are per layer
        x = _post_attn(x, torch.cat([attn_dec, attn_chk]), lp, spec)

    hidden = rmsnorm(x, params.final_norm, cfg.norm_eps)
    last_chunk_row = b + max(chunk_len - 1, 0)
    head_rows = torch.cat([hidden[:b], hidden[last_chunk_row][None]])
    logits = _lm_head_logits(head_rows, params.lm_head, cfg.vocab_size)
    next_ids = torch.argmax(logits[:b], dim=-1).to(torch.int32)
    chunk_tok = torch.argmax(logits[b]).to(torch.int32)

    flushed = flushed_new.clone()
    flushed[chunk_slot] = pos0 + chunk_len
    new_state = ServingState(pages=state.pages, hot=state.hot, row=(row + 1) % w, flushed=flushed)
    return next_ids, chunk_tok, new_state


def make_step_fns(params: ServingParams, cfg: ModelConfig, spec: QuantSpec):
    """(prefill_fn, decode_fn) closures with the engine's calling convention.
    ``decode_fn`` counts its calls: every W-th one flushes the ring."""

    def prefill_fn(state, ids, table_row, true_len, slot):
        return prefill_step(params, state, ids, table_row, true_len, slot, cfg, spec)

    counter = {"n": 0}

    def decode_fn(state, ids, page_table, seq_lens):
        counter["n"] += 1
        flush = counter["n"] % HOT_W == 0
        return decode_step(params, state, ids, page_table, seq_lens, cfg, spec, flush=flush)

    return prefill_fn, decode_fn


def make_mixed_step_fns(params: ServingParams, cfg: ModelConfig, spec: QuantSpec):
    """(prefill_fn, decode_fn, chunk_fn) for the mixed-scheduling engine.

    ``decode_fn`` and ``chunk_fn`` share the ring-step counter: a mixed step
    writes the decode ring and advances ``row`` exactly like a decode step,
    so the W-th call of either kind runs the flush variant."""
    prefill_fn, _ = make_step_fns(params, cfg, spec)
    counter = {"n": 0}

    def flush_now():
        counter["n"] += 1
        return counter["n"] % HOT_W == 0

    def decode_fn(state, ids, page_table, seq_lens):
        return decode_step(params, state, ids, page_table, seq_lens, cfg, spec, flush=flush_now())

    def chunk_fn(state, ids, page_table, seq_lens, chunk_ids, chunk_table_row, pos0, chunk_len, chunk_slot):
        return mixed_step(
            params, state, ids, page_table, seq_lens, chunk_ids, chunk_table_row, pos0, chunk_len, chunk_slot,
            cfg, spec, flush=flush_now(),
        )

    return prefill_fn, decode_fn, chunk_fn
