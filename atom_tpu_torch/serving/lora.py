"""Multi-adapter LoRA serving on the W4A4 stack (``atom_tpu/serving/lora.py``).

Every request in the continuous batch may carry its own rank-r adapter,
applied at the seven projection sites (q, k, v, o, gate, up, down) on the
unquantized activations: the base weights stay 4-bit (K1), the adapters dense
bf16.  A site's delta is ``x @ wa[idx].T @ wb[idx].T * scale`` in float32:
one gather of each row's adapter along the store's first axis and two
batched products, as the JAX package computes it with ``take`` and
``einsum``.  No Pallas kernel computes it there, so plain PyTorch (a float32
``bmm``; TF32 stays off) is the port.

LoRA takes the unfused qkv path: the q/k/v deltas land before RoPE and the
K/V quantization, which the fused ring kernel (K2) runs inside itself.  The
post-attention half runs K1 four times and never the fused kernels (K9,
K10).  The deltas are float32, so the residual stream turns float32 at layer
0's o_proj and stays so, as in the JAX package.

``make_lora_step_fns`` gives ``TextGenEngine(lora=True)`` its step functions:
``make_step_fns``'s signatures plus a trailing adapter argument (a Python int
for a prefill, an int32 [B] tensor of per-slot adapters for a decode step).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from atom_tpu_torch.config import QuantSpec
from atom_tpu_torch.models.configs import ModelConfig
from atom_tpu_torch.models.nn import apply_rope, rmsnorm
from atom_tpu_torch.ops import reference as R
from atom_tpu_torch.ops.formats import quantize_activation_packed
from atom_tpu_torch.ops.gemm_packed import quant_gemm_packed
from atom_tpu_torch.ops.kv_hot import HOT_W, write_hot
from atom_tpu_torch.ops.runtime import resolve_device
from atom_tpu_torch.serving.model import (
    ServingParams,
    ServingState,
    _lm_head_logits,
    decode_hidden,
    prefill_hidden,
)


class LoraSite(NamedTuple):
    """Stacked adapters of one projection site."""

    wa: torch.Tensor  # bf16 [A, L, r, d_in]   (x @ wa.T -> rank space)
    wb: torch.Tensor  # bf16 [A, L, d_out, r]  (rank space @ wb.T -> out)


class LlamaLora(NamedTuple):
    """Per-site adapter stores."""

    q: LoraSite
    k: LoraSite
    v: LoraSite
    o: LoraSite
    gate: LoraSite
    up: LoraSite
    down: LoraSite


def lora_site_dims(cfg: ModelConfig) -> dict:
    """Site name -> (d_in, d_out), in ``LlamaLora``'s field order."""
    d = cfg.hidden_size
    n_q = cfg.num_heads * cfg.head_dim
    n_kv = cfg.num_kv_heads * cfg.head_dim
    inter = cfg.intermediate_size
    return {
        "q": (d, n_q), "k": (d, n_kv), "v": (d, n_kv), "o": (n_q, d),
        "gate": (d, inter), "up": (d, inter), "down": (inter, d),
    }


@torch.no_grad()
def init_llama_lora(
    cfg: ModelConfig,
    capacity: int,
    rank: int,
    seed: int = 0,
    device=None,
    dtype=torch.bfloat16,
    zero_b: bool = False,
) -> LlamaLora:
    """Random adapter store ([A, L, ...] per site) from a seeded
    ``torch.Generator``: ``wa`` ~ N(0, 1/d_in), ``wb`` ~ N(0, 1/r).
    ``zero_b=True`` zeroes every ``wb``: the standard LoRA init, and a
    delta-free store for tests."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_layers = cfg.num_layers

    def normal(shape, std):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev).to(dtype) * std

    sites = {}
    for name, (d_in, d_out) in lora_site_dims(cfg).items():
        wa = normal((capacity, n_layers, rank, d_in), d_in**-0.5)
        if zero_b:
            wb = torch.zeros((capacity, n_layers, d_out, rank), dtype=dtype, device=dev)
        else:
            wb = normal((capacity, n_layers, d_out, rank), rank**-0.5)
        sites[name] = LoraSite(wa=wa, wb=wb)
    return LlamaLora(**sites)


def add_lora(x: torch.Tensor, site: LoraSite, idx, layer: int, scale: float) -> torch.Tensor:
    """``delta[i] = x[i] @ wa[idx[i], layer].T @ wb[idx[i], layer].T * scale``
    in float32 -> float32 [B, d_out] (the caller adds it to the base GEMM's
    output).  ``idx``: an int32 [B] tensor of per-row adapters, or one adapter
    for every row (a Python int or a 0-dim tensor, the prefill form)."""
    xf = x.to(torch.float32)
    if not isinstance(idx, torch.Tensor) or idx.ndim == 0:
        wa = site.wa[idx, layer].to(torch.float32)  # [r, d_in]
        wb = site.wb[idx, layer].to(torch.float32)  # [d_out, r]
        return (xf @ wa.T) @ wb.T * scale
    wa = site.wa[idx, layer].to(torch.float32)  # [B, r, d_in]
    wb = site.wb[idx, layer].to(torch.float32)  # [B, d_out, r]
    t = torch.bmm(wa, xf[:, :, None])  # [B, r, 1]
    return torch.bmm(wb, t)[:, :, 0] * scale


class LoraManager:
    """Host-side adapter slot allocator over a ``LlamaLora`` store.

    The free slots are a Python set, as in the JAX package, so ``alloc``
    hands them out in the same order (CPython's set order: for a store's
    small indices, the lowest free one first).  ``load`` writes the store in
    place, so step functions built over it see the new adapter."""

    def __init__(self, store: LlamaLora):
        self.store = store
        self._free = set(range(store.q.wa.shape[0]))

    @property
    def capacity(self) -> int:
        return self.store.q.wa.shape[0]

    def alloc(self) -> int:
        return self._free.pop()

    def free(self, idx: int) -> None:
        if not 0 <= idx < self.capacity or idx in self._free:
            raise ValueError(f"adapter slot {idx} is not allocated")
        self._free.add(idx)

    @torch.no_grad()
    def load(self, idx: int, site_name: str, wa, wb) -> None:
        """Install one site's [L, r, d_in] / [L, d_out, r] adapter weights
        (numpy arrays or tensors, rounded to the store's dtype)."""
        site: LoraSite = getattr(self.store, site_name)
        for dst, src in ((site.wa, wa), (site.wb, wb)):
            src = torch.from_numpy(np.asarray(src)) if not isinstance(src, torch.Tensor) else src
            dst[idx] = src.to(device=dst.device, dtype=dst.dtype)


# ---------------------------------------------------------------------------
# LoRA layer blocks: the base blocks plus the seven deltas
# ---------------------------------------------------------------------------


def _lora_attn_block(x, lp, cfg: ModelConfig, spec: QuantSpec, rope, lw: LlamaLora, idx, layer: int, scale: float):
    """The unfused qkv path (K1 into float32) with the q/k/v deltas added
    before RoPE and the K/V quantization -> (q bf16 [T, heads, dh], K
    ``KVQuant``, V ``KVQuant``).  With zero adapters the deltas are float32
    zeros and this is the base unfused block."""
    n_q = cfg.num_heads * cfg.head_dim
    n_kv = cfg.num_kv_heads * cfg.head_dim
    dh = cfg.head_dim
    cos, sin = rope
    t = x.shape[0]
    xn = rmsnorm(x, lp.ln_attn, cfg.norm_eps)
    h_in = quantize_activation_packed(torch.index_select(xn, -1, lp.attn_reorder), spec)
    qkv = quant_gemm_packed(h_in, lp.wqkv, out_dtype=torch.float32)
    qh = (qkv[:, :n_q] + add_lora(xn, lw.q, idx, layer, scale)).reshape(t, cfg.num_heads, dh)
    kh = (qkv[:, n_q : n_q + n_kv] + add_lora(xn, lw.k, idx, layer, scale)).reshape(t, cfg.num_kv_heads, dh)
    vh = (qkv[:, n_q + n_kv :] + add_lora(xn, lw.v, idx, layer, scale)).reshape(t, cfg.num_kv_heads, dh)
    q = apply_rope(qh, cos[:, None, :], sin[:, None, :]).to(torch.bfloat16)
    k = apply_rope(kh, cos[:, None, :], sin[:, None, :])
    return q, R.quantize_kv_asym(k), R.quantize_kv_asym(vh)


def _lora_post_attn(x, attn_out, lp, spec: QuantSpec, lw: LlamaLora, idx, layer: int, scale: float, norm_eps: float):
    """The unfused post-attention half (four K1 launches) plus the
    o/gate/up/down deltas.  The o delta makes the residual float32."""
    a_in = R.reorder_quant(attn_out, lp.o_reorder, spec)
    x = x + quant_gemm_packed(a_in, lp.wo) + add_lora(attn_out, lw.o, idx, layer, scale)
    xm = rmsnorm(x, lp.ln_mlp, norm_eps)
    m_in = quantize_activation_packed(torch.index_select(xm, -1, lp.mlp_reorder), spec)
    gu = quant_gemm_packed(m_in, lp.wgateup, out_dtype=torch.float32)
    inter = gu.shape[1] // 2
    gate = gu[:, :inter] + add_lora(xm, lw.gate, idx, layer, scale)
    up = gu[:, inter:] + add_lora(xm, lw.up, idx, layer, scale)
    act = F.silu(gate) * up
    d_in = quantize_activation_packed(act, spec)
    return x + quant_gemm_packed(d_in, lp.wdown) + add_lora(act, lw.down, idx, layer, scale)


# ---------------------------------------------------------------------------
# Step functions (a per-slot adapter index threaded through)
# ---------------------------------------------------------------------------


def lora_decode_hidden(params: ServingParams, lw: LlamaLora, state: ServingState, ids, page_table, seq_lens, adapters,
                       cfg: ModelConfig, spec: QuantSpec, scale: float, flush: bool = False):
    """``decode_hidden`` through the LoRA blocks -> (final-norm hidden, state).
    This step's K/V go into the ring (``write_hot``) before the flush (K4)
    and the attention (K3) read it."""

    def attn_fn(x, lp, layer, rope, hot, row):
        q, kq, vq = _lora_attn_block(x, lp, cfg, spec, rope, lw, adapters, layer, scale)
        return q, write_hot(hot, row, kq, vq)

    def post_fn(x, attn, lp, layer, gather):
        return _lora_post_attn(x, attn, lp, spec, lw, adapters, layer, scale, cfg.norm_eps)

    return decode_hidden(params, state, ids, page_table, seq_lens, cfg, spec, flush=flush, attn_block_fn=attn_fn,
                         post_attn_fn=post_fn)


def lora_prefill_hidden(params: ServingParams, lw: LlamaLora, pages, ids, table_row, adapter, cfg: ModelConfig,
                        spec: QuantSpec, scale: float):
    """``prefill_hidden`` through the LoRA blocks, one adapter for every row
    -> (final-norm hidden, pages)."""

    def attn_fn(x, lp, layer, rope):
        return _lora_attn_block(x, lp, cfg, spec, rope, lw, adapter, layer, scale)

    def post_fn(x, attn, lp, layer, gather):
        return _lora_post_attn(x, attn, lp, spec, lw, adapter, layer, scale, cfg.norm_eps)

    return prefill_hidden(params, pages, ids, table_row, cfg, spec, attn_block_fn=attn_fn, post_attn_fn=post_fn)


@torch.no_grad()
def lora_decode_step(
    params: ServingParams,
    lw: LlamaLora,
    state: ServingState,
    ids: torch.Tensor,  # int32 [B]
    page_table: torch.Tensor,  # int32 [B, max_pages]
    seq_lens: torch.Tensor,  # int32 [B] — including the incoming token
    adapters: torch.Tensor,  # int32 [B] — per-slot adapter index
    cfg: ModelConfig,
    spec: QuantSpec,
    scale: float,
    flush: bool = False,
):
    """``decode_step`` with per-request adapters -> (next_ids int32 [B], state)."""
    x, new_state = lora_decode_hidden(params, lw, state, ids, page_table, seq_lens, adapters, cfg, spec, scale,
                                      flush=flush)
    logits = _lm_head_logits(x, params.lm_head, cfg.vocab_size)
    return torch.argmax(logits, dim=-1).to(torch.int32), new_state


@torch.no_grad()
def lora_prefill_step(
    params: ServingParams,
    lw: LlamaLora,
    state: ServingState,
    ids: torch.Tensor,  # int32 [T] — bucket-padded prompt
    table_row: torch.Tensor,  # int32 [max_pages]
    true_len: int,
    slot: int,
    adapter,  # this sequence's adapter: an int or a 0-dim tensor
    cfg: ModelConfig,
    spec: QuantSpec,
    scale: float,
):
    """``prefill_step`` with one adapter for the whole prompt -> (first
    token, 0-dim int32; state)."""
    x, pages = lora_prefill_hidden(params, lw, state.pages, ids, table_row, adapter, cfg, spec, scale)
    last = x[max(true_len - 1, 0)]
    logits = _lm_head_logits(last[None], params.lm_head, cfg.vocab_size)[0]
    flushed = state.flushed.clone()
    flushed[slot] = true_len
    new_state = ServingState(pages=pages, hot=state.hot, row=state.row, flushed=flushed)
    return torch.argmax(logits).to(torch.int32), new_state


@torch.no_grad()
def lora_decode_burst(
    params: ServingParams,
    lw: LlamaLora,
    state: ServingState,
    ids: torch.Tensor,
    page_table: torch.Tensor,  # must cover the burst
    seq_lens: torch.Tensor,  # current lengths, excluding ids
    n_windows: int,
    adapters: torch.Tensor,  # int32 [B]
    cfg: ModelConfig,
    spec: QuantSpec,
    scale: float = 1.0,
):
    """``decode_burst`` with per-request adapters: ``n_windows`` whole ring
    windows, the last step of each flushing.  Returns (ids, state, seq_lens)."""
    w = state.hot[0].window
    for _ in range(n_windows):
        for i in range(w):
            seq_lens = seq_lens + 1
            ids, state = lora_decode_step(params, lw, state, ids, page_table, seq_lens, adapters, cfg, spec, scale,
                                          flush=i == w - 1)
    return ids, state, seq_lens


def make_lora_step_fns(params: ServingParams, lw: LlamaLora, cfg: ModelConfig, spec: QuantSpec, scale: float = 1.0):
    """(prefill_fn, decode_fn) for ``TextGenEngine(lora=True)``:
    ``make_step_fns``'s signatures plus the trailing adapter argument.  Every
    ``HOT_W``-th decode call flushes the ring."""

    def prefill_fn(state, ids, table_row, true_len, slot, adapter):
        return lora_prefill_step(params, lw, state, ids, table_row, true_len, slot, adapter, cfg, spec, scale)

    counter = {"n": 0}

    def decode_fn(state, ids, page_table, seq_lens, adapters):
        counter["n"] += 1
        return lora_decode_step(params, lw, state, ids, page_table, seq_lens, adapters, cfg, spec, scale,
                                flush=counter["n"] % HOT_W == 0)

    return prefill_fn, decode_fn
