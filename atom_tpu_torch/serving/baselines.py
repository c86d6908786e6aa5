"""Baseline serving stacks (``atom_tpu/serving/baselines.py``): bf16, W8A8 and
W4A16, in the same engine harness as the W4A4 stack.

The comparison stacks of the system Atom is measured against: vanilla bf16
serving, SmoothQuant W8A8 and AWQ-style weight-only INT4.  As in the JAX
package they are built the way a performance-minded engineer would build them
without Atom: a dense KV cache per layer [B, maxT, H, Dh], appended at each
sequence's position, and plain attention over the whole ``maxT`` with a length
mask (paging is the W4A4 stack's choice, not forced on the baselines), so the
W4A4-vs-baseline ratio measures the quantization scheme, not a handicapped
strawman.

  * bf16:  bf16 weights, bf16 dense GEMMs with float32 sums, bf16 KV.
  * W8A8:  per-output-channel INT8 weights, dynamic per-token INT8
    activations, exact int32 products (``torch._int_mm`` on the card), 8-bit KV
    codes with a static scale.
  * W4A16: weight-only group-128 INT4 through kernel K13 (``w4a16_gemm``) with
    bf16 activations, bf16 KV.

What differs from the JAX package, none of it in the numbers:
  * the dense KV is updated in place (the JAX steps donate it), and steps
    return the same list;
  * its storage is head-major: ``DenseKV.k`` has the JAX shape [B, maxT, H, Dh]
    but is a view of [B, H, maxT, Dh] memory, so each (sequence, head) is one
    matrix and attention's batched products read the cache where it lies
    instead of through a transposed copy per layer; query heads of a GQA group
    ride their kv head's product instead of a repeated K and V;
  * W8A8 weight codes keep the JAX shape [in, out] stored column by column
    (``column_major``), the layout of the card's fast int8 product.

Step functions share the engine's calling convention; the page-table
arguments are accepted and used only for their seq-len content.  Products
whose sums JAX keeps in float32 run as ``torch.mm``/``torch.bmm`` with a
float32 output on the card and on float32 operands on the CPU (products of
bf16 values are exact there).
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from atom_tpu_torch.models.configs import ModelConfig
from atom_tpu_torch.models.nn import apply_rope, causal_mask, rmsnorm, rope_tables
from atom_tpu_torch.ops.gemm_w4a16 import W4A16Weight, quantize_w4a16, w4a16_gemm
from atom_tpu_torch.ops.runtime import resolve_device
from atom_tpu_torch.quant.core import div_exact
from atom_tpu_torch.serving.model import _embed_lookup, _lm_head_logits


class DenseKV(NamedTuple):
    """Per-layer dense KV cache [B, maxT, H, Dh] (head-major storage)."""

    k: torch.Tensor
    v: torch.Tensor


def _head_major_zeros(batch: int, max_t: int, kv_heads: int, head_dim: int, dtype, device) -> torch.Tensor:
    return torch.zeros((batch, kv_heads, max_t, head_dim), dtype=dtype, device=device).transpose(1, 2)


def make_dense_kv(
    n_layers: int, batch: int, max_t: int, kv_heads: int, head_dim: int, dtype=torch.bfloat16, device=None
) -> List[DenseKV]:
    dev = resolve_device(device)
    return [
        DenseKV(
            _head_major_zeros(batch, max_t, kv_heads, head_dim, dtype, dev),
            _head_major_zeros(batch, max_t, kv_heads, head_dim, dtype, dev),
        )
        for _ in range(n_layers)
    ]


# The w8a8 stack stores 8-bit KV: int8 codes with a STATIC scale (the JAX
# package's analog of its reference's fp8 KV, SmoothQuant-style static scaling
# applied to the cache).  Range +-7.94 covers post-norm K/V magnitudes.
KV8_INV_SCALE = 16.0


def _kv_enc(x: torch.Tensor, dtype) -> torch.Tensor:
    """Encode bf16/f32 K or V rows for storage dtype ``dtype``."""
    if dtype == torch.int8:
        return torch.clamp(torch.round(x.to(torch.float32) * KV8_INV_SCALE), -127, 127).to(torch.int8)
    return x.to(dtype)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 operands with float32 sums and output."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.to(torch.float32) @ b.to(torch.float32)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b`` of bf16 operands with float32 sums and output."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


# ---------------------------------------------------------------------------
# bf16 baseline
# ---------------------------------------------------------------------------


class Bf16Layer(NamedTuple):
    ln_attn: torch.Tensor
    ln_mlp: torch.Tensor
    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    wgate: torch.Tensor
    wup: torch.Tensor
    wdown: torch.Tensor


class Bf16Params(NamedTuple):
    embed: torch.Tensor
    final_norm: torch.Tensor
    lm_head: torch.Tensor
    layers: List[Bf16Layer]


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device).to(torch.bfloat16) * scale


def _init_bf16_layer(gen: torch.Generator, cfg: ModelConfig) -> Bf16Layer:
    d = cfg.hidden_size
    n_q = cfg.num_heads * cfg.head_dim
    n_kv = cfg.num_kv_heads * cfg.head_dim
    inter = cfg.intermediate_size

    def w(i, o):
        return _normal(gen, (i, o), i**-0.5)

    return Bf16Layer(
        ln_attn=torch.ones((d,), dtype=torch.bfloat16, device=gen.device),
        ln_mlp=torch.ones((d,), dtype=torch.bfloat16, device=gen.device),
        wq=w(d, n_q),
        wk=w(d, n_kv),
        wv=w(d, n_kv),
        wo=w(n_q, d),
        wgate=w(d, inter),
        wup=w(d, inter),
        wdown=w(inter, d),
    )


def _init_embed_head(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.hidden_size
    return dict(
        embed=_normal(gen, (cfg.vocab_size, d), 0.02),
        final_norm=torch.ones((d,), dtype=torch.bfloat16, device=gen.device),
        lm_head=_normal(gen, (d, cfg.vocab_size), 0.02),
    )


@torch.no_grad()
def init_bf16_params(cfg: ModelConfig, seed: int = 0, device=None) -> Bf16Params:
    """Random bf16 weights from a seeded ``torch.Generator``: projections times
    ``in ** -0.5``, embedding and head times 0.02, norms of ones."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    head = _init_embed_head(gen, cfg)
    return Bf16Params(**head, layers=[_init_bf16_layer(gen, cfg) for _ in range(cfg.num_layers)])


def _dense_decode_attention(q: torch.Tensor, kv: DenseKV, seq_lens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """q bf16 [B, Hq, Dh]: dense causal attention over the whole cache
    -> bf16 [B, Hq, Dh].

    K is stored POST-RoPE (rotated once at append, like the W4A4 stack), so
    the per-step work is two bf16 products with float32 sums and a float32
    softmax; the probabilities are rounded to bf16 for the second product."""
    b, hq, dh = q.shape
    max_t, hkv = kv.k.shape[1], kv.k.shape[2]
    g = hq // hkv
    # 8-bit codes are read once, as bf16 (exact); their static scale, a power
    # of two, multiplies q and the output instead of every cached value: the
    # same products, exactly (the JAX stack dequantizes inside its einsum)
    scale = 1.0 / KV8_INV_SCALE if kv.k.dtype == torch.int8 else 1.0
    k = kv.k.to(torch.bfloat16).transpose(1, 2).reshape(b * hkv, max_t, dh)  # a view of head-major storage
    v = kv.v.to(torch.bfloat16).transpose(1, 2).reshape(b * hkv, max_t, dh)
    qs = q * scale if scale != 1.0 else q
    scores = _bmm_f32(qs.reshape(b * hkv, g, dh), k.transpose(1, 2)).reshape(b, hq, max_t) * dh**-0.5
    mask = torch.arange(max_t, device=q.device)[None, None, :] < seq_lens[:, None, None]
    scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(torch.bfloat16)
    out = _bmm_f32(probs.reshape(b * hkv, g, max_t), v)
    if scale != 1.0:
        out = out * scale
    return out.to(torch.bfloat16).reshape(b, hq, dh)


def _decode_layer_common(x, lp, matmul, kv: DenseKV, seq_lens, cfg: ModelConfig):
    """One decoder layer of the baseline decode step; ``matmul(x, w)`` is the
    precision-specific GEMM.  This step's K (post-RoPE) and V land in the cache
    at position ``seq_lens - 1``, in place."""
    b = x.shape[0]
    dh = cfg.head_dim
    pos = torch.clamp_min(seq_lens - 1, 0)
    cos, sin = rope_tables(pos, dh, cfg.rope_theta)

    h = rmsnorm(x, lp.ln_attn, cfg.norm_eps)
    q = matmul(h, lp.wq).reshape(b, cfg.num_heads, dh)
    k_new = matmul(h, lp.wk).reshape(b, cfg.num_kv_heads, dh)
    v_new = matmul(h, lp.wv).reshape(b, cfg.num_kv_heads, dh)
    q = apply_rope(q, cos[:, None, :], sin[:, None, :])
    k_new = apply_rope(k_new, cos[:, None, :], sin[:, None, :])
    bidx, pos = torch.arange(b, device=x.device), pos.long()
    kv.k[bidx, pos] = _kv_enc(k_new, kv.k.dtype)
    kv.v[bidx, pos] = _kv_enc(v_new, kv.v.dtype)
    attn = _dense_decode_attention(q, kv, seq_lens, cfg)
    x = x + matmul(attn.reshape(b, -1), lp.wo)
    h = rmsnorm(x, lp.ln_mlp, cfg.norm_eps)
    g = matmul(h, lp.wgate)
    u = matmul(h, lp.wup)
    act = (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(torch.bfloat16)
    return x + matmul(act, lp.wdown), kv


def _bf16_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _mm_f32(x.to(torch.bfloat16), w).to(torch.bfloat16)


@torch.no_grad()
def _decode_step(params, kvs: List[DenseKV], ids, seq_lens, cfg: ModelConfig, matmul):
    x = _embed_lookup(params.embed, ids)
    for lp, kv in zip(params.layers, kvs):
        x, _ = _decode_layer_common(x, lp, matmul, kv, seq_lens, cfg)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = _lm_head_logits(x, params.lm_head)
    return torch.argmax(logits, dim=-1).to(torch.int32), kvs


def _decode_burst(step, params, kvs, ids, seq_lens, n_steps: int, cfg: ModelConfig):
    for _ in range(n_steps):
        seq_lens = seq_lens + 1
        ids, kvs = step(params, kvs, ids, seq_lens, cfg)
    return ids, kvs, seq_lens


def bf16_decode_step(params: Bf16Params, kvs, ids, seq_lens, cfg: ModelConfig):
    """One decode step for B sequences -> (next ids int32 [B], kvs); ``seq_lens``
    includes the incoming token."""
    return _decode_step(params, kvs, ids, seq_lens, cfg, _bf16_matmul)


def bf16_decode_burst(params: Bf16Params, kvs, ids, seq_lens, n_steps: int, cfg: ModelConfig):
    """``n_steps`` decode steps; ``seq_lens`` excludes ``ids`` -> (ids, kvs, seq_lens)."""
    return _decode_burst(bf16_decode_step, params, kvs, ids, seq_lens, n_steps, cfg)


# ---------------------------------------------------------------------------
# W8A8 baseline (SmoothQuant recipe)
# ---------------------------------------------------------------------------


class W8Weight(NamedTuple):
    codes: torch.Tensor  # int8 [in, out]
    scale: torch.Tensor  # f32 [out] (per output channel)


class W8Layer(NamedTuple):
    ln_attn: torch.Tensor
    ln_mlp: torch.Tensor
    wq: W8Weight
    wk: W8Weight
    wv: W8Weight
    wo: W8Weight
    wgate: W8Weight
    wup: W8Weight
    wdown: W8Weight


class W8Params(NamedTuple):
    embed: torch.Tensor
    final_norm: torch.Tensor
    lm_head: torch.Tensor
    layers: List[W8Layer]


_PROJ = ("q", "k", "v", "o", "gate", "up", "down")


def column_major(codes: torch.Tensor) -> torch.Tensor:
    """The same [in, out] codes stored column by column: the operand layout
    the card's int8 tensor-core product (``torch._int_mm``, cuBLASLt) takes
    as it lies; a row-major one takes a slower kernel."""
    return codes.t().contiguous().t()


def _quant_w8(w: torch.Tensor) -> W8Weight:
    w32 = w.to(torch.float32)
    s = torch.clamp_min(div_exact(w32.abs().amax(dim=0), 127.0), 1e-8)
    codes = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return W8Weight(codes=column_major(codes), scale=s)


@torch.no_grad()
def init_w8_params(cfg: ModelConfig, seed: int = 0, device=None) -> W8Params:
    """The bf16 init quantized layer by layer (one bf16 layer is drawn,
    quantized and dropped: the bf16 model never coexists with its copy)."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    head = _init_embed_head(gen, cfg)
    layers = []
    for _ in range(cfg.num_layers):
        lp = _init_bf16_layer(gen, cfg)
        layers.append(W8Layer(lp.ln_attn, lp.ln_mlp, *(_quant_w8(getattr(lp, f"w{n}")) for n in _PROJ)))
        del lp
    return W8Params(**head, layers=layers)


_INT_MM_MIN_ROWS = 17  # torch._int_mm on the card takes more than 16 rows


def _int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 [M, K] and [K, N]: ``torch._int_mm`` on the
    card (a smaller M padded with zero rows to 32), float64 sums on the CPU
    (exact below 2**53)."""
    if not a.is_cuda:
        return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)
    m = a.shape[0]
    if m < _INT_MM_MIN_ROWS:
        return torch._int_mm(F.pad(a, (0, 0, 0, 32 - m)), b)[:m]
    return torch._int_mm(a, b)


def _w8a8_matmul(x: torch.Tensor, w: W8Weight) -> torch.Tensor:
    """Dynamic per-token INT8 activation quant + exact int8 product + dequant
    (the SmoothQuant linear_a8_w8_bfp32_ofp32 pattern)."""
    x32 = x.to(torch.float32)
    s_a = div_exact(torch.clamp_min(x32.abs().amax(dim=-1, keepdim=True), 1e-8), 127.0)
    xq = torch.clamp(torch.round(x32 / s_a), -127, 127).to(torch.int8)
    acc = _int8_mm(xq, w.codes)
    return (acc.to(torch.float32) * s_a * w.scale[None, :]).to(torch.bfloat16)


def w8a8_decode_step(params: W8Params, kvs, ids, seq_lens, cfg: ModelConfig):
    return _decode_step(params, kvs, ids, seq_lens, cfg, _w8a8_matmul)


def w8a8_decode_burst(params: W8Params, kvs, ids, seq_lens, n_steps: int, cfg: ModelConfig):
    return _decode_burst(w8a8_decode_step, params, kvs, ids, seq_lens, n_steps, cfg)


# ---------------------------------------------------------------------------
# W4A16 baseline (AWQ recipe: weight-only INT4, full-precision activations)
# ---------------------------------------------------------------------------


class W4A16Layer(NamedTuple):
    ln_attn: torch.Tensor
    ln_mlp: torch.Tensor
    wq: W4A16Weight
    wk: W4A16Weight
    wv: W4A16Weight
    wo: W4A16Weight
    wgate: W4A16Weight
    wup: W4A16Weight
    wdown: W4A16Weight


class W4A16Params(NamedTuple):
    embed: torch.Tensor
    final_norm: torch.Tensor
    lm_head: torch.Tensor
    layers: List[W4A16Layer]


@torch.no_grad()
def init_w4a16_params(cfg: ModelConfig, seed: int = 0, device=None) -> W4A16Params:
    """The bf16 init quantized layer by layer to group-128 INT4.  Where hidden
    size and kv width sit on the JAX kernel's tile grid (at Llama-2-7B), the
    MLP width is padded to a multiple of 1024 with zero weights, which
    quantize to zero codes and add nothing: gate/up gain zero columns, down
    zero rows (11008 -> 11264 at 7B), as the JAX package pads them."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    d = cfg.hidden_size
    pad_i = -(-cfg.intermediate_size // 1024) * 1024 - cfg.intermediate_size
    if d % 1024 or (cfg.num_kv_heads * cfg.head_dim) % 512:
        pad_i = 0

    def _q(name, w):
        w = w.to(torch.float32)
        if pad_i and name in ("gate", "up"):
            w = F.pad(w, (0, pad_i))
        elif pad_i and name == "down":
            w = F.pad(w, (0, 0, 0, pad_i))
        return quantize_w4a16(w)

    head = _init_embed_head(gen, cfg)
    layers = []
    for _ in range(cfg.num_layers):
        lp = _init_bf16_layer(gen, cfg)
        layers.append(W4A16Layer(lp.ln_attn, lp.ln_mlp, *(_q(n, getattr(lp, f"w{n}")) for n in _PROJ)))
        del lp
    return W4A16Params(**head, layers=layers)


def _w4a16_matmul(x: torch.Tensor, wq: W4A16Weight) -> torch.Tensor:
    return w4a16_gemm(x.to(torch.bfloat16), wq)


def w4a16_decode_step(params: W4A16Params, kvs, ids, seq_lens, cfg: ModelConfig):
    return _decode_step(params, kvs, ids, seq_lens, cfg, _w4a16_matmul)


def w4a16_decode_burst(params: W4A16Params, kvs, ids, seq_lens, n_steps: int, cfg: ModelConfig):
    return _decode_burst(w4a16_decode_step, params, kvs, ids, seq_lens, n_steps, cfg)


# ---------------------------------------------------------------------------
# Prefill + engine adapters (all three stacks)
# ---------------------------------------------------------------------------


def _prefill_layer_common(x, lp, matmul, kv: DenseKV, slot: int, cfg: ModelConfig, cos, sin, mask):
    """One decoder layer of single-sequence prefill; fills the slot's dense-KV
    rows [0, bucket) in place (rows past ``true_len`` hold garbage that decode
    appends overwrite before attention can ever see them).  Attention runs in
    float32 on the float32 K and V, as in the JAX stack."""
    t = x.shape[0]
    dh = cfg.head_dim
    hkv, g = cfg.num_kv_heads, cfg.kv_groups
    h = rmsnorm(x, lp.ln_attn, cfg.norm_eps)
    q = matmul(h, lp.wq).reshape(t, cfg.num_heads, dh)
    k = matmul(h, lp.wk).reshape(t, hkv, dh)
    v = matmul(h, lp.wv).reshape(t, hkv, dh)
    q = apply_rope(q, cos[:, None, :], sin[:, None, :])
    k = apply_rope(k.to(torch.float32), cos[:, None, :], sin[:, None, :])
    kv.k[slot, :t] = _kv_enc(k, kv.k.dtype)
    kv.v[slot, :t] = _kv_enc(v, kv.v.dtype)
    # query heads h*G .. h*G+G-1 ride kv head h's product: [Hkv, G*T, Dh]
    qg = q.to(torch.float32).reshape(t, hkv, g, dh).permute(1, 2, 0, 3).reshape(hkv, g * t, dh)
    scores = torch.bmm(qg, k.permute(1, 2, 0)).reshape(cfg.num_heads, t, t) * dh**-0.5
    probs = torch.softmax(scores + mask[0], dim=-1)  # mask [1, T, T]
    attn = torch.bmm(probs.reshape(hkv, g * t, t), v.to(torch.float32).transpose(0, 1))
    attn = attn.reshape(cfg.num_heads, t, dh).transpose(0, 1).to(torch.bfloat16)
    x = x + matmul(attn.reshape(t, -1), lp.wo)
    h = rmsnorm(x, lp.ln_mlp, cfg.norm_eps)
    gt = matmul(h, lp.wgate)
    u = matmul(h, lp.wup)
    act = (F.silu(gt.to(torch.float32)) * u.to(torch.float32)).to(torch.bfloat16)
    return x + matmul(act, lp.wdown), kv


_MATMULS = {"bf16": _bf16_matmul, "w8a8": _w8a8_matmul, "w4a16": _w4a16_matmul}
_DECODE_STEPS = {"bf16": bf16_decode_step, "w8a8": w8a8_decode_step, "w4a16": w4a16_decode_step}


@torch.no_grad()
def baseline_prefill_step(params, kvs: List[DenseKV], ids, true_len: int, slot: int, cfg: ModelConfig,
                          matmul_name: str):
    """Single-sequence bucketed prefill shared by all baseline stacks.

    ``ids`` is a zero-padded [bucket] prompt; fills the slot's dense-KV rows
    and returns (the argmax token at position ``true_len - 1``, 0-dim int32;
    kvs)."""
    matmul = _MATMULS[matmul_name]
    t = ids.shape[0]
    x = _embed_lookup(params.embed, ids)  # [T, d]
    cos, sin = rope_tables(torch.arange(t, device=ids.device), cfg.head_dim, cfg.rope_theta)
    mask = causal_mask(t, t, device=ids.device)
    for lp, kv in zip(params.layers, kvs):
        x, _ = _prefill_layer_common(x, lp, matmul, kv, slot, cfg, cos, sin, mask)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    last = min(max(true_len - 1, 0), t - 1)  # the JAX dynamic slice's clamp
    logits = _lm_head_logits(x[last : last + 1], params.lm_head)
    return torch.argmax(logits[0], dim=-1).to(torch.int32), kvs


def make_baseline_step_fns(params, cfg: ModelConfig, stack: str):
    """Engine adapters: (prefill_fn, decode_fn) with dense-KV state.

    ``stack`` is one of bf16/w8a8/w4a16.  The engine's page tables carry no
    information for a dense cache (only ``seq_lens`` is consumed), but the
    calling convention matches the W4A4 stack so the same ``TextGenEngine``
    drives all four stacks."""
    step = _DECODE_STEPS[stack]

    def prefill_fn(state, ids, table_row, true_len, slot):
        return baseline_prefill_step(params, state, ids, true_len, slot, cfg, stack)

    def decode_fn(state, ids, page_table, seq_lens):
        return step(params, state, ids, seq_lens, cfg)

    return prefill_fn, decode_fn
