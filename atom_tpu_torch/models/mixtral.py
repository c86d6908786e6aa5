"""Simulated-quantization Mixtral (top-2 MoE): the accuracy pipeline's third
model family (``atom_tpu/models/mixtral.py``).

Quantizer placement: attention exactly as Llama's (GQA included: K per head
before RoPE, V per head, the attention output reordered and quantized before
o_proj); the post-attention RMSNorm output is reordered by the expert-0 order
and fed unquantized to the float router; the hidden is quantized once after
the router logits, and each expert runs silu(w1 x) * w3 x -> act quant -> w2.
Every expert shares expert 0's reorder indices, so one gather serves the
block.

Dense dispatch, as in the JAX module: every expert runs over every token and
the top-k routing enters as a [T, E] weight matrix, zero where a token is not
routed; the weighted expert outputs are summed in float32, expert by expert.
The calibration taps keep the routed-token semantics by masking: a token's
row is zeroed in the taps of the experts it is not routed to, and the masked
rows stay in the tap (they count in ``gptq_add_batch``'s sample count).

Parameters are a dict with the JAX package's keys: ``embed``, ``final_norm``,
``lm_head`` and ``layers``, whose tensors carry the layer on the leading axis
(``wq`` ... ``wo`` and ``router`` [in, out]; ``w1``, ``w3``, ``w2`` stacked
[E, in, out]; the norms and the reorder gathers as Llama's).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from atom_tpu_torch.config import QuantSpec
from atom_tpu_torch.models.base import get_layer, params_from_numpy, set_layer, stack_layers  # noqa: F401
from atom_tpu_torch.models.configs import ModelConfig
from atom_tpu_torch.models.llama import embed, head, layer_aux  # noqa: F401  (shared with Llama)
from atom_tpu_torch.models.nn import apply_rope, attention, repeat_kv, rmsnorm
from atom_tpu_torch.ops.runtime import resolve_device
from atom_tpu_torch.quant.core import quantize_activation, quantize_kv_head, quantize_weight
from atom_tpu_torch.serving.moe import _route_top_k

Params = Dict[str, Any]

_EXPERT_WEIGHTS = ("w1", "w3", "w2")


def _layer_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    h, inter, e = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts
    qh, kvh = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    return {"wq": (h, qh), "wk": (h, kvh), "wv": (h, kvh), "wo": (qh, h), "router": (h, e),
            "w1": (e, h, inter), "w3": (e, h, inter), "w2": (e, inter, h)}


def _layer_vectors(cfg: ModelConfig) -> Dict[str, tuple]:
    h, qh = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    return {"input_ln": (h, None), "post_ln": (h, None), "attn_ln_idx": (h, torch.int32),
            "mlp_ln_idx": (h, torch.int32), "attn_out_idx": (qh, torch.int32)}


def init_layer_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16, device=None) -> Params:
    """One layer: N(0, 0.02) weights from ``gen``, unit norms, identity gathers."""
    dev = gen.device if device is None else device
    lp = {name: (torch.randn(shape, generator=gen, dtype=torch.float32, device=dev) * 0.02).to(dtype)
          for name, shape in _layer_shapes(cfg).items()}
    for name, (n, idx_dtype) in _layer_vectors(cfg).items():
        lp[name] = (torch.ones((n,), dtype=dtype, device=dev) if idx_dtype is None
                    else torch.arange(n, dtype=idx_dtype, device=dev))
    return lp


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16, device=None) -> Params:
    """Random-weight model from a seeded ``torch.Generator`` on the resolved device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32, device=dev) * 0.02).to(dtype)

    embed_w = normal((cfg.vocab_size, cfg.hidden_size))
    lm_head = normal((cfg.hidden_size, cfg.vocab_size))
    layers = stack_layers([init_layer_params(gen, cfg, dtype) for _ in range(cfg.num_layers)])
    return {"embed": embed_w, "final_norm": torch.ones((cfg.hidden_size,), dtype=dtype, device=dev),
            "lm_head": lm_head, "layers": layers}


def params_like(cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    """The structure, shapes and dtypes of :func:`init_params` on the meta device."""
    meta = dict(device="meta")
    n, h = cfg.num_layers, cfg.hidden_size
    layers = {name: torch.empty((n, *shape), dtype=dtype, **meta) for name, shape in _layer_shapes(cfg).items()}
    for name, (width, idx_dtype) in _layer_vectors(cfg).items():
        layers[name] = torch.empty((n, width), dtype=idx_dtype or dtype, **meta)
    return {"embed": torch.empty((cfg.vocab_size, h), dtype=dtype, **meta),
            "final_norm": torch.empty((h,), dtype=dtype, **meta),
            "lm_head": torch.empty((h, cfg.vocab_size), dtype=dtype, **meta), "layers": layers}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def router_logits(hid: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """hid [T, h] @ router [h, E] in hid's dtype: the products summed in
    float32 and rounded once (bf16 products are exact in float32), as XLA's
    bf16 dot and the serving router compute them."""
    return (hid.to(torch.float32) @ router.to(torch.float32)).to(hid.dtype)


def route_top_k(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Dense routing weights [T, E] (float32): the renormalised top-k softmax
    probabilities, zero for unrouted pairs; ties rank the lower expert first."""
    return _route_top_k(logits, cfg.num_experts_per_tok)


def moe_block(lp: Params, hid: torch.Tensor, cfg: ModelConfig, spec: QuantSpec, tap) -> torch.Tensor:
    """Top-k MoE block with dense expert dispatch; ``hid`` [T, h] reordered,
    not yet quantized.  ``tap(name, value)`` receives the taps; the
    per-expert taps only when ``tap.collecting``."""
    tap("block_sparse_moe.gate.input", hid)
    logits = router_logits(hid, lp["router"])
    tap("block_sparse_moe.gate.output", logits)

    hidq = quantize_activation(hid, spec)
    weights = route_top_k(logits, cfg)  # [T, E] float32
    routed = (weights > 0).to(hidq.dtype)

    # every expert over every token: [E, T, inter] and [E, T, h]
    g = torch.matmul(hidq[None], lp["w1"])
    u = torch.matmul(hidq[None], lp["w3"])
    act = F.silu(g.to(torch.float32)).to(g.dtype) * u
    act = quantize_activation(act, spec)
    down = torch.matmul(act, lp["w2"])
    # einsum("eth,te->th") in float32, expert-major
    out = torch.zeros(down.shape[1:], dtype=torch.float32, device=down.device)
    for e in range(down.shape[0]):
        out = out + down[e].to(torch.float32) * weights[:, e : e + 1]

    # the routed-token masking of the calibration taps
    for e in range(cfg.num_experts if tap.collecting else 0):
        m_e = routed[:, e : e + 1]
        pre = f"block_sparse_moe.experts.{e}"
        tap(f"{pre}.w1.input", hidq * m_e)
        tap(f"{pre}.w3.input", hidq * m_e)
        tap(f"{pre}.w1.output", g[e] * m_e)
        tap(f"{pre}.w3.output", u[e] * m_e)
        tap(f"{pre}.w2.input", act[e] * m_e)
        tap(f"{pre}.w2.output", down[e] * m_e)
    return out.to(hid.dtype)


def forward_layer(
    lp: Params,
    x: torch.Tensor,  # [b, t, hidden]
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: torch.Tensor,
    cfg: ModelConfig,
    spec: QuantSpec,
    collect_taps: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder layer -> (output, taps); taps is empty unless ``collect_taps``."""
    b, t, h = x.shape
    taps: Dict[str, torch.Tensor] = {}

    def tap(name: str, val: torch.Tensor):
        if collect_taps:
            taps[name] = val

    tap.collecting = collect_taps

    residual = x
    hid = rmsnorm(x, lp["input_ln"], cfg.norm_eps)
    hid = quantize_activation(hid.index_select(-1, lp["attn_ln_idx"]), spec)
    for nm in ("q_proj", "k_proj", "v_proj"):
        tap(f"self_attn.{nm}.input", hid)
    q = hid @ lp["wq"]
    k = hid @ lp["wk"]
    v = hid @ lp["wv"]
    tap("self_attn.q_proj.output", q)
    tap("self_attn.k_proj.output", k)
    tap("self_attn.v_proj.output", v)

    q = q.reshape(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)
    k = k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    v = v.reshape(b, t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    k = quantize_kv_head(k, spec)  # before RoPE, as in Llama
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    v = quantize_kv_head(v, spec)

    attn = attention(q, repeat_kv(k, cfg.kv_groups), repeat_kv(v, cfg.kv_groups), mask)
    attn = attn.transpose(1, 2).reshape(b, t, cfg.num_heads * cfg.head_dim)
    attn = quantize_activation(attn.index_select(-1, lp["attn_out_idx"]), spec)
    tap("self_attn.o_proj.input", attn)
    o = attn @ lp["wo"]
    tap("self_attn.o_proj.output", o)
    x = residual + o

    residual = x
    hid = rmsnorm(x, lp["post_ln"], cfg.norm_eps).index_select(-1, lp["mlp_ln_idx"])
    moe_out = moe_block(lp, hid.reshape(b * t, h), cfg, spec, tap)
    return residual + moe_out.reshape(b, t, h), taps


def forward(params: Params, input_ids: torch.Tensor, cfg: ModelConfig, spec: QuantSpec) -> torch.Tensor:
    """Full-model forward, ids [b, t] -> f32 logits [b, t, vocab]."""
    x = embed(params, input_ids)
    cos, sin, mask = layer_aux(params, cfg, input_ids.shape[1])
    for i in range(cfg.num_layers):
        x, _ = forward_layer(get_layer(params, i), x, cos, sin, mask, cfg, spec)
    return head(params, x, cfg)


def forward_collect_taps(
    params: Params, input_ids: torch.Tensor, cfg: ModelConfig, spec: QuantSpec
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward with every linear's taps, keyed ``layers.{i}.{module}.{input|output}``."""
    x = embed(params, input_ids)
    cos, sin, mask = layer_aux(params, cfg, input_ids.shape[1])
    all_taps: Dict[str, torch.Tensor] = {}
    for i in range(cfg.num_layers):
        x, taps = forward_layer(get_layer(params, i), x, cos, sin, mask, cfg, spec, collect_taps=True)
        for name, val in taps.items():
            all_taps[f"layers.{i}.{name}"] = val
    return head(params, x, cfg), all_taps


# ---------------------------------------------------------------------------
# Calibration wiring: reorder + weight quantization
# ---------------------------------------------------------------------------


def apply_reorder_layer(lp: Params, idx: Dict[str, torch.Tensor], prefix: str) -> Params:
    """Permute one layer's weights and install its gathers.  Every expert
    takes expert 0's orders: w1's input order on the router's rows and on
    w1's / w3's inputs, w2's input order on w1's / w3's outputs and w2's
    inputs; q/k/v/o their own input orders; the norm gathers k_proj's,
    expert 0's w1's and o_proj's input orders."""
    def n(mod):
        return idx[f"{prefix}.{mod}.input"].long()

    lp = dict(lp)
    e0w1_in = n("block_sparse_moe.experts.0.w1")
    e0w2_in = n("block_sparse_moe.experts.0.w2")
    lp["router"] = lp["router"][e0w1_in]
    lp["w1"] = lp["w1"][:, e0w1_in][:, :, e0w2_in]
    lp["w3"] = lp["w3"][:, e0w1_in][:, :, e0w2_in]
    lp["w2"] = lp["w2"][:, e0w2_in]
    lp["wq"] = lp["wq"][n("self_attn.q_proj")]
    lp["wk"] = lp["wk"][n("self_attn.k_proj")]
    lp["wv"] = lp["wv"][n("self_attn.v_proj")]
    lp["wo"] = lp["wo"][n("self_attn.o_proj")]
    lp["attn_ln_idx"] = n("self_attn.k_proj").to(torch.int32)
    lp["mlp_ln_idx"] = e0w1_in.to(torch.int32)
    lp["attn_out_idx"] = n("self_attn.o_proj").to(torch.int32)
    return lp


def apply_reorder(params: Params, cfg: ModelConfig, idx: Dict[str, torch.Tensor]) -> Params:
    for i in range(cfg.num_layers):
        params = set_layer(params, i, apply_reorder_layer(get_layer(params, i), idx, f"layers.{i}"))
    return params


def quantize_layer_weights_rtn(lp: Params, spec: QuantSpec) -> Params:
    """Round-to-nearest weight quantization of one layer, expert by expert;
    the router stays float."""
    lp = dict(lp)
    for wname in ("wq", "wk", "wv", "wo"):
        lp[wname] = quantize_weight(lp[wname].T, spec).T
    for wname in _EXPERT_WEIGHTS:
        lp[wname] = torch.stack([quantize_weight(w.T, spec).T for w in lp[wname]])
    return lp


def quantize_weights_rtn(params: Params, cfg: ModelConfig, spec: QuantSpec) -> Params:
    for i in range(cfg.num_layers):
        params = set_layer(params, i, quantize_layer_weights_rtn(get_layer(params, i), spec))
    return params


def hessian_tap_specs(cfg: ModelConfig) -> Dict[str, int]:
    """Distinct linear-input taps needing a GPTQ Hessian -> input features:
    q/k/v share one, and each expert's w1 and w3 one."""
    specs = {"self_attn.q_proj.input": cfg.hidden_size,
             "self_attn.o_proj.input": cfg.num_heads * cfg.head_dim}
    for e in range(cfg.num_experts):
        specs[f"block_sparse_moe.experts.{e}.w1.input"] = cfg.hidden_size
        specs[f"block_sparse_moe.experts.{e}.w2.input"] = cfg.intermediate_size
    return specs


def gptq_apply(lp: Params, hessians: Dict[str, torch.Tensor], quantize_fn) -> Params:
    """Quantize one layer's linears against their input Hessians;
    ``quantize_fn(w_out_in, hessian, name=...)`` works in [out, in].  Names:
    ``wq`` ... ``wo``, and ``"{w}.{e}"`` for expert ``e``'s w1, w3, w2."""
    lp = dict(lp)
    for wname, tapname in (("wq", "self_attn.q_proj.input"), ("wk", "self_attn.q_proj.input"),
                           ("wv", "self_attn.q_proj.input"), ("wo", "self_attn.o_proj.input")):
        lp[wname] = quantize_fn(lp[wname].T, hessians[tapname], name=wname).T
    n_exp = lp["w1"].shape[0]
    for stacked, tap_tmpl in (("w1", "block_sparse_moe.experts.{}.w1.input"),
                              ("w3", "block_sparse_moe.experts.{}.w1.input"),
                              ("w2", "block_sparse_moe.experts.{}.w2.input")):
        lp[stacked] = torch.stack([
            quantize_fn(lp[stacked][e].T, hessians[tap_tmpl.format(e)], name=f"{stacked}.{e}").T
            for e in range(n_exp)
        ])
    return lp


def load_hf_params(path: str, cfg: ModelConfig, dtype=torch.bfloat16, device=None) -> Params:
    """Local HF checkpoint -> this module's params (see ``models.hf_loader``)."""
    from atom_tpu_torch.models.hf_loader import load_mixtral_params

    return load_mixtral_params(path, cfg, dtype, device=device)
