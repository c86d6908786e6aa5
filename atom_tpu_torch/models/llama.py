"""Simulated-quantization Llama (1/2, GQA included): the accuracy pipeline's
model (``atom_tpu/models/llama.py``).

Parameters are a dict with the JAX package's keys: ``embed``, ``final_norm``,
``lm_head`` and ``layers``, whose tensors carry the layer on the leading
axis (``wq`` ... ``wdown`` in [in, out] convention, ``input_ln``,
``post_ln`` and the reorder gathers ``attn_ln_idx``, ``mlp_ln_idx``,
``attn_out_idx``).  The quantizers are functions of (x, QuantSpec) applied at
the reference's hook points (see ``forward_layer``); calibration taps, the
inputs and outputs of every linear, are returned explicitly.  ``forward``
loops over the layers where the JAX version scans them.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from atom_tpu_torch.config import QuantSpec
from atom_tpu_torch.models.base import get_layer, params_from_numpy, set_layer, stack_layers  # noqa: F401
from atom_tpu_torch.models.configs import ModelConfig
from atom_tpu_torch.models.nn import apply_rope, attention, causal_mask, repeat_kv, rmsnorm, rope_tables
from atom_tpu_torch.ops.runtime import resolve_device
from atom_tpu_torch.quant.core import quantize_activation, quantize_kv_head, quantize_weight

Params = Dict[str, Any]


def _layer_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    h, inter = cfg.hidden_size, cfg.intermediate_size
    qh, kvh = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    return {"wq": (h, qh), "wk": (h, kvh), "wv": (h, kvh), "wo": (qh, h),
            "wgate": (h, inter), "wup": (h, inter), "wdown": (inter, h)}


def init_layer_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16, device=None) -> Params:
    """One layer: N(0, 0.02) weights from ``gen``, unit norms, identity gathers."""
    dev = gen.device if device is None else device
    h, qh = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    lp = {name: (torch.randn(shape, generator=gen, dtype=torch.float32, device=dev) * 0.02).to(dtype)
          for name, shape in _layer_shapes(cfg).items()}
    lp.update(
        input_ln=torch.ones((h,), dtype=dtype, device=dev),
        post_ln=torch.ones((h,), dtype=dtype, device=dev),
        attn_ln_idx=torch.arange(h, dtype=torch.int32, device=dev),
        mlp_ln_idx=torch.arange(h, dtype=torch.int32, device=dev),
        attn_out_idx=torch.arange(qh, dtype=torch.int32, device=dev),
    )
    return lp


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16, device=None) -> Params:
    """Random-weight model from a seeded ``torch.Generator`` on the resolved device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32, device=dev) * 0.02).to(dtype)

    embed = normal((cfg.vocab_size, cfg.hidden_size))
    lm_head = normal((cfg.hidden_size, cfg.vocab_size))
    layers = stack_layers([init_layer_params(gen, cfg, dtype) for _ in range(cfg.num_layers)])
    return {"embed": embed, "final_norm": torch.ones((cfg.hidden_size,), dtype=dtype, device=dev),
            "lm_head": lm_head, "layers": layers}


def params_like(cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    """The structure, shapes and dtypes of :func:`init_params`, on the meta
    device (no memory): the template checkpoints restore into."""
    meta = dict(device="meta")
    n, h, qh = cfg.num_layers, cfg.hidden_size, cfg.num_heads * cfg.head_dim
    layers = {name: torch.empty((n, *shape), dtype=dtype, **meta) for name, shape in _layer_shapes(cfg).items()}
    layers.update(
        input_ln=torch.empty((n, h), dtype=dtype, **meta),
        post_ln=torch.empty((n, h), dtype=dtype, **meta),
        attn_ln_idx=torch.empty((n, h), dtype=torch.int32, **meta),
        mlp_ln_idx=torch.empty((n, h), dtype=torch.int32, **meta),
        attn_out_idx=torch.empty((n, qh), dtype=torch.int32, **meta),
    )
    return {"embed": torch.empty((cfg.vocab_size, h), dtype=dtype, **meta),
            "final_norm": torch.empty((h,), dtype=dtype, **meta),
            "lm_head": torch.empty((h, cfg.vocab_size), dtype=dtype, **meta), "layers": layers}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


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
    """One decoder layer -> (output, taps); taps is empty unless
    ``collect_taps``.  Hook points: input norm -> reorder -> act quant; K
    quantized per head before RoPE, V per head; the attention output ->
    reorder -> act quant -> o_proj; silu(gate) * up -> act quant -> down."""
    b, t, _ = x.shape
    taps: Dict[str, torch.Tensor] = {}

    def tap(name: str, val: torch.Tensor):
        if collect_taps:
            taps[name] = val

    residual = x
    hid = rmsnorm(x, lp["input_ln"], cfg.norm_eps)
    hid = quantize_activation(hid.index_select(-1, lp["attn_ln_idx"]), spec)
    tap("self_attn.q_proj.input", hid)
    tap("self_attn.k_proj.input", hid)
    tap("self_attn.v_proj.input", hid)
    q = hid @ lp["wq"]
    k = hid @ lp["wk"]
    v = hid @ lp["wv"]
    tap("self_attn.q_proj.output", q)
    tap("self_attn.k_proj.output", k)
    tap("self_attn.v_proj.output", v)

    q = q.reshape(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)
    k = k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    v = v.reshape(b, t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
    k = quantize_kv_head(k, spec)  # before RoPE, as the paged cache stores K
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
    hid = rmsnorm(x, lp["post_ln"], cfg.norm_eps)
    hid = quantize_activation(hid.index_select(-1, lp["mlp_ln_idx"]), spec)
    tap("mlp.gate_proj.input", hid)
    tap("mlp.up_proj.input", hid)
    g = hid @ lp["wgate"]
    u = hid @ lp["wup"]
    tap("mlp.gate_proj.output", g)
    tap("mlp.up_proj.output", u)
    act = F.silu(g.to(torch.float32)).to(g.dtype) * u
    act = quantize_activation(act, spec)
    tap("mlp.down_proj.input", act)
    d = act @ lp["wdown"]
    tap("mlp.down_proj.output", d)
    return residual + d, taps


def embed(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][input_ids.long()]


def layer_aux(params: Params, cfg: ModelConfig, seqlen: int):
    """(cos, sin, mask) shared by every layer at ``seqlen``."""
    dev = params["embed"].device
    cos, sin = rope_tables(torch.arange(seqlen, device=dev), cfg.head_dim, cfg.rope_theta)
    return cos, sin, causal_mask(seqlen, seqlen, device=dev)


def hessian_tap_specs(cfg: ModelConfig) -> Dict[str, int]:
    """Distinct linear-input taps needing a GPTQ Hessian -> input features
    (q/k/v share one input, as do gate/up)."""
    h = cfg.hidden_size
    return {
        "self_attn.q_proj.input": h,
        "self_attn.o_proj.input": cfg.num_heads * cfg.head_dim,
        "mlp.gate_proj.input": h,
        "mlp.down_proj.input": cfg.intermediate_size,
    }


_GPTQ_WIRING = {
    "self_attn.q_proj.input": ("wq", "wk", "wv"),
    "self_attn.o_proj.input": ("wo",),
    "mlp.gate_proj.input": ("wgate", "wup"),
    "mlp.down_proj.input": ("wdown",),
}


def gptq_apply(lp: Params, hessians: Dict[str, torch.Tensor], quantize_fn) -> Params:
    """Quantize one layer's linears against their input Hessians;
    ``quantize_fn(w_out_in, hessian, name=wname) -> w_q`` works in [out, in]."""
    lp = dict(lp)
    for tapname, wnames in _GPTQ_WIRING.items():
        for wname in wnames:
            lp[wname] = quantize_fn(lp[wname].T, hessians[tapname], name=wname).T
    return lp


def head(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).to(torch.float32)


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

LAYER_WEIGHT_OF = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
    "gate_proj": "wgate",
    "up_proj": "wup",
    "down_proj": "wdown",
}


def apply_reorder_layer(lp: Params, idx: Dict[str, torch.Tensor], layer_prefix: str) -> Params:
    """Permute one layer's weights and install its activation gathers:
    gate/up take their own input order and down_proj's input order on their
    outputs (so silu(gate) * up is already in down's order); q/k/v/o their
    own input order, outputs untouched (RoPE); the norm gathers take k_proj's,
    gate's and o_proj's input orders.  Weights are [in, out]."""
    def n(mod):
        return idx[f"{layer_prefix}.{mod}.input"].long()

    lp = dict(lp)
    down_in = n("mlp.down_proj")
    lp["wgate"] = lp["wgate"][n("mlp.gate_proj")][:, down_in]
    lp["wup"] = lp["wup"][n("mlp.up_proj")][:, down_in]
    lp["wdown"] = lp["wdown"][down_in]
    lp["wq"] = lp["wq"][n("self_attn.q_proj")]
    lp["wk"] = lp["wk"][n("self_attn.k_proj")]
    lp["wv"] = lp["wv"][n("self_attn.v_proj")]
    lp["wo"] = lp["wo"][n("self_attn.o_proj")]
    lp["attn_ln_idx"] = n("self_attn.k_proj").to(torch.int32)
    lp["mlp_ln_idx"] = n("mlp.gate_proj").to(torch.int32)
    lp["attn_out_idx"] = n("self_attn.o_proj").to(torch.int32)
    return lp


def apply_reorder(params: Params, cfg: ModelConfig, idx: Dict[str, torch.Tensor]) -> Params:
    for i in range(cfg.num_layers):
        params = set_layer(params, i, apply_reorder_layer(get_layer(params, i), idx, f"layers.{i}"))
    return params


def quantize_layer_weights_rtn(lp: Params, spec: QuantSpec) -> Params:
    """Round-to-nearest weight quantization of one layer ([out, in] in the
    quantizer, the keeper the trailing input channels)."""
    lp = dict(lp)
    for wname in ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown"):
        lp[wname] = quantize_weight(lp[wname].T, spec).T
    return lp


def quantize_weights_rtn(params: Params, cfg: ModelConfig, spec: QuantSpec) -> Params:
    for i in range(cfg.num_layers):
        params = set_layer(params, i, quantize_layer_weights_rtn(get_layer(params, i), spec))
    return params


def load_hf_params(path: str, cfg: ModelConfig, dtype=torch.bfloat16, device=None) -> Params:
    """Local HF checkpoint -> this module's params (see ``models.hf_loader``)."""
    from atom_tpu_torch.models.hf_loader import load_llama_params

    return load_llama_params(path, cfg, dtype, device=device)
