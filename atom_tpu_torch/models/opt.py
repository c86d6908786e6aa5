"""Simulated-quantization OPT: the accuracy pipeline's second model family
(``atom_tpu/models/opt.py``).

Against Llama: LayerNorm with bias in place of RMSNorm and biases on every
linear; learned positions at HF's offset of +2 and no RoPE, so K is quantized
per head as projected and V likewise; the attention scales q.k by
1/sqrt(head_dim) (HF pre-scales q: the same product); pre-norm layers; the
MLP is fc1 -> ReLU -> act quant -> fc2; the head is tied to the token
embedding.

Reorder wiring: fc1's outputs take fc2's input order, and fc1's bias is
permuted with them (the reference permutes the weight alone, a latent bug
that Llama, having no biases, never meets; the JAX module departs from it on
purpose and so does this one); q/k/v/out_proj take their own input orders;
the norm gathers take k_proj's, fc1's and out_proj's input orders.

Parameters are a dict with the JAX package's keys: ``embed``, ``pos_embed``
([max_pos + 2, h]), ``final_ln_w``, ``final_ln_b`` and ``layers`` (weights
[in, out] with their biases, the two LayerNorms' weights and biases, the
reorder gathers), stacked on the leading axis.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from atom_tpu_torch.config import QuantSpec
from atom_tpu_torch.models.base import get_layer, params_from_numpy, set_layer, stack_layers  # noqa: F401
from atom_tpu_torch.models.configs import ModelConfig
from atom_tpu_torch.models.nn import attention, causal_mask, layernorm
from atom_tpu_torch.ops.runtime import resolve_device
from atom_tpu_torch.quant.core import quantize_activation, quantize_kv_head, quantize_weight

Params = Dict[str, Any]

POS_OFFSET = 2  # HF OPT reserves two leading positions
_WEIGHTS = ("wq", "wk", "wv", "wo", "fc1_w", "fc2_w")


def _layer_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    h, inter = cfg.hidden_size, cfg.intermediate_size
    return {"wq": (h, h), "wk": (h, h), "wv": (h, h), "wo": (h, h), "fc1_w": (h, inter), "fc2_w": (inter, h)}


def _layer_vectors(cfg: ModelConfig) -> Dict[str, tuple]:
    """name -> (length, fill): 1 (LayerNorm weight), 0 (bias) or None (identity gather)."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    return {"attn_ln_w": (h, 1), "attn_ln_b": (h, 0), "final_ln_w": (h, 1), "final_ln_b": (h, 0),
            "bq": (h, 0), "bk": (h, 0), "bv": (h, 0), "bo": (h, 0), "fc1_b": (inter, 0), "fc2_b": (h, 0),
            "attn_ln_idx": (h, None), "mlp_ln_idx": (h, None), "attn_out_idx": (h, None)}


def init_layer_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16, device=None) -> Params:
    """One layer: N(0, 0.02) weights from ``gen``, unit LayerNorms, zero
    biases, identity gathers."""
    dev = gen.device if device is None else device
    lp = {name: (torch.randn(shape, generator=gen, dtype=torch.float32, device=dev) * 0.02).to(dtype)
          for name, shape in _layer_shapes(cfg).items()}
    for name, (n, fill) in _layer_vectors(cfg).items():
        lp[name] = (torch.arange(n, dtype=torch.int32, device=dev) if fill is None
                    else torch.full((n,), float(fill), dtype=dtype, device=dev))
    return lp


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16, device=None) -> Params:
    """Random-weight model from a seeded ``torch.Generator`` on the resolved device."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32, device=dev) * 0.02).to(dtype)

    h = cfg.hidden_size
    embed_w = normal((cfg.vocab_size, h))
    pos_embed = normal((cfg.max_position_embeddings + POS_OFFSET, h))
    layers = stack_layers([init_layer_params(gen, cfg, dtype) for _ in range(cfg.num_layers)])
    return {"embed": embed_w, "pos_embed": pos_embed, "final_ln_w": torch.ones((h,), dtype=dtype, device=dev),
            "final_ln_b": torch.zeros((h,), dtype=dtype, device=dev), "layers": layers}


def params_like(cfg: ModelConfig, dtype=torch.bfloat16) -> Params:
    """The structure, shapes and dtypes of :func:`init_params` on the meta device."""
    meta = dict(device="meta")
    n, h = cfg.num_layers, cfg.hidden_size
    layers = {name: torch.empty((n, *shape), dtype=dtype, **meta) for name, shape in _layer_shapes(cfg).items()}
    for name, (width, fill) in _layer_vectors(cfg).items():
        layers[name] = torch.empty((n, width), dtype=torch.int32 if fill is None else dtype, **meta)
    return {"embed": torch.empty((cfg.vocab_size, h), dtype=dtype, **meta),
            "pos_embed": torch.empty((cfg.max_position_embeddings + POS_OFFSET, h), dtype=dtype, **meta),
            "final_ln_w": torch.empty((h,), dtype=dtype, **meta), "final_ln_b": torch.empty((h,), dtype=dtype, **meta),
            "layers": layers}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def forward_layer(
    lp: Params,
    x: torch.Tensor,  # [b, t, hidden]
    mask: torch.Tensor,
    cfg: ModelConfig,
    spec: QuantSpec,
    collect_taps: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One pre-norm decoder layer -> (output, taps); taps is empty unless
    ``collect_taps``."""
    b, t, h = x.shape
    eps = cfg.norm_eps
    taps: Dict[str, torch.Tensor] = {}

    def tap(name: str, val: torch.Tensor):
        if collect_taps:
            taps[name] = val

    residual = x
    hid = layernorm(x, lp["attn_ln_w"], lp["attn_ln_b"], eps)
    hid = quantize_activation(hid.index_select(-1, lp["attn_ln_idx"]), spec)
    for nm in ("q_proj", "k_proj", "v_proj"):
        tap(f"self_attn.{nm}.input", hid)
    q = hid @ lp["wq"] + lp["bq"]
    k = hid @ lp["wk"] + lp["bk"]
    v = hid @ lp["wv"] + lp["bv"]
    tap("self_attn.q_proj.output", q)
    tap("self_attn.k_proj.output", k)
    tap("self_attn.v_proj.output", v)

    def to_heads(z):
        return z.reshape(b, t, cfg.num_heads, cfg.head_dim).transpose(1, 2)

    q, k, v = to_heads(q), to_heads(k), to_heads(v)
    k = quantize_kv_head(k, spec)  # no RoPE: K and V quantized as projected
    v = quantize_kv_head(v, spec)

    attn = attention(q, k, v, mask)
    attn = attn.transpose(1, 2).reshape(b, t, h)
    attn = quantize_activation(attn.index_select(-1, lp["attn_out_idx"]), spec)
    tap("self_attn.out_proj.input", attn)
    o = attn @ lp["wo"] + lp["bo"]
    tap("self_attn.out_proj.output", o)
    x = residual + o

    residual = x
    hid = layernorm(x, lp["final_ln_w"], lp["final_ln_b"], eps)
    hid = quantize_activation(hid.index_select(-1, lp["mlp_ln_idx"]), spec)
    tap("fc1.input", hid)
    f = hid @ lp["fc1_w"] + lp["fc1_b"]
    tap("fc1.output", f)
    f = quantize_activation(torch.clamp_min(f, 0), spec)  # ReLU
    tap("fc2.input", f)
    out = f @ lp["fc2_w"] + lp["fc2_b"]
    tap("fc2.output", out)
    return residual + out, taps


def embed(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    """Token embeddings plus the learned positions at offset +2."""
    t = input_ids.shape[-1]
    pos = params["pos_embed"][torch.arange(t, device=input_ids.device) + POS_OFFSET]
    return params["embed"][input_ids.long()] + pos


def head(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final LayerNorm, then the tied head -> f32 logits."""
    x = layernorm(x, params["final_ln_w"], params["final_ln_b"], cfg.norm_eps)
    return (x @ params["embed"].T).to(torch.float32)


def layer_aux(params: Params, cfg: ModelConfig, seqlen: int):
    """(mask,) shared by every layer at ``seqlen``."""
    return (causal_mask(seqlen, seqlen, device=params["embed"].device),)


def forward(params: Params, input_ids: torch.Tensor, cfg: ModelConfig, spec: QuantSpec) -> torch.Tensor:
    """Full-model forward, ids [b, t] -> f32 logits [b, t, vocab]."""
    x = embed(params, input_ids)
    (mask,) = layer_aux(params, cfg, input_ids.shape[1])
    for i in range(cfg.num_layers):
        x, _ = forward_layer(get_layer(params, i), x, mask, cfg, spec)
    return head(params, x, cfg)


def forward_collect_taps(
    params: Params, input_ids: torch.Tensor, cfg: ModelConfig, spec: QuantSpec
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward with every linear's taps, keyed ``layers.{i}.{module}.{input|output}``."""
    x = embed(params, input_ids)
    (mask,) = layer_aux(params, cfg, input_ids.shape[1])
    all_taps: Dict[str, torch.Tensor] = {}
    for i in range(cfg.num_layers):
        x, taps = forward_layer(get_layer(params, i), x, mask, cfg, spec, collect_taps=True)
        for name, val in taps.items():
            all_taps[f"layers.{i}.{name}"] = val
    return head(params, x, cfg), all_taps


# ---------------------------------------------------------------------------
# Calibration wiring: reorder + weight quantization
# ---------------------------------------------------------------------------


def apply_reorder_layer(lp: Params, idx: Dict[str, torch.Tensor], prefix: str) -> Params:
    """Permute one layer's weights (fc1's bias with its outputs) and install
    its gathers.  Weights are [in, out]."""
    def n(mod):
        return idx[f"{prefix}.{mod}.input"].long()

    lp = dict(lp)
    fc2_in = n("fc2")
    lp["fc1_w"] = lp["fc1_w"][n("fc1")][:, fc2_in]
    lp["fc1_b"] = lp["fc1_b"][fc2_in]
    lp["fc2_w"] = lp["fc2_w"][fc2_in]
    lp["wq"] = lp["wq"][n("self_attn.q_proj")]
    lp["wk"] = lp["wk"][n("self_attn.k_proj")]
    lp["wv"] = lp["wv"][n("self_attn.v_proj")]
    lp["wo"] = lp["wo"][n("self_attn.out_proj")]
    lp["attn_ln_idx"] = n("self_attn.k_proj").to(torch.int32)
    lp["mlp_ln_idx"] = n("fc1").to(torch.int32)
    lp["attn_out_idx"] = n("self_attn.out_proj").to(torch.int32)
    return lp


def apply_reorder(params: Params, cfg: ModelConfig, idx: Dict[str, torch.Tensor]) -> Params:
    for i in range(cfg.num_layers):
        params = set_layer(params, i, apply_reorder_layer(get_layer(params, i), idx, f"layers.{i}"))
    return params


def quantize_layer_weights_rtn(lp: Params, spec: QuantSpec) -> Params:
    """Round-to-nearest weight quantization of one layer's six matrices."""
    lp = dict(lp)
    for wname in _WEIGHTS:
        lp[wname] = quantize_weight(lp[wname].T, spec).T
    return lp


def quantize_weights_rtn(params: Params, cfg: ModelConfig, spec: QuantSpec) -> Params:
    for i in range(cfg.num_layers):
        params = set_layer(params, i, quantize_layer_weights_rtn(get_layer(params, i), spec))
    return params


def hessian_tap_specs(cfg: ModelConfig) -> Dict[str, int]:
    """Distinct linear-input taps needing a GPTQ Hessian -> input features."""
    h = cfg.hidden_size
    return {"self_attn.q_proj.input": h, "self_attn.out_proj.input": h, "fc1.input": h,
            "fc2.input": cfg.intermediate_size}


_GPTQ_WIRING = {
    "self_attn.q_proj.input": ("wq", "wk", "wv"),
    "self_attn.out_proj.input": ("wo",),
    "fc1.input": ("fc1_w",),
    "fc2.input": ("fc2_w",),
}


def gptq_apply(lp: Params, hessians: Dict[str, torch.Tensor], quantize_fn) -> Params:
    """Quantize one layer's linears against their input Hessians (biases stay float)."""
    lp = dict(lp)
    for tapname, wnames in _GPTQ_WIRING.items():
        for wname in wnames:
            lp[wname] = quantize_fn(lp[wname].T, hessians[tapname], name=wname).T
    return lp


def load_hf_params(path: str, cfg: ModelConfig, dtype=torch.bfloat16, device=None) -> Params:
    """Local HF checkpoint -> this module's params (see ``models.hf_loader``)."""
    from atom_tpu_torch.models.hf_loader import load_opt_params

    return load_opt_params(path, cfg, dtype, device=device)
