"""HF checkpoints and the calibrate -> serve bridge (``atom_tpu/models/hf_loader.py``).

Loading works from local checkpoint directories (anything ``transformers``
can save); ``transformers`` is imported inside the functions.  HF
``nn.Linear`` stores [out, in]; the accuracy model keeps [in, out], so every
matrix is transposed on the way in.

``pack_calibrated_params`` turns calibrated Llama accuracy-model params
(reordered, weight-quantized) into the serving model's ``ServingParams``, and
``pack_calibrated_params_moe`` calibrated Mixtral params into the MoE serving
model's ``MoEServingParams``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from atom_tpu_torch.models.base import stack_layers
from atom_tpu_torch.models.configs import Arch, ModelConfig
from atom_tpu_torch.ops.runtime import resolve_device


def _load_state_dict(path: str) -> Dict[str, Any]:
    """State dict of a local HF checkpoint directory (safetensors or .bin)."""
    from transformers import AutoModelForCausalLM

    model = AutoModelForCausalLM.from_pretrained(path)
    return {k: v.detach() for k, v in model.state_dict().items()}


def config_from_hf(path: str) -> ModelConfig:
    """ModelConfig from a local HF config.json (Llama, OPT or Mixtral)."""
    from transformers import AutoConfig

    c = AutoConfig.from_pretrained(path)
    common = dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size, num_layers=c.num_hidden_layers,
                  num_heads=c.num_attention_heads, head_dim=c.hidden_size // c.num_attention_heads,
                  max_position_embeddings=c.max_position_embeddings)
    if c.model_type == "llama":
        return ModelConfig(arch=Arch.LLAMA, intermediate_size=c.intermediate_size,
                           num_kv_heads=getattr(c, "num_key_value_heads", c.num_attention_heads),
                           rope_theta=getattr(c, "rope_theta", 10000.0), norm_eps=c.rms_norm_eps, **common)
    if c.model_type == "opt":
        return ModelConfig(arch=Arch.OPT, intermediate_size=c.ffn_dim, num_kv_heads=c.num_attention_heads,
                           do_layer_norm_before=c.do_layer_norm_before, tie_word_embeddings=True, **common)
    if c.model_type == "mixtral":
        return ModelConfig(arch=Arch.MIXTRAL, intermediate_size=c.intermediate_size,
                           num_kv_heads=c.num_key_value_heads, rope_theta=getattr(c, "rope_theta", 1e6),
                           norm_eps=c.rms_norm_eps, num_experts=c.num_local_experts,
                           num_experts_per_tok=c.num_experts_per_tok, **common)
    raise ValueError(f"unsupported model_type {c.model_type!r}")


def _readers(sd, dev, dtype, prefix: str = ""):
    """(w, v): a matrix [out, in] -> [in, out], and a vector, on ``dev`` in ``dtype``."""

    def w(name):
        return sd[prefix + name].T.to(device=dev, dtype=dtype).contiguous()

    def v(name):
        return sd[prefix + name].to(device=dev, dtype=dtype)

    return w, v


def load_llama_params(path: str, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
    """A local HF Llama checkpoint -> the accuracy model's params."""
    dev = resolve_device(device)
    sd = _load_state_dict(path)
    w, v = _readers(sd, dev, dtype)
    d, qh = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        layers.append({
            "input_ln": v(p + "input_layernorm.weight"),
            "post_ln": v(p + "post_attention_layernorm.weight"),
            "wq": w(p + "self_attn.q_proj.weight"),
            "wk": w(p + "self_attn.k_proj.weight"),
            "wv": w(p + "self_attn.v_proj.weight"),
            "wo": w(p + "self_attn.o_proj.weight"),
            "wgate": w(p + "mlp.gate_proj.weight"),
            "wup": w(p + "mlp.up_proj.weight"),
            "wdown": w(p + "mlp.down_proj.weight"),
            "attn_ln_idx": torch.arange(d, dtype=torch.int32, device=dev),
            "mlp_ln_idx": torch.arange(d, dtype=torch.int32, device=dev),
            "attn_out_idx": torch.arange(qh, dtype=torch.int32, device=dev),
        })
    lm_head = w("lm_head.weight") if "lm_head.weight" in sd else v("model.embed_tokens.weight").T.contiguous()
    return {
        "embed": v("model.embed_tokens.weight"),
        "final_norm": v("model.norm.weight"),
        "lm_head": lm_head,
        "layers": stack_layers(layers),
    }


def load_opt_params(path: str, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
    """A local HF OPT checkpoint (pre-norm) -> the accuracy model's params."""
    dev = resolve_device(device)
    w, v = _readers(_load_state_dict(path), dev, dtype, prefix="model.decoder.")
    d = cfg.hidden_size
    layers = []
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        lp = {
            "attn_ln_w": v(p + "self_attn_layer_norm.weight"),
            "attn_ln_b": v(p + "self_attn_layer_norm.bias"),
            "final_ln_w": v(p + "final_layer_norm.weight"),
            "final_ln_b": v(p + "final_layer_norm.bias"),
        }
        for ours, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("o", "out_proj")):
            lp[f"w{ours}"] = w(p + f"self_attn.{hf}.weight")
            lp[f"b{ours}"] = v(p + f"self_attn.{hf}.bias")
        for fc in ("fc1", "fc2"):
            lp[f"{fc}_w"] = w(p + f"{fc}.weight")
            lp[f"{fc}_b"] = v(p + f"{fc}.bias")
        for name in ("attn_ln_idx", "mlp_ln_idx", "attn_out_idx"):
            lp[name] = torch.arange(d, dtype=torch.int32, device=dev)
        layers.append(lp)
    return {
        "embed": v("embed_tokens.weight"),
        "pos_embed": v("embed_positions.weight"),
        "final_ln_w": v("final_layer_norm.weight"),
        "final_ln_b": v("final_layer_norm.bias"),
        "layers": stack_layers(layers),
    }


def load_mixtral_params(path: str, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
    """A local HF Mixtral checkpoint -> the accuracy model's params (the
    experts' w1, w3, w2 stacked on a leading [E] axis)."""
    dev = resolve_device(device)
    w, v = _readers(_load_state_dict(path), dev, dtype)
    d, qh = cfg.hidden_size, cfg.num_heads * cfg.head_dim
    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        moe = p + "block_sparse_moe."
        lp = {
            "input_ln": v(p + "input_layernorm.weight"),
            "post_ln": v(p + "post_attention_layernorm.weight"),
            "wq": w(p + "self_attn.q_proj.weight"),
            "wk": w(p + "self_attn.k_proj.weight"),
            "wv": w(p + "self_attn.v_proj.weight"),
            "wo": w(p + "self_attn.o_proj.weight"),
            "router": w(moe + "gate.weight"),
            "attn_ln_idx": torch.arange(d, dtype=torch.int32, device=dev),
            "mlp_ln_idx": torch.arange(d, dtype=torch.int32, device=dev),
            "attn_out_idx": torch.arange(qh, dtype=torch.int32, device=dev),
        }
        for name in ("w1", "w3", "w2"):
            lp[name] = torch.stack([w(moe + f"experts.{e}.{name}.weight") for e in range(cfg.num_experts)])
        layers.append(lp)
    return {
        "embed": v("model.embed_tokens.weight"),
        "final_norm": v("model.norm.weight"),
        "lm_head": w("lm_head.weight"),
        "layers": stack_layers(layers),
    }


# ---------------------------------------------------------------------------
# Calibrated fake-quant Llama -> packed serving weights
# ---------------------------------------------------------------------------


def pack_calibrated_params(params, cfg: ModelConfig, spec, *, orig_params=None, gptq_scales=None):
    """Calibrated Llama accuracy-model params -> the serving model's
    ``ServingParams`` (bf16 head), on the params' device.

    * ``gptq_scales`` (GPTQ): the per-group scales from
      ``calibrate(..., scales_out=...)``; the codes are recovered exactly on
      them (``ops.formats.pack_gptq_output``).
    * ``orig_params`` (RTN): the reordered, unquantized params; packing them
      reproduces the fake-quant weights exactly (shared scale math).
    * neither: the fake values are re-quantized with the clip ratio off
      (they already sit on the clipped grid); near exact.

    Reorder indices transfer as they are; q/k/v and gate/up are packed per
    piece and concatenated on the output axis into the wide serving GEMMs.
    """
    from atom_tpu_torch.ops.formats import concat_packed_out, pack_for_kernel, pack_gptq_output, quantize_weight_packed
    from atom_tpu_torch.serving.model import ServingLayerParams, ServingParams

    rtn_spec = spec if orig_params is not None else spec.replace(w_clip_ratio=1.0)
    bf16 = torch.bfloat16

    def packed(i, lp, lp_orig, *wnames):
        pws = []
        for wname in wnames:
            if gptq_scales is not None:
                pws.append(pack_gptq_output(lp[wname], gptq_scales[f"{i}.{wname}"], spec))
            else:
                src = lp_orig[wname] if lp_orig is not None else lp[wname]
                pws.append(quantize_weight_packed(src, rtn_spec))
        return pack_for_kernel(pws[0] if len(pws) == 1 else concat_packed_out(pws))

    layers = []
    for i in range(cfg.num_layers):
        lp = {k: v[i].clone() for k, v in params["layers"].items()}
        lp_orig = None if orig_params is None else {k: v[i] for k, v in orig_params["layers"].items()}
        ln_attn, ln_mlp = lp["input_ln"].to(bf16), lp["post_ln"].to(bf16)
        layers.append(ServingLayerParams(
            ln_attn=ln_attn,
            ln_mlp=ln_mlp,
            attn_reorder=lp["attn_ln_idx"].to(torch.int32),
            o_reorder=lp["attn_out_idx"].to(torch.int32),
            mlp_reorder=lp["mlp_ln_idx"].to(torch.int32),
            wqkv=packed(i, lp, lp_orig, "wq", "wk", "wv"),
            wo=packed(i, lp, lp_orig, "wo"),
            wgateup=packed(i, lp, lp_orig, "wgate", "wup"),
            wdown=packed(i, lp, lp_orig, "wdown"),
            ln_attn_g=ln_attn[lp["attn_ln_idx"].long()],
            ln_mlp_g=ln_mlp[lp["mlp_ln_idx"].long()],
        ))
    return ServingParams(
        embed=params["embed"].to(bf16),
        final_norm=params["final_norm"].to(bf16),
        lm_head=params["lm_head"].to(bf16).contiguous(),
        layers=layers,
    )


def pack_calibrated_params_moe(params, cfg: ModelConfig, spec, *, orig_params=None, gptq_scales=None):
    """Calibrated Mixtral accuracy-model params -> the MoE serving model's
    ``MoEServingParams`` (bf16 head), on the params' device.

    The exactness contract of :func:`pack_calibrated_params`, with GPTQ
    scales keyed ``"{layer}.{w}"`` and, per expert, ``"{layer}.{w}.{e}"``.
    Each expert's w1 and w3 are packed apart and concatenated on the output
    axis into its ``wgateup`` (gate = w1, up = w3: ``_moe_mlp``'s
    silu(w1) * w3), and the experts stacked on a leading [E] axis; the float
    router's rows are already in ``mlp_reorder`` order and transfer as they
    are.
    """
    from atom_tpu_torch.ops.formats import concat_packed_out, pack_for_kernel, pack_gptq_output, quantize_weight_packed
    from atom_tpu_torch.serving.moe import MoEServingLayerParams, MoEServingParams, _stack_experts

    rtn_spec = spec if orig_params is not None else spec.replace(w_clip_ratio=1.0)
    bf16 = torch.bfloat16

    def one(i, lp, lp_orig, wname, e=None):
        if gptq_scales is not None:
            key = f"{i}.{wname}" if e is None else f"{i}.{wname}.{e}"
            w = lp[wname] if e is None else lp[wname][e]
            return pack_gptq_output(w, gptq_scales[key], spec)
        src = (lp_orig if lp_orig is not None else lp)[wname]
        return quantize_weight_packed(src if e is None else src[e], rtn_spec)

    layers = []
    for i in range(cfg.num_layers):
        lp = {k: v[i] for k, v in params["layers"].items()}
        lp_orig = None if orig_params is None else {k: v[i] for k, v in orig_params["layers"].items()}
        ln_attn = lp["input_ln"].to(bf16)
        gateup = [pack_for_kernel(concat_packed_out([one(i, lp, lp_orig, "w1", e), one(i, lp, lp_orig, "w3", e)]))
                  for e in range(cfg.num_experts)]
        down = [pack_for_kernel(one(i, lp, lp_orig, "w2", e)) for e in range(cfg.num_experts)]
        layers.append(MoEServingLayerParams(
            ln_attn=ln_attn,
            ln_mlp=lp["post_ln"].to(bf16),
            attn_reorder=lp["attn_ln_idx"].to(torch.int32),
            o_reorder=lp["attn_out_idx"].to(torch.int32),
            mlp_reorder=lp["mlp_ln_idx"].to(torch.int32),
            wqkv=pack_for_kernel(concat_packed_out([one(i, lp, lp_orig, n) for n in ("wq", "wk", "wv")])),
            wo=pack_for_kernel(one(i, lp, lp_orig, "wo")),
            router=lp["router"].to(bf16),
            wgateup=_stack_experts(gateup),
            wdown=_stack_experts(down),
            ln_attn_g=ln_attn[lp["attn_ln_idx"].long()],
        ))
    return MoEServingParams(
        embed=params["embed"].to(bf16),
        final_norm=params["final_norm"].to(bf16),
        lm_head=params["lm_head"].to(bf16).contiguous(),
        layers=layers,
    )
