"""HF checkpoints and the calibrate -> serve bridge (``atom_tpu/models/hf_loader.py``,
its Llama half).

Loading works from local checkpoint directories (anything ``transformers``
can save); ``transformers`` is imported inside the functions.  HF
``nn.Linear`` stores [out, in]; the accuracy model keeps [in, out], so every
matrix is transposed on the way in.

``pack_calibrated_params`` turns calibrated accuracy-model params (reordered,
weight-quantized) into the serving model's ``ServingParams``.
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
    """ModelConfig from a local HF Llama config.json."""
    from transformers import AutoConfig

    c = AutoConfig.from_pretrained(path)
    if c.model_type in ("opt", "mixtral"):
        raise NotImplementedError(f"the {c.model_type} accuracy model is still to be ported (ROADMAP.md section A)")
    if c.model_type != "llama":
        raise ValueError(f"unsupported model_type {c.model_type!r}")
    return ModelConfig(
        arch=Arch.LLAMA,
        vocab_size=c.vocab_size,
        hidden_size=c.hidden_size,
        intermediate_size=c.intermediate_size,
        num_layers=c.num_hidden_layers,
        num_heads=c.num_attention_heads,
        num_kv_heads=getattr(c, "num_key_value_heads", c.num_attention_heads),
        head_dim=c.hidden_size // c.num_attention_heads,
        max_position_embeddings=c.max_position_embeddings,
        rope_theta=getattr(c, "rope_theta", 10000.0),
        norm_eps=c.rms_norm_eps,
    )


def load_llama_params(path: str, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
    """A local HF Llama checkpoint -> the accuracy model's params."""
    dev = resolve_device(device)
    sd = _load_state_dict(path)

    def w(name):
        return sd[name].T.to(device=dev, dtype=dtype).contiguous()  # [in, out]

    def v(name):
        return sd[name].to(device=dev, dtype=dtype)

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
