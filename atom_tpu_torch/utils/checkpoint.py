"""Checkpoints of the accuracy pipeline and the serving export
(``atom_tpu/utils/checkpoint.py``), in the JAX package's file format.

One ``.npz`` per tree, keyed by the leaves' paths joined with ``/`` (dict
keys, NamedTuple field names, list indices: the keys of JAX's
``tree_flatten_with_path``), with a ``__saved_dtypes__`` sidecar (the JSON of
each key's dtype name) and bfloat16 stored as its uint16 bits; a
``meta.json`` beside it holds the (cfg, spec) that produced it.  A directory
written by either package loads in the other.  The serving export is written
in the JAX package's layout of ``ServingParams`` or ``MoEServingParams``
(body and keeper scales apart); :func:`load_serving` merges them into the
port's.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from atom_tpu_torch.ops.runtime import resolve_device

_DTYPES_KEY = "__saved_dtypes__"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Iterator[Tuple[str, Any]]:
    """(key, child) pairs in JAX's flattening order: dicts by sorted key."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield str(k), tree[k]
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield f, getattr(tree, f)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield str(i), v


def _leaves_with_paths(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    for k, v in _children(tree):
        yield from _leaves_with_paths(v, f"{prefix}/{k}" if prefix else k)


def _map_with_paths(tree, fn, prefix: str = ""):
    """``tree`` with each tensor leaf replaced by ``fn(path, leaf)``."""
    if tree is None or isinstance(tree, torch.Tensor):
        return tree if tree is None else fn(prefix, tree)

    def sub(k, v):
        return _map_with_paths(v, fn, f"{prefix}/{k}" if prefix else k)

    if isinstance(tree, dict):
        return {k: sub(str(k), v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(sub(f, getattr(tree, f)) for f in tree._fields))
    return type(tree)(sub(str(i), v) for i, v in enumerate(tree))


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _save_flat(path: str, flat: Dict[str, torch.Tensor]) -> None:
    arrays, dtypes = {}, {}
    for key, leaf in flat.items():
        arrays[key], dtypes[key] = _to_numpy(leaf)
    arrays[_DTYPES_KEY] = np.frombuffer(json.dumps(dtypes).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def _load_flat(path: str) -> Tuple[Any, Dict[str, str]]:
    data = np.load(path)
    saved = json.loads(bytes(data[_DTYPES_KEY]).decode()) if _DTYPES_KEY in data.files else {}
    return data, saved


def _decode(arr: np.ndarray, saved_dtype: str | None, like_dtype: torch.dtype) -> torch.Tensor:
    """An npz array -> a tensor, through its recorded dtype (legacy files,
    with no sidecar, hold bfloat16 leaves as bits)."""
    if saved_dtype == "bfloat16" or (saved_dtype is None and like_dtype == torch.bfloat16):
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save_pytree(path: str, tree) -> None:
    _save_flat(path, dict(_leaves_with_paths(tree)))


def restore_pytree(path: str, like, device=None):
    """Restore into the structure of ``like`` (its tensors may be on the meta
    device): keys must match and shapes too; each leaf is decoded through
    its recorded dtype, then cast to the template leaf's dtype."""
    dev = resolve_device(device)
    data, saved = _load_flat(path)
    keys = [k for k, _ in _leaves_with_paths(like)]
    files = set(data.files) - {_DTYPES_KEY}
    if set(keys) != files:
        raise ValueError(f"checkpoint keys mismatch: {sorted(set(keys) ^ files)}")

    def leaf(key, like_leaf):
        arr = data[key]
        if arr.shape != tuple(like_leaf.shape):
            raise ValueError(f"checkpoint leaf {key}: saved shape {arr.shape} != expected {tuple(like_leaf.shape)}")
        return _decode(arr, saved.get(key), like_leaf.dtype).to(device=dev, dtype=like_leaf.dtype)

    return _map_with_paths(like, leaf)


def _write_meta(save_dir: str, cfg, spec) -> None:
    meta = {
        "cfg": dataclasses.asdict(cfg),
        "spec": {k: (v.value if hasattr(v, "value") else v) for k, v in dataclasses.asdict(spec).items()},
    }
    with open(os.path.join(save_dir, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)


def load_meta(save_dir: str):
    """(ModelConfig, QuantSpec) of a saved directory."""
    from atom_tpu_torch.config import KeeperPrecision, QuantSpec, QuantType
    from atom_tpu_torch.models.configs import Arch, ModelConfig

    with open(os.path.join(save_dir, "meta.json")) as f:
        meta = json.load(f)
    cfg = ModelConfig(**{**meta["cfg"], "arch": Arch(meta["cfg"]["arch"])})
    sd = dict(meta["spec"])
    sd["keeper_precision"] = KeeperPrecision(int(sd["keeper_precision"]))
    sd["quant_type"] = QuantType(sd["quant_type"])
    return cfg, QuantSpec(**sd)


def save_quantized(save_dir: str, params, indices, cfg, spec) -> None:
    """Calibrated accuracy-model params, their reorder indices and meta."""
    os.makedirs(save_dir, exist_ok=True)
    save_pytree(os.path.join(save_dir, "params.npz"), params)
    if indices:
        save_pytree(os.path.join(save_dir, "reorder_indices.npz"), indices)
    _write_meta(save_dir, cfg, spec)


def load_quantized(save_dir: str, params_like, indices_like=None, device=None):
    params = restore_pytree(os.path.join(save_dir, "params.npz"), params_like, device)
    indices = None
    idx_path = os.path.join(save_dir, "reorder_indices.npz")
    if indices_like is not None and os.path.exists(idx_path):
        indices = restore_pytree(idx_path, indices_like, device)
    return params, indices


def restore_model_params(path: str, m, full_cfg, layers: int = 0, device=None):
    """Accuracy-model params saved by :func:`save_pytree`, restored into
    ``m.params_like``: at ``full_cfg``'s depth (sliced to ``layers`` when
    given) or, for a checkpoint saved truncated, at ``layers``' depth."""
    try:
        params = restore_pytree(path, m.params_like(full_cfg), device)
    except ValueError:
        if not layers:
            raise
        return restore_pytree(path, m.params_like(full_cfg.replace(num_layers=layers)), device)
    if layers:
        params = {**params, "layers": {k: v[:layers].clone() for k, v in params["layers"].items()}}
    return params


# ---------------------------------------------------------------------------
# Serving export: the JAX package's ServingParams layout
# ---------------------------------------------------------------------------

_PACKED = ("wqkv", "wo", "wgateup", "wdown")


def _serving_layout(cfg, spec) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Key -> (shape, dtype) of the JAX package's Llama ``ServingParams`` or,
    for Mixtral, ``MoEServingParams`` (expert weights with a leading [E])."""
    from atom_tpu_torch.models.configs import Arch

    d, inter, k, g = cfg.hidden_size, cfg.intermediate_size, spec.keeper, spec.weight_group_size
    n_q, n_kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    bf16, i32 = torch.bfloat16, torch.int32
    moe = cfg.arch == Arch.MIXTRAL
    lead = (cfg.num_experts,) if moe else ()
    out = {"embed": ((cfg.vocab_size, d), bf16), "final_norm": ((d,), bf16), "lm_head": ((d, cfg.vocab_size), bf16)}
    gemms = {"wqkv": ((), d, n_q + 2 * n_kv), "wo": ((), n_q, d), "wgateup": (lead, d, 2 * inter),
             "wdown": (lead, inter, d)}
    for i in range(cfg.num_layers):
        p = f"layers/{i}/"
        out.update({p + "ln_attn": ((d,), bf16), p + "ln_mlp": ((d,), bf16), p + "attn_reorder": ((d,), i32),
                    p + "o_reorder": ((n_q,), i32), p + "mlp_reorder": ((d,), i32)})
        if moe:
            out[p + "router"] = ((d, cfg.num_experts), bf16)
        else:
            out.update({p + "ln_attn_g": ((d,), bf16), p + "ln_mlp_g": ((d,), bf16)})
        for name, (pre, in_f, out_f) in gemms.items():
            q = p + name + "/"
            out.update({q + "body_packed": ((*pre, (in_f - k) // 2, out_f), torch.int8),
                        q + "body_scale": ((*pre, (in_f - k) // g, out_f), torch.float32),
                        q + "keeper": ((*pre, k, out_f), torch.int8), q + "keeper_scale": ((*pre, out_f), torch.float32)})
    return out


def _layer_types(cfg):
    """(layer params type, params type) of the serving model of ``cfg``'s
    architecture, and the layer fields the JAX package does not store
    (the MoE layer's ``ln_attn_g``, rebuilt from ``ln_attn`` and
    ``attn_reorder`` on load)."""
    from atom_tpu_torch.models.configs import Arch

    if cfg.arch == Arch.MIXTRAL:
        from atom_tpu_torch.serving.moe import MoEServingLayerParams, MoEServingParams

        return MoEServingLayerParams, MoEServingParams, ("ln_attn_g",)
    if cfg.arch == Arch.LLAMA:
        from atom_tpu_torch.serving.model import ServingLayerParams, ServingParams

        return ServingLayerParams, ServingParams, ()
    raise ValueError(f"the serving export covers the served architectures (Llama, Mixtral), not {cfg.arch.value}")


def save_serving(save_dir: str, serving_params, cfg, spec) -> None:
    """Persist the port's ``ServingParams`` (Llama) or ``MoEServingParams``
    (Mixtral), with the bf16 head, and the producing (cfg, spec), in the
    layout the JAX package's ``load_serving`` reads."""
    _, _, derived = _layer_types(cfg)
    if not isinstance(serving_params.lm_head, torch.Tensor):
        raise ValueError("save_serving stores the bf16 head; quantize the head after loading")
    flat = {"embed": serving_params.embed, "final_norm": serving_params.final_norm, "lm_head": serving_params.lm_head}
    for i, lp in enumerate(serving_params.layers):
        for f in lp._fields:
            if f in derived:
                continue
            v = getattr(lp, f)
            p = f"layers/{i}/{f}"
            if f in _PACKED:  # scales [..., ng + 1, N]: the body groups, then the keeper's
                ng = v.scales.shape[-2] - 1
                flat.update({p + "/body_packed": v.body_packed, p + "/body_scale": v.scales[..., :ng, :],
                             p + "/keeper": v.keeper, p + "/keeper_scale": v.scales[..., ng, :]})
            else:
                flat[p] = v
    os.makedirs(save_dir, exist_ok=True)
    _save_flat(os.path.join(save_dir, "serving_params.npz"), flat)
    _write_meta(save_dir, cfg, spec)


def load_serving(save_dir: str, device=None):
    """Restore ``(ServingParams or MoEServingParams, cfg, spec)`` saved by
    either package's ``save_serving``, onto the resolved device; keys and
    shapes come from ``meta.json``."""
    from atom_tpu_torch.ops.formats import KernelPackedWeight

    dev = resolve_device(device)
    cfg, spec = load_meta(save_dir)
    layer_cls, params_cls, derived = _layer_types(cfg)
    layout = _serving_layout(cfg, spec)
    data, saved = _load_flat(os.path.join(save_dir, "serving_params.npz"))
    files = set(data.files) - {_DTYPES_KEY}
    if set(layout) != files:
        raise ValueError(f"serving checkpoint keys mismatch: {sorted(set(layout) ^ files)}")

    def get(key):
        shape, dtype = layout[key]
        arr = data[key]
        if arr.shape != shape:
            raise ValueError(f"serving checkpoint leaf {key}: saved shape {arr.shape} != expected {shape}")
        return _decode(arr, saved.get(key), dtype).to(device=dev, dtype=dtype)

    layers = []
    for i in range(cfg.num_layers):
        fields = {}
        for f in layer_cls._fields:
            p = f"layers/{i}/{f}"
            if f in derived:
                continue
            if f in _PACKED:
                scales = torch.cat([get(p + "/body_scale"), get(p + "/keeper_scale").unsqueeze(-2)], dim=-2)
                fields[f] = KernelPackedWeight(body_packed=get(p + "/body_packed"), keeper=get(p + "/keeper"),
                                               scales=scales)
            else:
                fields[f] = get(p)
        if derived:
            fields["ln_attn_g"] = fields["ln_attn"][fields["attn_reorder"].long()]
        layers.append(layer_cls(**fields))
    params = params_cls(embed=get("embed"), final_norm=get("final_norm"), lm_head=get("lm_head"), layers=layers)
    return params, cfg, spec
