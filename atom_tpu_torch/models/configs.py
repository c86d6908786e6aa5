"""Model architecture configs (the port's copy of ``atom_tpu/models/configs.py``)."""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Arch(str, enum.Enum):
    LLAMA = "llama"  # RMSNorm + RoPE + SiLU-gated MLP (Llama 1/2)
    OPT = "opt"  # LayerNorm + learned positions + ReLU MLP
    MIXTRAL = "mixtral"  # Llama geometry + top-2 MoE MLP


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: Arch
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    max_position_embeddings: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    num_experts: int = 0
    num_experts_per_tok: int = 2
    do_layer_norm_before: bool = True
    tie_word_embeddings: bool = False

    @property
    def kv_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def llama(
    hidden: int,
    inter: int,
    layers: int,
    heads: int,
    kv_heads: Optional[int] = None,
    vocab: int = 32000,
    max_pos: int = 2048,
    rope_theta: float = 10000.0,
    norm_eps: float = 1e-5,
) -> ModelConfig:
    return ModelConfig(
        arch=Arch.LLAMA,
        vocab_size=vocab,
        hidden_size=hidden,
        intermediate_size=inter,
        num_layers=layers,
        num_heads=heads,
        num_kv_heads=kv_heads if kv_heads is not None else heads,
        head_dim=hidden // heads,
        max_position_embeddings=max_pos,
        rope_theta=rope_theta,
        norm_eps=norm_eps,
    )


LLAMA2_7B = llama(4096, 11008, 32, 32, max_pos=4096)
