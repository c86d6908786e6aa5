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


# -- Llama family (first-gen geometries; Llama-2 7B/13B share them, 70B is GQA) --
LLAMA_7B = llama(4096, 11008, 32, 32, norm_eps=1e-6)
LLAMA_13B = llama(5120, 13824, 40, 40, norm_eps=1e-6)
LLAMA_30B = llama(6656, 17920, 60, 52, norm_eps=1e-6)
LLAMA_65B = llama(8192, 22016, 80, 64, norm_eps=1e-6)
LLAMA2_7B = llama(4096, 11008, 32, 32, max_pos=4096)
LLAMA2_13B = llama(5120, 13824, 40, 40, max_pos=4096)
LLAMA2_70B = llama(8192, 28672, 80, 64, kv_heads=8, max_pos=4096)

MIXTRAL_8X7B = ModelConfig(
    arch=Arch.MIXTRAL,
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    max_position_embeddings=32768,
    rope_theta=1e6,
    norm_eps=1e-5,
    num_experts=8,
    num_experts_per_tok=2,
)


def opt(hidden: int, inter: int, layers: int, heads: int, vocab: int = 50272) -> ModelConfig:
    return ModelConfig(
        arch=Arch.OPT,
        vocab_size=vocab,
        hidden_size=hidden,
        intermediate_size=inter,
        num_layers=layers,
        num_heads=heads,
        num_kv_heads=heads,
        head_dim=hidden // heads,
        max_position_embeddings=2048,
        tie_word_embeddings=True,
    )


OPT_125M = opt(768, 3072, 12, 12)
OPT_1_3B = opt(2048, 8192, 24, 32)
OPT_6_7B = opt(4096, 16384, 32, 32)

# -- the byte-level Llama of the accuracy artifact and tiny test geometries --
BYTE_LM = llama(768, 2048, 12, 6, vocab=256, max_pos=2048, norm_eps=1e-6)

TINY_LLAMA = llama(256, 512, 2, 4, vocab=512, max_pos=256)
TINY_LLAMA_GQA = llama(256, 512, 2, 4, kv_heads=2, vocab=512, max_pos=256)
TINY_OPT = opt(128, 256, 2, 4, vocab=512)
TINY_MIXTRAL = MIXTRAL_8X7B.replace(
    vocab_size=512,
    hidden_size=256,
    intermediate_size=512,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    max_position_embeddings=256,
    num_experts=4,
)
