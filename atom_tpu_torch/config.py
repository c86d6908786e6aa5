"""Quantization configuration of the Atom W4A4 scheme (the port's own copy).

The same frozen dataclass as ``atom_tpu/config.py``: one description of the
scheme, read by the plain PyTorch versions and the CUDA kernels alike.
Canonical Atom setting: W4A4, symmetric weights and activations, group 128
on both, weight channel-group 2, 128 INT8 keeper channels, clip 0.9 (act) /
0.85 (weight) / 1.0 (KV), INT4 asymmetric KV cache.
"""
from __future__ import annotations

import dataclasses
import enum


class KeeperPrecision(enum.IntEnum):
    """Precision of the outlier ("keeper") channels: 0 float, 1 FP8 E5M2,
    2 FP8 E4M3, 3 INT8 symmetric per row (the paper's setting)."""

    FLOAT = 0
    FP8_E5M2 = 1
    FP8_E4M3 = 2
    INT8 = 3


class QuantType(str, enum.Enum):
    """Uniform INT vs non-uniform FP4 code mapping."""

    INT = "int"
    FP = "fp"


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Full description of the Atom quantization scheme (defaults: canonical).

    ``wbits/abits >= 16`` disables the corresponding quantization.
    """

    wbits: int = 4
    abits: int = 4
    w_sym: bool = True
    a_sym: bool = True
    weight_group_size: int = 128
    act_group_size: int = 128
    weight_channel_group: int = 2
    keeper: int = 128
    keeper_precision: KeeperPrecision = KeeperPrecision.INT8
    w_clip_ratio: float = 0.85
    a_clip_ratio: float = 0.9
    kv_clip_ratio: float = 1.0
    kv_cache: bool = True
    quant_type: QuantType = QuantType.INT
    exponential: bool = False
    reorder: bool = True
    act_sort_metric: str = "hessian"
    # Serving: take the fused norm+quant qkv kernel on the decode path.
    fused_serving: bool = True
    use_gptq: bool = True
    percdamp: float = 0.01

    def __post_init__(self):
        if self.quant_type == QuantType.FP and self.wbits not in (4, 16):
            raise ValueError("FP quant_type only supports 4-bit (FP4) weights")
        if self.weight_channel_group < 1:
            raise ValueError("weight_channel_group must be >= 1")
        if self.keeper < 0:
            raise ValueError("keeper must be >= 0")

    @property
    def quantize_weights(self) -> bool:
        return self.wbits < 16

    @property
    def quantize_acts(self) -> bool:
        return self.abits < 16

    def replace(self, **kw) -> "QuantSpec":
        return dataclasses.replace(self, **kw)


ATOM_W4A4 = QuantSpec()

ATOM_W4A4_FP4 = QuantSpec(quant_type=QuantType.FP)

ATOM_W8A8 = QuantSpec(
    wbits=8,
    abits=8,
    weight_channel_group=1,
    keeper=0,
    keeper_precision=KeeperPrecision.FLOAT,
    w_clip_ratio=1.0,
    a_clip_ratio=1.0,
)

FP16_BASELINE = QuantSpec(
    wbits=16,
    abits=16,
    keeper=0,
    keeper_precision=KeeperPrecision.FLOAT,
    kv_cache=False,
    reorder=False,
    use_gptq=False,
)
