"""Perplexity (``atom_tpu/utils/eval.py``): the test stream cut into
non-overlapping ``seqlen`` windows, each window's mean causal cross-entropy,
PPL = exp(mean over windows)."""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from atom_tpu_torch.config import QuantSpec
from atom_tpu_torch.models.configs import ModelConfig


def window_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean causal cross-entropy of one window: logits [t, vocab] for tokens
    0..t-1, targets [t]; logits[:-1] predict targets[1:]."""
    lp = F.log_softmax(logits[:-1].to(torch.float32), dim=-1)
    return -torch.mean(torch.gather(lp, -1, targets[1:, None].long()))


@torch.no_grad()
def perplexity(
    params,
    cfg: ModelConfig,
    spec: QuantSpec,
    tokens: np.ndarray,
    seqlen: int = 2048,
    forward: Optional[Callable] = None,
    progress: bool = False,
) -> float:
    """PPL of a flat token stream over non-overlapping ``seqlen`` windows, on
    the params' device: an accuracy model's dict or a serving model's
    ``ServingParams`` (with a serving ``forward``)."""
    if forward is None:
        from atom_tpu_torch.calib.pipeline import _model_api

        forward = _model_api(cfg).forward
    tokens = np.asarray(tokens).reshape(-1)
    n_windows = len(tokens) // seqlen
    if n_windows <= 0:
        raise ValueError("token stream shorter than one window")
    dev = (params["embed"] if isinstance(params, dict) else params.embed).device
    total = 0.0
    for i in range(n_windows):
        window = torch.from_numpy(tokens[i * seqlen : (i + 1) * seqlen].astype(np.int32)).to(dev)
        total += float(window_nll(forward(params, window[None], cfg, spec)[0], window))
        if progress:
            print(f"  ppl window {i + 1}/{n_windows}", flush=True)
    return float(np.exp(total / n_windows))
