"""Activation saliency and channel reorder indices (``atom_tpu/calib/outlier.py``).

Inputs sort ascending, so the most salient (outlier) channels land last, where
the keeper block lives; outputs sort descending within each head.  Sorts are
stable, as ``jnp.argsort`` is.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch


class ActStats(NamedTuple):
    """Accumulated per-channel saliency of one tap point: the diagonal of
    ``2/n X^T X`` ('hessian') or the running max of per-sample mean |x|
    ('abs_mean')."""

    value: torch.Tensor  # float32 [channels]


def hessian_diag_update(stats: torch.Tensor | None, x: torch.Tensor, nsamples: int) -> torch.Tensor:
    """Fold one sample ([..., channels], summed over the leading axes) into
    the Hessian-diagonal saliency."""
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    contrib = (2.0 / nsamples) * torch.sum(x2 * x2, dim=0)
    return contrib if stats is None else stats + contrib


def abs_mean_update(stats: torch.Tensor | None, x: torch.Tensor, nsamples: int = 0) -> torch.Tensor:
    """Fold one sample into the abs-mean saliency (running max over samples)."""
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    contrib = torch.mean(x2.abs(), dim=0)
    return contrib if stats is None else torch.maximum(stats, contrib)


def reorder_index_ascending(saliency: torch.Tensor) -> torch.Tensor:
    """Gather permutation (int32) with the outlier channels last."""
    if saliency.ndim != 1:
        raise ValueError("saliency must be 1-D")
    return torch.argsort(saliency, stable=True).to(torch.int32)


def reorder_index_per_head(saliency: torch.Tensor, head_dim: int = 128) -> torch.Tensor:
    """Per-head descending sort (of -saliency, stably), offsets restored."""
    if saliency.ndim != 1 or saliency.shape[0] % head_dim:
        raise ValueError("saliency must be 1-D with whole heads")
    n_heads = saliency.shape[0] // head_dim
    idx = torch.argsort(-saliency.reshape(n_heads, head_dim), dim=-1, stable=True)
    offsets = (torch.arange(n_heads, device=saliency.device) * head_dim)[:, None]
    return (idx + offsets).reshape(-1).to(torch.int32)


def invert_permutation(idx: torch.Tensor) -> torch.Tensor:
    """If y = x[idx], then x = y[inv]."""
    inv = torch.empty_like(idx)
    inv[idx.long()] = torch.arange(idx.shape[0], dtype=idx.dtype, device=idx.device)
    return inv


class SaliencyAccumulator:
    """Saliency of a dict of named activation taps, folded sample by sample."""

    def __init__(self, metric: str = "hessian", nsamples: int = 1):
        if metric not in ("hessian", "abs_mean"):
            raise ValueError(f"unknown saliency metric {metric!r}")
        self.metric = metric
        self.nsamples = nsamples
        self.stats: Dict[str, torch.Tensor] = {}
        self._update = hessian_diag_update if metric == "hessian" else abs_mean_update

    def update(self, taps: Dict[str, torch.Tensor]) -> None:
        for name, x in taps.items():
            self.stats[name] = self._update(self.stats.get(name), x, self.nsamples)

    def reorder_indices(self, head_dim: int = 128) -> Dict[str, torch.Tensor]:
        """'.input' taps ascending, '.output' taps per head descending (an
        output narrower than a head ascending: its index reorders nothing)."""
        out: Dict[str, torch.Tensor] = {}
        for name, sal in self.stats.items():
            if name.endswith(".output") and sal.shape[0] % head_dim == 0:
                out[name] = reorder_index_per_head(sal, head_dim)
            else:
                out[name] = reorder_index_ascending(sal)
        return out
