"""Pretraining loop of the accuracy fixture (``atom_tpu/utils/train.py``).

The reference evaluates quantization on pretrained checkpoints; none can be
downloaded here, so the real-text accuracy artifact trains its own byte-level
Llama (``models.configs.BYTE_LM``) on the corpus: trained transformers grow
the activation-outlier channels that reorder and the keeper target, random
weights do not.

Training runs through autograd on the accuracy model's plain ops, each layer
under ``torch.utils.checkpoint`` (recomputed in the backward pass, so the
2,048-token attention of every layer is not kept).  The optimizer is the JAX
package's optax chain, written out: ``clip_by_global_norm(1.0)``, then AdamW
(b1 0.9, b2 0.95, eps 1e-8 outside the square root, weight decay 0.01 on
every float leaf) on a warmup-cosine schedule whose step count starts at 0,
so the first update runs at learning rate 0.  Integer leaves (the reorder
gathers) stay out of the optimizer.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from atom_tpu_torch.config import FP16_BASELINE
from atom_tpu_torch.models import llama as M
from atom_tpu_torch.models.configs import ModelConfig

B1, B2, EPS, WEIGHT_DECAY, MAX_NORM = 0.9, 0.95, 1e-8, 0.01, 1.0


def _layer(lp, x, cos, sin, mask, cfg: ModelConfig):
    return M.forward_layer(lp, x, cos, sin, mask, cfg, FP16_BASELINE)[0]


def _forward_logits(params, ids: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The unquantized forward with every layer recomputed in the backward
    pass -> f32 logits [b, t, vocab]."""
    x = M.embed(params, ids)
    cos, sin, mask = M.layer_aux(params, cfg, ids.shape[1])
    for i in range(cfg.num_layers):
        x = checkpoint(_layer, M.get_layer(params, i), x, cos, sin, mask, cfg, use_reentrant=False)
    return M.head(params, x, cfg)


def _loss(params, ids: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross entropy in nats a token; ids [b, t + 1]."""
    logits = _forward_logits(params, ids[:, :-1], cfg)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), ids[:, 1:].reshape(-1).long())


def _tree_map(fn, *trees):
    """Map over nested dicts of tensors (``None`` leaves included)."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [] if tree is None else [tree]


def split_trainable(params) -> Tuple[Dict, Dict]:
    """(float leaves, integer leaves), each the params' tree with ``None``
    where the other holds a leaf: the reorder gathers are not trained."""
    fl = _tree_map(lambda x: x if x.is_floating_point() else None, params)
    st = _tree_map(lambda x: None if x.is_floating_point() else x, params)
    return fl, st


def merge_trainable(fl, st):
    return _tree_map(lambda a, b: b if a is None else a, fl, st)


def lr_schedule(lr: float, warmup: int, steps: int) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule(0, lr, warmup, max(steps,
    warmup + 1), end_value=lr * 0.1)`` in its float32 arithmetic: a linear
    ramp from 0 over ``warmup`` updates, then a cosine decay to a tenth of
    ``lr`` at update ``steps``."""
    f32 = np.float32
    decay = float(max(steps, warmup + 1) - warmup)
    alpha = 0.0 if lr == 0 else lr * 0.1 / lr  # optax's end_value / peak_value, then float32 at its uses

    def at(count: int) -> float:
        if count < warmup:
            frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return float(f32(-lr) * frac + f32(lr))
        c = f32(min(float(count - warmup), decay))
        cosine = f32(0.5) * (f32(1) + f32(np.cos(np.float64(f32(math.pi) * c / f32(decay)))))
        return float(f32(lr) * (f32(1 - alpha) * cosine + f32(alpha)))

    return at


class AdamW:
    """optax's ``chain(clip_by_global_norm(1.0), adamw(schedule, b1=0.9,
    b2=0.95, eps=1e-8, weight_decay=0.01))`` over a list of float tensors,
    updated in place."""

    def __init__(self, params: List[torch.Tensor], schedule: Callable[[int], float]):
        self.params = params
        self.schedule = schedule
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        grads = [torch.where(g_norm < MAX_NORM, g, g / g_norm * MAX_NORM) for g in grads]
        t = self.count + 1
        bc1, bc2 = 1 - B1**t, 1 - B2**t
        step_size = -self.schedule(self.count)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(B1).add_(g, alpha=1 - B1)
            nu.mul_(B2).add_(g * g, alpha=1 - B2)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS) + WEIGHT_DECAY * p
            p.add_(step_size * update)
        self.count = t


def sample_windows(rng: np.random.Generator, tokens: np.ndarray, k: int, b: int, t: int) -> np.ndarray:
    """[k, b, t + 1] int32 random windows of a flat token stream."""
    starts = rng.integers(0, len(tokens) - t - 1, size=(k, b))
    idx = starts[..., None] + np.arange(t + 1)[None, None, :]
    return tokens[idx].astype(np.int32)


@torch.no_grad()
def eval_loss(params, cfg: ModelConfig, tokens: np.ndarray, seqlen: int, batch: int = 8,
              max_windows: int = 32) -> float:
    """Mean next-token NLL (nats) over non-overlapping eval windows."""
    n = min(len(tokens) // (seqlen + 1), max_windows)
    wins = tokens[: n * (seqlen + 1)].reshape(n, seqlen + 1).astype(np.int32)
    dev = params["embed"].device
    tot = 0.0
    for i in range(0, n, batch):
        chunk = torch.from_numpy(wins[i : i + batch]).to(dev)
        tot += float(_loss(params, chunk, cfg)) * chunk.shape[0]
    return tot / n


def train(
    params,
    cfg: ModelConfig,
    tokens: np.ndarray,
    steps: int = 2400,
    batch: int = 8,
    seqlen: int = 2048,
    lr: float = 3e-4,
    warmup: int = 100,
    chunk: int = 50,
    seed: int = 0,
    log=print,
) -> Tuple[object, float]:
    """Train ``params`` (float leaves in place) on a flat token stream on
    their device -> (params, the mean loss of the last chunk of updates)."""
    fl, st = split_trainable(params)
    leaves = _leaves(fl)
    for p in leaves:
        p.requires_grad_(True)
    opt = AdamW(leaves, lr_schedule(lr, warmup, steps))
    rng = np.random.default_rng(seed)
    dev = leaves[0].device
    done, loss = 0, float("nan")
    try:
        while done < steps:
            k = min(chunk, steps - done)
            data = torch.from_numpy(sample_windows(rng, tokens, k, batch, seqlen)).to(dev)
            losses = []
            for ids in data:
                value = _loss(merge_trainable(fl, st), ids, cfg)
                opt.step(torch.autograd.grad(value, leaves))
                losses.append(value.detach())
            loss = float(torch.stack(losses).mean())
            done += k
            log(f"  step {done}/{steps}  loss {loss:.4f} nats ({loss / np.log(2):.3f} bits/byte)")
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return merge_trainable(fl, st), loss
