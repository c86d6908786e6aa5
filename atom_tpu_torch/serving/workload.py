"""Seeded synthetic text-generation workloads
(``atom_tpu/serving/workload.py``; the port keeps its own copy).

ShareGPT-like request lengths from lognormal fits, seeded with numpy, so
both packages serve the same request sets and throughput numbers are
reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class RequestSet:
    prompt_lens: np.ndarray  # int32 [N]
    output_lens: np.ndarray  # int32 [N]
    prompts: List[np.ndarray]  # random token ids per request
    # per-request LoRA adapter index (``TextGenEngine(lora=True)``); None = adapter 0 for all
    adapter_ids: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.prompt_lens)

    @property
    def total_tokens(self) -> int:
        return int(self.prompt_lens.sum() + self.output_lens.sum())

    @property
    def total_output_tokens(self) -> int:
        return int(self.output_lens.sum())


def synth_requests(
    num_requests: int,
    vocab_size: int,
    seed: int = 0xABCDABCD987,  # the JAX package's default seed
    maxlen: int = 2048,
    prompt_mu: float = 5.0,
    prompt_sigma: float = 0.8,
    output_mu: float = 4.5,
    output_sigma: float = 1.0,
) -> RequestSet:
    """ShareGPT-like lognormal prompt and output lengths, random token ids."""
    rng = np.random.Generator(np.random.PCG64(seed))
    prompt_lens = np.clip(
        rng.lognormal(prompt_mu, prompt_sigma, num_requests).round(), 2, maxlen // 2
    ).astype(np.int32)
    output_lens = np.clip(
        rng.lognormal(output_mu, output_sigma, num_requests).round(), 2, None
    ).astype(np.int32)
    output_lens = np.minimum(output_lens, maxlen - prompt_lens).astype(np.int32)
    prompts = [
        rng.integers(1, vocab_size, size=int(pl)).astype(np.int32)
        for pl in prompt_lens
    ]
    return RequestSet(prompt_lens, output_lens, prompts)
