"""Calibration and evaluation data (``atom_tpu/calib/data.py``), numpy only.

Seeded random ``seqlen``-token calibration windows from a training split and
the flat tokenized test stream for perplexity: from HF datasets (a local
cache), from the repository's byte-level corpus, or from a seeded synthetic
Zipf stream.  The same seeds give the same tokens as the JAX package.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

_HF_SPECS = {
    "wikitext2": ("wikitext", "wikitext-2-raw-v1", "text", "\n\n"),
    "ptb": ("ptb_text_only", "penn_treebank", "sentence", " "),
    "c4": ("allenai/c4", "en", "text", " "),
}


def synthetic_tokens(vocab_size: int, n_tokens: int, seed: int = 0, alpha: float = 1.2) -> np.ndarray:
    """Deterministic Zipf-distributed token stream (a stand-in corpus)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks**-alpha
    probs /= probs.sum()
    return rng.choice(vocab_size, size=n_tokens, p=probs).astype(np.int32)


def synthetic_loaders(
    vocab_size: int, nsamples: int = 8, seqlen: int = 256, seed: int = 0, test_tokens: int = 4096
) -> Tuple[List[np.ndarray], np.ndarray]:
    """(calibration batches [1, seqlen], flat test stream) from the synthetic corpus."""
    stream = synthetic_tokens(vocab_size, nsamples * seqlen + test_tokens, seed)
    batches = [stream[i * seqlen : (i + 1) * seqlen][None].astype(np.int32) for i in range(nsamples)]
    return batches, stream[nsamples * seqlen :]


def _windows(train: np.ndarray, nsamples: int, seqlen: int, seed: int) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(nsamples):
        start = int(rng.integers(0, len(train) - seqlen - 1))
        batches.append(train[start : start + seqlen][None].astype(np.int32))
    return batches


def get_loaders(
    name: str, tokenizer, nsamples: int = 128, seed: int = 0, seqlen: int = 2048
) -> Tuple[List[np.ndarray], np.ndarray]:
    """HF-dataset loaders: ``nsamples`` seeded ``seqlen`` windows of the train
    split and the flat test stream.  Needs the dataset in a local HF cache."""
    if name not in _HF_SPECS:
        raise ValueError(f"unknown dataset {name!r}; options: {list(_HF_SPECS)}")
    ds_name, ds_config, field, joiner = _HF_SPECS[name]
    try:
        from datasets import load_dataset

        train = load_dataset(ds_name, ds_config, split="train")
        test = load_dataset(ds_name, ds_config, split="validation" if name == "c4" else "test")
    except Exception as e:  # no cache
        raise RuntimeError(
            f"could not load dataset {name!r} (no local cache?): {e}. Use synthetic_loaders() offline."
        ) from e
    train_ids = tokenizer(joiner.join(train[field]), return_tensors="np")["input_ids"][0]
    test_ids = tokenizer(joiner.join(test[field]), return_tensors="np")["input_ids"][0]
    return _windows(train_ids, nsamples, seqlen, seed), test_ids.astype(np.int32)


def corpus_loaders(
    nsamples: int = 16, seqlen: int = 2048, seed: int = 0, corpus_dir: str = "data/corpus"
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Loaders over the repository's real-text corpus, byte-tokenized:
    seeded ``seqlen`` windows of train.txt and all of eval.txt."""
    from atom_tpu_torch.utils import bytetok

    train = bytetok.encode_file(os.path.join(corpus_dir, "train.txt"))
    test = bytetok.encode_file(os.path.join(corpus_dir, "eval.txt"))
    return _windows(train, nsamples, seqlen, seed), test.astype(np.int32)
