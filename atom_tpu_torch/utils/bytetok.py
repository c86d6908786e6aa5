"""Byte-level tokenizer, vocab 256 (``atom_tpu/utils/bytetok.py``): raw UTF-8
bytes, the tokenization of the repository's real-text corpus."""
from __future__ import annotations

import numpy as np

VOCAB_SIZE = 256


def encode(text: str | bytes) -> np.ndarray:
    if isinstance(text, str):
        text = text.encode("utf-8", errors="ignore")
    return np.frombuffer(text, dtype=np.uint8).astype(np.int32)


def decode(ids) -> str:
    return bytes(np.asarray(ids, dtype=np.uint8)).decode("utf-8", errors="ignore")


def encode_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)
