"""Paged KV-cache pool: host-side page allocator over the device page arrays
(``atom_tpu/serving/kvpool.py``; the port keeps its own copy).

  * pages live in the nibble-plane layout of ``ops.kv_layout.KVPages``, one
    ``KVPages`` per layer; a page id indexes every layer's arrays at once;
  * batch addressing is a padded page table [B, max_pages] + seq_lens [B]
    (fixed shapes for the kernels) instead of CSR indptr/indices.

Page 0 is reserved as the garbage sink: bucket-padding writes and padded
page-table entries target it, and the decode kernel masks it out through
seq_lens.

The pool is host-side bookkeeping only (numpy): the device page arrays live
in the model's serving state (``serving.model.make_serving_state``).  The
allocation order is the JAX package's, so both packages build the same page
tables for the same requests.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class KvPool:
    """Free-list allocator over ``n_pages`` pages shared by all layers."""

    def __init__(
        self,
        n_layers: int,
        n_pages: int,
        kv_heads: int,
        page_size: int,
        head_dim: int,
    ):
        if n_pages < 2:
            raise ValueError("page 0 is reserved: the pool needs at least 2 pages")
        self.n_layers = n_layers
        self.n_pages = n_pages
        self.kv_heads = kv_heads
        self.page_size = page_size
        self.head_dim = head_dim
        self._free = list(range(n_pages - 1, 0, -1))  # stack; 0 reserved

    @property
    def num_free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"KV pool exhausted: want {n} pages, have {len(self._free)}"
            )
        got = self._free[-n:][::-1]
        del self._free[len(self._free) - n :]
        return got

    def free(self, ids: List[int]) -> None:
        self._free.extend(ids)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)


class SeqKvCache:
    """Per-sequence page list."""

    def __init__(self, pool: KvPool, init_len: int):
        if init_len <= 0:
            raise ValueError("a sequence starts with at least one token")
        self.pool = pool
        self.seqlen = init_len
        self.page_ids: List[int] = pool.alloc(pool.pages_for(init_len))

    def acquire_one(self) -> None:
        """Extend by one token, allocating a page on boundary crossing."""
        self.seqlen += 1
        if self.seqlen > len(self.page_ids) * self.pool.page_size:
            self.page_ids.extend(self.pool.alloc(1))

    def append_slot(self) -> tuple:
        """Reserve the next token's destination: returns (page_id, slot,
        new_seqlen).  The decode step writes the incoming token's KV there and
        attends over ``new_seqlen`` tokens."""
        pos = self.seqlen  # position of the token about to be written
        self.acquire_one()
        return (
            self.page_ids[pos // self.pool.page_size],
            pos % self.pool.page_size,
            self.seqlen,
        )

    def release(self) -> None:
        self.pool.free(self.page_ids)
        self.page_ids = []
        self.seqlen = 0


def batch_page_table(
    seqs: List[Optional[SeqKvCache]], max_pages: int
) -> tuple:
    """Assemble (page_table [B, max_pages], seq_lens [B]) numpy arrays for a
    decode batch.  ``None`` entries are idle slots (-> page 0, length 0)."""
    b = len(seqs)
    table = np.zeros((b, max_pages), np.int32)
    lens = np.zeros((b,), np.int32)
    for i, s in enumerate(seqs):
        if s is None:
            continue
        ids = s.page_ids
        if len(ids) > max_pages:
            raise ValueError(f"sequence needs {len(ids)} pages > max_pages={max_pages}")
        table[i, : len(ids)] = ids
        lens[i] = s.seqlen
    return table, lens
