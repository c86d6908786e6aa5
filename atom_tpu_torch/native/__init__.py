"""Native (C++) serving runtime: page allocator + FCFS batch scheduler
(``atom_tpu/native``; the port keeps its own copy of ``scheduler.cc``).

Built on first use with ``g++ -O2 -std=c++17 -shared -fPIC`` into
``atom_tpu_torch/build/`` (named by a hash of the source, so a changed
source rebuilds) and bound through ctypes.  ``TextGenEngine(native=True)``
runs its page assignment and per-step table assembly here; the assignment
order is the Python ``KvPool``'s, so both give the same tables and tokens.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "scheduler.cc"
BUILD = Path(__file__).resolve().parent.parent / "build"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lib = None


def _build() -> Path:
    """The shared library for this source, compiled if missing.  It is
    written under a temporary name and renamed, so processes that build it
    at once never load a half-written file."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes()).hexdigest()[:16]
    lib = BUILD / f"libatomserve-{digest}.so"
    if lib.exists():
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load_native():
    """ctypes handle to the native runtime (builds it on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
    i32 = ctypes.c_int32
    p32 = ctypes.POINTER(ctypes.c_int32)
    lib.atom_sched_create.restype = ctypes.c_void_p
    lib.atom_sched_create.argtypes = [i32, i32, i32, i32]
    lib.atom_sched_destroy.restype = None
    lib.atom_sched_destroy.argtypes = [ctypes.c_void_p]
    lib.atom_sched_free_pages.restype = i32
    lib.atom_sched_free_pages.argtypes = [ctypes.c_void_p]
    lib.atom_sched_admit.restype = i32
    lib.atom_sched_admit.argtypes = [ctypes.c_void_p, i32, i32, i32]
    lib.atom_sched_admit_hold.restype = i32
    lib.atom_sched_admit_hold.argtypes = [ctypes.c_void_p, i32, i32, i32]
    lib.atom_sched_activate.restype = None
    lib.atom_sched_activate.argtypes = [ctypes.c_void_p, i32, i32]
    lib.atom_sched_release.restype = None
    lib.atom_sched_release.argtypes = [ctypes.c_void_p, i32]
    lib.atom_sched_table_row.restype = None
    lib.atom_sched_table_row.argtypes = [ctypes.c_void_p, i32, p32]
    lib.atom_sched_decode_step.restype = i32
    lib.atom_sched_decode_step.argtypes = [ctypes.c_void_p, p32, p32, p32]
    lib.atom_sched_active.restype = i32
    lib.atom_sched_active.argtypes = [ctypes.c_void_p]
    lib.atom_sched_seqlen.restype = i32
    lib.atom_sched_seqlen.argtypes = [ctypes.c_void_p, i32]
    _lib = lib
    return lib


class NativeScheduler:
    """Python facade over the C++ scheduler (numpy buffers filled in place)."""

    def __init__(self, batch_size: int, n_pages: int, page_size: int, max_pages: int):
        self._lib = load_native()
        self._h = self._lib.atom_sched_create(batch_size, n_pages, page_size, max_pages)
        self.batch_size = batch_size
        self.max_pages = max_pages
        # step-path buffers, reused every call
        self._table = np.zeros((batch_size, max_pages), np.int32)
        self._lens = np.zeros((batch_size,), np.int32)
        self._finished = np.zeros((batch_size,), np.int32)
        self._row = np.zeros((max_pages,), np.int32)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.atom_sched_destroy(self._h)
            self._h = None

    @property
    def num_free_pages(self) -> int:
        return self._lib.atom_sched_free_pages(self._h)

    @property
    def num_active(self) -> int:
        return self._lib.atom_sched_active(self._h)

    def admit(self, request_id: int, prompt_len: int, output_len: int) -> int:
        """The slot, or -1 (no slot) / -2 (pool exhausted) / -3 (prompt +
        output exceed ``max_pages`` pages: the request can never be served)."""
        return self._lib.atom_sched_admit(self._h, request_id, prompt_len, output_len)

    def admit_hold(self, request_id: int, prompt_len: int, output_len: int) -> int:
        """``admit`` with the slot's decoding held until ``activate`` (its
        prefill is in flight)."""
        return self._lib.atom_sched_admit_hold(self._h, request_id, prompt_len, output_len)

    def _slot(self, slot: int) -> int:
        """``slot``, checked: the C++ side indexes its slots unchecked."""
        if not 0 <= slot < self.batch_size:
            raise IndexError(f"slot {slot} outside [0, {self.batch_size})")
        return slot

    def activate(self, slot: int, remaining: int) -> None:
        self._lib.atom_sched_activate(self._h, self._slot(slot), remaining)

    def release(self, slot: int) -> None:
        self._lib.atom_sched_release(self._h, self._slot(slot))

    def table_row(self, slot: int) -> np.ndarray:
        """The slot's page-table row (a reused buffer: copy it to keep it)."""
        self._lib.atom_sched_table_row(self._h, self._slot(slot),
                                       self._row.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return self._row

    def seqlen(self, slot: int) -> int:
        return self._lib.atom_sched_seqlen(self._h, self._slot(slot))

    def decode_step(self) -> Tuple[np.ndarray, np.ndarray, List[int]]:
        """Extend every active sequence by one token -> (page_table [B, MP],
        seq_lens [B], request ids retired this step; the two arrays are
        reused buffers)."""
        p32 = ctypes.POINTER(ctypes.c_int32)
        n = self._lib.atom_sched_decode_step(
            self._h, self._table.ctypes.data_as(p32), self._lens.ctypes.data_as(p32),
            self._finished.ctypes.data_as(p32),
        )
        if n == -2:
            raise RuntimeError("KV pool exhausted during decode step")
        if n == -3:
            raise RuntimeError("sequence outgrew max_pages_per_seq during decode step")
        return self._table, self._lens, self._finished[:n].tolist()
