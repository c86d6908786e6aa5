"""Build and load the CUDA kernels under ``atom_tpu_torch/csrc``.

Each ``csrc/*.cu`` compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes``.  All sources compile in parallel
(one ``nvcc`` each) on the first kernel launch of the process, into
``atom_tpu_torch/build/`` (listed in ``.gitignore``), named by a hash of the
sources and flags so a changed source rebuilds.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` — no
multiply-add contraction, so each kernel rounds its float math in the
order its plain PyTorch version does.  No ``--use_fast_math``: the
quantizers need IEEE division and round-half-to-even.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "--fmad=false",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(stem: str) -> Path:
    return BUILD / f"{stem}-{_digest()}.so"


@functools.cache
def build_all() -> dict:
    """Compile every ``csrc/*.cu`` not yet built; return {stem: ptxas log}."""
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = _lib_path(src.stem)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs[src.stem] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    logs, failed = {}, []
    for stem, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[stem] = log
        if proc.returncode != 0:
            failed.append(f"--- {stem}.cu (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


@functools.cache
def load(stem: str) -> ctypes.CDLL:
    """The built library of ``csrc/<stem>.cu`` (building all sources first)."""
    build_all()
    return ctypes.CDLL(str(_lib_path(stem)))


def stream() -> int:
    """Handle of PyTorch's current CUDA stream, for a kernel's launch."""
    return torch.cuda.current_stream().cuda_stream


def check(err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
