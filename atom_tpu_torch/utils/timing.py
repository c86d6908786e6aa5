"""Kernel micro-benchmark timing (port of ``atom_tpu/utils/timing.py``).

The JAX version runs the op N times inside one jitted program, so that the
per-call dispatch round trip drops out, and takes the slope between two trip
counts.  On the card the counterpart of one compiled program is a CUDA
graph: the op is captured at both trip counts and each replay is timed
between CUDA events, so the host's launch cost drops out the same way.  A
replay launches its copies back to back, so an op's operands stay in the
50 MB L2 from one copy to the next: these are warm-L2 times, not the cold
ones of ``chip_smoke.py``'s ``Timer``.

On CPU tensors the host clock times eager calls.  Neither eager PyTorch nor
a graph replay elides a repeated call, so the JAX version's numerically
inert carry (``_perturb``, ``perturb_arg``) has no counterpart here.
"""
from __future__ import annotations

import subprocess
import time
from typing import Callable, Sequence

import torch

from atom_tpu_torch.ops.runtime import resolve_device


def _tensors(tree):
    """The tensors of an argument tree of tuples (NamedTuples too), lists and dicts."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            yield from _tensors(item)
    elif isinstance(tree, dict):
        for item in tree.values():
            yield from _tensors(item)


def _capture(op, args, n: int, name: str) -> torch.cuda.CUDAGraph:
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(n):
                op(*args)
    except RuntimeError as e:  # CUDA's capture errors (a synchronising call, a host copy) arrive as RuntimeError
        raise RuntimeError(f"bench_op: {name} cannot be captured in a CUDA graph: {e}") from e
    return graph


def bench_op(op: Callable, args: Sequence, *, iters: int = 100, warmup: bool = True) -> float:
    """Seconds per execution of ``op(*args)``, free of the host's launch cost.

    The op runs at two trip counts, 1 and ``iters + 1``; each is timed three
    times and the fastest kept, and the result is the slope between them.
    On the card each trip count is one CUDA graph (captured after one eager
    call on a side stream, as capture requires), timed by CUDA events around
    its replay; ``warmup`` replays each graph once before timing.  An op that
    cannot be captured raises with its name: it is not timed eagerly instead.
    On the CPU each trip count is a loop of eager calls on the host clock.
    """
    args = list(args)
    tensors = list(_tensors(args))
    if not tensors:
        raise ValueError("bench_op: args hold no tensor, so the device is unknown")
    dev = tensors[0].device
    n_lo, n_hi = 1, iters + 1
    if dev.type == "cuda":
        name = getattr(op, "__qualname__", repr(op))
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            op(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graphs = {n: _capture(op, args, n, name) for n in (n_lo, n_hi)}

        def run(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[n].replay()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
    else:

        def run(n):
            t0 = time.perf_counter()
            for _ in range(n):
                op(*args)
            return time.perf_counter() - t0

    if warmup:
        run(n_lo)
        run(n_hi)
    t_lo = min(run(n_lo) for _ in range(3))
    t_hi = min(run(n_hi) for _ in range(3))
    return max(t_hi - t_lo, 1e-9) / iters


def dispatch_latency(n: int = 5, device=None) -> float:
    """Seconds for the host to run a tiny op and read its result back
    (diagnostics): on the card, one launch and a synchronising copy."""
    dev = resolve_device(device)
    x = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    float(torch.sum(x + 1.0))
    t0 = time.perf_counter()
    for _ in range(n):
        x = x + 1.0
        float(torch.sum(x))
    return (time.perf_counter() - t0) / n


def card_line(device=None) -> str:
    """What a figure was measured on: the card's name and power limit as
    ``nvidia-smi`` reports them, or the device for the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return f"device: {dev}"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        smi = out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi failed: {e}"
    return f"device: {torch.cuda.get_device_name(dev)} ({smi})"
