"""Run a function on ``world`` ranks, one process each, over ``torch.distributed``.

The JAX package runs its meshes on devices one process drives (virtual CPU
devices in its tests); the port's ranks are processes.  ``run_ranks`` spawns
them (``multiprocessing``'s ``spawn`` context: a fresh interpreter each, so
``fn`` must be importable by its module path and its module must not import
JAX), joins them to one process group over a ``FileStore`` in a temporary
directory (no port to collide with another run on the host), and returns
each rank's result in rank order.

It raises as soon as any rank fails (with that rank's traceback) and when
the run passes ``timeout_s`` (a hung collective, a rank that never returns):
either way every rank still running is killed first, so a fault costs
seconds, not a test run's time limit.  ``timeout_s`` is also the process
group's collective timeout.

On the card every rank uses ``device`` (``cuda:i``), or with ``cuda`` and no
index rank r takes ``cuda:r`` (one card a rank, as NCCL wants); ranks that
share one card need the ``gloo`` backend (NCCL refuses two ranks on one
device).
Kernels are built by the caller before the ranks start
(``ops._build.build_all()``): the ranks only load them.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

_POLL_S = 0.05
_GRACE_S = 3.0


def _rank_entry(fn, rank: int, world: int, backend: str, device: str, tmp: str, timeout_s: float, args) -> None:
    out = Path(tmp)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        store = dist.FileStore(str(out / "store"), world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, out / f"rank{rank}.pt.tmp")
        os.replace(out / f"rank{rank}.pt.tmp", out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(timeout=10)


def run_ranks(fn: Callable[..., Any], world: int, backend: str = "gloo", device: str = "cpu",
              timeout_s: float = 300.0, args: Sequence[Any] = ()) -> List[Any]:
    """``fn(rank, world, device, *args)`` on ``world`` spawned ranks ->
    their results, in rank order.  Results travel through ``torch.save``
    (tensors on the card: move them to the CPU first)."""
    if world < 1:
        raise ValueError(f"run_ranks: world must be positive, got {world}")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="atom_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_entry, args=(fn, r, world, backend, str(device), tmp, timeout_s, tuple(args)),
                             daemon=True, name=f"rank{r}") for r in range(world)]
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.start()
            while True:
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes):
                    # the ranks a failure strands in a collective fail too: give them a moment, then report
                    # every rank's traceback, the earliest written first (the cause)
                    grace = time.monotonic() + _GRACE_S
                    while time.monotonic() < grace and any(p.exitcode is None for p in procs):
                        time.sleep(_POLL_S)
                    _stop(procs)
                    failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                    errs = sorted(Path(tmp).glob("rank*.err"), key=lambda e: e.stat().st_mtime)
                    detail = "\n".join(f"--- {e.stem}:\n{e.read_text()}" for e in errs) or f"exit codes {codes}"
                    raise RuntimeError(f"run_ranks: rank(s) {failed} of {world} failed:\n{detail}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    running = [r for r, c in enumerate(codes) if c is None]
                    _stop(procs)
                    raise TimeoutError(f"run_ranks: rank(s) {running} of {world} still running after {timeout_s} s")
                time.sleep(_POLL_S)
            return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(world)]
        finally:
            _stop(procs)
