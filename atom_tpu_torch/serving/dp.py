"""Engine-level data parallelism (``atom_tpu/serving/dp.py``): independent
worksets, one per group.

Each dp group holds a whole model replica (on its tp ranks), its own KV
pool and serving state and its own FCFS workset; requests are partitioned
up front and groups never talk to each other.

Two forms, one result:

  * groups in one process, as the JAX package runs them: ``engines`` a list
    of engines (tp 1, each on its device, or several on one card), run in
    host threads by ``run_data_parallel``;
  * groups of ranks: the JAX package hands ``make_dp_tp_engines`` a device
    list and builds every group in one process; the port's ranks are
    processes, so it takes the rank mesh (axes ``dp`` and ``tp``) in place of
    the device list and returns this rank's group's engine alone, and
    ``run_data_parallel(..., mesh=mesh)`` runs that group's partition and
    gathers every group's result over ``dp``, so each rank returns the whole
    result.

Groups on one card share the kernels' launch counters, which are not
locked: read them around the whole run, not per thread.
"""
from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from atom_tpu_torch.serving.engine import TextGenEngine
from atom_tpu_torch.serving.workload import RequestSet


def split_requests(rs: RequestSet, dp: int) -> List[RequestSet]:
    """Round-robin request partition (arrival order kept inside a group)."""
    parts = []
    for i in range(dp):
        idx = np.arange(i, len(rs), dp)
        parts.append(RequestSet(
            prompt_lens=np.asarray(rs.prompt_lens)[idx],
            output_lens=np.asarray(rs.output_lens)[idx],
            prompts=[rs.prompts[j] for j in idx],
            adapter_ids=None if rs.adapter_ids is None else np.asarray(rs.adapter_ids)[idx],
        ))
    return parts


def _aggregate(results: List[dict]) -> dict:
    elapsed = max(r["elapsed_s"] for r in results)
    total = sum(r["total_tokens"] for r in results)
    out = sum(r["output_tokens"] for r in results)
    return {
        "dp": len(results),
        "elapsed_s": elapsed,
        "requests": sum(r["requests"] for r in results),
        "total_tokens": total,
        "output_tokens": out,
        "throughput_tok_s": total / elapsed,
        "output_tok_s": out / elapsed,
        "ttft_avg_s": float(np.mean([r["ttft_avg_s"] for r in results])),
        "decode_ms_per_token_avg": float(np.mean([r["decode_ms_per_token_avg"] for r in results])),
        "per_group": results,
    }


def run_data_parallel(engines: List[TextGenEngine], rs: RequestSet, progress: bool = False, record: bool = False,
                      mesh=None) -> dict:
    """Run the workload over the dp groups -> aggregate statistics.

    Throughput is the sum over groups against the slowest group's wall
    clock (all groups start together).  ``record=True`` adds each group's
    token transcripts (``per_group[i]["tokens"]``).  Without ``mesh`` each
    engine is a group, run in its own host thread; with it, ``engines`` is
    this rank's group (``make_dp_tp_engines``) and the groups are the
    mesh's ``dp`` axis.  A group's failure raises."""
    if mesh is not None:
        from atom_tpu_torch.parallel.mesh import axis_index, axis_size

        dp = axis_size(mesh, "dp")
        (engine,) = engines
        mine = engine.run(split_requests(rs, dp)[axis_index(mesh, "dp")], progress=progress, record=record)
        results: List[Optional[dict]] = [None] * dp
        dist.all_gather_object(results, mine, group=mesh.get_group("dp"))
        return _aggregate(results)

    parts = split_requests(rs, len(engines))
    results = [None] * len(engines)
    errors = [None] * len(engines)

    def worker(i):
        try:
            results[i] = engines[i].run(parts[i], progress=progress and i == 0, record=record)
        except BaseException as e:  # raised again below, in the caller's thread
            errors[i] = e

    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(len(engines))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return _aggregate(results)


def _to(tree, dev):
    """A params tree of NamedTuples and lists on ``dev`` (tensors already
    there are kept, not copied)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to(t, dev) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(t, dev) for t in tree)
    return tree


def make_dp_tp_engines(params, cfg, spec, tg, mesh, dp: int, tp: int) -> List[TextGenEngine]:
    """The engines of dp groups of tp ranks, each over its own KV pool and
    state.

    ``mesh`` is a list of devices (tp 1: one engine a device, in this
    process; a device may repeat) or a rank mesh with axes ``dp`` and ``tp``
    of that shape, for which this rank's group's engine comes back alone
    (its tensor-parallel step functions over ``tp``, its pages and ring
    split by head).  ``params`` is the whole model on this process's
    device; replicas hold the same weights."""
    from atom_tpu_torch.serving.kvpool import KvPool
    from atom_tpu_torch.serving.model import make_serving_state, make_step_fns

    n_pool = tg.batch_size * tg.max_seq_len // tg.page_size + 16

    def pool():
        return KvPool(cfg.num_layers, n_pool, cfg.num_kv_heads, tg.page_size, cfg.head_dim)

    if isinstance(mesh, (list, tuple)):
        if tp != 1 or len(mesh) < dp:
            raise ValueError(f"a device list runs dp groups of tp 1: got {len(mesh)} devices, dp {dp}, tp {tp}")
        engines = []
        for dev in mesh[:dp]:
            state = make_serving_state(cfg.num_layers, n_pool, tg.batch_size, cfg.num_kv_heads, tg.page_size,
                                       cfg.head_dim, device=dev)
            engines.append(TextGenEngine(tg, pool(), *make_step_fns(_to(params, dev), cfg, spec), state))
        return engines

    from atom_tpu_torch.parallel.mesh import axis_size
    from atom_tpu_torch.serving.parallel import make_state_sharded, make_tp_step_fns, shard_serving_params

    if (axis_size(mesh, "dp"), axis_size(mesh, "tp")) != (dp, tp):
        raise ValueError(f"the mesh is not dp {dp} x tp {tp}")
    sparams = shard_serving_params(params, cfg, mesh)
    state = make_state_sharded(cfg.num_layers, n_pool, tg.batch_size, cfg.num_kv_heads, tg.page_size, cfg.head_dim,
                               mesh, device=params.embed.device)
    return [TextGenEngine(tg, pool(), *make_tp_step_fns(sparams, cfg, spec, mesh), state)]
