#!/usr/bin/env python3
"""Tensor- and expert-parallel serving of the port on four cards over NCCL.

One rank a card (``parallel.launch.run_ranks`` with the ``nccl`` backend,
rank r on ``cuda:r``):

  * TP 4 at Llama-2-7B width, all 32 layers, ``ATOM_W4A4``, bf16 head: a
    400-token prefill in the 512 bucket then 33 decode steps at batch 32
    (through a ring flush), fed rank 0's single-device tokens: tokens, and the
    pages and ring of every rank's heads against rank 0's single-device state
    (bit for bit); the decode burst (batch 32, context 512, slope between 1
    and 2 ring windows) and 4 profiled steps (device time a step, busy share)
    beside rank 0's single-device burst on the same card; the engine (cell 2's
    configuration, 8 requests, recorded) against rank 0's single-device engine.
  * EP 4 on Mixtral-8x7B, all 32 layers (two experts, ~6.5 GB of expert
    weights a card), bf16 head: the same steps, state check and burst.

Every rank builds the model from the same seed and keeps its shard; rank 0
also keeps the whole model for its single-device runs.  Results go to
``--out`` (JSON) and the last line of stdout.

Usage: python3 scripts/torch_parallel_nccl.py [--out chiprun_out/parallel_nccl.json] [--world 4] [--layers 32]
       (on a host with four cards, ~9 minutes; ``--world 1 --layers 2`` runs the script's paths on one card)
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4


def _sync(torch, barrier: bool):
    torch.cuda.synchronize()
    if barrier:
        torch.distributed.barrier()


def _burst_inputs(torch, cs, sizes, dev):
    """A burst's page table (every slot its own pages), ids and lengths (a
    pinned context of 512 over zero pages, as phase 3's burst)."""
    b, mp = sizes["batch"], sizes["max_pages"]
    table = (1 + torch.arange(b * mp, device=dev, dtype=torch.int32)).reshape(b, mp)
    return table, torch.ones((b,), dtype=torch.int32, device=dev), torch.full((b,), cs.CTX, dtype=torch.int32, device=dev)


def _burst(torch, cs, decode_fn, state, sizes, dev, windows: int, barrier: bool):
    """``windows`` ring windows of decode steps at batch 32 -> seconds."""
    table, ids, lens = _burst_inputs(torch, cs, sizes, dev)
    state = state._replace(flushed=lens.clone(), row=0)
    _sync(torch, barrier)
    t = time.perf_counter()
    for _ in range(windows * state.hot[0].window):
        lens = lens + 1
        ids, state = decode_fn(state, ids, table, lens)
    _sync(torch, barrier)
    return time.perf_counter() - t


def _rate(torch, cs, make_fns, make_state, sizes, dev, profile_file: str, barrier: bool = True) -> dict:
    """Decode rate by the slope between 1 and 2 windows (fresh step functions
    each, so each burst flushes at its windows' ends), and 4 profiled steps
    (device time and kernels a step, busy share).  ``barrier``: every rank
    runs it (a parallel step), else this rank alone."""
    secs = {n: _burst(torch, cs, make_fns()[1], make_state(), sizes, dev, n, barrier) for n in (1, 2)}
    step_ms = (secs[2] - secs[1]) / 32 * 1e3
    decode_fn = make_fns()[1]
    table, ids, lens = _burst_inputs(torch, cs, sizes, dev)
    box = dict(state=make_state()._replace(flushed=lens.clone(), row=0), lens=lens)

    def once():
        for _ in range(4):
            box["lens"] = box["lens"] + 1
            _, box["state"] = decode_fn(box["state"], ids, table, box["lens"])
        torch.cuda.synchronize()

    prof = cs.profile_once(torch, once, profile_file, "4 decode steps")
    return dict(ms_per_step=step_ms, tok_s=sizes["batch"] / step_ms * 1e3, burst_s={str(k): v for k, v in secs.items()},
                device_ms_per_step=prof["device_ms"] / 4, kernels_per_step=prof["device_kernels"] / 4,
                busy_share=prof["device_busy_share"], profiled_wall_ms_per_step=prof["wall_ms"] / 4)


def _state_check(torch, cs, ref: dict | None, mine: dict, group, rank: int, world: int) -> dict:
    """Rank 0's single-device state broadcast field by field; each rank holds
    its heads of it against its own -> the differing entries over all ranks."""
    import torch.distributed as dist

    differing = torch.zeros((), dtype=torch.float64, device="cuda")
    total = 0
    for key, t in mine.items():
        shape = list(t.shape)
        if key != "flushed":
            shape[cs.PAR_HEAD_DIM[key.split(".")[-1]]] *= world
        whole = (ref[key].cuda() if rank == 0 else torch.empty(shape, dtype=t.dtype, device="cuda"))
        dist.broadcast(whole, src=0, group=group)
        if key != "flushed":
            d = cs.PAR_HEAD_DIM[key.split(".")[-1]]
            h = shape[d] // world
            whole = whole.narrow(d, rank * h, h)
        differing += cs.bits(whole).ne(cs.bits(t.cuda())).sum()
        total += t.numel()
    dist.all_reduce(differing, group=group)
    return dict(entries_differing=int(differing.item()), entries=total * world)


def nccl_rank(rank: int, world: int, dev, out_dir: str, layers: int) -> dict:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import atom_tpu_torch.serving.model as model
    import atom_tpu_torch.serving.moe as moe
    import atom_tpu_torch.serving.parallel as par
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.models.configs import MIXTRAL_8X7B
    from atom_tpu_torch.parallel.mesh import all_gather_cols, make_mesh

    cs.OUT = Path(out_dir)
    cs.par_backend_flags(torch)
    sizes = dict(cs.par_sizes(), llama=cs.llama7b(layers), mixtral=MIXTRAL_8X7B.replace(num_layers=layers))
    burst_sizes = dict(sizes, max_pages=sizes["batch"] * sizes["max_pages"])  # the bursts' pool: every slot's pages
    mesh = make_mesh((world,), ("tp",))
    ep_mesh = make_mesh((world,), ("ep",))
    group = mesh.get_group("tp")
    res: dict = {"card": torch.cuda.get_device_name(dev), "rank": rank}

    def steps(fns, state, mod, feed):
        rows = []
        with cs.record_logits(mod, rows):
            toks, state = cs.par_steps(torch, dev, sizes, *fns, state, feed=feed)
        return toks, state, torch.stack(rows)

    for what, cfg, axis, m in (("tp", sizes["llama"], "tp", mesh), ("ep", sizes["mixtral"], "ep", ep_mesh)):
        t0 = time.perf_counter()
        if what == "tp":
            whole = model.init_serving_params(cfg, ATOM_W4A4, seed=0, device=dev)
            shard = par.shard_serving_params(whole, cfg, m)
            single_fns = lambda: model.make_step_fns(whole, cfg, ATOM_W4A4)  # noqa: E731
            par_fns = lambda: par.make_tp_step_fns(shard, cfg, ATOM_W4A4, m)  # noqa: E731
            mod_single, mod_par = model, par
        else:
            whole = moe.init_moe_serving_params(cfg, ATOM_W4A4, seed=0, device=dev)
            shard = moe.shard_moe_serving_params(whole, cfg, m)
            single_fns = lambda: moe.make_moe_step_fns(whole, cfg, ATOM_W4A4)  # noqa: E731
            par_fns = lambda: moe.make_moe_ep_step_fns(shard, cfg, ATOM_W4A4, m)  # noqa: E731
            mod_single, mod_par = moe, moe
        if rank:
            del whole
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        r = res[what] = dict(init_s=time.perf_counter() - t0, layers=cfg.num_layers)

        feed = [None]
        if rank == 0:
            toks, state, logits = steps(single_fns(), cs.par_state(sizes, cfg, dev), mod_single, None)
            ref = dict(tokens=toks, logits=logits, state=cs.state_tensors(state))
            del state
            feed = [toks[:-1]]
        dist.broadcast_object_list(feed, src=0)
        toks, state, logits = steps(par_fns(), cs.par_state(sizes, cfg, dev, m, axis), mod_par, feed[0])
        logits = all_gather_cols(logits.to(dev), m.get_group(axis)).cpu()  # NCCL gathers on the card
        r["state"] = _state_check(torch, cs, ref["state"] if rank == 0 else None, cs.state_tensors(state),
                                  m.get_group(axis), rank, world)
        del state
        if rank == 0:
            r["tokens"] = cs.par_token_check(torch, f"{what} {world} steps, {cfg.num_layers} layers", ref["tokens"],
                                             ref["logits"], toks, logits)
        r["rate"] = _rate(torch, cs, par_fns, lambda: cs.par_state(burst_sizes, cfg, dev, m, axis), sizes, dev,
                          f"profile_nccl_{what}_rank{rank}.txt")
        if what == "tp":
            engine, pool, n_pages, rs = cs.par_engine(sizes, cfg, dev, par_fns(), m)
            _sync(torch, True)
            out = engine.run(rs, record=True)
            r["engine"] = dict(tok_s=out["throughput_tok_s"], output_tok_s=out["output_tok_s"],
                               decode_ms_per_token=out["decode_ms_per_token_avg"], decode_steps=out["decode_steps"],
                               pages_returned=pool.num_free_pages == n_pages - 1)
            tokens = out["tokens"]
            del engine, pool
        if rank == 0:
            r["single_rate"] = _rate(torch, cs, single_fns, lambda: cs.par_state(burst_sizes, cfg, dev), sizes, dev,
                                     f"profile_nccl_{what}_single.txt", barrier=False)
            if what == "tp":
                engine, pool, n_pages, rs = cs.par_engine(sizes, cfg, dev, single_fns())
                out = engine.run(rs, record=True)
                r["single_engine"] = dict(tok_s=out["throughput_tok_s"], output_tok_s=out["output_tok_s"],
                                          decode_ms_per_token=out["decode_ms_per_token_avg"])
                r["engine"]["first_tokens_equal"] = sum(tokens[i][0] == out["tokens"][i][0] for i in range(len(rs)))
                r["engine"]["transcripts_equal"] = sum(tokens[i] == out["tokens"][i] for i in range(len(rs)))
                r["engine"]["requests"] = len(rs)
                del engine, pool
            del whole
        dist.barrier()
        del shard
        torch.cuda.empty_cache()
        r["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return res


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "parallel_nccl.json"))
    ap.add_argument("--world", type=int, default=WORLD, help="ranks, one card each")
    ap.add_argument("--layers", type=int, default=32, help="depth of both models")
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < args.world:
        print(f"torch_parallel_nccl: needs {args.world} CUDA devices", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from atom_tpu_torch.ops import _build
    from atom_tpu_torch.parallel.launch import run_ranks

    cards = cs.subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    print("\n".join(cards), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    out_dir = Path(args.out).parent
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    ranks = run_ranks(nccl_rank, args.world, backend="nccl", device="cuda", timeout_s=1200,
                      args=(str(out_dir), args.layers))
    summary = dict(cards=cards, world=args.world, layers=args.layers, build_s=build_s, ranks_s=time.perf_counter() - t0, rank0=ranks[0],
                   rates_by_rank={what: [r[what]["rate"] for r in ranks] for what in ("tp", "ep")},
                   states_by_rank={what: [r[what]["state"] for r in ranks] for what in ("tp", "ep")})
    Path(args.out).write_text(json.dumps(summary, indent=1))
    ok = all(s["entries_differing"] == 0 for what in ("tp", "ep") for s in summary["states_by_rank"][what])
    print(json.dumps(dict(summary, ok=ok)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
