"""End-to-end text-generation benchmark across serving stacks (port of
``atom_tpu/benchmarks/bench_textgen.py``).

The same seeded synthetic ShareGPT-like workload through the same
continuous-batching engine, for each stack:

  * ``w4a4``  — Atom W4A4: packed 4-bit GEMMs + INT4 paged KV;
  * ``bf16``  — bf16 weights and KV;
  * ``w8a8``  — SmoothQuant-style INT8 with int8 dense KV;
  * ``w4a16`` — weight-only INT4;
  * ``moe``   — W4A4 Mixtral-8x7B (burst only);
  * ``lora``  — W4A4 with a distinct rank-r adapter per request.

Two modes:
  * ``--engine``: the whole engine loop, host scheduling included;
  * default: steady-state decode burst throughput, the step time taken as the
    slope between two burst lengths (the median of the positive samples).

    python -m atom_tpu_torch.benchmarks.bench_textgen --stacks w4a4 bf16 --layers 8 [--device cpu]

Random weights come from seeded ``torch.Generator``s: seed 0 for the
params, seed 1 for the LoRA store.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from atom_tpu_torch import serving
from atom_tpu_torch.config import ATOM_W4A4
from atom_tpu_torch.models.configs import Arch, ModelConfig
from atom_tpu_torch.ops.kv_hot import HOT_W
from atom_tpu_torch.ops.runtime import resolve_device
from atom_tpu_torch.serving import baselines as bl
from atom_tpu_torch.serving import lora as sl
from atom_tpu_torch.serving import model as sm
from atom_tpu_torch.serving import moe as smoe
from atom_tpu_torch.utils.timing import card_line


def model_cfg(name: str, layers: int) -> ModelConfig:
    geom = {
        "7b": dict(hidden_size=4096, intermediate_size=11008, num_heads=32,
                   num_kv_heads=32),
        "13b": dict(hidden_size=5120, intermediate_size=13824, num_heads=40,
                    num_kv_heads=40),
        # Llama-2-70B's per-layer geometry (GQA, 8 kv heads): a layer slice
        "70b": dict(hidden_size=8192, intermediate_size=28672, num_heads=64,
                    num_kv_heads=8),
    }[name]
    return ModelConfig(
        arch=Arch.LLAMA,
        vocab_size=32000,
        num_layers=layers,
        head_dim=128,
        max_position_embeddings=2048,
        **geom,
    )


def _ring_burst_state(cfg: ModelConfig, batch: int, ctx: int, n_steps: int, dev):
    """The W4A4-family bursts' set-up -> (n_hi, page table, [state, ids, lens]).

    The page table covers every step the timing advances: ``_slope_tok_s``
    runs a warm-up of 2 windows and 3 rounds of (2 + n_hi) windows of
    ``HOT_W`` steps each (a burst needs its table to cover it).  Every
    sequence starts with ``ctx`` tokens already in its pages."""
    n_hi = max(n_steps // HOT_W, 2) + 2
    total_steps = (2 + 3 * (2 + n_hi)) * HOT_W
    page, maxp = 256, -(-(ctx + total_steps + 64) // 256)
    pool = serving.KvPool(cfg.num_layers, batch * maxp + 1, cfg.num_kv_heads, page, cfg.head_dim)
    table = np.zeros((batch, maxp), np.int32)
    for b in range(batch):
        table[b] = np.asarray(pool.alloc(maxp), np.int32)
    mstate = sm.make_serving_state(
        cfg.num_layers, batch * maxp + 1, batch, cfg.num_kv_heads, page, cfg.head_dim, device=dev,
    )._replace(flushed=torch.full((batch,), ctx, dtype=torch.int32, device=dev))
    state = [mstate, torch.ones((batch,), dtype=torch.int32, device=dev),
             torch.full((batch,), ctx, dtype=torch.int32, device=dev)]
    return n_hi, torch.from_numpy(table).to(dev), state


def _w4a4_params(cfg: ModelConfig, head: str, dev):
    params = sm.init_serving_params(cfg, ATOM_W4A4, seed=0, device=dev)
    if head != "bf16":
        params = sm.quantize_lm_head(params, bits=4 if head == "w4a16" else 8)
    return params


def burst_throughput_w4a4(cfg, batch, ctx, n_steps=32, head="bf16", device=None):
    dev = resolve_device(device)
    spec = ATOM_W4A4
    params = _w4a4_params(cfg, head, dev)
    n_hi, table, state = _ring_burst_state(cfg, batch, ctx, n_steps, dev)

    def run(n):  # n = ring windows of HOT_W steps each
        ids, st, lens = sm.decode_burst(params, state[0], state[1], table, state[2], n, cfg, spec)
        state[0], state[1], state[2] = st, ids, lens
        return float(torch.sum(ids))

    tok_s, per_window = _slope_tok_s(run, batch * HOT_W, n_hi)
    return tok_s, per_window / HOT_W


def burst_throughput_moe(batch, ctx, n_steps=32, layers=8, device=None):
    """Mixtral-8x7B-width W4A4 decode burst (the MoE serving path) over
    ``layers`` layers; the card holds all 32."""
    dev = resolve_device(device)
    cfg = ModelConfig(
        arch=Arch.MIXTRAL, vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=layers, num_heads=32,
        num_kv_heads=8, head_dim=128, num_experts=8, num_experts_per_tok=2,
    )
    spec = ATOM_W4A4
    params = smoe.init_moe_serving_params(cfg, spec, seed=0, device=dev)
    n_hi, table, state = _ring_burst_state(cfg, batch, ctx, n_steps, dev)

    def run(n):  # n = ring windows of HOT_W steps
        ids, st, lens = smoe.decode_burst_moe(params, state[0], state[1], table, state[2], n, cfg, spec)
        state[0], state[1], state[2] = st, ids, lens
        return float(torch.sum(ids))

    tok_s, per_window = _slope_tok_s(run, batch * HOT_W, n_hi)
    return tok_s, per_window / HOT_W


def burst_throughput_lora(cfg, batch, ctx, n_steps=32, rank=16, head="w8a16", device=None):
    """W4A4 + per-request LoRA decode burst: every request carries a
    distinct rank-r adapter, the worst case for adapter traffic.  ``head``
    must match the w4a4 row's lm_head precision, or the ratio between the
    two rows mixes head cost into adapter cost."""
    dev = resolve_device(device)
    spec = ATOM_W4A4
    params = _w4a4_params(cfg, head, dev)
    lw = sl.init_llama_lora(cfg, capacity=batch, rank=rank, seed=1, device=dev)
    adapters = torch.arange(batch, dtype=torch.int32, device=dev)
    n_hi, table, state = _ring_burst_state(cfg, batch, ctx, n_steps, dev)

    def run(n):  # n = ring windows of HOT_W steps
        ids, st, lens = sl.lora_decode_burst(params, lw, state[0], state[1], table, state[2], n, adapters, cfg, spec)
        state[0], state[1], state[2] = st, ids, lens
        return float(torch.sum(ids))

    tok_s, per_window = _slope_tok_s(run, batch * HOT_W, n_hi)
    return tok_s, per_window / HOT_W


def _slope_tok_s(run, batch, n_hi):
    """(tokens/s, seconds per unit of ``run``) from the slope between runs of
    2 and ``n_hi`` units, 3 samples after a warm-up run.  The median of the
    positive samples: a host stall can make one sample negative, and the
    JAX version's ``min`` once published a negative rate."""
    run(2)  # warm-up
    samples = []
    for _ in range(3):
        t0 = time.perf_counter(); run(2); t_lo = time.perf_counter() - t0  # noqa: E702
        t0 = time.perf_counter(); run(n_hi); t_hi = time.perf_counter() - t0  # noqa: E702
        samples.append((t_hi - t_lo) / (n_hi - 2))
    positive = [s for s in samples if s > 0]
    if not positive:
        raise RuntimeError(f"no positive slope sample between 2 and {n_hi}: {samples}")
    per = statistics.median(positive)
    return batch / per, per


def burst_throughput_baseline(cfg, batch, ctx, kind, n_steps=32, device=None):
    dev = resolve_device(device)
    max_t = ctx + n_steps * 3 + 64
    # w8a8 stores 8-bit KV; bf16 and w4a16 keep bf16 KV
    kv_dtype = torch.int8 if kind == "w8a8" else torch.bfloat16
    kvs = bl.make_dense_kv(cfg.num_layers, batch, max_t, cfg.num_kv_heads, cfg.head_dim, dtype=kv_dtype, device=dev)
    init, burst = {
        "bf16": (bl.init_bf16_params, bl.bf16_decode_burst),
        "w4a16": (bl.init_w4a16_params, bl.w4a16_decode_burst),
        "w8a8": (bl.init_w8_params, bl.w8a8_decode_burst),
    }[kind]
    params = init(cfg, seed=0, device=dev)
    state = [kvs, torch.ones((batch,), dtype=torch.int32, device=dev),
             torch.full((batch,), ctx, dtype=torch.int32, device=dev)]

    def run(n):
        ids, kvs_, lens = burst(params, state[0], state[1], state[2], n, cfg)
        state[0], state[1], state[2] = kvs_, ids, lens
        return float(torch.sum(ids))

    return _slope_tok_s(run, batch, n_steps)


def engine_run(cfg, batch, n_requests, stack="w4a4", sched="mixed", device=None):
    """``sched``: "mixed" gives w4a4 chunked-prefill scheduling (its
    production mode); "serial" forces whole-prompt prefills for every stack,
    so cross-stack engine ratios compare quantization schemes, not
    schedulers (the baselines have serial prefill only)."""
    dev = resolve_device(device)
    tg = serving.TextGenConfig(batch_size=batch, max_seq_len=1024, page_size=256,
                               prefill_buckets=(128, 256, 512))
    n_pool = batch * tg.max_seq_len // tg.page_size + 16
    pool = serving.KvPool(cfg.num_layers, n_pool, cfg.num_kv_heads, tg.page_size, cfg.head_dim)
    if stack == "moe":
        raise ValueError("engine mode has no moe stack (burst-only row); drop --engine")
    chunk_fn = None
    lora = stack == "lora"
    if stack in ("w4a4", "lora"):
        spec = ATOM_W4A4
        params = sm.init_serving_params(cfg, spec, seed=0, device=dev)
        lw = sl.init_llama_lora(cfg, capacity=batch, rank=16, seed=1, device=dev) if lora else None
        state = sm.make_serving_state(cfg.num_layers, n_pool, batch, cfg.num_kv_heads, tg.page_size, cfg.head_dim,
                                      device=dev)
        if lora:
            step_fns = sl.make_lora_step_fns(params, lw, cfg, spec)
        else:
            # mixed scheduling: prompts ride the decode batch in page chunks
            pre, dec, chunk_fn = sm.make_mixed_step_fns(params, cfg, spec)
            if sched == "serial":
                chunk_fn = None
            step_fns = (pre, dec)
    else:
        init = {"bf16": bl.init_bf16_params, "w8a8": bl.init_w8_params, "w4a16": bl.init_w4a16_params}[stack]
        params = init(cfg, seed=0, device=dev)
        state = bl.make_dense_kv(cfg.num_layers, batch, tg.max_seq_len, cfg.num_kv_heads, cfg.head_dim,
                                 dtype=torch.int8 if stack == "w8a8" else torch.bfloat16, device=dev)
        step_fns = bl.make_baseline_step_fns(params, cfg, stack)
    engine = serving.TextGenEngine(tg, pool, *step_fns, state, chunk_fn=chunk_fn, lora=lora)
    rs = serving.synth_requests(n_requests, cfg.vocab_size, maxlen=900)
    if lora:  # round-robin distinct adapters
        rs = serving.RequestSet(rs.prompt_lens, rs.output_lens, rs.prompts,
                                adapter_ids=(np.arange(len(rs)) % batch).astype(np.int32))
    return engine.run(rs, progress=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["7b", "13b", "70b"], default="7b")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--ctx", type=int, default=512)
    ap.add_argument("--stacks", nargs="*",
                    choices=["w4a4", "bf16", "w8a8", "w4a16", "moe", "lora"],
                    default=["w4a4", "bf16", "w8a8", "w4a16"])
    ap.add_argument("--lora_rank", type=int, default=16)
    ap.add_argument("--engine", action="store_true")
    ap.add_argument("--head", choices=["bf16", "w8a16", "w4a16"], default="w8a16",
                    help="lm_head precision for the w4a4 stack (w8a16 is the production default)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--sched", choices=["mixed", "serial"], default="mixed",
                    help="engine mode only: w4a4 prefill scheduling (serial = fair cross-stack comparison)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = model_cfg(args.model, args.layers)
    print(f"{card_line(dev)}  model={args.model} L={args.layers} "
          f"batch={args.batch} ctx={args.ctx}", flush=True)

    if args.engine:
        for stack in args.stacks:
            print(f"--- engine: {stack} ---", flush=True)
            res = engine_run(cfg, args.batch, args.requests, stack, sched=args.sched, device=dev)
            for k, v in res.items():
                print(f"  {k}: {v}")
        return

    results = {}
    for stack in args.stacks:
        t0 = time.perf_counter()
        if stack == "w4a4":
            tok_s, per_step = burst_throughput_w4a4(cfg, args.batch, args.ctx, head=args.head, device=dev)
        elif stack == "moe":
            tok_s, per_step = burst_throughput_moe(args.batch, args.ctx, layers=args.layers, device=dev)
        elif stack == "lora":
            tok_s, per_step = burst_throughput_lora(cfg, args.batch, args.ctx, rank=args.lora_rank, head=args.head,
                                                    device=dev)
        else:
            tok_s, per_step = burst_throughput_baseline(cfg, args.batch, args.ctx, stack, device=dev)
        results[stack] = tok_s
        print(
            f"{stack:6s} decode: {per_step*1e3:8.3f} ms/step  "
            f"{tok_s:8.1f} tok/s  (setup+warm-up {time.perf_counter()-t0:.0f}s)",
            flush=True,
        )
    if "w4a4" in results:
        for base in ("bf16", "w8a8", "w4a16"):
            if base in results:
                print(f"w4a4 vs {base}: {results['w4a4']/results[base]:.2f}x")
        if "lora" in results:
            print(f"lora vs w4a4: {results['lora']/results['w4a4']:.2f}x "
                  f"(multi-tenant adapter cost)")


if __name__ == "__main__":
    main()
