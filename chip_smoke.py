#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``atom_tpu_torch``) on one NVIDIA GPU.

Phases, each fatal on failure:
  1. build every CUDA kernel from ``atom_tpu_torch/csrc`` (one ``nvcc`` per
     source, in parallel) and print the card's name and power limit;
  2. hold each kernel K1-K14 against its plain PyTorch version at the
     Llama-2-7B shapes of the decode step (batch 32, context 512), of prefill
     (K1 and K7 at the engine's buckets 128, 256 and 512 rows and at 1024, K12
     at 1024 and 128), of the head (K5 at 32 rows, 1 and the mixed step's 33,
     and a ragged shape; two launches bitwise), of the ring flush (K4 reading
     the live ring in place at three ring rows, and on pre-rolled blocks, with
     the three torch.roll copies + kernel timed beside it; also at head dims 64
     and 256), of the mixed step (K1
     and K7 at its 288 rows, K11 on the decode rows and on a chunk's prefix),
     of the fused post-attention half (K9, K10; also at 288 rows; K9 and K10
     given the reorder index bitwise with index_select and the kernel; K10's
     cluster epilogue at 8, 17 and 32 rows bitwise with its four-launch form
     under both cluster layouts, each form timed, also by the profiler), of the
     W4A16 stack (K13 at its layer's seven GEMMs, at 1024 rows and at the head)
     and of the int8-carrier GEMMs (K14a bitwise at 1, 32, 64, 65, 288 and 1024
     rows, N 4096 and 11008, and at the 70B down depth, K 28672, at 32 and 288
     rows, with K1 on the same codes beside it; K14b at 32, 288 and 1024 rows,
     N 4096; both at N 128), and time kernel, plain version and, where one PyTorch call
     computes the same function, that call; K1's decode core bit for bit at
     o_proj, gate/up, down, qkv and the 70B down projection's depth (K-blocked
     order), each shape timed on its own and under other layouts of the core;
     K1's prefill GEMM bit for bit at o_proj, gate/up and down from 100 to
     1024 rows and at the 70B depth at 288 rows, K7 at every prefill row count;
     and at Mixtral-8x7B's shapes (each row's ``moe``): K1 at the experts'
     gate/up (N 28,672) and down (K 14,336) at 32 rows and on the prefill GEMM
     at the routed capacity (256 rows), K2 and K7 at GQA 32/8 (N 6,144), K3
     at GQA 32/8, K4 on 8 kv heads, K10 at inter 14,336 with row_scale on a
     float32 residual;
  3. drive the W4A4 decode path at full width (32 layers, hidden 4096,
     ATOM_W4A4, random weights from a seed): ``decode_burst`` over 2 ring
     windows, which flush, with every kernel's launch count read; then decode
     tok/s by the slope between burst lengths (median of positive samples; the
     profiled window must run no torch.roll kernel), with
     the W8A16 head, the bf16 head and the W4A16 head (K13); then the same with
     ``ATOM_TPU_FUSED_MLP=1`` (K9 and K10 in place of K1 and its glue; the
     profiled window counts the K1 family's kernels and the reorder gathers);
  4. drive the serving engine at full width in the JAX package's cross-stack
     engine configuration (32 seeded requests, max_seq_len 1024): serial
     prefill with the bf16 head (the W4A4 row of the stack comparison), launch
     counts read, every request's tokens and the pool checked; then the same
     requests through the mixed-scheduling engine (``make_mixed_step_fns``,
     ``chunk_fn``: K11) with the W8A16 head at 4 layers, and one mixed step
     alone at 32; then one prefill alone at 1024 and
     256 rows through the flash kernel (K12) beside the default path;
  5. the kernel path against the plain path at 2 layers of the same width: one
     flushing decode step on the ring-fused branch, on the int-input ring
     branch (``fused_serving=False``), on the batch-8 fallback branch, with the
     fused post-attention half and with the W4A16 head; a mixed step with a
     flush and one at ``pos0 = 0`` with a partly filled chunk; a kernel
     prefill; and the engine with a dozen requests, serial and mixed;
  6. K14's path (it lies on no serving path): one 7B layer's seven projections
     through the int8-carrier ``quant_gemm`` drop-in (K14a) and k/v through
     ``quant_gemm_o4`` (K14b), held bit for bit against K1 on the same codes,
     and k/v through K1's drop-in ``quant_gemm_o4_packed`` bit for bit against
     its plain version and K14b;
  7. the baseline stacks (``serving/baselines.py``: bf16, W8A8 with int8 dense
     KV, W4A16 through K13) at full width, one at a time: a decode burst at
     batch 32, context 512 (launch counts, tok/s by the slope between 8 and 32
     steps, device time and kernels per step under the profiler, peak memory),
     then the engine cell of phase 4 over ``make_baseline_step_fns``; then the
     W4A16 stack at 2 layers, kernel path against plain path (a decode step, a
     prefill, the engine with a dozen requests); and the W4A4 stack's ratios
     against each baseline, burst and engine.
  8. Mixtral-8x7B (``serving/moe.py``) at full width and 16 layers (32 until
     phase 12 took their time),
     ``ATOM_W4A4``, random weights from a seed, the bf16 head, after the
     baselines' params are freed: ``decode_burst_moe`` at batch 32, context
     512 (launches over 2 flushing windows checked per layer and expert,
     tok/s by the slope between 1 and 2 windows, device time and kernels a
     step over 4 profiled steps, peak memory), the same under ``ATOM_TPU_FUSED_MLP=1`` (K9 and eight K10 a
     layer, no K1); the engine cell of phase 4 over ``make_moe_step_fns`` at
     4 layers (the 512 bucket's prompts on the routed experts); at 2 layers
     the kernel path against the plain path (a flushing decode step unfused
     and fused, prefills at 256 rows, dense, and 512, routed).
  9. LoRA serving (``serving/lora.py``; run right after phase 4, on its
     32-layer W4A4 params with the W8A16 head) at rank 16 with a store of 32
     adapters (2.56 GB): ``lora_decode_burst`` at batch 32, context 512,
     every sequence its own adapter (launches over a flushing window: K1,
     K3, K4, K5, K6 and no K2, K7-K10; tok/s by the slope between 1 and 2
     windows; device time and kernels a step over 4 profiled steps; the
     adapter path alone against its byte floor; peak memory); the engine
     cell over ``make_lora_step_fns`` at 4 layers, 8 adapters; at 2 layers
     the kernel path against the plain path (a flushing decode step over a
     zero-delta store under the gates' bounds and over the burst's adapters
     with layer 0 bitwise, a 512-row prefill); then the native C++ scheduler (``native=True``)
     against the Python pool in the 2-layer engine cell: equal tokens and
     page tables, host scheduling ms a step of each.
 10. calibrate -> export -> serve (after phase 8, on freed memory), through
     ``atom_tpu_torch/main.py``'s parser, spec and data loader: Llama-2-7B
     at full width cut to 4 layers with ``--layers``, random bf16 weights
     from a seed, ``--reorder --use_gptq`` on 8 windows of 512 tokens of
     ``data/corpus/train.txt`` (saliency, reorder, GPTQ, each timed), the
     ``targetResult,corpus,<ppl>`` line over the first 16 windows of
     eval.txt, the export (``pack_calibrated_params`` on the GPTQ scales,
     ``save_serving``) loaded back onto the card bit for bit, the engine
     cell of phase 4 over the loaded params with the bf16 head at 8
     requests (K1 on both its kernels, K2, K3, K4, K6, K7 launched, under
     ``calibrated_engine``), and on the first 2 calibrated layers the kernel
     prefill's logits against the accuracy pipeline's ``forward`` (within
     W4A4's own floor) and a flushing decode step, kernel path against plain
     path.
 11. the rest of the accuracy pipeline, on freed memory after phase 10, through
     phase 10's code: Mixtral-8x7B at full width cut to 2 layers, the same
     flags and figures, exported through ``pack_calibrated_params_moe`` and
     served by the MoE engine (``make_moe_step_fns``, 16 requests, the 512
     bucket's prompts on the routed experts; K1 both kernels, K2, K3, K4, K6,
     K7 under ``calibrated_moe_engine``), the served logits against the
     accuracy forward and the kernel-vs-plain decode step at 2 layers; OPT-6.7B
     at full width cut to 2 layers to its ``targetResult`` line (OPT is not
     served: no kernel); then ``utils/train.py`` on ``BYTE_LM`` at full width
     (batch 8, seqlen 2048, 24 steps with an 8-step warmup) over
     ``data/corpus/train.txt``, the loss falling below its first chunk's,
     steps/s and tokens/s, ``eval_loss`` over 8 eval windows, and the
     checkpoint written as ``scripts/torch_train_corpus_model.py`` writes it,
     read back through ``main.py``'s ``--ckpt`` path.
 12. parallelism on one card (``parallel/``, ``serving/parallel.py``, ``sp.py``,
     ``dp.py``, the expert-parallel half of ``serving/moe.py``), on freed
     memory, last: the single-device references on the kernel path, then one
     spawn of 4 gloo ranks on the card (``parallel.launch.run_ranks``) over
     subgroups: (a) TP 2 at Llama-2-7B width, 2 layers, a 400-token prefill in
     the 512 bucket and 33 decode steps through a ring flush at batch 32, fed
     the single device's tokens: pages and ring gathered over the ranks bit
     for bit, tokens equal except where the single device's top-2 logit
     margin is below the step's TP-vs-single logit difference; then cell 2's
     engine at 4 layers with 8 requests (every token, every page back, 7 of 8
     first tokens); (b) EP 2 at Mixtral-8x7B width, 2 layers, the same steps
     (the prefill on the routed experts); (c) SP 2 and SP 2 x TP 2 over a
     1,000-token prompt in the 1,024 bucket against ``prefill_step`` (layer
     0's pages bitwise, the share of entries differing under 5%, the token);
     and in this process (d) dp 2 groups of tp 1 as threads on the card at 4
     layers, each group's transcripts equal to a single-group run of its
     partition.  Launches of every check under ``parallel_*`` (summed over
     the ranks).  No rate: the ranks share one card.

stdout ends with the kernels line, the results line, the ratios line, the card
line and then ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the ``atom_tpu_torch`` package beside this file, it exits non-zero.

Usage: python3 chip_smoke.py                  (everything; what a check of the port runs)
       python3 chip_smoke.py --kernels-only   (phases 1 and 2, then stop: prints the
                                               kernels' checks and times, not the ok line)
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"  # run artifacts (profile, compiler log); ignored by git

# NVIDIA H100 SXM data sheet (dense): HBM3 bytes/s, int8 and bf16 tensor-core
# op/s, float32 op/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS = 1979e12
PEAK_BF16_OPS = 989e12
PEAK_F32_OPS = 67e12

BATCH, CTX, PAGE, MAX_PAGES = 32, 512, 256, 4
# Llama-2-7B widths of the kernel checks: hidden, MLP width, vocabulary, the
# W8A16 head's padded width, and prefill's row counts (largest bucket first)
HID, INTER, VOCAB, HEAD_N = 4096, 11008, 32000, 32256
PREFILL_MS = (1024, 128)
MIXED_M = BATCH + PAGE  # rows of a mixed step: the decode batch and one page-size chunk
# K1 and K7 on the prefill GEMM: the engine's buckets, the largest, the mixed
# step's rows, and (K1) an M that is not a multiple of the row tile
PREFILL_GEMM_MS = (128, 256, 512, 1024, MIXED_M, 100)
# Mixtral-8x7B's expert width and kv heads, and an expert's rows in the routed
# prefill at the 512-token bucket (``serving.moe._moe_capacity(512)``)
MOE_INTER, MOE_KV, MOE_CAPACITY = 14336, 8, 256


class SmokeError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bits(t):
    """A tensor's bit pattern, for bitwise comparison (bf16 viewed as int16)."""
    import torch

    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_operands(torch, gen, dev, m: int, ktot: int, n: int) -> tuple:
    """K1's operands for an [m, ktot] x [ktot, n] product, random from ``gen``:
    body codes in [-8, 8), keeper codes, nibble planes, activation and weight
    scales."""
    ng = ktot // 128 - 1

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32).to(torch.int8)

    def uniform(lo, hi, shape):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    a = torch.cat([randint(-8, 8, (m, ng * 128)), randint(-127, 128, (m, 128))], dim=1)
    wp, wk = randint(-128, 128, (ng * 64, n)), randint(-127, 128, (128, n))
    sa, sw = uniform(0.01, 0.2, (m, ng + 1)), uniform(0.001, 0.02, (ng + 1, n))
    return a, wp, wk, sa, sw


def int8_operands(torch, gen, dev, m: int, n: int, k: int = HID) -> tuple:
    """K14's operands for an [m, k] x [k, n] product, random from ``gen``:
    body codes in [-8, 8) (so K1 can take them as nibble planes), then the
    keeper's int8 codes, in activation and weight, and the group scales."""
    ng = k // 128

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32).to(torch.int8)

    a = torch.cat([randint(-8, 8, (m, (ng - 1) * 128)), randint(-127, 128, (m, 128))], dim=1)
    w = torch.cat([randint(-8, 8, ((ng - 1) * 128, n)), randint(-127, 128, (128, n))], dim=0)
    sa = torch.rand((m, ng), generator=gen, device=dev) * 0.19 + 0.01
    sw = torch.rand((ng, n), generator=gen, device=dev) * 0.019 + 0.001
    return a, w, sa, sw


def k1_bound(m: int, ktot: int, n: int) -> tuple[int, int]:
    """The bytes K1 must move (each operand read once, the f32 output written
    once) and its int8 operations."""
    ng = ktot // 128 - 1
    nbytes = m * ktot + ng * 64 * n + 128 * n + 4 * (m * (ng + 1) + (ng + 1) * n) + 4 * m * n
    return nbytes, 2 * m * n * ktot


class Timer:
    """Median CUDA-event time of one call, with the L2 cache flushed before
    each timed call (the decode step finds every weight and page cold).
    ``host_us`` keeps the median host time of the last timed function's call
    (its wrapper's time to enqueue): where it passes the flush's time, the
    event interval holds the excess."""

    def __init__(self, torch, dev):
        self.torch = torch
        self.l2 = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MB

    def __call__(self, fn, n: int = 25, warm: int = 3) -> float:
        torch = self.torch
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        times, host = [], []
        for _ in range(n):
            self.l2.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            t = time.perf_counter()
            fn()
            host.append(time.perf_counter() - t)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        self.host_us = statistics.median(host) * 1e6
        return statistics.median(times)

    def device(self, fn, n: int = 20) -> dict:
        """Device time of one call by the profiler: its kernels' own time (µs)
        and count per call over ``n`` calls, each after the L2 flush (whose
        fill kernel is left out), and the time per call by kernel.  Unlike
        the event interval it holds no host time, so wrappers whose host
        time passes the flush's (K9, K10) compare by it."""
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                self.l2.zero_()
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and "FillFunctor" not in e.key]
        return dict(us=sum(e.self_device_time_total for e in kernels) / n, kernels=sum(e.count for e in kernels) / n,
                    by_kernel={e.key[:90]: e.self_device_time_total / n for e in kernels})


def idle_slots(torch, dev):
    """Idle slots of the attention check's batch: every third row."""
    return torch.arange(BATCH, device=dev) % 3 == 1


ATTN_TOL = dict(atol=2e-3, rtol=2**-7)  # K3 vs plain: f32 sums in another order, then one bf16 rounding


def kv_inputs(torch, gen, dev, batch: int, heads: int, window: int = 32, max_pages: int = MAX_PAGES,
              head_dim: int = 128):
    """Random KV pages (page 0 the sink, then MAX_PAGES per sequence), their
    page table and a hot ring.  K is centred like real codes (zero = -7.5
    scale); V's offsets are not, so attention outputs are of order 1."""
    from atom_tpu_torch.ops.kv_hot import HotKV
    from atom_tpu_torch.ops.kv_layout import KVPages

    def codes(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32).to(torch.int8)

    def uniform(lo, hi, shape):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def planes(n, lanes):
        ks, vs = uniform(0.01, 0.1, (n, heads, lanes)), uniform(0.01, 0.1, (n, heads, lanes))
        vz = uniform(-1.0, 1.0, (n, heads, lanes))
        return torch.stack([ks, -7.5 * ks, vs, vz], dim=1).to(torch.bfloat16)

    n_pages = 1 + batch * max_pages
    dh = head_dim // 2
    pages = KVPages(codes(-128, 128, (n_pages, heads, dh, PAGE)),
                    codes(-128, 128, (n_pages, heads, PAGE // 2, head_dim)), planes(n_pages, PAGE))
    hot = HotKV(codes(-128, 128, (batch, heads, dh, window)), planes(batch, window),
                codes(0, 16, (batch, heads, window, head_dim)))
    table = (1 + torch.arange(batch * max_pages, device=dev, dtype=torch.int32)).reshape(batch, max_pages)
    return pages, hot, table


def attention_args(torch, gen, dev, hq: int, hkv: int, flushed, n_hot, row: int = 9, max_pages: int = MAX_PAGES):
    """K3's arguments over ``kv_inputs``, with q scaled so the softmax peaks
    on a few tokens: a lane masked wrongly then moves the output past
    ATTN_TOL (``tests/test_torch_kernels.py`` checks that)."""
    pages, hot, table = kv_inputs(torch, gen, dev, flushed.shape[0], hkv, max_pages=max_pages)
    q = (torch.randn((flushed.shape[0], hq, 128), generator=gen, device=dev) * 12.0).to(torch.bfloat16)
    return q, pages, table, flushed, hot, n_hot, row


def check_kernels(torch, dev) -> dict:
    """Phase 2: each kernel vs its plain version at the main path's shapes."""
    import torch.nn.functional as F

    from atom_tpu_torch.models.nn import rope_tables
    from atom_tpu_torch.numerics import rms_rstd
    from atom_tpu_torch.ops import decode as dec
    from atom_tpu_torch.ops import gemm_packed as gp
    from atom_tpu_torch.ops import gemm_w4a16 as gw
    from atom_tpu_torch.ops import misc
    from atom_tpu_torch.ops.kv_hot import hot_flush_blocks
    from atom_tpu_torch.ops.kv_layout import KVPages

    gen = torch.Generator(device=dev).manual_seed(1)
    timer = Timer(torch, dev)
    res = {}

    def randint(lo, hi, shape, dtype=torch.int8):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32).to(dtype)

    def uniform(lo, hi, shape, dtype=torch.float32):
        return (torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo).to(dtype)

    def normal(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # --- K6 embed_gather: bitwise
    v, d = VOCAB, HID
    embed = normal((v, d), 0.02, torch.bfloat16)
    ids = randint(0, v, (BATCH,), torch.int32)
    got, want = misc.embed_gather(embed, ids), misc.embed_gather_plain(embed, ids)
    require(torch.equal(bits(got), bits(want)), "embed_gather differs from its plain version")
    # the first and last rows and ids out of range, which clamp into [0, V)
    edge = torch.tensor([0, v - 1, -1, -(2**31), v, v + 7, 2**31 - 1], dtype=torch.int32, device=dev)
    edge_ids = torch.cat([edge, ids[: BATCH - edge.numel()]])
    require(torch.equal(bits(misc.embed_gather(embed, edge_ids)), bits(misc.embed_gather_plain(embed, edge_ids))),
            "embed_gather differs from its plain version on the first and last rows or the clamp")
    b_ms, b_by = bound(2 * BATCH * d * 2 + BATCH * 4, 0, PEAK_F32_OPS)
    res["embed_gather"] = dict(
        max_abs_err=0.0,
        ms=timer(lambda: misc.embed_gather(embed, ids)),
        plain_ms=timer(lambda: misc.embed_gather_plain(embed, ids)),
        library_ms=timer(lambda: F.embedding(ids, embed)),
        bound_ms=b_ms, bound_by=b_by, shape="embed [32000, 4096] bf16, ids [32]",
        checked="random ids; ids 0, V-1, -1, -2^31, V, V+7, 2^31-1 (clamped) beside random ones: bitwise",
    )
    # a second reading beside ms / library_ms: kernel, library, library, kernel
    res["embed_gather"]["ms_kernel_library_library_kernel"] = [
        timer(lambda: misc.embed_gather(embed, ids)), timer(lambda: F.embedding(ids, embed)),
        timer(lambda: F.embedding(ids, embed)), timer(lambda: misc.embed_gather(embed, ids))]

    # --- K1 packed_w4_gemm on the decode core at M = 32: o_proj, gate/up, down (summed: the kernels
    # line's ms) and qkv, then the 70B down projection's depth (223 groups, the K-blocked order), each
    # timed on its own, and other layouts of the core at the four decode shapes: all bit for bit
    def k1_inputs(m, ktot, n):
        return k1_operands(torch, gen, dev, m, ktot, n)

    k1 = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, ms_by_shape={}, bound_ms_by_shape={}, plan_by_shape={},
              layouts={})
    k1_bytes = k1_ops = 0
    k1_shapes = (("o_proj", HID, HID), ("gate_up", HID, 2 * INTER), ("down", INTER, HID), ("qkv", HID, 3 * HID),
                 ("down_70b_depth", 28672, 1024), ("moe_gate_up", HID, 2 * MOE_INTER), ("moe_down", MOE_INTER, HID))
    for tag, ktot, n in k1_shapes:
        args = k1_inputs(BATCH, ktot, n)
        got, want = gp.packed_w4_gemm(*args), gp.packed_w4_gemm_plain(*args)
        require(torch.equal(got, want), f"packed_w4_gemm at M={BATCH}, K={ktot}, N={n} ({tag}) is not bitwise its plain version")
        plan = gp.packed_w4_plan(BATCH, ktot, n)
        ms = timer(lambda: gp.packed_w4_gemm(*args))
        nbytes, ops = k1_bound(BATCH, ktot, n)
        k1["ms_by_shape"][tag] = ms
        k1["bound_ms_by_shape"][tag] = bound(nbytes, ops, PEAK_INT8_OPS)[0]
        k1["plan_by_shape"][tag] = plan._asdict()
        if tag in ("o_proj", "gate_up", "down"):
            k1["ms"] += ms
            k1["plain_ms"] += timer(lambda: gp.packed_w4_gemm_plain(*args), n=5)
            k1_bytes, k1_ops = k1_bytes + nbytes, k1_ops + ops
        if tag in ("o_proj", "gate_up", "down", "qkv"):  # other layouts of the core: (tile_n, tile_m, stages)
            for tn, tm, st in ((32, 32, None), (32, 16, None), (64, 32, None), (64, 16, None), (128, 32, None),
                               (128, 16, None), (64, 16, 8), (64, 32, 8)):
                alt = gp.packed_w4_plan(BATCH, ktot, n, tile_n=tn, tile_m=tm, stages=st)
                require(torch.equal(gp.packed_w4_gemm_with_plan(*args, alt), want),
                        f"packed_w4_gemm ({tag}) under the layout {alt} is not bitwise its plain version")
                k1["layouts"][f"{tag} tn{tn} tm{tm} st{alt.stages}"] = timer(lambda: gp.packed_w4_gemm_with_plan(*args, alt))
        del got, want, args
        log(f"K1 {tag} (M={BATCH}, K={ktot}, N={n}): {ms:.4f} ms under {plan}")
    # the core's other row counts (16, 32 and 64-row blocks, rows past M): bitwise
    for m in (1, 8, 17, 48, 64):
        for ktot, n in ((HID, HID), (INTER, HID)):
            args = k1_inputs(m, ktot, n)
            require(torch.equal(gp.packed_w4_gemm(*args), gp.packed_w4_gemm_plain(*args)),
                    f"packed_w4_gemm at M={m}, K={ktot}, N={n} is not bitwise its plain version")
    b_ms, b_by = bound(k1_bytes, k1_ops, PEAK_INT8_OPS)
    res["packed_w4_gemm"] = dict(
        k1, library_ms=None, bound_ms=b_ms, bound_by=b_by,
        shape="M=32; (K,N) = o_proj (4096,4096) + gate/up (4096,22016) + down (11008,4096), times summed; "
              "ms_by_shape also qkv (4096,12288), the 70B down depth (28672,1024) and Mixtral's expert gate/up "
              "(4096,28672) and down (14336,4096); moe: the expert shapes on the prefill GEMM at the routed capacity",
        checked="decode core bitwise at M=32 (the seven shapes; the first four under every layout), M=1, 8, 17, 48, 64; "
                "prefill GEMM bitwise at M=100, 128, 256, 288, 512, 1024 (o_proj, gate/up, down), the 70B depth at "
                "M=288 and Mixtral's expert shapes at M=256",
    )
    # K1 above 64 rows, on the prefill GEMM: o_proj, gate/up and down (summed) at every row count of
    # PREFILL_GEMM_MS, and the 70B down projection's depth (223 groups, the K-blocked order) at the mixed
    # step's rows: bit for bit, each timed beside its bound
    for m in PREFILL_GEMM_MS:
        row = dict(ms=0.0, plain_ms=0.0, plans=[])
        m_bytes = m_ops = 0
        for ktot, n in ((HID, HID), (HID, 2 * INTER), (INTER, HID)):
            args = k1_inputs(m, ktot, n)
            got, want = gp.packed_w4_gemm(*args), gp.packed_w4_gemm_plain(*args)
            require(torch.equal(got, want), f"packed_w4_gemm at M={m}, K={ktot}, N={n} is not bitwise its plain version")
            del got, want
            row["ms"] += timer(lambda: gp.packed_w4_gemm(*args), n=10)
            row["plain_ms"] += timer(lambda: gp.packed_w4_gemm_plain(*args), n=3, warm=1)
            plan = gp.packed_w4_plan(m, ktot, n)
            row["plans"].append(f"{plan.path} {plan.tile_m}x{plan.tile_n} st{plan.stages}")
            nbytes, ops = k1_bound(m, ktot, n)
            m_bytes, m_ops = m_bytes + nbytes, m_ops + ops
            del args
        b_ms, b_by = bound(m_bytes, m_ops, PEAK_INT8_OPS)
        res["packed_w4_gemm"].update({f"m{m}_ms": row["ms"], f"m{m}_plain_ms": row["plain_ms"], f"m{m}_bound_ms": b_ms,
                                      f"m{m}_bound_by": b_by, f"m{m}_plans": row["plans"]})
        log(f"K1 at M={m} (o_proj + gate/up + down): {row['ms']:.4f} ms, bound {b_ms:.4f} ({b_by}), {row['plans']}")
    args = k1_inputs(MIXED_M, 28672, 1024)
    require(torch.equal(gp.packed_w4_gemm(*args), gp.packed_w4_gemm_plain(*args)),
            f"packed_w4_gemm at M={MIXED_M}, K=28672, N=1024 (K-blocked) is not bitwise its plain version")
    b_ms, b_by = bound(*k1_bound(MIXED_M, 28672, 1024), PEAK_INT8_OPS)
    res["packed_w4_gemm"].update({f"m{MIXED_M}_down_70b_depth_ms": timer(lambda: gp.packed_w4_gemm(*args), n=10),
                                  f"m{MIXED_M}_down_70b_depth_bound_ms": b_ms, f"m{MIXED_M}_down_70b_depth_bound_by": b_by})
    del args
    torch.cuda.empty_cache()

    # --- K2 packed_w4_gemm_qkv_ring_fused at the 7B qkv
    hid, n_q, h, w, row = HID, HID, HID // 128, 32, 17
    n = n_q + 2 * h * 128
    ng = hid // 128 - 1
    y = normal((BATCH, hid), 1.0, torch.bfloat16)
    norm_w = uniform(0.7, 1.3, (hid,), torch.bfloat16)
    wp, wk = randint(-128, 128, (ng * 64, n)), randint(-127, 128, (128, n))
    sw = uniform(0.0005, 0.004, (ng + 1, n))
    cos, sin = rope_tables(randint(0, 2048, (BATCH,), torch.int32), 128, 10000.0)
    rstd = rms_rstd(y)
    ring0 = (randint(-128, 128, (BATCH, h, 64, w)), uniform(0.01, 0.1, (BATCH, 4, h, w), torch.bfloat16),
             randint(0, 16, (BATCH, h, w, 128)))
    rk, rp_ = [r.clone() for r in ring0], [r.clone() for r in ring0]
    qk = gp.packed_w4_gemm_qkv_ring_fused(y, norm_w, wp, wk, sw, cos, sin, *rk, row, n_q, n_q, abits=4, a_clip=0.9, rstd=rstd)
    qp = gp.packed_w4_gemm_qkv_ring_fused_plain(y, norm_w, wp, wk, sw, cos, sin, *rp_, row, n_q, n_q, abits=4, a_clip=0.9, rstd=rstd)
    qd = (qk.float() - qp.float()).abs()
    require(torch.equal(bits(qk), bits(qp)), "qkv_ring_fused: q differs from its plain version")
    others = torch.tensor([c for c in range(w) if c != row], device=dev)
    for i, (a_, b_, r0, axis) in enumerate(zip(rk, rp_, ring0, (3, 3, 2))):
        require(torch.equal(bits(a_), bits(b_)), f"qkv_ring_fused: ring {i} differs from its plain version")
        require(torch.equal(bits(a_).index_select(axis, others), bits(r0).index_select(axis, others)),
                f"qkv_ring_fused: ring {i} written outside column {row}")
    # other batch sizes: 16-row blocks (M = 8) and two 32-row tiles (M = 64): bitwise
    def ring_case(m_):
        y_, cs_ = normal((m_, hid), 1.0, torch.bfloat16), rope_tables(randint(0, 2048, (m_,), torch.int32), 128, 10000.0)
        r_ = (randint(-128, 128, (m_, h, 64, w)), uniform(0.01, 0.1, (m_, 4, h, w), torch.bfloat16),
              randint(0, 16, (m_, h, w, 128)))
        rk_, rp2 = [r.clone() for r in r_], [r.clone() for r in r_]
        a_q = gp.packed_w4_gemm_qkv_ring_fused(y_, norm_w, wp, wk, sw, *cs_, *rk_, row, n_q, n_q, abits=4, a_clip=0.9)
        b_q = gp.packed_w4_gemm_qkv_ring_fused_plain(y_, norm_w, wp, wk, sw, *cs_, *rp2, row, n_q, n_q, abits=4, a_clip=0.9)
        require(torch.equal(bits(a_q), bits(b_q)) and all(torch.equal(bits(x_), bits(z_)) for x_, z_ in zip(rk_, rp2)),
                f"qkv_ring_fused at M={m_} differs from its plain version")

    for m_ in (8, 64):
        ring_case(m_)
    # a decode batch over 64 rows (M = 96, 128): 32-row head blocks over 3-4 row tiles, where C3 was; its inputs from a
    # generator of their own, so that the later checks' inputs stay as they were
    gen_main, gen = gen, torch.Generator(device=dev).manual_seed(96)
    for m_ in (96, 128):
        ring_case(m_)
    gen = gen_main
    ring_bytes = BATCH * h * (64 + 8 + 128)
    nbytes = (y.numel() * 2 + hid * 2 + BATCH * 4 + wp.numel() + wk.numel() + 4 * sw.numel()
              + 2 * 4 * BATCH * 128 + BATCH * n_q * 2 + ring_bytes)
    b_ms, b_by = bound(nbytes, 2 * BATCH * n * hid, PEAK_INT8_OPS)
    res["packed_w4_gemm_qkv_ring_fused"] = dict(
        max_abs_err=qd.max().item(),
        ms=timer(lambda: gp.packed_w4_gemm_qkv_ring_fused(y, norm_w, wp, wk, sw, cos, sin, *rk, row, n_q, n_q, abits=4, a_clip=0.9, rstd=rstd)),
        plain_ms=timer(lambda: gp.packed_w4_gemm_qkv_ring_fused_plain(y, norm_w, wp, wk, sw, cos, sin, *rp_, row, n_q, n_q, abits=4, a_clip=0.9, rstd=rstd), n=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, shape="y [32,4096] bf16, N=12288, ring [32,32,64,32]",
        device_us=timer.device(lambda: gp.packed_w4_gemm_qkv_ring_fused(y, norm_w, wp, wk, sw, cos, sin, *rk, row, n_q, n_q,
                                                                         abits=4, a_clip=0.9, rstd=rstd))["us"],
        plan=gp.packed_w4_plan(BATCH, hid, n, head=True)._asdict(),
        checked="q and the whole ring bitwise at M=32, 8, 64, 96 and 128",
    )

    # --- K7 packed_w4_gemm_qkv at every prefill bucket, the largest and the mixed step's rows: bitwise
    def qkv_inputs(m):
        a = torch.cat([randint(-8, 8, (m, ng * 128)), randint(-127, 128, (m, 128))], dim=1)
        sa = uniform(0.01, 0.2, (m, ng + 1))
        c, s_ = rope_tables(torch.arange(m, device=dev), 128, 10000.0)
        return a, sa, c, s_

    k7 = {}
    for m in PREFILL_GEMM_MS[:-1]:
        a, sa, c7, s7 = qkv_inputs(m)
        got = gp.packed_w4_gemm_qkv(a, wp, wk, sa, sw, c7, s7, n_q, n_q)
        want = gp.packed_w4_gemm_qkv_plain(a, wp, wk, sa, sw, c7, s7, n_q, n_q)
        for name, g_, w_ in zip(("q", "k_codes", "k_prm", "v_codes", "v_prm"), got, want):
            require(torch.equal(bits(g_), bits(w_)), f"packed_w4_gemm_qkv at M={m}: {name} differs from its plain version")
        nbytes = (a.numel() + wp.numel() + wk.numel() + 4 * (sa.numel() + sw.numel()) + 2 * 4 * m * 128
                  + m * n_q * 2 + 2 * m * h * (128 + 8))
        b_ms, b_by = bound(nbytes, 2 * m * n * hid, PEAK_INT8_OPS)
        k7[m] = dict(
            max_abs_err=0.0,
            ms=timer(lambda: gp.packed_w4_gemm_qkv(a, wp, wk, sa, sw, c7, s7, n_q, n_q), n=10),
            plain_ms=timer(lambda: gp.packed_w4_gemm_qkv_plain(a, wp, wk, sa, sw, c7, s7, n_q, n_q), n=3, warm=1),
            bound_ms=b_ms, bound_by=b_by, plan=gp.packed_w4_plan(m, hid, n, path="prefill")._asdict(),
        )
        del got, want
    res["packed_w4_gemm_qkv"] = dict(
        k7[PREFILL_MS[0]], library_ms=None,
        shape="a int8 [1024,4096], N=12288, cos/sin [1024,128]; m128_*, m256_*, m512_*: the engine's buckets; "
              "m288_*: the mixed step's rows",
        **{f"m{m}_{k_}": v_ for m in PREFILL_GEMM_MS[:-1] if m != PREFILL_MS[0] for k_, v_ in k7[m].items()},
    )

    # --- K8 packed_w4_gemm_qkv_ring at the decode batch: q and the written ring column bitwise
    a, sa, _, _ = qkv_inputs(BATCH)
    rk, rp_ = [r.clone() for r in ring0], [r.clone() for r in ring0]
    qk = gp.packed_w4_gemm_qkv_ring(a, wp, wk, sa, sw, cos, sin, *rk, row, n_q, n_q)
    qp = gp.packed_w4_gemm_qkv_ring_plain(a, wp, wk, sa, sw, cos, sin, *rp_, row, n_q, n_q)
    require(torch.equal(bits(qk), bits(qp)), "packed_w4_gemm_qkv_ring: q differs from its plain version")
    for i, (a_, b_, r0, axis) in enumerate(zip(rk, rp_, ring0, (3, 3, 2))):
        require(torch.equal(bits(a_), bits(b_)), f"packed_w4_gemm_qkv_ring: ring {i} differs from its plain version")
        require(torch.equal(bits(a_).index_select(axis, others), bits(r0).index_select(axis, others)),
                f"packed_w4_gemm_qkv_ring: ring {i} written outside column {row}")
    nbytes = (a.numel() + wp.numel() + wk.numel() + 4 * (sa.numel() + sw.numel()) + 2 * 4 * BATCH * 128
              + BATCH * n_q * 2 + ring_bytes)
    b_ms, b_by = bound(nbytes, 2 * BATCH * n * hid, PEAK_INT8_OPS)
    res["packed_w4_gemm_qkv_ring"] = dict(
        max_abs_err=0.0,
        ms=timer(lambda: gp.packed_w4_gemm_qkv_ring(a, wp, wk, sa, sw, cos, sin, *rk, row, n_q, n_q)),
        plain_ms=timer(lambda: gp.packed_w4_gemm_qkv_ring_plain(a, wp, wk, sa, sw, cos, sin, *rp_, row, n_q, n_q), n=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, shape="a int8 [32,4096], N=12288, ring [32,32,64,32]",
    )

    # --- K5 w8a16_gemm at the padded 7B head: the decode batch (timed row), one row (prefill), the mixed
    # step's 33 rows, then a ragged shape (N not whole 256-column tiles, K not whole 128-row stages); each
    # within W8A16_RTOL of the plain version, and two launches bitwise equal
    kh, nh = HID, HEAD_N
    head = normal((kh, nh), 0.02, torch.bfloat16)
    head[:, VOCAB:] = 0
    wq = gw.quantize_w8a16(head.to(torch.float32))

    def k5_check(x, w8, what):
        got, want = gw.w8a16_gemm(x, w8), gw.w8a16_gemm_plain(x, w8)
        err, top = (got - want).abs().max().item(), want.abs().max().item()
        require(err <= gw.W8A16_RTOL * top, f"w8a16_gemm {what}: max |diff| {err} beyond {gw.W8A16_RTOL} x {top}")
        require(torch.equal(gw.w8a16_gemm(x, w8), got), f"w8a16_gemm {what}: two launches on the same inputs differ")
        return err

    k5 = {}
    for m in (BATCH, 1, BATCH + 1):
        x = normal((m, kh), 1.0, torch.bfloat16)
        err = k5_check(x, wq, f"at M={m}")
        nbytes = x.numel() * 2 + wq.codes.numel() + 4 * nh + 4 * m * nh
        b_ms, b_by = bound(nbytes, 2 * m * nh * kh, PEAK_BF16_OPS)
        ms = timer(lambda: gw.w8a16_gemm(x, wq))
        k5[m] = dict(
            max_abs_err=err, ms=ms, host_us=timer.host_us,
            device_us=timer.device(lambda: gw.w8a16_gemm(x, wq))["us"],
            plan=gw.w8a16_plan(m, kh, nh)._asdict(),
            plain_ms=timer(lambda: gw.w8a16_gemm_plain(x, wq), n=5),
            # no single PyTorch call multiplies bf16 by int8: the bf16 product of the
            # unquantized head stands beside it for scale; it reads twice the bytes
            library_ms=timer(lambda: torch.mm(x, head, out_dtype=torch.float32)),
            bound_ms=b_ms, bound_by=b_by,
        )
    kr, nr, mr = HID - 96, 4160, 17  # K = 4000, N = 16.25 column tiles
    wr = gw.quantize_w8a16(normal((kr, nr), 0.02))
    ragged = dict(shape=f"a [{mr},{kr}] x int8 [{kr},{nr}]", plan=gw.w8a16_plan(mr, kr, nr)._asdict(),
                  max_abs_err=k5_check(normal((mr, kr), 1.0, torch.bfloat16), wr, "at a ragged shape"))
    res["w8a16_gemm"] = dict(
        k5[BATCH], shape="a bf16 [32,4096] x int8 [4096,32256], scale [1,32256]; m1_*: one row (prefill); "
        "m33_*: the mixed step's 33 rows", ragged=ragged,
        library_note="torch.mm of the unquantized bf16 head (twice the weight bytes); no one call does bf16 x int8",
        tolerance=f"|diff| <= {gw.W8A16_RTOL} x max|out| (float32 sums in another order); two launches bitwise",
        **{f"m{m}_{k_}": v_ for m in (1, BATCH + 1) for k_, v_ in k5[m].items()},
    )
    del head, wq, wr
    torch.cuda.empty_cache()

    # --- K3 paged_ring_decode_attention: MHA at 7B, GQA (8 q heads per kv
    # head), a ring-only and a pages-only case, idle rows, one long sequence,
    # the engine's 1,024 tokens, the main shape in a wider table, within
    # ATTN_TOL; each launched twice: bitwise
    n_hot = randint(1, w + 1, (BATCH,), torch.int32)
    flushed = (CTX - n_hot).to(torch.int32)  # last pages partly filled
    none = torch.zeros_like(n_hot)
    first = torch.arange(BATCH, device=dev) == 0
    cases = {  # name: (q heads, kv heads, flushed, n_hot)
        "mha": (h, h, flushed, n_hot), "gqa_64q_8kv": (2 * h, h // 4, flushed, n_hot),
        "gqa_32q_8kv": (h, MOE_KV, flushed, n_hot),  # Mixtral-8x7B: 4 query heads a kv head
        "ring_only": (h, h, none, n_hot), "pages_only": (h, h, flushed, none),
        # the engine steps idle slots too: nothing flushed, nothing in the ring
        "idle_rows": (h, h, torch.where(idle_slots(torch, dev), none, flushed), torch.where(idle_slots(torch, dev), none, n_hot)),
        # the engine's tail: one long sequence alive among idle slots (context 2048 over 8 pages)
        "lone_2048": (h, h, torch.where(first, 2048 - w, none), torch.where(first, w, none), 8),
        # the engine cell's longest sequences: 1,024 tokens over 4 pages and the ring
        "ctx_1024": (h, h, (4 * PAGE - n_hot).to(torch.int32), n_hot),
        # the main shape in a table of 8 columns (the engine's default max_seq_len of 2048)
        "mha_8_columns": (h, h, flushed, n_hot, 8),
    }
    k3 = {}
    for case, (hq, hkv, fl_, nh_, *pages_per_seq) in cases.items():
        args = attention_args(torch, gen, dev, hq, hkv, fl_.to(torch.int32), nh_.to(torch.int32), max_pages=(pages_per_seq or [MAX_PAGES])[0])
        q, table = args[0], args[2]
        got, want = dec.paged_ring_decode_attention(*args), dec.paged_ring_decode_attention_plain(*args)
        torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL, msg=f"attention {case}")
        # one launch, no atomics: a second launch on the same inputs is bitwise the first
        require(torch.equal(bits(dec.paged_ring_decode_attention(*args)), bits(got)),
                f"attention {case}: two launches on the same inputs differ")
        k3[case] = dict(max_abs_err=(got.float() - want.float()).abs().max().item(),
                        mean_abs_out=want.float().abs().mean().item())
        if case == "idle_rows":
            idle = idle_slots(torch, dev)
            require(bool(torch.isfinite(got.float()).all()) and not bool(got[idle].any()),
                    "attention of idle rows is not a finite zero row")
        if case in ("mha", "gqa_64q_8kv", "gqa_32q_8kv", "lone_2048", "ctx_1024", "mha_8_columns"):
            tokens = (fl_ + nh_).sum().item()
            nbytes = tokens * hkv * (128 + 8) + 2 * q.numel() * 2 + table.numel() * 4 + 2 * BATCH * 4
            b_ms, b_by = bound(nbytes, 4 * hq * 128 * tokens, PEAK_BF16_OPS)
            k3[case].update(
                ms=timer(lambda: dec.paged_ring_decode_attention(*args)),
                plain_ms=timer(lambda: dec.paged_ring_decode_attention_plain(*args), n=5),
                bound_ms=b_ms, bound_by=b_by,
            )
    log(f"attention checks: {k3}")
    res["paged_ring_decode_attention"] = dict(
        k3.pop("mha"), library_ms=None, mha_max_abs_err=None,
        shape="q [32,32,128], context 512 (pages + ring), page 256, W 32", **k3,
    )
    k3_row = res["paged_ring_decode_attention"]
    k3_row["mha_max_abs_err"] = k3_row["max_abs_err"]  # the timed case; the row's error is the worst case's
    k3_row["max_abs_err"] = max([k3_row["max_abs_err"]] + [c["max_abs_err"] for c in k3.values()])

    # --- K4 flush: the live ring read in place (flush_hot_ring) at ring rows 0, 5 and W - 1, and pre-rolled
    # blocks (flush_hot); blocks crossing page 2's start, two inactive sequences: bitwise
    pages, hot, table = kv_inputs(torch, gen, dev, BATCH, h, w)
    lens = (CTX - 12 + torch.arange(BATCH, device=dev, dtype=torch.int32)).to(torch.int32)
    fl = (lens - w).to(torch.int32)
    fl[3], fl[7] = lens[3], lens[7]  # inactive
    active = (lens > 0) & (lens > fl)
    page_lo = torch.div(lens - w, PAGE, rounding_mode="floor")
    slot0 = (page_lo * PAGE).to(torch.int32)
    o_lane = (lens - w - slot0).to(torch.int32)
    pick = lambda i: torch.gather(table, 1, i.clamp(0, MAX_PAGES - 1)[:, None].long())[:, 0]  # noqa: E731
    pg_a = torch.where(active & (page_lo >= 0), pick(page_lo), 0).to(torch.int32)
    pg_b = torch.where(active & ((page_lo + 1) * PAGE < lens), pick(page_lo + 1), 0).to(torch.int32)
    require(bool((pg_b > 0).any()), "flush check has no page-crossing block")
    book = (pg_a, pg_b, slot0, o_lane, fl, lens)
    forms = {f"ring_row_{r}": (lambda p_, r=r: dec.flush_hot_ring(p_, hot, r, *book),
                               lambda p_, r=r: dec.flush_hot_ring_plain(p_, hot, r, *book)) for r in (0, 5, w - 1)}
    blocks = hot_flush_blocks(hot, 5)
    forms["rolled"] = (lambda p_: dec.flush_hot(p_, *blocks, *book), lambda p_: dec.flush_hot_plain(p_, *blocks, *book))

    def flush_check(pages_, forms_, what):
        for form, (kernel, plain) in forms_.items():
            pk = KVPages(*(t.clone() for t in pages_))
            pp = KVPages(*(t.clone() for t in pages_))
            kernel(pk)
            plain(pp)
            for a_, b_ in zip(pk, pp):
                require(torch.equal(bits(a_), bits(b_)), f"flush_hot ({what}{form}) differs from its plain version")
            require(torch.equal(bits(pk.k_pages[0]), bits(pages_.k_pages[0])), f"flush_hot ({what}{form}) wrote the sink page")
        return pk, pp

    pk, pp = flush_check(pages, forms, "")
    # the generic instance (flush_kernel<0>, byte pieces) at head dims other than 128: 64, and 256 (two K batches
    # a warp), on 8 kv heads, live ring at row 5 and pre-rolled
    for d in (64, 256):
        pages_d, hot_d, _ = kv_inputs(torch, gen, dev, BATCH, 8, w, head_dim=d)
        blocks_d = hot_flush_blocks(hot_d, 5)
        flush_check(pages_d, {
            "ring_row_5": (lambda p_: dec.flush_hot_ring(p_, hot_d, 5, *book),
                           lambda p_: dec.flush_hot_ring_plain(p_, hot_d, 5, *book)),
            "rolled": (lambda p_: dec.flush_hot(p_, *blocks_d, *book), lambda p_: dec.flush_hot_plain(p_, *blocks_d, *book)),
        }, f"head_dim {d}, ")
        del pages_d, hot_d, blocks_d
    # Mixtral-8x7B's flush: 8 kv heads of 128, the live ring at row 5, timed below
    pages_8, hot_8, _ = kv_inputs(torch, gen, dev, BATCH, MOE_KV, w)
    pk8, _ = flush_check(pages_8, {"ring_row_5": (lambda p_: dec.flush_hot_ring(p_, hot_8, 5, *book),
                                                  lambda p_: dec.flush_hot_ring_plain(p_, hot_8, 5, *book))}, "8 kv heads, ")
    tokens = (lens - fl).clamp_min(0).sum().item()
    # per token and kv head: the ring's K, params and V (64 + 8 + 128 bytes) read once, the page's K and params
    # written, and the V page row (128 bytes) read for the nibble merge and written
    b_ms, b_by = bound(tokens * h * (2 * (64 + 8 + 128) + 128) + 6 * BATCH * 4, 0, PEAK_F32_OPS)
    ring = lambda: dec.flush_hot_ring(pk, hot, 5, *book)  # noqa: E731
    rolled = lambda: dec.flush_hot(pk, *hot_flush_blocks(hot, 5), *book)  # noqa: E731
    ms = timer(ring)
    res["flush_hot"] = dict(
        max_abs_err=0.0, ms=ms, host_us=timer.host_us, device_us=timer.device(ring)["us"],
        plain_ms=timer(lambda: dec.flush_hot_ring_plain(pp, hot, 5, *book), n=5),
        # the call sequence of the pre-rolled form: three torch.roll copies of the ring, then the kernel
        rolls_then_kernel_ms=timer(rolled), rolls_then_kernel_device=timer.device(rolled),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, checked=sorted(forms),
        checked_head_dims={"64": ["ring_row_5", "rolled"], "256": ["ring_row_5", "rolled"]},
        shape="ring [32,32,64,32] -> pages [129,32,64,256], 30 active sequences, blocks crossing slot 512; "
        "ring rows 0, 5, 31 read in place and the pre-rolled form; head dims 64 and 256 (8 kv heads) bitwise too; "
        "moe: Mixtral-8x7B's 8 kv heads of 128, ring row 5",
    )
    ring8 = lambda: dec.flush_hot_ring(pk8, hot_8, 5, *book)  # noqa: E731
    b_ms, b_by = bound(tokens * MOE_KV * (2 * (64 + 8 + 128) + 128) + 6 * BATCH * 4, 0, PEAK_F32_OPS)
    res["flush_hot"]["moe"] = dict(shape="ring [32,8,64,32] -> pages [129,8,64,256], ring row 5", max_abs_err=0.0,
                                   ms=timer(ring8), device_us=timer.device(ring8)["us"], bound_ms=b_ms, bound_by=b_by)
    del pages, hot, pk, pp, pages_8, hot_8, pk8
    torch.cuda.empty_cache()
    res.update(check_new_kernels(torch, dev, timer, gen))
    res.update(check_slice4_kernels(torch, dev, timer, gen))
    check_moe_kernels(torch, dev, timer, gen, res)
    return res


STATE_TOL = dict(m=dict(rtol=1e-5, atol=1e-4), l=dict(rtol=1e-4, atol=1e-6))  # K11's softmax state: f32 sums in another order
F32_OUT_TOL = dict(atol=2e-4, rtol=2e-4)  # K11's float32 output: the same sums, no bf16 rounding


def check_new_kernels(torch, dev, timer, gen) -> dict:
    """Phase 2, continued: K9-K12 vs their plain versions at the shapes the
    mixed step, the fused decode configuration and kernel prefill give them."""
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.numerics import rms_rstd
    from atom_tpu_torch.ops import _build
    from atom_tpu_torch.ops import decode as dec
    from atom_tpu_torch.ops import gemm_packed as gp
    from atom_tpu_torch.ops import mlp
    from atom_tpu_torch.ops import prefill as pf
    from atom_tpu_torch.ops.reference import quantize_kv_asym
    from atom_tpu_torch.serving.model import _rand_packed

    res = {}
    h, w = HID // 128, 32

    def randint(lo, hi, shape, dtype=torch.int8):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32).to(dtype)

    def uniform(lo, hi, shape, dtype=torch.float32):
        return (torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo).to(dtype)

    def normal(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # --- K11 paged_decode_attention_rotated
    def k11_case(q, pages, table, lens, out_dtype, time_it):
        got, gm, gl = dec.paged_decode_attention_rotated(q, pages, table, lens, out_dtype=out_dtype, return_state=True)
        want, wm, wl = dec.paged_decode_attention_rotated_plain(q, pages, table, lens, out_dtype, True)
        tol = ATTN_TOL if out_dtype == torch.bfloat16 else F32_OUT_TOL
        torch.testing.assert_close(got.float(), want.float(), **tol, msg="paged_decode_attention_rotated: out")
        torch.testing.assert_close(gm, wm, **STATE_TOL["m"], msg="paged_decode_attention_rotated: m")
        torch.testing.assert_close(gl, wl, **STATE_TOL["l"], msg="paged_decode_attention_rotated: l")
        require(bool(torch.isfinite(got.float()).all()), "paged_decode_attention_rotated: output not finite")
        empty = lens == 0
        if bool(empty.any()):
            require(not bool(got[empty].any()) and bool((gm[empty] == -1e30).all()) and not bool(gl[empty].any()),
                    "paged_decode_attention_rotated: an empty sequence must give out = 0, m = -1e30, l = 0")
        row = dict(path=dec.check_rotated_decode_shape(pages.page_size, q.shape[1], pages.kv_heads),
                   max_abs_err=(got.float() - want.float()).abs().max().item(),
                   m_max_abs_err=(gm - wm).abs().max().item(),
                   l_max_rel_err=((gl - wl).abs() / wl.clamp_min(1e-20)).max().item())
        if time_it:
            hq, hkv = q.shape[1], pages.kv_heads
            tokens = lens.sum().item()
            nbytes = (tokens * hkv * (128 + 8) + q.numel() * 2 + got.numel() * got.element_size() + 2 * gm.numel() * 4
                      + table.numel() * 4 + lens.numel() * 4)
            # each query row meets every token of its own sequence: 2 x 2 x 128 operations per pair
            # (q [B, HQ, D] holds HQ rows per sequence in both call shapes)
            b_ms, b_by = bound(nbytes, 4 * 128 * hq * tokens, PEAK_BF16_OPS)
            row.update(
                ms=timer(lambda: dec.paged_decode_attention_rotated(q, pages, table, lens, out_dtype=out_dtype, return_state=True)),
                plain_ms=timer(lambda: dec.paged_decode_attention_rotated_plain(q, pages, table, lens, out_dtype, True), n=3, warm=1),
                bound_ms=b_ms, bound_by=b_by)
        return row

    k11 = {}
    lens32 = (CTX - randint(1, w + 1, (BATCH,), torch.int32)).to(torch.int32)  # partly filled last pages
    lens_idle = torch.where(idle_slots(torch, dev), torch.zeros_like(lens32), lens32)
    for name, hq, hkv, lens_, dt, time_it in (
            ("decode_mha", h, h, lens32, torch.float32, True),
            ("decode_gqa_64q_8kv", 2 * h, h // 4, lens32, torch.float32, True),
            ("decode_idle_rows_bf16", h, h, lens_idle, torch.bfloat16, False),
            ("decode_idle_rows_f32", h, h, lens_idle, torch.float32, False)):
        pages, _, table = kv_inputs(torch, gen, dev, BATCH, hkv)
        q = normal((BATCH, hq, 128), 12.0, torch.bfloat16)
        k11[name] = k11_case(q, pages, table, lens_, dt, time_it)
    # the chunk-prefix call (the tile path): one sequence, all C = 256 chunk queries of every q head as
    # query rows; prefixes of 0, whole pages, and one ending mid-page (1,000 tokens)
    for hq, hkv in ((h, h), (2 * h, h // 4)):
        pages, _, table = kv_inputs(torch, gen, dev, 1, hkv, max_pages=8)
        q = normal((1, hq * PAGE, 128), 12.0, torch.bfloat16)
        for prefix in (0, 768, 1000, 1792):
            lens_ = torch.full((1,), prefix, dtype=torch.int32, device=dev)
            tag = f"chunk_prefix_{'mha' if hq == hkv else 'gqa_64q_8kv'}_{prefix}"
            k11[tag] = k11_case(q, pages, table, lens_, torch.float32, prefix in (768, 1792) or (hq == hkv and prefix == 0))
        if hq == hkv:  # the tile path's bf16 output
            lens_ = torch.full((1,), 1000, dtype=torch.int32, device=dev)
            k11["chunk_prefix_mha_1000_bf16"] = k11_case(q, pages, table, lens_, torch.bfloat16, False)
        del pages, q
    torch.cuda.empty_cache()
    log(f"paged_decode_attention_rotated checks: {k11}")
    first = k11.pop("decode_mha")
    res["paged_decode_attention_rotated"] = dict(
        first, library_ms=None, library_note="no PyTorch call reads u4 code pages",
        shape="decode rows (path stream): q [32,32,128] over ~500 flushed tokens each (float32 out + state); chunk_prefix_* "
              "(path tile): q [1, HQ*256, 128] over a prefix of 0 / 768 / 1000 / 1792 tokens",
        timed_max_abs_err=first["max_abs_err"], **k11)
    res["paged_decode_attention_rotated"]["max_abs_err"] = max([first["max_abs_err"]] + [c["max_abs_err"] for c in k11.values()])

    # --- K9 packed_w4_gemm_fused_in at o_proj's shape: bitwise, with the residual and with the norm
    spec = ATOM_W4A4
    wo = _rand_packed(gen, HID, HID, spec, dev)
    y = normal((BATCH, HID), 1.0, torch.bfloat16)
    resid = normal((BATCH, HID), 1.0, torch.bfloat16)
    norm_w = uniform(0.7, 1.3, (HID,), torch.bfloat16)
    rstd = rms_rstd(y)
    k9 = {}
    resid32 = normal((BATCH, HID))  # a float32 residual (fault C4): float32 out, resid + acc unrounded
    for tag, kwargs in (("resid", dict(resid=resid)), ("norm_resid", dict(norm_w=norm_w, rstd=rstd, resid=resid)),
                        ("norm", dict(norm_w=norm_w, rstd=rstd)), ("f32_out", dict(out_dtype=torch.float32)),
                        ("f32_resid", dict(norm_w=norm_w, rstd=rstd, resid=resid32))):
        kwargs = dict(kwargs, abits=spec.abits, a_clip=spec.a_clip_ratio)
        got = gp.packed_w4_gemm_fused_in(y, wo, **kwargs)
        want = gp.packed_w4_gemm_fused_in_plain(y, wo, **kwargs)
        require(got.dtype == want.dtype and torch.equal(bits(got), bits(want)),
                f"packed_w4_gemm_fused_in ({tag}) differs from its plain version")
        require(tag != "f32_resid" or got.dtype == torch.float32, "packed_w4_gemm_fused_in: a float32 residual must give float32")
        nbytes = (2 * y.numel() + sum(t.numel() * t.element_size() for t in wo) + got.numel() * got.element_size()
                  + (2 * resid.numel() if "resid" in kwargs else 0) + (2 * HID + 4 * BATCH if "norm_w" in kwargs else 0))
        b_ms, b_by = bound(nbytes, 2 * BATCH * HID * HID, PEAK_INT8_OPS)
        if tag in ("resid", "norm_resid"):
            k9[tag] = dict(ms=timer(lambda: gp.packed_w4_gemm_fused_in(y, wo, **kwargs)),
                           plain_ms=timer(lambda: gp.packed_w4_gemm_fused_in_plain(y, wo, **kwargs), n=5),
                           bound_ms=b_ms, bound_by=b_by)
    # the unfused chain the decode step runs without the flag: equal bit for bit
    from atom_tpu_torch.ops.formats import quantize_activation_packed
    chain = resid + gp.quant_gemm_packed(quantize_activation_packed(y, spec), wo)
    require(torch.equal(bits(chain), bits(gp.packed_w4_gemm_fused_in(y, wo, resid=resid, abits=spec.abits, a_clip=spec.a_clip_ratio))),
            "packed_w4_gemm_fused_in differs from the unfused chain x + quant_gemm_packed(quantize(y))")
    # the reorder gather read in the prologue (the fused burst's call: the ungathered attention output and
    # o_reorder): bitwise with index_select + K9 and with the plain version given the index; timed beside them
    gen_perm = torch.Generator(device=dev).manual_seed(120)  # its own draws: the later checks' inputs stay as they were
    perm = torch.argsort(torch.rand(HID, generator=gen_perm, device=dev)).to(torch.int32)
    for tag, kwargs in (("resid", dict(resid=resid)), ("norm_resid", dict(norm_w=norm_w, rstd=rstd, resid=resid)),
                        ("f32_resid", dict(resid=resid32))):
        kwargs = dict(kwargs, abits=spec.abits, a_clip=spec.a_clip_ratio)
        got = gp.packed_w4_gemm_fused_in(y, wo, reorder=perm, **kwargs)
        require(torch.equal(bits(got), bits(gp.packed_w4_gemm_fused_in(torch.index_select(y, -1, perm), wo, **kwargs)))
                and torch.equal(bits(got), bits(gp.packed_w4_gemm_fused_in_plain(y, wo, reorder=perm, **kwargs))),
                f"packed_w4_gemm_fused_in ({tag}) with reorder differs from index_select + K9 or from its plain version")
    kwargs = dict(resid=resid, abits=spec.abits, a_clip=spec.a_clip_ratio)
    k9_forms = {"gathered_input": lambda: gp.packed_w4_gemm_fused_in(y, wo, **kwargs),
                "reorder": lambda: gp.packed_w4_gemm_fused_in(y, wo, reorder=perm, **kwargs),
                "index_select_then_kernel": lambda: gp.packed_w4_gemm_fused_in(torch.index_select(y, -1, perm), wo, **kwargs)}
    k9["reorder"] = dict(ms=timer(k9_forms["reorder"]), index_select_then_kernel_ms=timer(k9_forms["index_select_then_kernel"]))
    k9_device = {k_: timer.device(f_) for k_, f_ in k9_forms.items()}
    # above 64 rows the GEMM runs on the prefill GEMM (its RESID epilogue, and F32): bitwise at the mixed step's rows
    y_big, resid_big = normal((MIXED_M, HID), 1.0, torch.bfloat16), normal((MIXED_M, HID), 1.0, torch.bfloat16)
    rstd_big = rms_rstd(y_big)
    for tag, kwargs in (("resid", dict(resid=resid_big)), ("norm_resid", dict(norm_w=norm_w, rstd=rstd_big, resid=resid_big)),
                        ("f32_out", dict(out_dtype=torch.float32))):
        kwargs = dict(kwargs, abits=spec.abits, a_clip=spec.a_clip_ratio)
        got, want = gp.packed_w4_gemm_fused_in(y_big, wo, **kwargs), gp.packed_w4_gemm_fused_in_plain(y_big, wo, **kwargs)
        require(got.dtype == want.dtype and torch.equal(bits(got), bits(want)),
                f"packed_w4_gemm_fused_in ({tag}) at M={MIXED_M} differs from its plain version")
    res["packed_w4_gemm_fused_in"] = dict(
        k9["resid"], max_abs_err=0.0, library_ms=None,
        shape="y bf16 [32,4096], wo K 4096 -> N 4096, resid bf16 [32,4096]; norm_*: with the RMSNorm in front; "
              "reorder_*: the fused burst's call, the ungathered y and a permutation read in the prologue",
        checked=f"bitwise at M=32 (resid, norm + resid, norm, f32 out, a float32 residual into float32; the unfused "
                f"chain; with reorder: resid, norm + resid, f32 resid, against index_select + K9 and the plain version) "
                f"and at M={MIXED_M} (resid, norm + resid, f32 out: the prefill GEMM)",
        **{f"norm_{k_}": v_ for k_, v_ in k9["norm_resid"].items()},
        reorder_ms=k9["reorder"]["ms"], reorder_index_select_then_kernel_ms=k9["reorder"]["index_select_then_kernel_ms"],
        device_by_form=k9_device)

    # --- K10 fused_mlp_packed at the 7B MLP, in two parts: the act codes after
    # gate/up (flips counted), and the down half on the kernel's own act codes (bitwise).  Up to 64 rows the
    # gate/up launch carries SiLU * up and the requantization in its epilogue over a block cluster: its act
    # codes and scales, and the output, bitwise with the four-launch form (the f32 scratch and a SiLU launch)
    # under both cluster layouts (t = 32 and t = 64 gate columns a block)
    gu = _rand_packed(gen, HID, 2 * INTER, spec, dev)
    dn = _rand_packed(gen, INTER, HID, spec, dev)
    row_scale = uniform(0.1, 1.0, (BATCH,))
    k10 = {}
    mlp_layouts = (64, 128)  # the cluster epilogue's gate/up block columns: t = 32 (the default) and t = 64

    def against_four_launch(y_, res_, kwargs, what):
        out, act, act_s = mlp.fused_mlp_packed_stages(y_, res_, gu, dn, **kwargs)
        for tile_n in mlp_layouts:
            got = mlp.fused_mlp_packed_stages(y_, res_, gu, dn, gu_tile_n=tile_n, **kwargs)
            require(all(torch.equal(bits(g_), bits(w_)) for g_, w_ in zip(got, (out, act, act_s))),
                    f"fused_mlp_packed ({what}): the {tile_n}-column cluster layout differs from the default one")
        four = mlp.fused_mlp_packed_stages(y_, res_, gu, dn, path=mlp.FOUR_LAUNCH, **kwargs)
        require(torch.equal(act, four[1]) and torch.equal(act_s, four[2]),
                f"fused_mlp_packed ({what}): the SiLU-quant epilogue's act codes or scales differ from the four-launch form")
        require(torch.equal(bits(out), bits(four[0])), f"fused_mlp_packed ({what}): output differs from the four-launch form")
        return out, act, act_s

    # the float32 residual (fault C4), with row_scale MoE's chain over the experts on a float32 accumulator
    for tag, kwargs, res_ in (("norm", dict(norm_w=norm_w, rstd=rstd), resid), ("no_norm", dict(), resid),
                              ("row_scale", dict(norm_w=norm_w, rstd=rstd, row_scale=row_scale), resid),
                              ("f32_resid", dict(norm_w=norm_w, rstd=rstd), resid32),
                              ("f32_resid_row_scale", dict(norm_w=norm_w, rstd=rstd, row_scale=row_scale), resid32)):
        kwargs = dict(kwargs, abits=spec.abits, a_clip=spec.a_clip_ratio)
        out, act, act_s = against_four_launch(y, res_, kwargs, tag)
        require(out.dtype == res_.dtype, f"fused_mlp_packed ({tag}): output {out.dtype} for a {res_.dtype} residual")
        in_kwargs = {k_: v_ for k_, v_ in kwargs.items() if k_ != "row_scale"}
        act_p, act_sp = mlp.fused_mlp_act_plain(y, gu, **in_kwargs)
        flips = act.ne(act_p).float().mean().item()
        scale_flips = act_s.ne(act_sp).float().mean().item()
        # the kernel's SiLU is PyTorch's CUDA formula, so no flip is expected; one act code on a
        # rounding boundary per thousand is the bound a differing last bit of expf would stay under
        require(flips <= 1e-3 and scale_flips <= 1e-3,
                f"fused_mlp_packed ({tag}): {flips:.4%} of act codes and {scale_flips:.4%} of act scales differ")
        down = mlp.fused_mlp_down_plain(act, act_s, res_, dn, kwargs.get("row_scale"))
        require(torch.equal(bits(out), bits(down)), f"fused_mlp_packed ({tag}): down half differs from its plain version")
        whole = mlp.fused_mlp_packed_plain(y, res_, gu, dn, **kwargs)
        k10[tag] = dict(act_code_flips=flips, act_scale_flips=scale_flips,
                        max_abs_err=(out.float() - whole.float()).abs().max().item(),
                        equal_to_four_launch=True, cluster_layouts_equal=list(mlp_layouts))
    # other row counts of the cluster path (the batch-8 branch's; a last block with rows past M): as the four-launch form
    for m_ in (8, 17):
        kwargs = dict(norm_w=norm_w, rstd=rstd[:m_], abits=spec.abits, a_clip=spec.a_clip_ratio)
        against_four_launch(y[:m_].contiguous(), resid[:m_].contiguous(), kwargs, f"M={m_}")
        k10[f"m{m_}_norm"] = dict(equal_to_four_launch=True, cluster_layouts_equal=list(mlp_layouts))
    # the reorder gather in the prologue (the fused burst's call: the ungathered hidden and mlp_reorder)
    perm_d = torch.argsort(torch.rand(HID, generator=gen_perm, device=dev)).to(torch.int32)
    kw_main = dict(norm_w=norm_w, rstd=rstd, abits=spec.abits, a_clip=spec.a_clip_ratio)
    for tag, res_, extra in (("reorder_norm", resid, {}), ("reorder_f32_resid_row_scale", resid32, dict(row_scale=row_scale))):
        got = mlp.fused_mlp_packed_stages(y, res_, gu, dn, reorder=perm_d, **kw_main, **extra)
        want = mlp.fused_mlp_packed_stages(torch.index_select(y, -1, perm_d), res_, gu, dn, **kw_main, **extra)
        require(all(torch.equal(bits(g_), bits(w_)) for g_, w_ in zip(got, want)),
                f"fused_mlp_packed ({tag}) differs from index_select + K10")
        act_p, act_sp = mlp.fused_mlp_act_plain(y, gu, reorder=perm_d, **kw_main)
        k10[tag] = dict(act_code_flips=got[1].ne(act_p).float().mean().item(),
                        act_scale_flips=got[2].ne(act_sp).float().mean().item(), equal_to_index_select_then_kernel=True)
        require(k10[tag]["act_code_flips"] <= 1e-3 and k10[tag]["act_scale_flips"] <= 1e-3,
                f"fused_mlp_packed ({tag}): act codes differ from the plain version given the index")
    # above 64 rows both GEMMs run on the prefill GEMM (F32 for gate/up, RESID or ROW_SCALE for down),
    # held bit for bit: act codes and scales equal, and the down half
    row_scale_big = uniform(0.1, 1.0, (MIXED_M,))
    resid32_big = normal((MIXED_M, HID))
    for tag, kwargs, res_ in (("norm", dict(norm_w=norm_w, rstd=rstd_big), resid_big),
                              ("row_scale", dict(norm_w=norm_w, rstd=rstd_big, row_scale=row_scale_big), resid_big),
                              ("f32_resid", dict(norm_w=norm_w, rstd=rstd_big), resid32_big),
                              ("f32_resid_row_scale", dict(norm_w=norm_w, rstd=rstd_big, row_scale=row_scale_big),
                               resid32_big)):
        kwargs = dict(kwargs, abits=spec.abits, a_clip=spec.a_clip_ratio)
        out, act, act_s = mlp.fused_mlp_packed_stages(y_big, res_, gu, dn, **kwargs)
        require(out.dtype == res_.dtype, f"fused_mlp_packed ({tag}) at M={MIXED_M}: output {out.dtype} for a {res_.dtype} residual")
        act_p, act_sp = mlp.fused_mlp_act_plain(y_big, gu, **{k_: v_ for k_, v_ in kwargs.items() if k_ != "row_scale"})
        flips, scale_flips = act.ne(act_p).float().mean().item(), act_s.ne(act_sp).float().mean().item()
        require(torch.equal(act, act_p) and torch.equal(act_s, act_sp),
                f"fused_mlp_packed ({tag}) at M={MIXED_M}: {flips:.4%} of act codes and {scale_flips:.4%} of act scales differ")
        down = mlp.fused_mlp_down_plain(act, act_s, res_, dn, kwargs.get("row_scale"))
        require(torch.equal(bits(out), bits(down)), f"fused_mlp_packed ({tag}) at M={MIXED_M}: down half differs from its plain version")
        whole = mlp.fused_mlp_packed_plain(y_big, res_, gu, dn, **kwargs)
        k10[f"m{MIXED_M}_{tag}"] = dict(act_code_flips=flips, act_scale_flips=scale_flips,
                                        max_abs_err=(out.float() - whole.float()).abs().max().item())
    nbytes = (2 * y.numel() + 2 * 2 * resid.numel() + 2 * HID + 4 * BATCH
              + sum(t.numel() * t.element_size() for t in (*gu, *dn)))
    b_ms, b_by = bound(nbytes, 2 * BATCH * HID * 3 * INTER, PEAK_INT8_OPS)
    kwargs = dict(norm_w=norm_w, rstd=rstd, abits=spec.abits, a_clip=spec.a_clip_ratio)
    # the times, each form in turn and then again in reverse order: the default layout (gathered input), each
    # cluster layout, the four-launch form, the fused burst's call (reorder) and the parent's (index_select + four launches)
    forms = {
        "ms": lambda: mlp.fused_mlp_packed(y, resid, gu, dn, **kwargs),
        **{f"ms_cluster_t{tn // 2}": (lambda tn=tn: mlp.fused_mlp_packed_stages(y, resid, gu, dn, gu_tile_n=tn, **kwargs))
           for tn in mlp_layouts},
        "ms_four_launch": lambda: mlp.fused_mlp_packed_stages(y, resid, gu, dn, path=mlp.FOUR_LAUNCH, **kwargs),
        "ms_reorder": lambda: mlp.fused_mlp_packed(y, resid, gu, dn, reorder=perm_d, **kwargs),
        "ms_index_select_then_four_launch": lambda: mlp.fused_mlp_packed_stages(
            torch.index_select(y, -1, perm_d), resid, gu, dn, path=mlp.FOUR_LAUNCH, **kwargs),
    }
    times = {k_: [] for k_ in forms}
    device = {k_: [] for k_ in forms}  # the profiler's device time: the event interval holds K10's host time
    for order in (list(forms), list(forms)[::-1]):
        for k_ in order:
            times[k_].append(timer(forms[k_]))
            device[k_].append(timer.device(forms[k_]))
    clusters = {}
    for tn in mlp_layouts:
        plan = gp.packed_w4_plan(BATCH, HID, 2 * INTER, paired=True, tile_n=tn)
        n_ = ctypes.c_int(0)
        _build.check(gp._lib().atom_silu_quant_max_clusters(gp.plan_arg(plan), HID // 128 - 1, ctypes.byref(n_)),
                     "atom_silu_quant_max_clusters")
        clusters[f"t{tn // 2}"] = dict(blocks=plan.grid[0] * plan.grid[1], cluster=plan.cluster, max_active_clusters=n_.value)
    res["fused_mlp_packed"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in k10.values() if "max_abs_err" in c),
        **{k_: statistics.median(v_) for k_, v_ in times.items()}, times_both_orders=times,
        device_us_by_form={k_.replace("ms", "form", 1): [d_["us"] for d_ in v_] for k_, v_ in device.items()},
        device_by_form={k_.replace("ms", "form", 1): v_[0] for k_, v_ in device.items()},
        plain_ms=timer(lambda: mlp.fused_mlp_packed_plain(y, resid, gu, dn, **kwargs), n=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, parts=k10, cluster_layouts=clusters,
        default_gu_plan=gp.packed_w4_plan(BATCH, HID, 2 * INTER, paired=True)._asdict(),
        shape="y bf16 [32,4096], gate/up K 4096 -> N 22016, down K 11008 -> N 4096, norm + rstd, resid bf16 [32,4096]",
        tolerance="act codes and scales: at most 1e-3 differing from the plain version at 32 rows, none at 288; at 8, 17 "
                  "and 32 rows the cluster epilogue's act codes, scales and output bitwise with the four-launch form "
                  "under both layouts; down half on the kernel's act codes: bitwise; with reorder bitwise with "
                  "index_select + K10; f32_resid*: a float32 residual (with row_scale: MoE's chain), float32 out")
    del gu, dn, wo
    torch.cuda.empty_cache()

    # --- K12 flash_code_attention at prefill's largest bucket and the engine's others, GQA, row offsets, a ragged
    # shape; q scaled as for K3 and K11, so that the softmax peaks on a few keys and a key admitted or dropped
    # wrongly at the causal edge moves the output past ATTN_TOL
    def k12_case(tq, tk, hq, hkv, offset, time_it, library=False):
        q = normal((tq, hq, 128), 12.0, torch.bfloat16)
        kq = quantize_kv_asym(normal((tk, hkv, 128)))
        vq = quantize_kv_asym(normal((tk, hkv, 128)))
        args = (q, kq.codes, kq.params, vq.codes, vq.params, hq // hkv, 128 ** -0.5)
        got = pf.flash_code_attention(*args, row_offset=offset, offset_max=max(tk - tq, 0))
        want = pf.flash_code_attention_plain(*args, row_offset=offset)
        torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL, msg=f"flash_code_attention Tq={tq} Tk={tk} HQ={hq}")
        require(torch.equal(bits(got), bits(pf.flash_code_attention(*args, row_offset=offset))),
                f"flash_code_attention Tq={tq} Tk={tk} offset={offset}: two launches differ")
        plan = pf.flash_plan(tq, tk, offset)
        row = dict(max_abs_err=(got.float() - want.float()).abs().max().item(), mean_abs_out=want.float().abs().mean().item(),
                   plan=dict(tile_q=pf.TILE_Q, q_tiles=len(plan.q_tiles), key_tiles=sum(plan.key_tiles),
                             blocks=len(plan.q_tiles) * hq, heaviest=plan.key_tiles[0]))
        if time_it:
            pairs = sum(min(offset + r + 1, tk) for r in range(tq))
            nbytes = 2 * 2 * q.numel() + 2 * tk * hkv * (128 + 8)
            # three products of 128 multiply-adds a visible (row, key, head) on the bf16 tensor cores: q.K, and p.V
            # as two bf16 terms; bound_f32_pv_ms counts p.V once at the float32 CUDA-core peak (the earlier design's)
            b_ms, b_by = bound(nbytes, 3 * 2 * hq * 128 * pairs, PEAK_BF16_OPS)
            t_f32 = (2 * hq * 128 * pairs / PEAK_BF16_OPS + 2 * hq * 128 * pairs / PEAK_F32_OPS) * 1e3
            row.update(ms=timer(lambda: pf.flash_code_attention(*args, row_offset=offset), n=10),
                       plain_ms=timer(lambda: pf.flash_code_attention_plain(*args, row_offset=offset), n=3, warm=1),
                       bound_ms=b_ms, bound_by=b_by, bound_f32_pv_ms=max(t_f32, nbytes / HBM_BYTES_PER_S * 1e3))
        last = offset + tq - 1  # the last key any row may see
        if last + 1 < tk:
            # other keys and values past it must change nothing, bit for bit
            kq2, vq2 = quantize_kv_asym(normal((tk, hkv, 128), 3.0)), quantize_kv_asym(normal((tk, hkv, 128), 3.0))
            for t, t2 in zip((kq.codes, kq.params, vq.codes, vq.params), (kq2.codes, kq2.params, vq2.codes, vq2.params)):
                t[last + 1:] = t2[last + 1:]
            again = pf.flash_code_attention(*args, row_offset=offset, offset_max=max(tk - tq, 0))
            require(torch.equal(bits(got), bits(again)),
                    f"flash_code_attention Tq={tq} Tk={tk} offset={offset}: keys past the last visible one changed the output")
            row["keys_past_last_visible_replaced"] = tk - last - 1
        if library:
            # for scale only: PyTorch's fused attention on K and V dequantized to bf16 (other inputs, other numerics)
            kd = (kq.codes.float() * kq.params[..., :1] + kq.params[..., 1:]).to(torch.bfloat16).transpose(0, 1)[None]
            vd = (vq.codes.float() * vq.params[..., :1] + vq.params[..., 1:]).to(torch.bfloat16).transpose(0, 1)[None]
            qd = q.transpose(0, 1)[None]
            row["sdpa_on_dequantized_bf16_ms"] = timer(
                lambda: torch.nn.functional.scaled_dot_product_attention(qd, kd, vd, is_causal=True), n=10)
        if time_it:
            log(f"flash_code_attention Tq={tq} Tk={tk} HQ={hq} Hkv={hkv} offset={offset}: {row['ms']:.4f} ms, plan {row['plan']}")
        return row

    k12 = {"t1024": k12_case(1024, 1024, h, h, 0, True, library=True),
           "t128": k12_case(128, 128, h, h, 0, True), "t256": k12_case(256, 256, h, h, 0, True),
           "t512": k12_case(512, 512, h, h, 0, True),
           "gqa_64q_8kv_t1024": k12_case(1024, 1024, 2 * h, h // 4, 0, True),
           "tq512_tk1024_offset512": k12_case(512, 1024, h, h, 512, False),
           "tq512_tk1024_offset200": k12_case(512, 1024, h, h, 200, False),
           "t300": k12_case(300, 300, h, h, 0, False),
           "tq200_tk457_offset100": k12_case(200, 457, h, h, 100, False)}
    log(f"flash_code_attention checks: {k12}")
    first = k12.pop("t1024")
    res["flash_code_attention"] = dict(
        first, library_ms=None, library_note="no PyTorch call attends over u4 codes; sdpa_on_dequantized_bf16_ms is "
        "scaled_dot_product_attention on K/V dequantized to bf16, for scale only",
        shape="q bf16 [1024,32,128], K/V codes int8 [1024,32,128] + params; t128, t256, t512, GQA 64/8, Tq 512 at offset "
              "512 and at 200 (keys past row 711 replaced: output bitwise unchanged), T 300, Tq 200 / Tk 457 at offset 100 "
              "(no multiples of the tiles); q of scale 12 (peaked softmax); every case launched twice (bitwise)",
        bound_note="bound_ms: q.K and p.V as two bf16 terms, three products on the bf16 tensor cores; bound_f32_pv_ms: "
                   "p.V once at the float32 CUDA-core peak, the bound of K12's earlier CUDA-core design",
        timed_max_abs_err=first["max_abs_err"], **k12)
    res["flash_code_attention"]["max_abs_err"] = max([first["max_abs_err"]] + [c["max_abs_err"] for c in k12.values()])
    torch.cuda.empty_cache()
    return res


def check_slice4_kernels(torch, dev, timer, gen) -> dict:
    """Phase 2, continued: K13 at the W4A16 stack's decode, prefill and head
    shapes, K14a and K14b at decode and prefill rows and K14a at the 70B
    down depth, each against its plain version."""
    from atom_tpu_torch.ops import gemm as g8
    from atom_tpu_torch.ops import gemm_packed as gp
    from atom_tpu_torch.ops import gemm_w4a16 as gw
    from atom_tpu_torch.ops.formats import PackedWeight, pack_for_kernel

    res = {}

    def randint(lo, hi, shape, dtype=torch.int8):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32).to(dtype)

    def uniform(lo, hi, shape):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    # --- K13 w4a16_gemm: within W4A16_RTOL of the largest output; the bf16 output is the float32 one rounded once
    def k13_case(m, shapes, out_dtype, time_it=True, library=False):
        row = dict(max_abs_err=0.0, **(dict(ms=0.0, host_us=0.0, plain_ms=0.0) if time_it else {}))
        if library:
            row["library_ms"] = row["library_host_us"] = 0.0
        nbytes = ops = 0
        plans = [gw.w4a16_plan(m, k, n) for k, n in shapes]
        row["plan"] = sorted({f"{p.path} {p.tile_m}x128 split {p.split}" for p in plans})
        for k, n in shapes:
            a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
            wq = gw.W4A16Weight(randint(-128, 128, (k // 2, n)), uniform(0.001, 0.02, (k // 128, n)))
            got, want = gw.w4a16_gemm(a, wq, out_dtype=torch.float32), gw.w4a16_gemm_plain(a, wq, torch.float32)
            err, top = (got - want).abs().max().item(), want.abs().max().item()
            require(err <= gw.W4A16_RTOL * top, f"w4a16_gemm at M={m}, K={k}, N={n}: max |diff| {err} beyond {gw.W4A16_RTOL} x {top}")
            require(torch.equal(bits(gw.w4a16_gemm(a, wq)), bits(got.to(torch.bfloat16))),
                    f"w4a16_gemm at M={m}, K={k}, N={n}: the bf16 output is not the float32 one rounded once")
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if time_it:
                row["ms"] += timer(lambda: gw.w4a16_gemm(a, wq, out_dtype=out_dtype), n=10 if m > 32 else 25)
                row["host_us"] += timer.host_us
                row["plain_ms"] += timer(lambda: gw.w4a16_gemm_plain(a, wq, out_dtype), n=3, warm=1)
            if library:
                # no one PyTorch call multiplies bf16 by int4 with group scales: the bf16 product of the
                # dequantized weight stands beside it for scale; it reads four times the weight bytes
                wd = gw.dequantize_w4a16(wq).to(torch.bfloat16)
                row["library_ms"] += timer(lambda: torch.mm(a, wd), n=10 if m > 32 else 25)
                row["library_host_us"] += timer.host_us
                del wd
            nbytes += 2 * a.numel() + wq.packed.numel() + 4 * wq.scale.numel() + m * n * (2 if out_dtype == torch.bfloat16 else 4)
            ops += 2 * m * n * k
            del a, wq, got, want
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops, PEAK_BF16_OPS)
        return row

    inter_p = -(-INTER // 1024) * 1024  # the W4A16 stack's MLP width, padded to 11264
    layer = [(HID, HID)] * 4 + [(HID, inter_p)] * 2 + [(inter_p, HID)]
    k13 = {"decode_layer": k13_case(BATCH, layer, torch.bfloat16, library=True),
           "prefill_1024": k13_case(PREFILL_MS[0], [(HID, inter_p)], torch.bfloat16, library=True),
           "head_m32": k13_case(BATCH, [(HID, HEAD_N)], torch.float32, library=True),
           "head_m1": k13_case(1, [(HID, HEAD_N)], torch.float32),
           "m100_k384_n224": k13_case(100, [(384, 224)], torch.float32, time_it=False)}
    # both paths and the switch between them (64 / 65 rows), every skinny block
    # height (8, 16, 32, 64 rows), the largest prefill bucket, N off the 128-column tile
    for m, k, n in ((1, HID, HID), (13, HID, HID), (64, HID, HID), (64, HID, inter_p), (65, HID, HID),
                    (512, HID, inter_p), (48, 640, 160), (BATCH, 1024, HID + 32)):
        k13[f"m{m}_k{k}_n{n}"] = k13_case(m, [(k, n)], torch.float32, time_it=False)
    require(k13["m64_k4096_n4096"]["plan"][0].startswith("skinny") and k13["m65_k4096_n4096"]["plan"][0].startswith("tile"),
            "w4a16_gemm: 64 and 65 rows must take different paths")
    log(f"w4a16_gemm checks: {k13}")
    first = k13.pop("decode_layer")
    res["w4a16_gemm"] = dict(
        first, shape="the W4A16 stack's layer at M=32: q/k/v/o [4096,4096] x4 + gate/up [4096,11264] x2 + down "
        "[11264,4096], bf16 out, times summed; prefill_1024: [1024,4096]x[4096,11264]; head_m32 / head_m1: [32 or 1, 4096] "
        "x [4096,32256], f32 out; m100_k384_n224: rows and columns off the tiles; m{M}_k{K}_n{N}: untimed checks of "
        "both paths and their boundary (M 1, 13, 48, 64, 65, 512; N off the column tile)",
        library_note="torch.mm of the dequantized bf16 weight (four times the weight bytes); no one call does bf16 x int4",
        host_note="host_us / library_host_us: the wrapper's / torch.mm's median host time to enqueue one call, summed as ms",
        tolerance=f"|diff| <= {gw.W4A16_RTOL} x max|out| (float32 sums in another order); bf16 out = float32 out rounded once",
        **{f"{case}_{k_}": v_ for case, r in k13.items() for k_, v_ in r.items()})
    torch.cuda.empty_cache()

    # --- K14a grouped_int8_gemm and K14b grouped_int8_gemm_o4 (K1's decode core and prefill GEMM in their
    # int8-weight form, never K-blocked): bitwise at every row count, each case timed beside its bound
    def k14a_case(m, n, k=HID, plain=True):
        args = int8_operands(torch, gen, dev, m, n, k)
        got = g8.grouped_int8_gemm(*args)
        require(torch.equal(got, g8.grouped_int8_gemm_plain(*args)),
                f"grouped_int8_gemm at M={m}, K={k}, N={n} is not bitwise its plain version")
        plan = g8.grouped_int8_plan(m, k, n)
        b_ms, b_by = bound(sum(t.numel() * t.element_size() for t in args) + 4 * m * n, 2 * m * n * k, PEAK_INT8_OPS)
        row = dict(max_abs_err=0.0, ms=timer(lambda: g8.grouped_int8_gemm(*args), n=10 if m > 32 else 25),
                   bound_ms=b_ms, bound_by=b_by, plan=f"{plan.path} {plan.tile_m}x{plan.tile_n} st{plan.stages}")
        if plain:
            row["plain_ms"] = timer(lambda: g8.grouped_int8_gemm_plain(*args), n=3, warm=1)
        return args, got, row

    def as_k1(a, w, sa, sw):
        """The same codes as K1 takes them: the body's nibble planes, the keeper's int8 rows."""
        kw = pack_for_kernel(PackedWeight(body=w[:-128], body_scale=sw[:-1], keeper=w[-128:], keeper_scale=sw[-1]))
        return a, kw.body_packed, kw.keeper.contiguous(), sa, kw.scales

    k14a, k14b = {}, {}
    for m in (BATCH, 1, 64, 65, MIXED_M, PREFILL_MS[0]):
        for n in (HID, INTER):
            args, _, k14a[f"m{m}_n{n}"] = k14a_case(m, n)
            if n == HID and m in (BATCH, MIXED_M, PREFILL_MS[0]):
                codes, prm = g8.grouped_int8_gemm_o4(*args)
                wc, wp = g8.grouped_int8_gemm_o4_plain(*args)
                require(torch.equal(codes, wc) and torch.equal(prm, wp),
                        f"grouped_int8_gemm_o4 at M={m}: codes or params differ from its plain version")
                nbytes = sum(t.numel() * t.element_size() for t in args) + m * n + 4 * prm.numel()
                b_ms, b_by = bound(nbytes, 2 * m * n * HID, PEAK_INT8_OPS)
                k14b[f"m{m}_n{n}"] = dict(max_abs_err=0.0, ms=timer(lambda: g8.grouped_int8_gemm_o4(*args), n=10 if m > 32 else 25),
                                          plain_ms=timer(lambda: g8.grouped_int8_gemm_o4_plain(*args), n=3, warm=1),
                                          bound_ms=b_ms, bound_by=b_by)
            del args
    # the 70B down depth (223 body groups): K14 takes the unblocked chain; K1 on the same codes K-blocks, so
    # its output may differ (logged, no failure)
    for m in (BATCH, MIXED_M):
        args, got, row = k14a_case(m, 1024, 28672, plain=False)
        row["k1_elements_differing"] = int((gp.packed_w4_gemm(*as_k1(*args)) != got).sum())
        k14a[f"m{m}_k28672_n1024"] = row
        del args, got
    # N off the tiles (K14b: one head), M off the row tiles
    for m in (100, BATCH):
        args = int8_operands(torch, gen, dev, m, 128)
        require(torch.equal(g8.grouped_int8_gemm(*args), g8.grouped_int8_gemm_plain(*args))
                and all(torch.equal(x, y) for x, y in zip(g8.grouped_int8_gemm_o4(*args), g8.grouped_int8_gemm_o4_plain(*args))),
                f"grouped_int8_gemm(_o4) at M={m}, N=128 differs from its plain version")
    log(f"grouped_int8_gemm checks: {k14a}; _o4: {k14b}")
    first = k14a.pop(f"m{BATCH}_n{HID}")
    res["grouped_int8_gemm"] = dict(
        first, library_ms=None, library_note="no PyTorch call applies per-group scales to an integer product",
        shape="a int8 [32,4096] (31 body groups + keeper) x w int8 [4096,4096], sa [32,32], sw [32,4096]; "
              "m{M}_n{N}: M 1 / 64 / 65 / 288 / 1024, N 4096 / 11008; m{M}_k28672_n1024: the 70B down depth, "
              "k1_elements_differing: K1 on the same codes (K-blocked); also M=100 and 32 at N=128 checked",
        checked="bitwise with the plain version in every case",
        **{f"{case}_{k_}": v_ for case, r in k14a.items() for k_, v_ in r.items()})
    first = k14b.pop(f"m{BATCH}_n{HID}")
    res["grouped_int8_gemm_o4"] = dict(
        first, library_ms=None, library_note="no PyTorch call applies per-group scales to an integer product",
        shape="K14a's operands at N=4096 (32 heads of 128) -> codes int8 [32,4096] + params f32 [32,32,2]; "
              "m288_* / m1024_*: 288 / 1024 rows; also M=100 and 32 at N=128 (one head) checked",
        **{f"{case}_{k_}": v_ for case, r in k14b.items() for k_, v_ in r.items()})
    torch.cuda.empty_cache()
    return res


def check_moe_kernels(torch, dev, timer, gen, res: dict) -> None:
    """Phase 2, continued: K1, K2, K7 and K10 at Mixtral-8x7B's shapes (the
    MoE phase's), each into its row's ``moe`` entry: K1's expert gate/up and
    down on the prefill GEMM at the routed capacity, K2 and K7 at GQA 32/8
    (N 6,144), K10 at inter 14,336 with ``row_scale`` on a float32 residual
    (MoE's fused chain).  K1 at 32 rows is in ``check_kernels``' shapes, K3
    and K4 in their own checks there."""
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.models.nn import rope_tables
    from atom_tpu_torch.numerics import rms_rstd
    from atom_tpu_torch.ops import gemm_packed as gp
    from atom_tpu_torch.ops import mlp
    from atom_tpu_torch.serving.model import _rand_packed

    def randint(lo, hi, shape, dtype=torch.int8):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32).to(dtype)

    def uniform(lo, hi, shape, dtype=torch.float32):
        return (torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo).to(dtype)

    def normal(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # --- K1 on the prefill GEMM at the routed prefill's rows: the experts' gate/up and down, bitwise
    k1 = {}
    for tag, ktot, n in (("gate_up", HID, 2 * MOE_INTER), ("down", MOE_INTER, HID)):
        args = k1_operands(torch, gen, dev, MOE_CAPACITY, ktot, n)
        require(torch.equal(gp.packed_w4_gemm(*args), gp.packed_w4_gemm_plain(*args)),
                f"packed_w4_gemm at M={MOE_CAPACITY}, K={ktot}, N={n} (MoE {tag}) is not bitwise its plain version")
        plan = gp.packed_w4_plan(MOE_CAPACITY, ktot, n)
        b_ms, b_by = bound(*k1_bound(MOE_CAPACITY, ktot, n), PEAK_INT8_OPS)
        k1[f"m{MOE_CAPACITY}_{tag}"] = dict(
            ms=timer(lambda: gp.packed_w4_gemm(*args), n=10), plain_ms=timer(lambda: gp.packed_w4_gemm_plain(*args), n=3, warm=1),
            bound_ms=b_ms, bound_by=b_by, plan=f"{plan.path} {plan.tile_m}x{plan.tile_n} st{plan.stages}")
        del args
    res["packed_w4_gemm"]["moe"] = dict(k1, shape=f"the expert gate/up (K 4096, N 28672) and down (K 14336, N 4096) at "
                                        f"M={MOE_CAPACITY}, the routed prefill's capacity at 512 tokens; M=32 under "
                                        "ms_by_shape moe_gate_up / moe_down")
    torch.cuda.empty_cache()

    # --- K2 at GQA 32/8: q and the whole ring bitwise; K7 at the engine's buckets: bitwise
    hid, n_q, n_kv, w, row = HID, HID, MOE_KV * 128, 32, 17
    n = n_q + 2 * n_kv
    ng = hid // 128 - 1
    y = normal((BATCH, hid), 1.0, torch.bfloat16)
    norm_w = uniform(0.7, 1.3, (hid,), torch.bfloat16)
    wp, wk = randint(-128, 128, (ng * 64, n)), randint(-127, 128, (128, n))
    sw = uniform(0.0005, 0.004, (ng + 1, n))
    cos, sin = rope_tables(randint(0, 2048, (BATCH,), torch.int32), 128, 1e6)
    rstd = rms_rstd(y)
    ring0 = (randint(-128, 128, (BATCH, MOE_KV, 64, w)), uniform(0.01, 0.1, (BATCH, 4, MOE_KV, w), torch.bfloat16),
             randint(0, 16, (BATCH, MOE_KV, w, 128)))
    rk, rp_ = [r.clone() for r in ring0], [r.clone() for r in ring0]
    k2 = lambda ring: gp.packed_w4_gemm_qkv_ring_fused(y, norm_w, wp, wk, sw, cos, sin, *ring, row, n_q, n_kv,  # noqa: E731
                                                       abits=4, a_clip=0.9, rstd=rstd)
    qk = k2(rk)
    qp = gp.packed_w4_gemm_qkv_ring_fused_plain(y, norm_w, wp, wk, sw, cos, sin, *rp_, row, n_q, n_kv, abits=4, a_clip=0.9,
                                                rstd=rstd)
    require(torch.equal(bits(qk), bits(qp)) and all(torch.equal(bits(a_), bits(b_)) for a_, b_ in zip(rk, rp_)),
            "qkv_ring_fused at GQA 32/8 differs from its plain version")
    nbytes = (y.numel() * 2 + hid * 2 + BATCH * 4 + wp.numel() + wk.numel() + 4 * sw.numel() + 2 * 4 * BATCH * 128
              + BATCH * n_q * 2 + BATCH * MOE_KV * (64 + 8 + 128))
    b_ms, b_by = bound(nbytes, 2 * BATCH * n * hid, PEAK_INT8_OPS)
    res["packed_w4_gemm_qkv_ring_fused"]["moe"] = dict(
        shape="y [32,4096] bf16, N=6144 (32 query + 2 x 8 kv heads of 128), ring [32,8,64,32]", max_abs_err=0.0,
        ms=timer(lambda: k2(rk)), host_us=timer.host_us, device_us=timer.device(lambda: k2(rk))["us"],
        plain_ms=timer(lambda: gp.packed_w4_gemm_qkv_ring_fused_plain(
            y, norm_w, wp, wk, sw, cos, sin, *rp_, row, n_q, n_kv, abits=4, a_clip=0.9, rstd=rstd), n=5),
        bound_ms=b_ms, bound_by=b_by, plan=gp.packed_w4_plan(BATCH, hid, n, head=True)._asdict())
    k7 = {}
    for m in (128, 256, 512):
        a = torch.cat([randint(-8, 8, (m, ng * 128)), randint(-127, 128, (m, 128))], dim=1)
        sa = uniform(0.01, 0.2, (m, ng + 1))
        c7, s7 = rope_tables(torch.arange(m, device=dev), 128, 1e6)
        got = gp.packed_w4_gemm_qkv(a, wp, wk, sa, sw, c7, s7, n_q, n_kv)
        want = gp.packed_w4_gemm_qkv_plain(a, wp, wk, sa, sw, c7, s7, n_q, n_kv)
        for name, g_, w_ in zip(("q", "k_codes", "k_prm", "v_codes", "v_prm"), got, want):
            require(torch.equal(bits(g_), bits(w_)), f"packed_w4_gemm_qkv at M={m}, GQA 32/8: {name} differs from its plain version")
        nbytes = (a.numel() + wp.numel() + wk.numel() + 4 * (sa.numel() + sw.numel()) + 2 * 4 * m * 128 + m * n_q * 2
                  + 2 * m * MOE_KV * (128 + 8))
        b_ms, b_by = bound(nbytes, 2 * m * n * hid, PEAK_INT8_OPS)
        k7[f"m{m}"] = dict(ms=timer(lambda: gp.packed_w4_gemm_qkv(a, wp, wk, sa, sw, c7, s7, n_q, n_kv), n=10),
                           plain_ms=timer(lambda: gp.packed_w4_gemm_qkv_plain(a, wp, wk, sa, sw, c7, s7, n_q, n_kv), n=3, warm=1),
                           bound_ms=b_ms, bound_by=b_by)
        del got, want
    res["packed_w4_gemm_qkv"]["moe"] = dict(k7, max_abs_err=0.0,
                                           shape="a int8 [M,4096], N=6144 (GQA 32/8), M = the buckets 128, 256, 512")
    log(f"MoE shapes: K1 {k1}, K2 {res['packed_w4_gemm_qkv_ring_fused']['moe']['ms']:.4f} ms, K7 {k7}")
    del wp, wk, sw, ring0, rk, rp_
    torch.cuda.empty_cache()

    # --- K10 at inter 14,336, no norm, row_scale on a float32 residual (one expert of MoE's fused chain): act codes
    # against the plain version (flips counted), the down half on the kernel's act codes bitwise, and bitwise with
    # its four-launch form
    spec = ATOM_W4A4
    gu = _rand_packed(gen, HID, 2 * MOE_INTER, spec, dev)
    dn = _rand_packed(gen, MOE_INTER, HID, spec, dev)
    h_r = normal((BATCH, HID), 1.0, torch.bfloat16)
    acc = normal((BATCH, HID))
    row_scale = uniform(0.0, 1.0, (BATCH,))
    kwargs = dict(row_scale=row_scale, abits=spec.abits, a_clip=spec.a_clip_ratio)
    out, act, act_s = mlp.fused_mlp_packed_stages(h_r, acc, gu, dn, **kwargs)
    four = mlp.fused_mlp_packed_stages(h_r, acc, gu, dn, path=mlp.FOUR_LAUNCH, **kwargs)
    require(out.dtype == torch.float32 and all(torch.equal(bits(g_), bits(w_)) for g_, w_ in zip((out, act, act_s), four)),
            "fused_mlp_packed at inter 14336: the cluster epilogue differs from the four-launch form")
    act_p, act_sp = mlp.fused_mlp_act_plain(h_r, gu, abits=spec.abits, a_clip=spec.a_clip_ratio)
    flips, scale_flips = act.ne(act_p).float().mean().item(), act_s.ne(act_sp).float().mean().item()
    require(flips <= 1e-3 and scale_flips <= 1e-3,
            f"fused_mlp_packed at inter 14336: {flips:.4%} of act codes and {scale_flips:.4%} of act scales differ")
    require(torch.equal(out, mlp.fused_mlp_down_plain(act, act_s, acc, dn, row_scale)),
            "fused_mlp_packed at inter 14336: down half differs from its plain version")
    whole = mlp.fused_mlp_packed_plain(h_r, acc, gu, dn, **kwargs)
    fused = lambda: mlp.fused_mlp_packed(h_r, acc, gu, dn, **kwargs)  # noqa: E731
    nbytes = 2 * h_r.numel() + 2 * 4 * acc.numel() + 4 * BATCH + sum(t.numel() * t.element_size() for t in (*gu, *dn))
    b_ms, b_by = bound(nbytes, 2 * BATCH * HID * 3 * MOE_INTER, PEAK_INT8_OPS)
    res["fused_mlp_packed"]["moe"] = dict(
        shape="h_r bf16 [32,4096], no norm, gate/up N 28672, down K 14336, row_scale [32], acc float32 [32,4096]",
        act_code_flips=flips, act_scale_flips=scale_flips, max_abs_err=(out - whole).abs().max().item(),
        equal_to_four_launch=True, ms=timer(fused), device_us=timer.device(fused)["us"],
        plain_ms=timer(lambda: mlp.fused_mlp_packed_plain(h_r, acc, gu, dn, **kwargs), n=3, warm=1),
        bound_ms=b_ms, bound_by=b_by, gu_plan=gp.packed_w4_plan(BATCH, HID, 2 * MOE_INTER, paired=True)._asdict())
    log(f"K10 at inter {MOE_INTER}: {res['fused_mlp_packed']['moe']}")
    del gu, dn
    torch.cuda.empty_cache()


def llama7b(layers: int):
    from atom_tpu_torch.models.configs import LLAMA2_7B

    return LLAMA2_7B.replace(num_layers=layers)


def counters():
    from atom_tpu_torch.ops import decode as dec
    from atom_tpu_torch.ops import gemm as g8
    from atom_tpu_torch.ops import gemm_packed as gp
    from atom_tpu_torch.ops import gemm_w4a16 as gw
    from atom_tpu_torch.ops import misc, mlp
    from atom_tpu_torch.ops import prefill as pf

    return {
        "packed_w4_gemm": gp.packed_w4_gemm,
        "packed_w4_gemm_qkv_ring_fused": gp.packed_w4_gemm_qkv_ring_fused,
        "paged_ring_decode_attention": dec.paged_ring_decode_attention,
        "flush_hot": dec.flush_hot,
        "w8a16_gemm": gw.w8a16_gemm,
        "embed_gather": misc.embed_gather,
        "packed_w4_gemm_qkv": gp.packed_w4_gemm_qkv,
        "packed_w4_gemm_qkv_ring": gp.packed_w4_gemm_qkv_ring,
        "packed_w4_gemm_fused_in": gp.packed_w4_gemm_fused_in,
        "fused_mlp_packed": mlp.fused_mlp_packed,
        "paged_decode_attention_rotated": dec.paged_decode_attention_rotated,
        "flash_code_attention": pf.flash_code_attention,
        "w4a16_gemm": gw.w4a16_gemm,
        "grouped_int8_gemm": g8.grouped_int8_gemm,
        "grouped_int8_gemm_o4": g8.grouped_int8_gemm_o4,
    }


def zero_counts() -> None:
    for fn in counters().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_path"):
            fn.launches_by_path = dict.fromkeys(fn.launches_by_path, 0)


def read_counts() -> dict:
    """Each kernel's launches, and K1's, K4's, K10's and K11's split by path
    (K1: decode core, prefill GEMM; K4: the live ring read in place, pre-rolled
    blocks; K10: the cluster epilogue, four launches; K11: stream, tile)."""
    counts = {name: fn.launches for name, fn in counters().items()}
    for name in ("packed_w4_gemm", "flush_hot", "fused_mlp_packed", "paged_decode_attention_rotated"):
        counts[f"{name}_by_path"] = dict(counters()[name].launches_by_path)
    return counts


# kernels each driven path must launch
DECODE_KERNELS = ("packed_w4_gemm", "packed_w4_gemm_qkv_ring_fused", "paged_ring_decode_attention", "flush_hot",
                  "w8a16_gemm", "embed_gather")
FUSED_DECODE_KERNELS = ("packed_w4_gemm_fused_in", "fused_mlp_packed") + DECODE_KERNELS[1:]
# the serial engine runs the bf16 head (the cross-stack engine row), the mixed engine the W8A16 head
ENGINE_KERNELS = tuple(k for k in DECODE_KERNELS if k != "w8a16_gemm") + ("packed_w4_gemm_qkv",)
MIXED_ENGINE_KERNELS = DECODE_KERNELS + ("packed_w4_gemm_qkv", "paged_decode_attention_rotated")
BASELINE_KERNELS = {"bf16": ("embed_gather",), "w8a8": ("embed_gather",), "w4a16": ("embed_gather", "w4a16_gemm")}


@contextlib.contextmanager
def fused_flag():
    """``ATOM_TPU_FUSED_MLP=1`` for the duration: the decode step's
    post-attention half runs as K9 + K10."""
    saved = {k: os.environ.get(k) for k in ("ATOM_TPU_FUSED_MLP", "ATOM_TPU_NO_FUSED_MLP")}
    os.environ["ATOM_TPU_FUSED_MLP"] = "1"
    os.environ.pop("ATOM_TPU_NO_FUSED_MLP", None)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def decode_path(torch, dev, heads, must_launch=DECODE_KERNELS, profile_file="profile.txt") -> tuple[dict, dict]:
    """Phase 3: the 32-layer decode burst with the first head of ``heads``
    ((name, params, samples), ...), launch counts, then tok/s with each head;
    host enqueue time and a profiled window with the first."""
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.serving.model import decode_burst, decode_hidden, make_serving_state

    cfg = llama7b(32)
    qparams = heads[0][1]
    n_pages = BATCH * MAX_PAGES + 1
    table = (1 + torch.arange(BATCH * MAX_PAGES, device=dev, dtype=torch.int32)).reshape(BATCH, MAX_PAGES)
    state = make_serving_state(cfg.num_layers, n_pages, BATCH, cfg.num_kv_heads, PAGE, cfg.head_dim, device=dev)
    full = lambda v: torch.full((BATCH,), v, dtype=torch.int32, device=dev)  # noqa: E731
    state = state._replace(flushed=full(CTX))
    ids = torch.ones((BATCH,), dtype=torch.int32, device=dev)

    zero_counts()
    t0 = time.perf_counter()
    ids, state, lens = decode_burst(qparams, state, ids, table, full(CTX), 2, cfg, ATOM_W4A4)
    x, state = decode_hidden(qparams, state, ids, table, lens + 1, cfg, ATOM_W4A4)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"decode path: 2 windows + 1 step in {time.perf_counter() - t0:.1f} s, launches {counts}")
    for name in must_launch:
        require(counts[name] > 0, f"kernel {name} was not launched on the decode path")
    require(bool(((ids >= 0) & (ids < cfg.vocab_size)).all()), "next ids out of range")
    require(bool(torch.isfinite(x.float()).all()), "hidden states not finite")
    require(bool((lens == CTX + 64).all()), "sequence lengths did not advance by 64")
    steps = 2 * state.hot[0].window + 1
    require(counts["paged_ring_decode_attention"] == steps * cfg.num_layers,
            f"K3 launched {counts['paged_ring_decode_attention']} times in {steps} steps of {cfg.num_layers} layers, "
            "not once per layer")

    def timed(p, n):
        nonlocal state, ids
        # pinned context: every burst starts at lens = flushed = CTX and ring
        # row 0 (timing does not depend on the ring's contents)
        state = state._replace(flushed=full(CTX), row=0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ids, state, _ = decode_burst(p, state, ids, table, full(CTX), n, cfg, ATOM_W4A4)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    w = state.hot[0].window
    n_lo, n_hi = 1, 4
    stats = {}
    for head, p, n_samples in heads:
        samples = []
        for _ in range(n_samples):
            t_lo, t_hi = timed(p, n_lo), timed(p, n_hi)
            samples.append((t_hi - t_lo) / ((n_hi - n_lo) * w))
            log(f"  step time sample ({head} head): {samples[-1] * 1e3:.3f} ms")
        positive = [s for s in samples if s > 0]
        require(len(positive) > 0, f"no positive step-time sample ({head} head)")
        per_step = statistics.median(positive)
        stats[head] = dict(decode_tok_s=BATCH / per_step, step_ms=per_step * 1e3,
                           step_ms_samples=[s * 1e3 for s in samples])

    # host cost: time for Python to enqueue one window, vs the window's time
    state = state._replace(flushed=full(CTX), row=0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ids, state, _ = decode_burst(qparams, state, ids, table, full(CTX), 1, cfg, ATOM_W4A4)
    t_enqueue = time.perf_counter() - t
    torch.cuda.synchronize()
    t_window = time.perf_counter() - t
    device_ms, kernels, k3_per_step, k3_counted, gemm = profile_decode(torch, qparams, state, ids, table, full, cfg,
                                                                       ATOM_W4A4, w, profile_file)
    # K3's launches per step by its wrapper's counter, exactly; the profiler's count (which has dropped
    # events in some runs) is reported beside it and may not exceed it
    require(k3_counted == cfg.num_layers, f"K3 launched {k3_counted} times per profiled step, not once per layer")
    require(k3_per_step <= k3_counted, f"the profiler saw {k3_per_step} K3 kernels per step, more than launched")
    # the ring flush reads the ring in place: no torch.roll copies, no pre-rolled launches
    rolls = gemm.pop("roll", dict(launches_per_step=0.0))["launches_per_step"]
    require(rolls == 0, f"the profiled window ran {rolls} torch.roll kernels a step")
    require(counts["flush_hot_by_path"]["rolled"] == 0, "the decode path flushed pre-rolled blocks")
    first = stats[heads[0][0]]
    step_ms = first["step_ms"]
    first.update(
        host_enqueue_ms_per_step=t_enqueue / w * 1e3, window_ms_per_step=t_window / w * 1e3,
        device_ms_per_step_profiled=device_ms, device_busy_share=device_ms / step_ms, device_kernels_per_step=kernels,
        k3_kernels_per_step=k3_per_step, k3_launches_per_step=k3_counted, k1_family_kernels_per_step=gemm,
        roll_kernels_per_step=rolls,
    )
    log(f"step {step_ms:.3f} ms ({heads[0][0]} head): host enqueue {t_enqueue / w * 1e3:.3f} ms, device {device_ms:.3f} ms "
        f"(busy share {device_ms / step_ms:.3f}), {kernels:.0f} kernels")
    return counts, stats


N_REQUESTS, XS_MAXLEN = 32, 900  # the cross-stack engine cell: synth_requests(32, 32000, maxlen=900)
# the mixed engine's depth (it feeds no ratio; cut from 32 to 8 to hold the run's time limit with phase 10, to 4
# with phase 12)
MIXED_ENGINE_LAYERS = 4


def engine_setup(torch, dev, cfg):
    """The engine cell's configuration, the JAX package's cross-stack engine
    comparison (``atom_tpu/benchmarks/bench_textgen.py`` engine_run): batch 32,
    page 256, max_seq_len 1024, buckets up to 512, a pool of batch x 4 + 16
    pages -> (TextGenConfig, pool, pages, requests)."""
    from atom_tpu_torch.serving import KvPool, TextGenConfig, synth_requests

    tg = TextGenConfig(batch_size=BATCH, page_size=PAGE, max_seq_len=1024, prefill_buckets=(128, 256, 512))
    n_pages = tg.batch_size * tg.max_seq_len // tg.page_size + 16
    pool = KvPool(cfg.num_layers, n_pages, cfg.num_kv_heads, tg.page_size, cfg.head_dim)
    return tg, pool, n_pages, synth_requests(N_REQUESTS, cfg.vocab_size, maxlen=XS_MAXLEN)


def make_engine(tg, pool, state, qparams, cfg, mixed: bool):
    """The engine over the W4A4 step functions, with serial prefill or (``mixed``)
    mixed scheduling: ``make_mixed_step_fns`` and its ``chunk_fn``."""
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.serving import TextGenEngine, make_mixed_step_fns, make_step_fns

    if mixed:
        prefill_fn, decode_fn, chunk_fn = make_mixed_step_fns(qparams, cfg, ATOM_W4A4)
        return TextGenEngine(tg, pool, prefill_fn, decode_fn, state, chunk_fn=chunk_fn)
    return TextGenEngine(tg, pool, *make_step_fns(qparams, cfg, ATOM_W4A4), state)


def drive_engine(torch, engine, pool, n_pages: int, rs, cfg, what: str, must_launch) -> tuple[dict, dict]:
    """One run of ``rs`` at full width as a user would call it (tokens not
    recorded): launch counts, every request's output tokens, the pool and the
    metrics checked; for serial prefill the prefill figures by bucket."""
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    res = engine.run(rs, record=False)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"{what}: {res}")
    log(f"{what} launches: {counts}")
    for name in must_launch:
        require(counts[name] > 0, f"kernel {name} was not launched by the {what}")
    require(res["requests"] == len(rs) and res["output_tokens"] == rs.total_output_tokens,
            f"the {what} did not produce every request's output tokens")
    require(pool.num_free_pages == n_pages - 1, f"{what}: {n_pages - 1 - pool.num_free_pages} pages not returned to the pool")
    require(all(math.isfinite(res[k]) and res[k] > 0 for k in ("throughput_tok_s", "ttft_avg_s", "decode_ms_per_token_avg")),
            f"{what} metrics not finite")
    res = dict(res, n_requests=len(rs), peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    if engine.last_prefill_s:
        by_bucket = {}
        for bucket, sec in engine.last_prefill_s:
            by_bucket.setdefault(bucket, []).append(sec * 1e3)
        prefill_s = sum(sec for _, sec in engine.last_prefill_s)
        res.update(
            prefill_ms_by_bucket={str(b): dict(n=len(v), median_ms=statistics.median(v), max_ms=max(v))
                                  for b, v in sorted(by_bucket.items())},
            prefill_share=prefill_s / res["elapsed_s"], decode_share=1 - prefill_s / res["elapsed_s"],
            ms_per_decode_step=(res["elapsed_s"] - prefill_s) / res["decode_steps"] * 1e3)
    return counts, res


def check_recorded(engine, pool, n_pages: int, cfg, what: str) -> None:
    """A second, short run with the tokens recorded: every request gets its
    output_len tokens, all in range, and the pool is drained back."""
    from atom_tpu_torch.serving import synth_requests

    rs2 = synth_requests(8, cfg.vocab_size, seed=7, maxlen=128)
    rec = engine.run(rs2, record=True)
    for r, want in enumerate(rs2.output_lens):
        toks = rec["tokens"][r]
        require(len(toks) == int(want) and all(0 <= t < cfg.vocab_size for t in toks),
                f"{what}, request {r}: {len(toks)} tokens recorded, {int(want)} wanted, or a token out of range")
    require(pool.num_free_pages == n_pages - 1, f"{what}: pages not returned to the pool after the recorded run")


def engine_path(torch, dev, qparams, mixed: bool = False) -> tuple[dict, dict]:
    """Phase 4: the serving engine at full width over the W4A4 stack: serial
    prefill (with a bf16 head, the cross-stack engine row), or with ``mixed``
    the mixed-scheduling engine, whose prompts ride the decode steps in
    page-size chunks (``chunk_fn``)."""
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.serving.model import make_serving_state

    what = "mixed engine" if mixed else "engine"
    cfg = llama7b(MIXED_ENGINE_LAYERS if mixed else 32)
    params = qparams._replace(layers=qparams.layers[: cfg.num_layers])
    tg, pool, n_pages, rs = engine_setup(torch, dev, cfg)
    state = make_serving_state(cfg.num_layers, n_pages, tg.batch_size, cfg.num_kv_heads, tg.page_size, cfg.head_dim,
                               device=dev)
    engine = make_engine(tg, pool, state, params, cfg, mixed)
    counts, res = drive_engine(torch, engine, pool, n_pages, rs, cfg, what, MIXED_ENGINE_KERNELS if mixed else ENGINE_KERNELS)
    if mixed:
        n_chunks = sum(-(-int(t) // PAGE) for t in rs.prompt_lens)
        require(engine.last_prefill_s == [], "the mixed engine ran a serial prefill")
        require(0 < res["mixed_steps"] <= n_chunks, f"mixed_steps {res['mixed_steps']} outside (0, {n_chunks}]")
        # every chunk is one mixed_step call: K11 twice per layer (the decode rows on the stream path, the
        # chunk's prefix on the tile path), K7 once
        require(counts["paged_decode_attention_rotated"] == 2 * cfg.num_layers * n_chunks
                and counts["flash_code_attention"] == 0, "the mixed engine's chunk count does not match its K11 launches")
        require(counts["paged_decode_attention_rotated_by_path"] == dict(stream=cfg.num_layers * n_chunks,
                                                                         tile=cfg.num_layers * n_chunks),
                f"K11's launches by path {counts['paged_decode_attention_rotated_by_path']} are not one of each per layer")
        res.update(prompt_chunks=n_chunks, ms_per_step=res["elapsed_s"] / (res["decode_steps"] + n_chunks - res["mixed_steps"]) * 1e3,
                   layers=cfg.num_layers)
    check_recorded(engine, pool, n_pages, cfg, what)
    if mixed:  # one mixed step alone at all 32 layers, on a fresh state
        del engine, state
        cfg = llama7b(32)
        state = make_serving_state(cfg.num_layers, n_pages, tg.batch_size, cfg.num_kv_heads, tg.page_size, cfg.head_dim,
                                   device=dev)
        res["mixed_step_alone"] = profile_mixed_step(torch, dev, qparams, state, cfg, ATOM_W4A4)
        log(f"one mixed step alone: {res['mixed_step_alone']}")
    else:
        res["prefill_alone"] = prefill_alone(torch, dev, qparams, engine.state, cfg, ATOM_W4A4)
    return counts, res


@contextlib.contextmanager
def kernel_prefill():
    """``PREFILL_KERNEL_THRESHOLD = 0`` for the duration: every prefill's
    attention runs as the flash kernel (K12)."""
    import atom_tpu_torch.serving.model as sm

    saved = sm.PREFILL_KERNEL_THRESHOLD
    sm.PREFILL_KERNEL_THRESHOLD = 0
    try:
        yield
    finally:
        sm.PREFILL_KERNEL_THRESHOLD = saved


def prefill_alone(torch, dev, qparams, state, cfg, spec) -> dict:
    """One prefill alone on the card at 256 and 1024 rows, on the default path
    (attention as two ``bmm``s over [HQ, T, T] scores) and through the flash
    kernel (K12): wall and device time beside each other, K12's launches."""
    res = {}
    for bucket in (256, 1024):
        res[f"default_{bucket}"] = profile_prefill(torch, dev, qparams, state, cfg, spec, bucket, f"profile_prefill_{bucket}.txt")
        zero_counts()
        with kernel_prefill():
            res[f"kernel_{bucket}"] = profile_prefill(torch, dev, qparams, state, cfg, spec, bucket,
                                                      f"profile_prefill_kernel_{bucket}.txt")
        launches = read_counts()["flash_code_attention"]
        # three prefills per measurement (warm-up, timed, profiled), one K12 launch per layer
        require(launches == 3 * cfg.num_layers, f"kernel prefill: {launches} launches of flash_code_attention")
        res[f"kernel_{bucket}"]["flash_code_attention_launches"] = launches
        log(f"one prefill alone, {bucket} rows: default {res[f'default_{bucket}']}, kernel {res[f'kernel_{bucket}']}")
    return res


def profile_once(torch, once, out_file: str, what: str, by_kernel: dict | None = None) -> dict:
    """``once()`` (which ends by fetching a value from the device) alone on
    the card: warm-up, its wall time, then under the profiler: device time and
    kernel count, written to chiprun_out/``out_file``; with ``by_kernel``
    ({name: (substring, ...)}) also the device ms and kernels of the kernels
    whose names hold every substring of a name."""
    from torch.profiler import ProfilerActivity, profile

    once()
    torch.cuda.synchronize()
    t = time.perf_counter()
    once()
    wall_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        once()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    OUT.mkdir(exist_ok=True)
    (OUT / out_file).write_text(
        f"{what}: wall {wall_ms:.1f} ms unprofiled, device {dev_ms:.1f} ms, {n_kernels} device kernels\n"
        f"{events.table(sort_by='self_device_time_total', row_limit=40)}\n")
    require(dev_ms > 0, f"the profiler recorded no device time for {what}")
    res = dict(wall_ms=wall_ms, device_ms=dev_ms, device_kernels=n_kernels, device_busy_share=dev_ms / wall_ms)
    if by_kernel:
        res["by_kernel"] = {name: dict(device_ms=sum(e.self_device_time_total for e in sel) / 1e3,
                                       kernels=sum(e.count for e in sel))
                            for name, subs in by_kernel.items()
                            for sel in ([e for e in kernels if all(x in e.key for x in subs)],)}
    return res


def profile_prefill(torch, dev, qparams, state, cfg, spec, bucket: int, out_file: str) -> dict:
    """One prefill at ``bucket`` rows into the (free) pages 1.., alone on the
    card (``profile_once``), and the token it gives."""
    from atom_tpu_torch.serving.model import prefill_step

    gen = torch.Generator(device=dev).manual_seed(5)
    ids = torch.randint(1, cfg.vocab_size, (bucket,), generator=gen, device=dev, dtype=torch.int32)
    table_row = torch.zeros((8,), dtype=torch.int32, device=dev)
    n_pg = -(-bucket // PAGE)
    table_row[:n_pg] = torch.arange(1, n_pg + 1, dtype=torch.int32, device=dev)
    tokens = []

    def once():
        tok, _ = prefill_step(qparams, state, ids, table_row, bucket - 56, 0, cfg, spec)
        tokens.append(tok.item())

    res = profile_once(torch, once, out_file, f"one prefill of {bucket} rows, {cfg.num_layers} layers")
    require(0 <= tokens[-1] < cfg.vocab_size, "the prefill's token is out of range")
    return dict(res, bucket=bucket, token=tokens[-1])


def profile_mixed_step(torch, dev, qparams, state, cfg, spec) -> dict:
    """One mixed step alone on the card (``profile_once``): 31 decoding
    sequences at context 500 (6 tokens in the ring) and, in slot 1, a full
    chunk at ``pos0 = 512`` of a prompt; the pool's pages are free, so the
    sequences take pages 1.. (4 each, within the engine cell's 144)."""
    from atom_tpu_torch.serving.model import mixed_step

    gen = torch.Generator(device=dev).manual_seed(9)
    max_pages, slot = 4, 1
    table = (1 + torch.arange(BATCH * max_pages, device=dev, dtype=torch.int32)).reshape(BATCH, max_pages)
    lens = torch.full((BATCH,), 500, dtype=torch.int32, device=dev)
    lens[slot] = 0
    flushed = torch.clamp_min(lens - 6, 0)
    dec_table = table.clone()
    dec_table[slot] = 0
    ids = torch.randint(1, cfg.vocab_size, (BATCH,), generator=gen, device=dev, dtype=torch.int32)
    chunk_ids = torch.randint(1, cfg.vocab_size, (PAGE,), generator=gen, device=dev, dtype=torch.int32)
    st = state._replace(row=5, flushed=flushed)

    def once():
        nxt, tok, _ = mixed_step(qparams, st, ids, dec_table, lens, chunk_ids, table[slot], 512, PAGE, slot, cfg, spec)
        require(0 <= tok.item() < cfg.vocab_size and bool(((nxt >= 0) & (nxt < cfg.vocab_size)).all()),
                "the mixed step's tokens are out of range")

    res = profile_once(torch, once, "profile_mixed_step.txt",
                       f"one mixed step (32 decode rows at context 500 + a 256-token chunk at 512), {cfg.num_layers} layers",
                       by_kernel={"K11_stream": (K11_KERNELS["stream"], ", false>"), "K11_tile": (K11_KERNELS["tile"],)})
    k11 = res["by_kernel"]
    res["k11_share"] = (k11["K11_stream"]["device_ms"] + k11["K11_tile"]["device_ms"]) / res["device_ms"]
    return res


def baseline_params(torch, dev, stack: str, layers: int = 32, seed: int = 0):
    """A baseline stack's random weights at Llama-2-7B width (layer by layer)."""
    from atom_tpu_torch.serving import baselines as bl

    init = {"bf16": bl.init_bf16_params, "w8a8": bl.init_w8_params, "w4a16": bl.init_w4a16_params}[stack]
    params = init(llama7b(layers), seed=seed, device=dev)
    torch.cuda.synchronize()
    return params


def dense_kv(torch, dev, stack: str, cfg, batch: int, max_t: int):
    """The stack's dense KV: int8 codes for W8A8 (the JAX bench's 8-bit KV), bf16 otherwise."""
    from atom_tpu_torch.serving.baselines import make_dense_kv

    dtype = torch.int8 if stack == "w8a8" else torch.bfloat16
    return make_dense_kv(cfg.num_layers, batch, max_t, cfg.num_kv_heads, cfg.head_dim, dtype=dtype, device=dev)


BURST_LO, BURST_HI = 8, 32  # decode steps of the baseline bursts' slope


def baseline_burst(torch, dev, stack: str, params) -> tuple[dict, dict]:
    """New phase: a baseline stack's decode burst at full width, batch 32,
    context 512 (``bench_textgen.py``'s ``burst_throughput_baseline``: dense KV
    of 672 rows): launch counts over 8 steps, then the step time by the slope
    between bursts of 8 and 32 steps (median of positive samples; every burst
    starts at lens 512), and 8 steps under the profiler."""
    from atom_tpu_torch.serving import baselines as bl

    cfg = llama7b(32)
    burst = {"bf16": bl.bf16_decode_burst, "w8a8": bl.w8a8_decode_burst, "w4a16": bl.w4a16_decode_burst}[stack]
    kvs = dense_kv(torch, dev, stack, cfg, BATCH, CTX + BURST_HI * 3 + 64)
    full = lambda v: torch.full((BATCH,), v, dtype=torch.int32, device=dev)  # noqa: E731
    ids = torch.ones((BATCH,), dtype=torch.int32, device=dev)

    zero_counts()
    ids, kvs, lens = burst(params, kvs, ids, full(CTX), BURST_LO, cfg)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"{stack} burst: launches over {BURST_LO} steps {counts}")
    for name in BASELINE_KERNELS[stack]:
        require(counts[name] > 0, f"kernel {name} was not launched by the {stack} burst")
    require(bool(((ids >= 0) & (ids < cfg.vocab_size)).all()), f"{stack} burst: next ids out of range")
    require(bool((lens == CTX + BURST_LO).all()), f"{stack} burst: lengths did not advance")

    def timed(n):
        nonlocal ids
        torch.cuda.synchronize()
        t = time.perf_counter()
        ids, _, _ = burst(params, kvs, ids, full(CTX), n, cfg)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    samples = []
    for _ in range(3):
        t_lo, t_hi = timed(BURST_LO), timed(BURST_HI)
        samples.append((t_hi - t_lo) / (BURST_HI - BURST_LO))
        log(f"  {stack} step time sample: {samples[-1] * 1e3:.3f} ms")
    positive = [x for x in samples if x > 0]
    require(len(positive) > 0, f"no positive step-time sample ({stack})")
    per_step = statistics.median(positive)

    def once():
        out, _, _ = burst(params, kvs, ids, full(CTX), BURST_LO, cfg)
        require(0 <= int(out.max().item()) < cfg.vocab_size, f"{stack} burst: next ids out of range")

    prof = profile_once(torch, once, f"profile_{stack}.txt", f"{BURST_LO} decode steps of the {stack} stack")
    stats = dict(decode_tok_s=BATCH / per_step, step_ms=per_step * 1e3, step_ms_samples=[x * 1e3 for x in samples],
                 device_ms_per_step_profiled=prof["device_ms"] / BURST_LO,
                 device_kernels_per_step=prof["device_kernels"] / BURST_LO,
                 device_busy_share=prof["device_ms"] / BURST_LO / (per_step * 1e3),
                 peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                 kv_gb=sum(t.numel() * t.element_size() for kv in kvs for t in kv) / 1e9)
    log(f"{stack} burst: {stats}")
    return counts, stats


def baseline_engine(torch, dev, stack: str, params) -> tuple[dict, dict]:
    """New phase: the engine cell over a baseline stack (``make_baseline_step_fns``,
    dense KV of ``max_seq_len`` rows), serial prefill, as for the W4A4 row."""
    from atom_tpu_torch.serving import TextGenEngine
    from atom_tpu_torch.serving.baselines import make_baseline_step_fns

    what = f"{stack} engine"
    cfg = llama7b(32)
    tg, pool, n_pages, rs = engine_setup(torch, dev, cfg)
    state = dense_kv(torch, dev, stack, cfg, tg.batch_size, tg.max_seq_len)
    engine = TextGenEngine(tg, pool, *make_baseline_step_fns(params, cfg, stack), state)
    counts, res = drive_engine(torch, engine, pool, n_pages, rs, cfg, what, BASELINE_KERNELS[stack])
    check_recorded(engine, pool, n_pages, cfg, what)
    return counts, res


def int8_carrier_layer(torch, dev) -> tuple[dict, dict]:
    """K14's path: one Llama-2-7B layer's seven W4A4 projections (q, k, v, o,
    gate, up, down: ``quantize_weight_packed`` of random weights, batch 32)
    through the int8-carrier drop-in ``ops.gemm.quant_gemm`` (K14a), and k and
    v through ``ops.gemm.quant_gemm_o4`` (K14b); then K1 on the same codes
    (nibble planes) and the plain KV quantizer on K1's product, and k and v
    through ``ops.gemm_packed.quant_gemm_o4_packed`` (K1 + the quantizer)
    against its plain version and K14b: bitwise?"""
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.ops import gemm as g8
    from atom_tpu_torch.ops.formats import pack_for_kernel, quantize_activation_packed, quantize_weight_packed
    from atom_tpu_torch.ops.gemm_packed import quant_gemm_o4_packed, quant_gemm_packed
    from atom_tpu_torch.ops.reference import quantize_kv_asym

    gen = torch.Generator(device=dev).manual_seed(12)
    shapes = dict(q=(HID, HID), k=(HID, HID), v=(HID, HID), o=(HID, HID), gate=(HID, INTER), up=(HID, INTER),
                  down=(INTER, HID))
    weights = {n: quantize_weight_packed(torch.randn(sh, generator=gen, device=dev) * sh[0] ** -0.5, ATOM_W4A4)
               for n, sh in shapes.items()}
    acts = {k_: quantize_activation_packed(torch.randn((BATCH, k_), generator=gen, device=dev), ATOM_W4A4)
            for k_ in (HID, INTER)}
    zero_counts()
    out = {n: g8.quant_gemm(acts[shapes[n][0]], pw, out_dtype=torch.float32) for n, pw in weights.items()}
    kv = {n: g8.quant_gemm_o4(acts[HID], weights[n]) for n in ("k", "v")}
    torch.cuda.synchronize()
    counts = read_counts()
    require(counts["grouped_int8_gemm"] == 7 and counts["grouped_int8_gemm_o4"] == 2,
            f"int8-carrier layer: launches {counts}")
    bitwise = {}
    for n, pw in weights.items():
        k1 = quant_gemm_packed(acts[shapes[n][0]], pack_for_kernel(pw), out_dtype=torch.float32)
        bitwise[n] = torch.equal(out[n], k1)
        if n in kv:
            want = quantize_kv_asym(k1.reshape(BATCH, HID // 128, 128))
            bitwise[f"{n}_o4"] = torch.equal(kv[n].codes, want.codes) and torch.equal(kv[n].params, want.params)
            # the K1 drop-in of the k/v projection (K1 into float32, then the per-head u4 quantizer) against its
            # plain version and against K14b on the same codes
            o4 = quant_gemm_o4_packed(acts[HID], pack_for_kernel(pw))
            with plain_path():
                o4_plain = quant_gemm_o4_packed(acts[HID], pack_for_kernel(pw))
            for ref, what in ((o4_plain, "plain"), (kv[n], "k14b")):
                bitwise[f"{n}_o4_packed_vs_{what}"] = torch.equal(o4.codes, ref.codes) and torch.equal(o4.params, ref.params)
        require(bool(torch.isfinite(out[n]).all()), f"int8-carrier layer: {n} not finite")
    log(f"int8-carrier layer (K14 vs K1 on the same codes, bitwise): {bitwise}")
    require(all(bitwise.values()), f"int8-carrier layer: K14 differs from K1 on the same codes: {bitwise}")
    return counts, dict(bitwise_with_k1=bitwise, launches={k_: v_ for k_, v_ in counts.items() if v_})


def capture_head_input(module):
    """Record the hidden rows a step hands its head: wraps ``module._lm_head_logits``."""
    seen = []
    head = module._lm_head_logits

    def wrapped(x, *a, **k):
        seen.append(x.float())
        return head(x, *a, **k)

    @contextlib.contextmanager
    def ctx():
        module._lm_head_logits = wrapped
        try:
            yield seen
        finally:
            module._lm_head_logits = head

    return ctx()


def w4a16_stack_vs_plain(torch, dev) -> dict:
    """Phase 5: the W4A16 stack at 2 layers of the same width, kernel path
    (K13, K6) against plain path: a decode step at batch 32 on a random dense
    cache (an idle slot), a 512-row prefill of 400 tokens into slot 1, and the
    engine with a dozen requests.  K13 equals its plain version within float32
    reordering, so a bf16 output rounds the other way now and then: the gates
    are the 2-layer W4A4 gates' (hidden moved > 0.05 under 25%, max under 1.5,
    the tokens), and the cache entries within 2**-6 of the largest."""
    from atom_tpu_torch.serving import TextGenEngine, synth_requests
    from atom_tpu_torch.serving import baselines as bl
    from atom_tpu_torch.serving.baselines import DenseKV, make_baseline_step_fns

    cfg = llama7b(2)
    params = baseline_params(torch, dev, "w4a16", layers=2, seed=5)
    gen = torch.Generator(device=dev).manual_seed(13)
    max_t = 1024
    kv0 = [DenseKV(*((torch.randn((BATCH, max_t, cfg.num_kv_heads, cfg.head_dim), generator=gen, device=dev) * 0.5)
                     .to(torch.bfloat16) for _ in range(2))) for _ in range(cfg.num_layers)]
    lens = torch.randint(CTX - 40, CTX, (BATCH,), generator=gen, device=dev, dtype=torch.int32)
    lens[1] = 0
    ids = torch.randint(0, cfg.vocab_size, (BATCH,), generator=gen, device=dev, dtype=torch.int32)
    prompt = torch.zeros((512,), dtype=torch.int32, device=dev)
    prompt[:400] = torch.randint(1, cfg.vocab_size, (400,), generator=gen, device=dev, dtype=torch.int32)

    def fresh():
        return [DenseKV(*(t.transpose(1, 2).contiguous().transpose(1, 2) for t in kv)) for kv in kv0]

    def run():
        with capture_head_input(bl) as seen:
            kvs = fresh()
            nxt, kvs = bl.w4a16_decode_step(params, kvs, ids, lens, cfg)
            pkv = fresh()
            tok, pkv = bl.baseline_prefill_step(params, pkv, prompt, 400, 1, cfg, "w4a16")
        return seen[0], nxt, kvs, int(tok.item()), pkv

    zero_counts()
    xk, nk, kk, tk, pk = run()
    counts = read_counts()
    require(counts["w4a16_gemm"] == 2 * 7 * cfg.num_layers and counts["embed_gather"] == 2,
            f"W4A16 stack, 2 layers: launches {counts}")
    with plain_path():
        xp, np_, kp, tp, pp = run()
    torch.cuda.synchronize()
    require(read_counts() == counts, "the plain path launched a kernel")
    diff = (xk - xp).abs()
    moved, dmax = (diff > 0.05).float().mean().item(), diff.max().item()
    agree = (nk == np_).float().mean().item()

    def kv_gap(a_layers, b_layers):
        return max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                   for la, lb in zip(a_layers, b_layers) for a, b in zip(la, lb))

    gaps = dict(decode=kv_gap(kk, kp), prefill=kv_gap(pk, pp))
    log(f"W4A16 stack, kernel vs plain path (2 layers): decode {moved:.4%} of hidden moved > 0.05, max {dmax:.4f}, "
        f"next-id agreement {agree:.3f}; prefill token {tk} / {tp}; cache gaps {gaps}, "
        f"entries differing {entries_differing(kk, kp):.5f} / {entries_differing(pk, pp):.5f}")
    require(bool(torch.isfinite(xk).all()), "W4A16 stack: hidden states not finite (idle slot?)")
    require(moved < 0.25 and dmax < 1.5 and agree >= 0.75, f"W4A16 stack diverges from the plain path: {moved:.2%} moved, max {dmax}")
    require(tk == tp, f"W4A16 stack: the prefill's token differs between the paths ({tk} / {tp})")
    require(max(gaps.values()) <= 2**-6, f"W4A16 stack: cache entries differ by {gaps}")
    res = dict(decode=dict(moved_gt_0p05=moved, max_abs=dmax, next_id_agreement=agree,
                           cache_entries_differing=entries_differing(kk, kp)),
               prefill=dict(token_equal=tk == tp, cache_entries_differing=entries_differing(pk, pp)),
               cache_gap_rel=gaps, launches={k_: v_ for k_, v_ in counts.items() if v_})

    # the engine with a dozen requests on both paths
    tg, _, n_pages, _ = engine_setup(torch, dev, cfg)
    rs = synth_requests(12, cfg.vocab_size, seed=11, maxlen=512)

    def run_engine():
        from atom_tpu_torch.serving import KvPool

        pool = KvPool(cfg.num_layers, n_pages, cfg.num_kv_heads, tg.page_size, cfg.head_dim)
        state = dense_kv(torch, dev, "w4a16", cfg, tg.batch_size, tg.max_seq_len)
        out = TextGenEngine(tg, pool, *make_baseline_step_fns(params, cfg, "w4a16"), state).run(rs, record=True)
        require(pool.num_free_pages == n_pages - 1, "2-layer W4A16 engine: pages not returned to the pool")
        return out

    zero_counts()
    rk = run_engine()
    counts = read_counts()
    require(counts["w4a16_gemm"] > 0, "2-layer W4A16 engine: kernel w4a16_gemm was not launched")
    with plain_path():
        rp = run_engine()
    require(read_counts() == counts, "the plain path launched a kernel")
    require(rk["decode_steps"] == rp["decode_steps"], "2-layer W4A16 engine: step counts differ")
    first = before = total = 0
    for r in range(len(rs)):
        a, b = rk["tokens"][r], rp["tokens"][r]
        require(len(a) == len(b) == int(rs.output_lens[r]), f"2-layer W4A16 engine: request {r} token count")
        first += a[0] == b[0]
        same = [x == y for x, y in zip(a, b)]
        before += same.index(False) if False in same else len(same)
        total += len(same)
    log(f"2-layer W4A16 engine, kernel vs plain: {rk['decode_steps']} decode steps, first tokens equal in {first}/{len(rs)}, "
        f"{before}/{total} positions before the first divergence")
    require(first * 8 >= 7 * len(rs), f"2-layer W4A16 engine: first tokens agree in only {first}/{len(rs)} requests")
    res["engine"] = dict(decode_steps=rk["decode_steps"], first_tokens_equal=first, requests=len(rs),
                         positions_before_first_divergence=before, positions=total,
                         launches={k_: v_ for k_, v_ in counts.items() if v_})
    return res


K3_KERNEL = "paged_ring_stream_kernel"  # K3's CUDA kernel (its RING = true instance), as the profiler names it
K11_KERNELS = {"stream": "paged_ring_stream_kernel", "tile": "paged_tile_kernel"}  # K11's two paths' kernels
# gemm_core_kernel's EPI template argument, in order (silu_quant: K10's gate/up launch over a block cluster)
CORE_EPILOGUES = ("f32", "resid", "row_scale", "ring", "resid_f32", "row_scale_f32", "silu_quant")
# the reorder gathers' kernels, as the profiler names them (index_select on the card)
GATHER_KERNELS = ("_scatter_gather_elementwise_kernel", "indexSelect")
ROLL_KERNEL = "roll_cuda_kernel"  # torch.roll on the card


def k1_family(kernels, steps: int) -> dict:
    """The K1 family's kernels among profiler events (ms and launches per
    step): the decode core by its epilogue, the prefill GEMM, the activation
    prologue (K2's first launch; also K9's and K10's), SiLU (K10's four-launch
    form); the reorder gathers (index_select) that feed them; and torch.roll's
    copies."""
    gemm = {}
    for e in kernels:
        core = re.search(r"gemm_core_kernel<(\d+), (\d+), (?:true|false)(?:, (?:true|false))?>", e.key)
        name = (f"core_{CORE_EPILOGUES[int(core.group(2))]}" if core else
                next((n for n in ("gemm_prefill_kernel", "quant_prologue_kernel", "silu_mul_quant_kernel") if n in e.key), None)
                or ("gather" if any(g_ in e.key for g_ in GATHER_KERNELS) else None)
                or ("roll" if ROLL_KERNEL in e.key else None))
        if name:
            ms, cnt = gemm.get(name, (0.0, 0.0))
            gemm[name] = (ms + e.self_device_time_total / steps / 1e3, cnt + e.count / steps)
    return {k: dict(ms_per_step=v[0], launches_per_step=v[1]) for k, v in gemm.items()}


def profile_decode(torch, params, state, ids, table, full, cfg, spec, w, out_file="profile.txt") -> tuple:
    """One profiled ring window: device time by kernel, written to
    ``OUT / out_file``; returns device ms, kernels and K3 kernels per
    decode step (as the profiler saw them, and by K3's launch counter) and
    the K1 family's kernels' ms and launches per step.  (The
    profiler's own host cost stretches the window's wall time, so the busy
    share is taken against the unprofiled step time.)"""
    from torch.profiler import ProfilerActivity, profile

    from atom_tpu_torch.ops import decode as dec
    from atom_tpu_torch.serving.model import decode_burst

    state = state._replace(flushed=full(CTX), row=0)
    torch.cuda.synchronize()
    k3_before = dec.paged_ring_decode_attention.launches
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        decode_burst(params, state, ids, table, full(CTX), 1, cfg, spec)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t) * 1e6
    k3_counted = (dec.paged_ring_decode_attention.launches - k3_before) / w
    events = prof.key_averages()
    # kernel events only: an aten op also reports its kernels' time as its own
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    table_txt = events.table(sort_by="self_device_time_total", row_limit=40)
    OUT.mkdir(exist_ok=True)
    (OUT / out_file).write_text(
        f"one window of {w} steps: wall {wall_us:.0f} us (profiler on), device {dev_us:.0f} us, "
        f"{n_kernels} device kernels\n{table_txt}\n")
    require(dev_us > 0, "the profiler recorded no device time")
    k3 = sum(e.count for e in kernels if K3_KERNEL in e.key and ", true>" in e.key)
    # the K1 family's kernels; torch.roll's copies must be none: the flush reads the ring
    gemm = k1_family(kernels, w)
    log(f"profiled window: {n_kernels / w:.0f} device kernels per step, {k3 / w:.0f} of them K3 ({k3_counted:.0f} "
        f"launched); K1 family {gemm}")
    return dev_us / w / 1e3, n_kernels / w, k3 / w, k3_counted, gemm


@contextlib.contextmanager
def plain_path():
    """Route the serving model (Llama and MoE), the baseline stacks and the
    int8-carrier drop-ins through the plain PyTorch versions."""
    import atom_tpu_torch.serving.baselines as bl
    import atom_tpu_torch.serving.model as sm
    import atom_tpu_torch.serving.moe as moe
    from atom_tpu_torch.ops import decode as dec
    from atom_tpu_torch.ops import gemm as g8
    from atom_tpu_torch.ops import gemm_packed as gp
    from atom_tpu_torch.ops import gemm_w4a16 as gw
    from atom_tpu_torch.ops import misc, mlp
    from atom_tpu_torch.ops import prefill as pf

    swaps = [
        (sm, "packed_w4_gemm_fused_in", gp.packed_w4_gemm_fused_in_plain),
        (sm, "fused_mlp_packed", mlp.fused_mlp_packed_plain),
        (sm, "paged_decode_attention_rotated", dec.paged_decode_attention_rotated_plain),
        (sm, "flash_code_attention", pf.flash_code_attention_plain),
        (sm, "embed_gather", misc.embed_gather_plain),
        (sm, "packed_w4_gemm_qkv_ring_fused", gp.packed_w4_gemm_qkv_ring_fused_plain),
        (sm, "packed_w4_gemm_qkv", gp.packed_w4_gemm_qkv_plain),
        (sm, "packed_w4_gemm_qkv_ring", gp.packed_w4_gemm_qkv_ring_plain),
        (sm, "w8a16_gemm", gw.w8a16_gemm_plain),
        (sm, "flush_hot_ring", dec.flush_hot_ring_plain),
        (sm, "paged_ring_decode_attention", dec.paged_ring_decode_attention_plain),
        (moe, "packed_w4_gemm_fused_in", gp.packed_w4_gemm_fused_in_plain),
        (moe, "fused_mlp_packed", mlp.fused_mlp_packed_plain),
        (moe, "flush_hot_ring", dec.flush_hot_ring_plain),
        (moe, "paged_ring_decode_attention", dec.paged_ring_decode_attention_plain),
        (gp, "packed_w4_gemm", gp.packed_w4_gemm_plain),
        (sm, "w4a16_gemm", gw.w4a16_gemm_plain),
        (bl, "w4a16_gemm", gw.w4a16_gemm_plain),
        (g8, "grouped_int8_gemm", g8.grouped_int8_gemm_plain),
        (g8, "grouped_int8_gemm_o4", g8.grouped_int8_gemm_o4_plain),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def entries_differing(a_layers, b_layers) -> float:
    """Mean share of differing entries over the arrays of two per-layer lists
    of pages or rings."""
    return statistics.mean(bits(a).ne(bits(b)).float().mean().item()
                           for la, lb in zip(a_layers, b_layers) for a, b in zip(la, lb))


def kernel_and_plain_step(torch, dev, params, batch: int, spec, head, must_launch: tuple, fused: bool = False,
                          cfg=None, hidden_fn=None) -> tuple:
    """One flushing decode step at 2 layers on the kernel path and on the
    plain path from the same state -> (launch counts, (hidden, next ids,
    state) of the kernel path, the same of the plain path).  ``cfg`` and
    ``hidden_fn``: as ``kernel_vs_plain_path``."""
    from atom_tpu_torch.ops.kv_hot import HotKV
    from atom_tpu_torch.ops.kv_layout import KVPages
    from atom_tpu_torch.serving.model import ServingState, _lm_head_logits, decode_hidden

    cfg = cfg or llama7b(2)
    hidden_fn = hidden_fn or decode_hidden
    gen = torch.Generator(device=dev).manual_seed(4)
    w = 32
    pages, hot, table = random_kv_state(torch, gen, dev, cfg, batch, w)
    flushed = torch.randint(CTX - 40, CTX, (batch,), generator=gen, device=dev, dtype=torch.int32)
    lens = flushed + w  # the ring holds W-1 tokens; this step writes column W-1 and flushes
    flushed[1], lens[1] = 0, 0  # an idle slot
    ids = torch.randint(0, cfg.vocab_size, (batch,), generator=gen, device=dev, dtype=torch.int32)

    def run():
        st = ServingState([KVPages(*(t.clone() for t in p)) for p in pages],
                          [HotKV(*(t.clone() for t in r)) for r in hot], w - 1, flushed.clone())
        with fused_flag() if fused else contextlib.nullcontext():
            x, st = hidden_fn(params, st, ids, table, lens, cfg, spec, flush=True)
        nxt = torch.argmax(_lm_head_logits(x, head, cfg.vocab_size), -1)
        return x.float(), nxt, st

    zero_counts()
    kernel = run()
    counts = read_counts()
    for name in must_launch:
        require(counts[name] > 0, f"kernel {name} was not launched on the batch-{batch} branch")
    with plain_path():
        plain = run()
    torch.cuda.synchronize()
    require(read_counts() == counts, "the plain path launched a kernel")
    return counts, kernel, plain


def kernel_vs_plain_path(torch, dev, params, batch: int, spec, head, must_launch: tuple, fused: bool = False,
                         cfg=None, hidden_fn=None) -> dict:
    """Phase 5: one flushing decode step at 2 layers, kernels vs plain, on the
    decode branch that ``batch`` and ``spec`` select; with ``fused`` the
    post-attention half as K9 + K10 (``ATOM_TPU_FUSED_MLP=1``).  ``cfg`` and
    ``hidden_fn`` (the 2-layer Llama-2-7B and ``decode_hidden`` by default):
    another model's and its layer stack (the MoE phase's)."""
    counts, (xk, nk, sk), (xp, np_, sp) = kernel_and_plain_step(torch, dev, params, batch, spec, head, must_launch,
                                                                fused, cfg, hidden_fn)
    diff = (xk - xp).abs()
    moved, dmax = (diff > 0.05).float().mean().item(), diff.max().item()
    agree = (nk == np_).float().mean().item()
    page_diff, ring_diff = entries_differing(sk.pages, sp.pages), entries_differing(sk.hot, sp.hot)
    log(f"kernel vs plain path (2 layers, batch {batch}, fused_serving={spec.fused_serving}, fused post-attention {fused}, flush step): "
        f"{moved:.4%} of hidden moved > 0.05, max {dmax:.4f}, next-id agreement {agree:.3f}, "
        f"page bytes differing {page_diff:.6f}, ring bytes differing {ring_diff:.6f}")
    require(bool(torch.isfinite(xk).all()), "hidden states not finite (idle slot?)")
    require(moved < 0.25 and dmax < 1.5, f"kernel path diverges from plain path: {moved:.2%} moved, max {dmax}")
    return dict(moved_gt_0p05=moved, max_abs=dmax, next_id_agreement=agree, page_entries_differing=page_diff,
                ring_entries_differing=ring_diff, launches={k: v for k, v in counts.items() if v})


def random_kv_state(torch, gen, dev, cfg, batch: int, w: int = 32):
    """Per-layer pages (MAX_PAGES per sequence after the sink) and rings with
    random codes and centred scale/zero pairs, and the page table."""
    from atom_tpu_torch.ops.kv_hot import HotKV
    from atom_tpu_torch.ops.kv_layout import KVPages

    h = cfg.num_kv_heads
    n_pages = batch * MAX_PAGES + 1

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32).to(torch.int8)

    def prm(shape):
        s = torch.rand(shape[:1] + (2,) + shape[2:], generator=gen, device=dev) * 0.05 + 0.01
        return torch.stack([s[:, 0], -7.5 * s[:, 0], s[:, 1], -7.5 * s[:, 1]], dim=1).to(torch.bfloat16)

    pages = [KVPages(ri(-128, 128, (n_pages, h, 64, PAGE)), ri(-128, 128, (n_pages, h, PAGE // 2, 128)),
                     prm((n_pages, 4, h, PAGE))) for _ in range(cfg.num_layers)]
    hot = [HotKV(ri(-128, 128, (batch, h, 64, w)), prm((batch, 4, h, w)), ri(0, 16, (batch, h, w, 128)))
           for _ in range(cfg.num_layers)]
    table = (1 + torch.arange(batch * MAX_PAGES, device=dev, dtype=torch.int32)).reshape(batch, MAX_PAGES)
    return pages, hot, table


def mixed_step_kernel_vs_plain(torch, dev, params, flush: bool, pos0: int, chunk_len: int) -> dict:
    """Phase 5: one mixed step at 2 layers, kernels vs plain: 31 decoding
    sequences at context ~500 and, in the idle slot 1, a prompt chunk at
    ``pos0`` with ``chunk_len`` valid tokens (its prefix pages hold random
    codes).  ``flush``: the step writes ring column W-1 and flushes."""
    import atom_tpu_torch.serving.model as sm
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.ops.kv_hot import HotKV
    from atom_tpu_torch.ops.kv_layout import KVPages

    cfg = llama7b(2)
    gen = torch.Generator(device=dev).manual_seed(6)
    w, slot = 32, 1
    pages, hot, table = random_kv_state(torch, gen, dev, cfg, BATCH, w)
    row = w - 1 if flush else 5
    flushed = torch.randint(CTX - 40, CTX, (BATCH,), generator=gen, device=dev, dtype=torch.int32)
    lens = flushed + row + 1
    flushed[slot], lens[slot] = 0, 0
    dec_table = table.clone()
    dec_table[slot] = 0  # the prefilling slot is idle in the decode batch
    ids = torch.randint(0, cfg.vocab_size, (BATCH,), generator=gen, device=dev, dtype=torch.int32)
    chunk_ids = torch.randint(1, cfg.vocab_size, (PAGE,), generator=gen, device=dev, dtype=torch.int32)
    chunk_ids[chunk_len:] = 0

    def run():
        st = sm.ServingState([KVPages(*(t.clone() for t in p)) for p in pages],
                             [HotKV(*(t.clone() for t in r)) for r in hot], row, flushed.clone())
        with capture_head_input(sm) as seen:
            nxt, tok, st = sm.mixed_step(params, st, ids, dec_table, lens, chunk_ids, table[slot], pos0, chunk_len, slot,
                                         cfg, ATOM_W4A4, flush=flush)
        return seen[0], nxt, tok, st

    zero_counts()
    xk, nk, tk, sk = run()
    counts = read_counts()
    want = {"paged_decode_attention_rotated": 2 * cfg.num_layers, "packed_w4_gemm_qkv": cfg.num_layers,
            "packed_w4_gemm": 3 * cfg.num_layers, "flush_hot": cfg.num_layers * flush, "embed_gather": 2, "w8a16_gemm": 1}
    for name, n in want.items():
        require(counts[name] == n, f"mixed step: {counts[name]} launches of {name}, {n} expected")
    with plain_path():
        xp, np_, tp, sp = run()
    torch.cuda.synchronize()
    require(read_counts() == counts, "the plain path launched a kernel")
    require(sk.row == sp.row == (row + 1) % w and torch.equal(sk.flushed, sp.flushed)
            and int(sk.flushed[slot]) == pos0 + chunk_len, "mixed step: row or flushed counts differ")
    diff = (xk - xp).abs()
    moved, dmax = (diff > 0.05).float().mean().item(), diff.max().item()
    rows_equal = diff.eq(0).all(dim=1).float().mean().item()
    agree = (nk == np_).float().mean().item()
    chunk_page = int(table[slot, pos0 // PAGE])
    # K7 equals its plain version bit for bit, so layer 0's K/V (the chunk's page and the ring) do too
    require(all(torch.equal(bits(a[chunk_page]), bits(b[chunk_page])) for a, b in zip(sk.pages[0], sp.pages[0])),
            "mixed step: layer 0 of the chunk's page differs between the paths")
    page_diff, ring_diff = entries_differing(sk.pages, sp.pages), entries_differing(sk.hot, sp.hot)
    # all of the chunk's rows, not only the one the head sees: their layer-1 K and V codes follow layer 0's
    # attention, K11's chunk-prefix call included; by rows, as the kernel prefill's gate counts them
    k1k, k1p, v1k, v1p = (st.pages[1][i][chunk_page] for i in (0, 1) for st in (sk, sp))
    chunk_k_rows = (k1k == k1p).all(dim=0).all(dim=0)[:chunk_len].float().mean().item()
    chunk_v_entries = (v1k == v1p).float().mean().item()
    log(f"mixed step, kernel vs plain path (2 layers, flush {flush}, pos0 {pos0}, chunk_len {chunk_len}): {moved:.4%} of hidden "
        f"moved > 0.05, max {dmax:.4f}, {rows_equal:.3f} of the head's rows bitwise equal, next-id agreement {agree:.3f}, "
        f"chunk token equal {int(tk) == int(tp)}, {chunk_k_rows:.3f} of the chunk's rows with layer-1 K codes bitwise equal "
        f"({chunk_v_entries:.5f} of its V page's entries), "
        f"page bytes differing {page_diff:.6f}, ring bytes differing {ring_diff:.6f}")
    require(bool(torch.isfinite(xk).all()), "mixed step: hidden states not finite (idle slot or empty prefix?)")
    # K11 is within 1e-6 of its plain version, which moves a merged bf16 output by one ulp now and then; where that
    # lands on a quantizer's rounding boundary a code flips and moves its whole row (random weights, attention
    # outputs of magnitude 0.01 under a norm).  So most rows are equal bit for bit and a few differ throughout.
    require(moved < 0.25 and dmax < 1.5 and rows_equal >= 0.6,
            f"mixed step: kernel path diverges from plain path: {moved:.2%} moved, max {dmax}, {rows_equal:.2%} rows equal")
    # the chunk's rows: with an empty prefix K11 adds nothing to them (l = 0 drops out of the merge exactly), so they
    # are equal bit for bit; with a prefix, the same flip noise by rows as above, held to the kernel prefill's bound
    require(chunk_k_rows >= (0.75 if pos0 else 1.0) and chunk_v_entries >= (0.75 if pos0 else 1.0),
            f"mixed step: only {chunk_k_rows:.2%} of the chunk's rows keep their layer-1 K codes ({chunk_v_entries:.2%} of V entries)")
    require(int(tk) == int(tp), f"mixed step: the chunk's token differs between the paths ({int(tk)} / {int(tp)})")
    return dict(moved_gt_0p05=moved, max_abs=dmax, rows_bitwise_equal=rows_equal, next_id_agreement=agree,
                chunk_token_equal=int(tk) == int(tp), chunk_rows_layer1_k_bitwise_equal=chunk_k_rows,
                chunk_layer1_v_entries_equal=chunk_v_entries,
                page_entries_differing=page_diff, ring_entries_differing=ring_diff,
                launches={k: v for k, v in counts.items() if v})


# The gate below as K12's earlier CUDA-core design read it (float32 FMAs, 32-row tiles;
# scripts/torch_flash_compare.py on that tree, NVIDIA H100 80GB HBM3, 700 W), logged beside this run's reading
EARLIER_K12_GATE = dict(rows_layer1_k_bitwise_equal=0.9125, page_entries_differing=0.022151)


def prefill_kernel_vs_plain(torch, dev, params, bucket: int = 512, true_len: int = 400) -> dict:
    """Phase 5: one prefill at 2 layers through the flash kernel (K12), kernel
    path vs plain path: layer 0's pages bitwise (K6, K7 and the append are),
    the share of page bytes differing over both layers, the first token."""
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.serving.model import make_serving_state, prefill_step

    cfg = llama7b(2)
    gen = torch.Generator(device=dev).manual_seed(8)
    ids = torch.randint(1, cfg.vocab_size, (bucket,), generator=gen, device=dev, dtype=torch.int32)
    ids[true_len:] = 0
    table_row = torch.zeros((4,), dtype=torch.int32, device=dev)
    table_row[:2] = torch.tensor([2, 1], dtype=torch.int32, device=dev)

    def run():
        state = make_serving_state(cfg.num_layers, 4, 2, cfg.num_kv_heads, PAGE, cfg.head_dim, device=dev)
        with kernel_prefill():
            tok, state = prefill_step(params, state, ids, table_row, true_len, 1, cfg, ATOM_W4A4)
        return int(tok.item()), state

    zero_counts()
    tk, sk = run()
    counts = read_counts()
    require(counts["flash_code_attention"] == cfg.num_layers and counts["packed_w4_gemm_qkv"] == cfg.num_layers,
            f"kernel prefill: launches {counts}")
    with plain_path():
        tp, sp = run()
    require(read_counts() == counts, "the plain path launched a kernel")
    require(all(torch.equal(bits(a), bits(b)) for a, b in zip(sk.pages[0], sp.pages[0])),
            "kernel prefill: layer 0's pages differ between the paths")
    page_diff = entries_differing(sk.pages, sp.pages)
    # by rows: the prompt's slots whose layer-1 K codes are equal bit for bit
    own = table_row[: bucket // PAGE].long()
    same = (sk.pages[1].k_pages[own] == sp.pages[1].k_pages[own]).all(dim=1).all(dim=1).reshape(-1)[:true_len]
    rows_equal = same.float().mean().item()
    log(f"kernel prefill, kernel vs plain path (2 layers, {bucket} rows, {true_len} true): token {tk} / {tp}, "
        f"page bytes differing {page_diff:.6f}, {rows_equal:.3f} of the prompt's rows with layer-1 K codes bitwise equal "
        f"(K12's earlier design: {EARLIER_K12_GATE})")
    # K12 is within one bf16 rounding of its plain version in a few elements of a row; where one sits on the o_proj
    # quantizer's rounding boundary a code flips and the row's hidden moves, and with it its layer-1 K/V codes
    require(page_diff < 0.05 and rows_equal >= 0.75 and sk.flushed.tolist() == sp.flushed.tolist() == [0, true_len],
            f"kernel prefill: {page_diff:.3%} of page bytes differ, {rows_equal:.2%} of rows equal")
    return dict(token_equal=tk == tp, page_entries_differing=page_diff, rows_layer1_k_bitwise_equal=rows_equal,
                launches={k: v for k, v in counts.items() if v}, earlier_k12_design=EARLIER_K12_GATE)


def engine_kernel_vs_plain(torch, dev, qparams, mixed: bool = False) -> dict:
    """Phase 5: the engine at 2 layers, a dozen requests with the tokens
    recorded, kernel path against plain path, with serial prefill or (``mixed``)
    mixed scheduling.

    The schedule does not depend on the tokens: same decode-step and
    mixed-step counts, pages freed on both.  A request's first token depends on
    its prompt alone, and on that path K1, K6 and K7 equal their plain versions
    bit for bit while K5 (and, in a mixed step, K11) differs by float32
    reordering: it must agree in at least 7 of 8 requests, the share the CPU
    tests hold the port to against the JAX package.  Later tokens follow K3,
    which is within a bf16 rounding of its plain version, so near-tie flips
    compound and only the share before the first divergence is reported."""
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.serving import KvPool, TextGenConfig, synth_requests
    from atom_tpu_torch.serving.model import make_serving_state

    what = "2-layer mixed engine" if mixed else "2-layer engine"
    cfg = llama7b(2)
    tg = TextGenConfig(batch_size=BATCH, page_size=PAGE, max_seq_len=1024, prefill_buckets=(128, 256, 512))
    n_pages = 12 * 4 + 8
    rs = synth_requests(12, cfg.vocab_size, seed=11, maxlen=512)

    def run():
        pool = KvPool(cfg.num_layers, n_pages, cfg.num_kv_heads, tg.page_size, cfg.head_dim)
        state = make_serving_state(cfg.num_layers, n_pages, tg.batch_size, cfg.num_kv_heads, tg.page_size,
                                   cfg.head_dim, device=dev)
        res = make_engine(tg, pool, state, qparams, cfg, mixed).run(rs, record=True)
        require(pool.num_free_pages == n_pages - 1, f"{what}: pages not returned to the pool")
        return res

    zero_counts()
    rk = run()
    counts = read_counts()
    if mixed:
        require(counts["paged_decode_attention_rotated"] > 0, f"{what}: kernel paged_decode_attention_rotated was not launched")
    with plain_path():
        rp = run()
    require(read_counts() == counts, "the plain path launched a kernel")
    require(rk["decode_steps"] == rp["decode_steps"] and rk["mixed_steps"] == rp["mixed_steps"],
            f"{what}: step counts differ")
    require((rk["mixed_steps"] > 0) == mixed, f"{what}: {rk['mixed_steps']} mixed steps")
    first = before = total = 0
    for r in range(len(rs)):
        a, b = rk["tokens"][r], rp["tokens"][r]
        require(len(a) == len(b) == int(rs.output_lens[r]), f"{what}: request {r} token count")
        first += a[0] == b[0]
        same = [x == y for x, y in zip(a, b)]
        before += same.index(False) if False in same else len(same)
        total += len(same)
    log(f"{what}, kernel vs plain: {rk['decode_steps']} decode steps, {rk['mixed_steps']} mixed, first tokens equal in "
        f"{first}/{len(rs)}, {before}/{total} positions before the first divergence")
    require(first * 8 >= 7 * len(rs), f"{what}: first tokens agree in only {first}/{len(rs)} requests")
    return dict(decode_steps=rk["decode_steps"], mixed_steps=rk["mixed_steps"], first_tokens_equal=first, requests=len(rs),
                positions_before_first_divergence=before, positions=total,
                launches={k: v for k, v in counts.items() if v})


# the Mixtral phase: the kernels each MoE path must launch, the engine's depth (``bench_textgen.py``'s MoE
# depth) and the profiled decode steps (a whole window runs ~7,000 kernels a step)
MOE_DECODE_KERNELS = ("packed_w4_gemm", "packed_w4_gemm_qkv_ring_fused", "paged_ring_decode_attention", "flush_hot",
                      "embed_gather")
MOE_FUSED_KERNELS = ("packed_w4_gemm_fused_in", "fused_mlp_packed") + MOE_DECODE_KERNELS[1:]
MOE_ENGINE_KERNELS = MOE_DECODE_KERNELS + ("packed_w4_gemm_qkv",)
# the Mixtral bursts' slope between 1 and MOE_BURST_HI windows, and its samples (cut from 4 and 3 with phase 10, the
# samples to 1 with phase 11)
MOE_ENGINE_LAYERS, MOE_PROFILE_STEPS, MOE_BURST_SAMPLES, MOE_BURST_HI = 4, 4, 1, 2
MOE_BURST_LAYERS = 16  # the Mixtral bursts' depth: cut from all 32 with phase 12 (it feeds no ratio)


@contextlib.contextmanager
def count_calls(module, name: str):
    """Count the calls of ``module.name`` for the duration -> a list, one entry a call."""
    calls, real = [], getattr(module, name)

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def moe_decode_path(torch, dev, params, cfg, fused: bool, profile_file: str) -> tuple[dict, dict]:
    """The Mixtral phase's decode burst (batch 32, context 512, page 256, W
    32; with ``fused`` under ``ATOM_TPU_FUSED_MLP=1``): 2 flushing windows and
    one step with every launch counted and checked per layer and expert, then
    tok/s by the slope between 1 and ``MOE_BURST_HI`` windows (median of the
    positive samples), device time and kernels a step over a few profiled steps (the
    experts' GEMMs among the K1 family's kernels), peak memory."""
    from torch.profiler import ProfilerActivity, profile

    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.serving.model import make_serving_state
    from atom_tpu_torch.serving.moe import decode_burst_moe, decode_hidden_moe, decode_step_moe

    spec = ATOM_W4A4
    n_layers, n_exp = cfg.num_layers, cfg.num_experts
    torch.cuda.reset_peak_memory_stats()
    n_pages = BATCH * MAX_PAGES + 1
    table = (1 + torch.arange(BATCH * MAX_PAGES, device=dev, dtype=torch.int32)).reshape(BATCH, MAX_PAGES)
    full = lambda v: torch.full((BATCH,), v, dtype=torch.int32, device=dev)  # noqa: E731
    state = make_serving_state(n_layers, n_pages, BATCH, cfg.num_kv_heads, PAGE, cfg.head_dim, device=dev)
    state = state._replace(flushed=full(CTX))
    ids = torch.ones((BATCH,), dtype=torch.int32, device=dev)
    what = "fused MoE decode burst" if fused else "MoE decode burst"
    with fused_flag() if fused else contextlib.nullcontext():
        zero_counts()
        t0 = time.perf_counter()
        ids, state, lens = decode_burst_moe(params, state, ids, table, full(CTX), 2, cfg, spec)
        x, state = decode_hidden_moe(params, state, ids, table, lens + 1, cfg, spec)
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"{what}: 2 windows + 1 step in {time.perf_counter() - t0:.1f} s, launches {counts}")
        w = state.hot[0].window
        steps = 2 * w + 1
        per = steps * n_layers
        want = {"packed_w4_gemm_qkv_ring_fused": per, "paged_ring_decode_attention": per, "flush_hot": 2 * n_layers,
                "embed_gather": steps, "packed_w4_gemm_qkv": 0}
        # unfused: o_proj and every expert's gate/up and down on K1; fused: K9 for o_proj and one K10 an expert
        want.update(dict(packed_w4_gemm_fused_in=per, fused_mlp_packed=per * n_exp, packed_w4_gemm=0) if fused else
                    dict(packed_w4_gemm_fused_in=0, fused_mlp_packed=0, packed_w4_gemm=per * (1 + 2 * n_exp)))
        for name, n in want.items():
            require(counts[name] == n, f"{what}: {counts[name]} launches of {name} in {steps} steps, {n} expected")
        require(counts["flush_hot_by_path"]["rolled"] == 0, f"{what} flushed pre-rolled blocks")
        require(counts["packed_w4_gemm_by_path"]["prefill"] == 0, f"{what} ran the prefill GEMM")
        require(not fused or counts["fused_mlp_packed_by_path"]["four_launch"] == 0, f"{what} ran K10's four-launch form")
        require(bool(((ids >= 0) & (ids < cfg.vocab_size)).all()), f"{what}: next ids out of range")
        require(bool(torch.isfinite(x.float()).all()), f"{what}: hidden states not finite")
        require(bool((lens == CTX + 2 * w).all()), f"{what}: sequence lengths did not advance by {2 * w}")

        def timed(n):
            nonlocal state, ids
            state = state._replace(flushed=full(CTX), row=0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            ids, state, _ = decode_burst_moe(params, state, ids, table, full(CTX), n, cfg, spec)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        samples = []
        for _ in range(MOE_BURST_SAMPLES):
            t_lo, t_hi = timed(1), timed(MOE_BURST_HI)
            samples.append((t_hi - t_lo) / ((MOE_BURST_HI - 1) * w))
            log(f"  {what} step time sample: {samples[-1] * 1e3:.3f} ms")
        positive = [s for s in samples if s > 0]
        require(len(positive) > 0, f"{what}: no positive step-time sample")
        step_ms = statistics.median(positive) * 1e3

        # a few non-flushing steps under the profiler, from ring row 0
        state = state._replace(flushed=full(CTX), row=0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(MOE_PROFILE_STEPS):
                ids, state = decode_step_moe(params, state, ids, table, full(CTX + 1 + i), cfg, spec)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(e.self_device_time_total for e in kernels) / MOE_PROFILE_STEPS / 1e3
        n_kernels = sum(e.count for e in kernels) / MOE_PROFILE_STEPS
        OUT.mkdir(exist_ok=True)
        (OUT / profile_file).write_text(
            f"{MOE_PROFILE_STEPS} {what} steps: device {dev_ms:.3f} ms a step, {n_kernels:.0f} kernels a step\n"
            + prof.key_averages().table(sort_by="self_device_time_total", row_limit=40) + "\n")
        require(dev_ms > 0, f"{what}: the profiler recorded no device time")
    stats = dict(decode_tok_s=BATCH / step_ms * 1e3, step_ms=step_ms, step_ms_samples=[s * 1e3 for s in samples],
                 device_ms_per_step_profiled=dev_ms, device_busy_share=dev_ms / step_ms, device_kernels_per_step=n_kernels,
                 k1_family_kernels_per_step=k1_family(kernels, MOE_PROFILE_STEPS), profiled_steps=MOE_PROFILE_STEPS,
                 peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"{what}: step {step_ms:.3f} ms, device {dev_ms:.3f} ms ({n_kernels:.0f} kernels), K1 family "
        f"{stats['k1_family_kernels_per_step']}")
    return counts, stats


def moe_engine_path(torch, dev, params, cfg) -> tuple[dict, dict]:
    """The serving engine over ``make_moe_step_fns`` at ``MOE_ENGINE_LAYERS``
    layers in the engine cell's configuration (``engine_setup``): launch
    counts, every request's tokens, the pool; the prompts of the 512 bucket
    take the routed experts in every layer, the others the dense ones."""
    import atom_tpu_torch.serving.moe as moe
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.serving import TextGenEngine, make_moe_step_fns
    from atom_tpu_torch.serving.model import make_serving_state

    cfg = cfg.replace(num_layers=MOE_ENGINE_LAYERS)
    params = params._replace(layers=params.layers[:MOE_ENGINE_LAYERS])
    tg, pool, n_pages, rs = engine_setup(torch, dev, cfg)
    state = make_serving_state(cfg.num_layers, n_pages, tg.batch_size, cfg.num_kv_heads, tg.page_size, cfg.head_dim,
                               device=dev)
    engine = TextGenEngine(tg, pool, *make_moe_step_fns(params, cfg, ATOM_W4A4), state)
    with count_calls(moe, "_moe_mlp_routed") as routed:
        counts, res = drive_engine(torch, engine, pool, n_pages, rs, cfg, "MoE engine", MOE_ENGINE_KERNELS)
    n_512 = sum(1 for b, _ in engine.last_prefill_s if b >= moe.MOE_ROUTED_THRESHOLD)
    require(n_512 > 0 and len(routed) == n_512 * cfg.num_layers,
            f"MoE engine: {len(routed)} routed expert blocks for {n_512} prompts of the 512 bucket at {cfg.num_layers} layers")
    check_recorded(engine, pool, n_pages, cfg, "MoE engine")
    res.update(layers=cfg.num_layers, routed_prefills=n_512, routed_capacity=moe._moe_capacity(512, cfg))
    return counts, res


def moe_prefill_kernel_vs_plain(torch, dev, params, cfg, bucket: int, true_len: int) -> dict:
    """A 2-layer MoE prefill at ``bucket`` rows (dense experts below
    ``MOE_ROUTED_THRESHOLD``, routed from it on), kernel path against plain
    path: layer 0's pages bitwise, the hidden rows within the decode gates'
    structural bound, the share of page entries differing and the token."""
    import atom_tpu_torch.serving.moe as moe
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.serving.model import _lm_head_logits, make_serving_state

    gen = torch.Generator(device=dev).manual_seed(9)
    ids = torch.randint(1, cfg.vocab_size, (bucket,), generator=gen, device=dev, dtype=torch.int32)
    ids[true_len:] = 0
    table_row = torch.zeros((4,), dtype=torch.int32, device=dev)
    table_row[: bucket // PAGE] = torch.arange(bucket // PAGE, 0, -1, dtype=torch.int32, device=dev)

    def run():
        state = make_serving_state(cfg.num_layers, 4, 2, cfg.num_kv_heads, PAGE, cfg.head_dim, device=dev)
        with count_calls(moe, "_moe_mlp_routed") as routed:
            x, pages = moe.prefill_hidden_moe(params, state.pages, ids, table_row, cfg, ATOM_W4A4)
        require(len(routed) == (cfg.num_layers if bucket >= moe.MOE_ROUTED_THRESHOLD else 0),
                f"MoE prefill at {bucket} rows: {len(routed)} routed expert blocks")
        tok = int(torch.argmax(_lm_head_logits(x[true_len - 1][None], params.lm_head, cfg.vocab_size)[0]))
        return x[:true_len].float(), pages, tok

    zero_counts()
    xk, pk, tk = run()
    counts = read_counts()
    require(counts["packed_w4_gemm_qkv"] == cfg.num_layers and counts["packed_w4_gemm"] > 0,
            f"MoE prefill at {bucket} rows: launches {counts}")
    with plain_path():
        xp, pp, tp = run()
    require(read_counts() == counts, "the plain path launched a kernel")
    require(all(torch.equal(bits(a), bits(b)) for a, b in zip(pk[0], pp[0])),
            f"MoE prefill at {bucket} rows: layer 0's pages differ between the paths")
    diff = (xk - xp).abs()
    moved, dmax = (diff > 0.05).float().mean().item(), diff.max().item()
    page_diff = entries_differing(pk, pp)
    log(f"MoE prefill at {bucket} rows ({true_len} true), kernel vs plain path: {moved:.4%} of hidden moved > 0.05, max "
        f"{dmax:.4f}, page entries differing {page_diff:.6f}, token {tk} / {tp}")
    require(bool(torch.isfinite(xk).all()), f"MoE prefill at {bucket} rows: hidden states not finite")
    require(moved < 0.25 and dmax < 1.5, f"MoE prefill at {bucket} rows: kernel path diverges: {moved:.2%} moved, max {dmax}")
    return dict(moved_gt_0p05=moved, max_abs=dmax, hidden_bitwise_equal=bool(torch.equal(xk, xp)),
                page_entries_differing=page_diff, token_equal=tk == tp, launches={k: v for k, v in counts.items() if v})


def mixtral_phase(torch, dev) -> tuple[dict, dict]:
    """Phase 8: Mixtral-8x7B at full width and ``MOE_BURST_LAYERS`` layers
    (``ATOM_W4A4``, random weights from a seed, the bf16 head), one device:
    the decode burst unfused and fused, the engine at ``MOE_ENGINE_LAYERS`` layers (its first
    layers), and at 2 layers the kernel path against the plain path (a
    flushing decode step unfused and fused, prefills at 256 and 512 rows)."""
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.models.configs import MIXTRAL_8X7B
    from atom_tpu_torch.serving.moe import decode_hidden_moe, init_moe_serving_params

    cfg = MIXTRAL_8X7B.replace(num_layers=MOE_BURST_LAYERS)
    t0 = time.perf_counter()
    params = init_moe_serving_params(cfg, ATOM_W4A4, seed=0, device=dev)
    torch.cuda.synchronize()
    params_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    expert_bytes = sum(t.numel() * t.element_size() for lp in params.layers for t in (*lp.wgateup, *lp.wdown))
    layer_bytes = sum(t.numel() * t.element_size() for lp in params.layers for t in _leaves(lp))
    res = dict(params_gb=params_gb, init_s=time.perf_counter() - t0,
               # dense routing reads every expert every step: their bytes, and every layer's and the head's, at HBM rate
               experts_bound_ms=expert_bytes / HBM_BYTES_PER_S * 1e3,
               weights_bound_ms=(layer_bytes + params.lm_head.numel() * 2) / HBM_BYTES_PER_S * 1e3)
    log(f"Mixtral-8x7B params ({params_gb:.2f} GB) in {res['init_s']:.1f} s; experts' byte bound "
        f"{res['experts_bound_ms']:.3f} ms a step")
    counts = {}
    counts["moe_decode_burst"], res["decode"] = moe_decode_path(torch, dev, params, cfg, False, "profile_moe.txt")
    torch.cuda.empty_cache()
    counts["moe_fused_decode_burst"], res["decode_fused"] = moe_decode_path(torch, dev, params, cfg, True,
                                                                             "profile_moe_fused.txt")
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    counts["moe_engine"], res["engine"] = moe_engine_path(torch, dev, params, cfg)
    torch.cuda.empty_cache()
    log(f"MoE engine in {time.perf_counter() - t1:.1f} s")
    cfg2 = cfg.replace(num_layers=2)
    p2 = params._replace(layers=params.layers[:2])
    res["path_parity_2_layers"] = {
        "decode_step": kernel_vs_plain_path(torch, dev, p2, BATCH, ATOM_W4A4, p2.lm_head, MOE_DECODE_KERNELS[:4],
                                            cfg=cfg2, hidden_fn=decode_hidden_moe),
        "decode_step_fused": kernel_vs_plain_path(torch, dev, p2, BATCH, ATOM_W4A4, p2.lm_head, MOE_FUSED_KERNELS[:2],
                                                  fused=True, cfg=cfg2, hidden_fn=decode_hidden_moe),
        "prefill_256_dense": moe_prefill_kernel_vs_plain(torch, dev, p2, cfg2, 256, 200),
        "prefill_512_routed": moe_prefill_kernel_vs_plain(torch, dev, p2, cfg2, 512, 400),
    }
    res["model"] = ("Mixtral-8x7B (hidden 4096, 32 / 8 heads of 128, 8 experts of 14336, top-2), ATOM_W4A4, bf16 head; "
                    f"bursts at {MOE_BURST_LAYERS} layers, engine at {MOE_ENGINE_LAYERS}, parity at 2")
    del params, p2
    torch.cuda.empty_cache()
    return counts, res


# the LoRA phase: ``bench_textgen.py`` burst_throughput_lora's cell (rank 16, a store of 32 adapters, every
# sequence its own), the engine's depth and adapters, and the kernels LoRA decode must and must not launch
# (LoRA runs the unfused qkv path and the unfused post-attention half: no K2, K7-K10)
LORA_RANK, LORA_CAPACITY, LORA_ENGINE_LAYERS, LORA_ENGINE_ADAPTERS = 16, 32, 4, 8
LORA_BURST_LO, LORA_BURST_HI = 1, 2  # ring windows of the LoRA burst's slope (its steps run ~3x the W4A4 burst's kernels)
LORA_BURST_SAMPLES = 2  # cut from 3 with phase 10
LORA_DECODE_KERNELS = ("packed_w4_gemm", "paged_ring_decode_attention", "flush_hot", "w8a16_gemm", "embed_gather")
LORA_NEVER = ("packed_w4_gemm_qkv_ring_fused", "packed_w4_gemm_qkv", "packed_w4_gemm_qkv_ring", "packed_w4_gemm_fused_in",
              "fused_mlp_packed")


def require_not_launched(counts: dict, what: str) -> None:
    for name in LORA_NEVER:
        require(counts[name] == 0, f"{what} launched {name} {counts[name]} times")


def lora_store_cut(lw, adapters: int, layers: int):
    """The first ``adapters`` adapters' first ``layers`` layers of a store (views)."""
    from atom_tpu_torch.serving.lora import LlamaLora, LoraSite

    return LlamaLora(*(LoraSite(s.wa[:adapters, :layers], s.wb[:adapters, :layers]) for s in lw))


def lora_decode_path(torch, dev, qparams, lw, w4a4: dict) -> tuple[dict, dict]:
    """The LoRA burst at full width and all 32 layers (batch 32, context 512,
    the W8A16 head, every sequence its own adapter): launches over one
    flushing window checked (K1; K3 once a layer and step; K4, K5, K6; no K2,
    K7-K10), tok/s by the slope between ``LORA_BURST_LO`` and
    ``LORA_BURST_HI`` windows (median of positive samples), a few profiled
    steps (device time, kernels a step), the adapter
    path alone under the profiler against its byte floor (the store read once
    a step), peak memory; beside the W4A4 burst's figures ``w4a4``."""
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.serving.lora import add_lora, lora_decode_burst, lora_decode_step, lora_site_dims
    from atom_tpu_torch.serving.model import make_serving_state

    cfg = llama7b(32)
    n_pages = BATCH * MAX_PAGES + 1
    table = (1 + torch.arange(BATCH * MAX_PAGES, device=dev, dtype=torch.int32)).reshape(BATCH, MAX_PAGES)
    full = lambda v: torch.full((BATCH,), v, dtype=torch.int32, device=dev)  # noqa: E731
    state = make_serving_state(cfg.num_layers, n_pages, BATCH, cfg.num_kv_heads, PAGE, cfg.head_dim, device=dev)
    state = state._replace(flushed=full(CTX))
    ids = torch.ones((BATCH,), dtype=torch.int32, device=dev)
    adapters = torch.arange(BATCH, dtype=torch.int32, device=dev)  # every sequence its own adapter
    w = state.hot[0].window

    def burst(n):
        nonlocal ids, state
        # pinned context: every burst starts at lens = flushed = CTX and ring row 0
        state = state._replace(flushed=full(CTX), row=0)
        ids, state, lens = lora_decode_burst(qparams, lw, state, ids, table, full(CTX), n, adapters, cfg, ATOM_W4A4)
        return lens

    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    lens = burst(1)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"LoRA decode path: 1 window in {time.perf_counter() - t0:.1f} s, launches {counts}")
    for name in LORA_DECODE_KERNELS:
        require(counts[name] > 0, f"kernel {name} was not launched on the LoRA decode path")
    require_not_launched(counts, "the LoRA decode path")
    require(counts["paged_ring_decode_attention"] == w * cfg.num_layers, "LoRA decode: K3 not once per layer and step")
    require(counts["packed_w4_gemm_by_path"]["prefill"] == 0, "the LoRA burst ran the prefill GEMM")
    require(bool(((ids >= 0) & (ids < cfg.vocab_size)).all()) and bool((lens == CTX + w).all()),
            "LoRA decode: next ids out of range or lengths not advanced")

    def timed(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        burst(n)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    samples = []
    for _ in range(LORA_BURST_SAMPLES):
        t_lo, t_hi = timed(LORA_BURST_LO), timed(LORA_BURST_HI)
        samples.append((t_hi - t_lo) / ((LORA_BURST_HI - LORA_BURST_LO) * w))
        log(f"  LoRA step time sample: {samples[-1] * 1e3:.3f} ms")
    positive = [x for x in samples if x > 0]
    require(len(positive) > 0, "no positive LoRA step-time sample")
    step_ms = statistics.median(positive) * 1e3

    # a few profiled steps (a whole window's ~226,000 kernel events take the profiler minutes to sum)
    from torch.profiler import ProfilerActivity, profile

    state = state._replace(flushed=full(CTX), row=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(MOE_PROFILE_STEPS):
            ids, state = lora_decode_step(qparams, lw, state, ids, table, full(CTX + 1 + i), adapters, cfg, ATOM_W4A4,
                                          1.0)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / MOE_PROFILE_STEPS
    n_kernels = sum(e.count for e in kernels) / MOE_PROFILE_STEPS
    OUT.mkdir(exist_ok=True)
    (OUT / "profile_lora.txt").write_text(f"{MOE_PROFILE_STEPS} LoRA decode steps, 32 layers: device {dev_ms:.3f} ms, "
                                          f"{n_kernels:.0f} device kernels a step\n"
                                          f"{events.table(sort_by='self_device_time_total', row_limit=50)}\n")
    require(dev_ms > 0, "the profiler recorded no device time for the LoRA steps")
    k1_ms = sum(e.self_device_time_total for e in kernels if "gemm_core_kernel" in e.key) / 1e3 / MOE_PROFILE_STEPS
    k3_ms = sum(e.self_device_time_total for e in kernels if K3_KERNEL in e.key and ", true>" in e.key) / 1e3 / MOE_PROFILE_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the adapter path alone: one step's 7 deltas in each of the 32 layers, at the step's shapes
    gen = torch.Generator(device=dev).manual_seed(12)
    dims = lora_site_dims(cfg)
    xs = {d: torch.randn((BATCH, d), generator=gen, device=dev) for d in {d_in for d_in, _ in dims.values()}}
    store_bytes = sum(t.numel() * t.element_size() for s in lw for t in s)
    step_bytes = store_bytes * BATCH / lw.q.wa.shape[0]  # every sequence reads its own adapter's rows

    def adapter_step():
        out = None
        for layer in range(cfg.num_layers):
            for name, (d_in, _) in dims.items():
                out = add_lora(xs[d_in], getattr(lw, name), adapters, layer, 1.0)
        out.sum().item()

    adapter = profile_once(torch, adapter_step, "profile_lora_adapters.txt",
                           f"one step's adapter deltas (7 sites x 32 layers, batch {BATCH}, rank {LORA_RANK})")
    floor_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    res = dict(
        decode_tok_s=BATCH * 1e3 / step_ms, step_ms=step_ms, step_ms_samples=[x * 1e3 for x in samples],
        protocol=f"slope between {LORA_BURST_LO} and {LORA_BURST_HI} ring windows, 3 samples, median of positive ones",
        device_ms_per_step_profiled=dev_ms, device_kernels_per_step=n_kernels, device_busy_share=dev_ms / step_ms,
        profiled_steps=MOE_PROFILE_STEPS, k1_core_ms_per_step=k1_ms, k3_ms_per_step=k3_ms,
        adapter_path=dict(device_ms_per_step=adapter["device_ms"], kernels_per_step=adapter["device_kernels"],
                          wall_ms=adapter["wall_ms"], bytes_per_step=step_bytes, floor_ms=floor_ms,
                          floor_share=floor_ms / adapter["device_ms"]),
        store_gb=store_bytes / 1e9, peak_memory_gb=peak_gb, rank=LORA_RANK, capacity=lw.q.wa.shape[0],
        w4a4_burst=dict((k, w4a4.get(k)) for k in ("decode_tok_s", "step_ms", "device_ms_per_step_profiled",
                                                    "device_kernels_per_step", "device_busy_share", "peak_memory_gb")),
    )
    log(f"LoRA burst: {res['decode_tok_s']:.1f} tok/s, step {step_ms:.3f} ms, device {res['device_ms_per_step_profiled']:.3f} "
        f"ms ({res['device_kernels_per_step']:.0f} kernels) a step, busy {res['device_busy_share']:.3f}; adapter path "
        f"{adapter['device_ms']:.3f} ms a step against a {floor_ms:.3f} ms floor; peak {peak_gb:.2f} GB")
    return counts, res


def lora_hidden_fn(torch, dev, lw):
    """``kernel_vs_plain_path``'s ``hidden_fn`` for LoRA decode over the
    store ``lw``, every sequence its own adapter."""
    from atom_tpu_torch.serving.lora import lora_decode_hidden

    adapters = torch.arange(BATCH, dtype=torch.int32, device=dev)

    def hidden_fn(params, st, ids, table, lens, cfg, spec, flush=False):
        return lora_decode_hidden(params, lw, st, ids, table, lens, adapters, cfg, spec, 1.0, flush=flush)

    return hidden_fn


def lora_decode_kernel_vs_plain(torch, dev, params, lw, cfg) -> dict:
    """The 2-layer LoRA decode step over the burst's adapters (rank 16, unit
    gain: each delta is as large as its projection's output), kernel path
    against plain path.  Every operation before layer 0's attention is
    bitwise with its plain version (K6, K1, the same torch calls), so layer
    0's ring and pages must be equal bit for bit.  K3 is not bitwise (within
    ``ATTN_TOL``), and LoRA's float32 residual carries its roundings on
    unrounded (the base path rounds every residual add to bf16), the o delta
    straight from the attention output, so later quantizers flip codes that
    the base path's do not: the hidden's spread is reported (it passes the
    gates' 25%-moved bound on the zero-delta store, ``decode_step_zero_delta``,
    and not on these adapters) and held finite and under the gates' max of
    1.5."""
    from atom_tpu_torch.config import ATOM_W4A4

    counts, (xk, nk, sk), (xp, np_, sp) = kernel_and_plain_step(torch, dev, params, BATCH, ATOM_W4A4, params.lm_head,
                                                                LORA_DECODE_KERNELS, cfg=cfg,
                                                                hidden_fn=lora_hidden_fn(torch, dev, lw))
    diff = (xk - xp).abs()
    moved, dmax = (diff > 0.05).float().mean().item(), diff.max().item()
    agree = (nk == np_).float().mean().item()
    layer0 = all(torch.equal(bits(a), bits(b)) for a, b in zip((*sk.pages[0], *sk.hot[0]), (*sp.pages[0], *sp.hot[0])))
    per_layer = [dict(pages=entries_differing(sk.pages[i:i + 1], sp.pages[i:i + 1]),
                      ring=entries_differing(sk.hot[i:i + 1], sp.hot[i:i + 1])) for i in range(cfg.num_layers)]
    log(f"LoRA decode step (2 layers, batch {BATCH}, unit-gain adapters), kernel vs plain path: {moved:.4%} of hidden "
        f"moved > 0.05, max {dmax:.4f}, next-id agreement {agree:.3f}, layer 0 bitwise {layer0}, entries differing "
        f"by layer {per_layer}")
    require(bool(torch.isfinite(xk).all()), "LoRA decode: hidden states not finite")
    require(layer0, "LoRA decode: layer 0's ring or pages differ between the kernel and the plain path")
    require(dmax < 1.5, f"LoRA decode: kernel path diverges from plain path: max {dmax}")
    return dict(moved_gt_0p05=moved, max_abs=dmax, next_id_agreement=agree, layer0_bitwise=layer0,
                entries_differing_by_layer=per_layer, launches={k: v for k, v in counts.items() if v})


def lora_prefill_kernel_vs_plain(torch, dev, params, lw, cfg, bucket: int = 512, true_len: int = 400) -> dict:
    """A 2-layer ``lora_prefill_hidden`` at ``bucket`` rows, one adapter,
    kernel path against plain path: K1 (the prefill GEMM) and K6 are bitwise
    with their plain versions and every other operation is the same PyTorch
    call on both paths, so the pages and the token should be equal; held to
    layer 0's pages bitwise and the decode gates' bound, the rest reported."""
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.serving.lora import lora_prefill_hidden
    from atom_tpu_torch.serving.model import _lm_head_logits, make_serving_state

    gen = torch.Generator(device=dev).manual_seed(10)
    ids = torch.randint(1, cfg.vocab_size, (bucket,), generator=gen, device=dev, dtype=torch.int32)
    ids[true_len:] = 0
    table_row = torch.zeros((4,), dtype=torch.int32, device=dev)
    table_row[: bucket // PAGE] = torch.arange(bucket // PAGE, 0, -1, dtype=torch.int32, device=dev)

    def run():
        state = make_serving_state(cfg.num_layers, 4, 2, cfg.num_kv_heads, PAGE, cfg.head_dim, device=dev)
        x, pages = lora_prefill_hidden(params, lw, state.pages, ids, table_row, 3, cfg, ATOM_W4A4, 1.0)
        tok = int(torch.argmax(_lm_head_logits(x[true_len - 1][None], params.lm_head, cfg.vocab_size)[0]))
        return x[:true_len].float(), pages, tok

    zero_counts()
    xk, pk, tk = run()
    counts = read_counts()
    require(counts["packed_w4_gemm_by_path"]["prefill"] == 4 * cfg.num_layers, f"LoRA prefill: launches {counts}")
    require_not_launched(counts, "the LoRA prefill")
    with plain_path():
        xp, pp, tp = run()
    require(read_counts() == counts, "the plain path launched a kernel")
    require(all(torch.equal(bits(a), bits(b)) for a, b in zip(pk[0], pp[0])), "LoRA prefill: layer 0's pages differ")
    diff = (xk - xp).abs()
    moved, dmax = (diff > 0.05).float().mean().item(), diff.max().item()
    pages_equal = all(torch.equal(bits(a), bits(b)) for la, lb in zip(pk, pp) for a, b in zip(la, lb))
    log(f"LoRA prefill at {bucket} rows ({true_len} true), kernel vs plain path: {moved:.4%} of hidden moved > 0.05, max "
        f"{dmax:.4f}, pages bitwise {pages_equal}, hidden bitwise {torch.equal(xk, xp)}, token {tk} / {tp}")
    require(bool(torch.isfinite(xk).all()), "LoRA prefill: hidden states not finite")
    require(moved < 0.25 and dmax < 1.5, f"LoRA prefill: kernel path diverges: {moved:.2%} moved, max {dmax}")
    return dict(moved_gt_0p05=moved, max_abs=dmax, hidden_bitwise_equal=bool(torch.equal(xk, xp)),
                pages_bitwise_equal=pages_equal, page_entries_differing=entries_differing(pk, pp), token_equal=tk == tp,
                launches={k: v for k, v in counts.items() if v})


def lora_engine_path(torch, dev, qparams, lw) -> tuple[dict, dict]:
    """``TextGenEngine(lora=True)`` over ``make_lora_step_fns`` at
    ``LORA_ENGINE_LAYERS`` layers in the engine cell's configuration
    (``engine_setup``), request r under adapter r mod ``LORA_ENGINE_ADAPTERS``:
    launch counts, every request's tokens, the pool."""
    import numpy as np

    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.serving import TextGenEngine, make_lora_step_fns
    from atom_tpu_torch.serving.model import make_serving_state

    cfg = llama7b(LORA_ENGINE_LAYERS)
    params = qparams._replace(layers=qparams.layers[:LORA_ENGINE_LAYERS])
    lw8 = lora_store_cut(lw, LORA_ENGINE_ADAPTERS, LORA_ENGINE_LAYERS)
    tg, pool, n_pages, rs = engine_setup(torch, dev, cfg)
    rs.adapter_ids = (np.arange(len(rs)) % LORA_ENGINE_ADAPTERS).astype(np.int32)
    state = make_serving_state(cfg.num_layers, n_pages, tg.batch_size, cfg.num_kv_heads, tg.page_size, cfg.head_dim,
                               device=dev)
    engine = TextGenEngine(tg, pool, *make_lora_step_fns(params, lw8, cfg, ATOM_W4A4), state, lora=True)
    counts, res = drive_engine(torch, engine, pool, n_pages, rs, cfg, "LoRA engine", LORA_DECODE_KERNELS)
    require_not_launched(counts, "the LoRA engine")
    require(counts["packed_w4_gemm_by_path"]["prefill"] > 0, "the LoRA engine's prefills did not run the prefill GEMM")
    check_recorded(engine, pool, n_pages, cfg, "LoRA engine")
    res.update(layers=cfg.num_layers, adapters=LORA_ENGINE_ADAPTERS, rank=LORA_RANK, head="w8a16")
    return counts, res


def native_scheduler_path(torch, dev, qparams) -> dict:
    """The engine cell at 2 layers with ``native=True`` and ``native=False``:
    a recorded run of each (the same tokens, the same prefill rows, page
    tables and lengths at every step, every page back), then an unrecorded
    run of each for the host scheduling ms a step."""
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.serving import KvPool, TextGenEngine, make_step_fns
    from atom_tpu_torch.serving.model import make_serving_state

    cfg = llama7b(2)
    params = qparams._replace(layers=qparams.layers[:2])
    tg, _, n_pages, rs = engine_setup(torch, dev, cfg)

    def engine(native):
        pool = KvPool(cfg.num_layers, n_pages, cfg.num_kv_heads, tg.page_size, cfg.head_dim)
        state = make_serving_state(cfg.num_layers, n_pages, tg.batch_size, cfg.num_kv_heads, tg.page_size,
                                   cfg.head_dim, device=dev)
        return TextGenEngine(tg, pool, *make_step_fns(params, cfg, ATOM_W4A4), state, native=native), pool

    def free_pages(eng, pool):
        return eng.nat.num_free_pages if eng.nat is not None else pool.num_free_pages

    runs, res = {}, {}
    for native in (False, True):
        eng, pool = engine(native)
        log_ = []
        pre, dec = eng.prefill_fn, eng.decode_fn
        eng.prefill_fn = lambda st, ids, row, *a: (log_.append(row.cpu()), pre(st, ids, row, *a))[1]
        eng.decode_fn = lambda st, ids, tbl, lens: (log_.append(torch.cat([tbl.cpu(), lens.cpu()[:, None]], 1)),
                                                    dec(st, ids, tbl, lens))[1]
        rec = eng.run(rs, record=True)
        require(free_pages(eng, pool) == n_pages - 1, f"native={native}: pages not returned")
        eng2, pool2 = engine(native)
        timed = eng2.run(rs)
        require(free_pages(eng2, pool2) == n_pages - 1, f"native={native}: pages not returned (timed run)")
        require(timed["scheduler"] == ("native" if native else "python"), f"native={native}: scheduler {timed['scheduler']}")
        runs[native] = (rec["tokens"], log_)
        res["native" if native else "python"] = {k: timed[k] for k in (
            "host_sched_ms_per_step", "decode_steps", "elapsed_s", "throughput_tok_s", "decode_ms_per_token_avg")}
    tokens_equal = runs[True][0] == runs[False][0]
    tables_equal = len(runs[True][1]) == len(runs[False][1]) and all(
        torch.equal(a, b) for a, b in zip(runs[True][1], runs[False][1]))
    log(f"native scheduler vs Python pool (2 layers, engine cell): tokens equal {tokens_equal}, tables equal "
        f"{tables_equal} over {len(runs[True][1])} steps; host scheduling ms a step: python "
        f"{res['python']['host_sched_ms_per_step']:.4f}, native {res['native']['host_sched_ms_per_step']:.4f}")
    require(tokens_equal and tables_equal, "the native scheduler's tokens or page tables differ from the Python pool's")
    return dict(res, tokens_equal=tokens_equal, tables_equal=tables_equal, steps_compared=len(runs[True][1]), layers=2)


def lora_phase(torch, dev, qparams, w4a4: dict) -> tuple[dict, dict]:
    """Phase 9 (after phase 4, on its 32-layer W4A4 params with the W8A16
    head): LoRA at rank 16 with a store of 32 adapters, the burst at all 32
    layers, the engine at ``LORA_ENGINE_LAYERS``, the kernel path against the
    plain path at 2 layers (a flushing decode step, a 512-row prefill); then
    the native scheduler against the Python pool."""
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.serving.lora import init_llama_lora

    cfg = llama7b(32)
    t0 = time.perf_counter()
    lw = init_llama_lora(cfg, LORA_CAPACITY, LORA_RANK, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"LoRA store ({sum(t.numel() * t.element_size() for s in lw for t in s) / 1e9:.3f} GB) in "
        f"{time.perf_counter() - t0:.1f} s")
    counts, res = {}, {}
    counts["lora_decode_burst"], res["decode"] = lora_decode_path(torch, dev, qparams, lw, w4a4)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    counts["lora_engine"], res["engine"] = lora_engine_path(torch, dev, qparams, lw)
    torch.cuda.empty_cache()
    log(f"LoRA engine in {time.perf_counter() - t1:.1f} s")
    cfg2 = llama7b(2)
    p2 = qparams._replace(layers=qparams.layers[:2])
    lw2 = lora_store_cut(lw, LORA_CAPACITY, 2)
    lw0 = init_llama_lora(cfg2, LORA_CAPACITY, LORA_RANK, seed=0, device=dev, zero_b=True)
    res["path_parity_2_layers"] = dict(
        decode_step_zero_delta=kernel_vs_plain_path(torch, dev, p2, BATCH, ATOM_W4A4, p2.lm_head, LORA_DECODE_KERNELS,
                                                    cfg=cfg2, hidden_fn=lora_hidden_fn(torch, dev, lw0)),
        decode_step=lora_decode_kernel_vs_plain(torch, dev, p2, lw2, cfg2),
        prefill_512=lora_prefill_kernel_vs_plain(torch, dev, p2, lw2, cfg2))
    for name, r in res["path_parity_2_layers"].items():
        require_not_launched(dict.fromkeys(LORA_NEVER, 0) | r["launches"], f"the 2-layer LoRA {name}")
    del lw, lw2
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    res["native_scheduler"] = native_scheduler_path(torch, dev, qparams)
    log(f"native scheduler in {time.perf_counter() - t1:.1f} s")
    res["config"] = (f"Llama-2-7B width, ATOM_W4A4, W8A16 head, rank {LORA_RANK}, {LORA_CAPACITY} adapters; burst at 32 "
                     f"layers with adapters = arange({BATCH}); engine at {LORA_ENGINE_LAYERS} layers, "
                     f"{LORA_ENGINE_ADAPTERS} adapters; parity and the native scheduler at 2 layers")
    return counts, res


# the accuracy pipeline's phases (10: Llama-2-7B; 11: Mixtral-8x7B and OPT-6.7B, then the fixture trainer): each
# model at full width cut with main.py's --layers (GPTQ's column loop is sequential), ATOM_W4A4 with --reorder
# --use_gptq, 8 calibration windows of 512 tokens of the corpus, perplexity on the first 16 windows of its eval split,
# parity at 2 layers.  Phase 10 ran 8 layers and its engine 16 requests until phase 11 took their time.
CALIB_SAMPLES, CALIB_SEQLEN, CALIB_PPL_WINDOWS, CALIB_PARITY_T = 8, 512, 16, 256
# main.py's model name -> (layers, the engine's counts key and requests, or None where the model is not served)
CALIB_MODELS = {"llama2-7b": (4, ("calibrated_engine", 8)), "mixtral-8x7b": (2, ("calibrated_moe_engine", 16)),
                "opt-6.7b": (2, None)}


def logit_figures(got, want) -> dict:
    """``tests/test_calibrated_serving.py``'s figures of two [T, V] logit
    arrays: correlation, mean |delta| over mean |logit|, argmax agreement."""
    import numpy as np

    return dict(corr=float(np.corrcoef(got.ravel(), want.ravel())[0, 1]),
                mean_abs_delta_over_mean_abs_logit=float(np.abs(got - want).mean() / np.abs(want).mean()),
                argmax_agreement=float(np.mean(got.argmax(-1) == want.argmax(-1))))


def served_vs_accuracy(torch, dev, sp, calib, cfg, spec, ids) -> dict:
    """The served model's kernel prefill (``prefill_hidden``, or
    ``prefill_hidden_moe`` for Mixtral, + the bf16 head) against the accuracy
    pipeline's ``forward`` on the card, on one window (``logit_figures``),
    beside the floor that W4A4's rounding sets on these weights: the same
    figures of the accuracy forward against itself with activations and KV
    unquantized (``FP16_BASELINE``; the weights stay quantized).  Served and
    accuracy paths round activations and KV at other points (K after RoPE in
    the cache, before it in the accuracy model), so they can stand no closer
    than that."""
    import numpy as np

    from atom_tpu_torch.calib.pipeline import _model_api
    from atom_tpu_torch.config import FP16_BASELINE
    from atom_tpu_torch.models.configs import Arch
    from atom_tpu_torch.serving.model import _lm_head_logits, make_serving_state, prefill_hidden
    from atom_tpu_torch.serving.moe import prefill_hidden_moe

    m = _model_api(cfg)
    t = ids.shape[0]
    state = make_serving_state(cfg.num_layers, 1 + t // PAGE, 1, cfg.num_kv_heads, PAGE, cfg.head_dim, device=dev)
    table_row = torch.zeros((MAX_PAGES,), dtype=torch.int32, device=dev)
    table_row[: t // PAGE] = torch.arange(1, 1 + t // PAGE, dtype=torch.int32, device=dev)
    prefill = prefill_hidden_moe if cfg.arch == Arch.MIXTRAL else prefill_hidden
    x, _ = prefill(sp, state.pages, ids, table_row, cfg, spec)
    got = _lm_head_logits(x, sp.lm_head, cfg.vocab_size).float().cpu().numpy()
    want = m.forward(calib, ids[None], cfg, spec)[0].float().cpu().numpy()
    unquantized = m.forward(calib, ids[None], cfg, FP16_BASELINE)[0].float().cpu().numpy()
    require(got.shape == want.shape == (t, cfg.vocab_size) and all(np.isfinite(a).all() for a in (got, want, unquantized)),
            f"served / accuracy logits: shapes {got.shape} / {want.shape} or not finite")
    return dict(logit_figures(got, want), layers=cfg.num_layers, tokens=t,
                floor_w4a4_vs_unquantized_activations=logit_figures(want, unquantized))


def gptq_graph_vs_eager(torch, dev, spec) -> dict:
    """GPTQ of one 7B-width [4096, 4096] weight on a random Hessian with its
    column loop replayed from the CUDA graph (as calibration runs it) and
    eagerly: outputs and scales bitwise, and the two times."""
    import atom_tpu_torch.calib.gptq as gq

    gen = torch.Generator(device=dev).manual_seed(5)
    w = torch.randn((HID, HID), generator=gen, device=dev) * 0.02
    x = torch.randn((512, HID), generator=gen, device=dev)
    h = 2.0 * (x.T @ x) / 512
    out = {}
    for name in ("graphed", "eager"):
        saved = gq._column_loop_graphed
        if name == "eager":
            gq._column_loop_graphed = lambda w1, h1, s, b, cg: gq._column_loop(w1, h1, s, b, cg, gq.QuantType.INT)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name] = gq.gptq_quantize_weight_spec(w, h, spec, return_scales=True)
            torch.cuda.synchronize()
            out[name + "_s"] = time.perf_counter() - t0
        finally:
            gq._column_loop_graphed = saved
    same = all(torch.equal(a, b) for a, b in zip(out["graphed"], out["eager"]))
    log(f"GPTQ of a [{HID}, {HID}] weight: graphed {out['graphed_s']:.2f} s, eager {out['eager_s']:.2f} s, bitwise {same}")
    require(same, "GPTQ's graphed column loop differs from the eager one")
    return dict(graphed_s=out["graphed_s"], eager_s=out["eager_s"], bitwise=same)


def calibrated_phase(torch, dev, model: str) -> tuple[dict, dict]:
    """Phases 10 and 11: the accuracy pipeline's path through ``main.py``'s
    own parser, spec and data loader for ``model`` (a name of
    ``CALIB_MODELS``): calibrate at full width and the model's depth (random
    bf16 weights from a seed; saliency, reorder, GPTQ), the perplexity line;
    then for a served model the export (``pack_calibrated_params`` or
    ``pack_calibrated_params_moe``, ``save_serving``) and its load back onto
    the card (bitwise), the engine over the loaded params with the bf16 head,
    and at 2 layers the served logits against the accuracy forward and the
    kernel path against the plain path."""
    import tempfile

    import numpy as np

    import atom_tpu_torch.serving.moe as moe_mod
    from atom_tpu_torch import main as cli
    from atom_tpu_torch.calib.pipeline import (_model_api, collect_saliency, compute_reorder_indices,
                                               quantize_model_gptq, reorder_model)
    from atom_tpu_torch.models import configs
    from atom_tpu_torch.models.configs import Arch
    from atom_tpu_torch.models.hf_loader import pack_calibrated_params, pack_calibrated_params_moe
    from atom_tpu_torch.serving import TextGenEngine, make_moe_step_fns, make_step_fns, synth_requests
    from atom_tpu_torch.serving.model import make_serving_state
    from atom_tpu_torch.utils.checkpoint import load_serving, save_serving
    from atom_tpu_torch.utils.eval import perplexity

    layers, served = CALIB_MODELS[model]
    args = cli.build_parser().parse_args(
        [model, "corpus", "--layers", str(layers), "--reorder", "--use_gptq", "--calib_samples", str(CALIB_SAMPLES),
         "--seqlen", str(CALIB_SEQLEN), "--corpus_dir", str(ROOT / "data" / "corpus"), "--eval_ppl"])
    cfg = getattr(configs, cli.MODEL_PRESETS[model]).replace(num_layers=args.layers)
    spec = cli.make_spec(args)
    m = _model_api(cfg)
    moe = cfg.arch == Arch.MIXTRAL
    require(spec.keeper == 128 and spec.keeper_precision == 3 and spec.use_gptq and spec.reorder,
            f"the accuracy phase runs ATOM_W4A4's scheme with --reorder --use_gptq, got {spec}")
    res = dict(model=f"{model} width ({cfg.hidden_size}, MLP {cfg.intermediate_size}"
                     + (f", {cfg.num_experts} experts" if moe else "") + f"), {cfg.num_layers} layers, random bf16 "
                     f"weights (seed {args.seed})",
               spec="ATOM_W4A4 scheme, --reorder --use_gptq, keeper 128 INT8",
               calibration=f"{args.calib_samples} windows of {args.seqlen} tokens of data/corpus/train.txt")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = m.init_params(cfg, seed=args.seed, dtype=torch.bfloat16, device=dev)
    batches, tests, seqlen = cli.load_data(args, cfg)
    batches = [torch.from_numpy(b).to(dev) for b in batches]
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    indices = compute_reorder_indices(collect_saliency(params, cfg, batches, spec.act_sort_metric), cfg.head_dim)
    params = reorder_model(params, cfg, indices)
    torch.cuda.synchronize()
    res["saliency_reorder_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scales = {}
    calib = quantize_model_gptq(params, cfg, spec, batches, scales_out=scales)
    torch.cuda.synchronize()
    res["gptq_s"] = time.perf_counter() - t0
    res["gptq_s_per_layer"] = res["gptq_s"] / cfg.num_layers
    res["calibration_s"] = res["saliency_reorder_s"] + res["gptq_s"]
    del params
    log(f"{model} calibration ({cfg.num_layers} layers): saliency + reorder {res['saliency_reorder_s']:.1f} s, GPTQ "
        f"{res['gptq_s']:.1f} s ({res['gptq_s_per_layer']:.2f} s a layer)")
    gptq_apply_names = set()  # the names gptq_apply quantizes, from a dry run on the meta device
    m.gptq_apply({k: v[0].to("meta") for k, v in calib["layers"].items()}, dict.fromkeys(m.hessian_tap_specs(cfg)),
                 lambda w, h, name: gptq_apply_names.add(name) or w.T)
    require(set(scales) == {f"{i}.{n}" for i in range(cfg.num_layers) for n in gptq_apply_names},
            f"{model}: GPTQ did not export every weight's scales")
    if model == "llama2-7b":
        res["gptq_graph_vs_eager"] = gptq_graph_vs_eager(torch, dev, spec)

    stream = np.asarray(tests["corpus"])[: CALIB_PPL_WINDOWS * seqlen]
    t0 = time.perf_counter()
    ppl = perplexity(calib, cfg, spec, stream, seqlen=seqlen)
    res["ppl_s"] = time.perf_counter() - t0
    res.update(ppl=ppl, ppl_windows=CALIB_PPL_WINDOWS, ppl_tokens=int(stream.size))
    require(math.isfinite(ppl) and ppl > 1, f"{model}: perplexity {ppl}")
    print(f"targetResult,corpus,{ppl:.6f}", flush=True)
    log(f"{model} perplexity {ppl:.3f} over {CALIB_PPL_WINDOWS} windows of {seqlen} tokens in {res['ppl_s']:.2f} s "
        f"(random weights: a path check), {card_line()}")
    res["peak_memory_gb_calibration"] = torch.cuda.max_memory_allocated() / 1e9
    if served is None:  # not served (OPT): the accuracy path only
        del calib
        torch.cuda.empty_cache()
        return {}, res

    t0 = time.perf_counter()
    sp = (pack_calibrated_params_moe if moe else pack_calibrated_params)(calib, cfg, spec, gptq_scales=scales)
    torch.cuda.synchronize()
    res["pack_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        save_serving(tmp, sp, cfg, spec)
        res["save_s"] = time.perf_counter() - t0
        res["export_mb"] = sum(f.stat().st_size for f in Path(tmp).iterdir()) / 1e6
        t0 = time.perf_counter()
        loaded, cfg_l, spec_l = load_serving(tmp, device=dev)
        torch.cuda.synchronize()
        res["load_s"] = time.perf_counter() - t0
    exported, back = list(_leaves(sp)), list(_leaves(loaded))
    same = cfg_l == cfg and spec_l == spec and type(loaded) is type(sp) and len(exported) == len(back) and all(
        a.dtype == b.dtype and a.shape == b.shape and b.device == a.device and torch.equal(bits(a), bits(b))
        for a, b in zip(exported, back))
    log(f"{model} export ({res['export_mb']:.1f} MB): pack {res['pack_s']:.2f} s, save {res['save_s']:.2f} s, load "
        f"{res['load_s']:.2f} s; loaded params equal the exported ones bit for bit: {same}")
    require(same, f"{model}: the loaded serving params differ from the exported ones")
    res["export_load_bitwise"] = same
    del sp

    counts_key, n_requests = served
    tg, pool, n_pages, _ = engine_setup(torch, dev, cfg)
    rs = synth_requests(n_requests, cfg.vocab_size, maxlen=XS_MAXLEN)
    state = make_serving_state(cfg.num_layers, n_pages, tg.batch_size, cfg.num_kv_heads, tg.page_size, cfg.head_dim,
                               device=dev)
    engine = TextGenEngine(tg, pool, *(make_moe_step_fns if moe else make_step_fns)(loaded, cfg_l, spec_l), state)
    with count_calls(moe_mod, "_moe_mlp_routed") as routed:
        counts, res["engine"] = drive_engine(torch, engine, pool, n_pages, rs, cfg, f"{model} calibrated engine",
                                             MOE_ENGINE_KERNELS if moe else ENGINE_KERNELS)
    if moe:  # the 512 bucket's prompts take the routed experts in every layer, the others the dense ones
        n_512 = sum(1 for b, _ in engine.last_prefill_s if b >= moe_mod.MOE_ROUTED_THRESHOLD)
        require(n_512 > 0 and len(routed) == n_512 * cfg.num_layers,
                f"{model}: {len(routed)} routed expert blocks for {n_512} prompts of the 512 bucket")
        res["engine"]["routed_prefills"] = n_512
    by_path = counts["packed_w4_gemm_by_path"]
    require(all(v > 0 for v in by_path.values()), f"{model}: the calibrated engine's K1 launches by path {by_path}")
    res["engine"].update(layers=cfg.num_layers, head="bf16",
                         config=f"batch 32, page 256, buckets (128, 256, 512), synth_requests({n_requests}, "
                                f"{cfg.vocab_size}, maxlen={XS_MAXLEN})")
    del engine, state
    torch.cuda.empty_cache()

    ids = torch.from_numpy(np.ascontiguousarray(stream[:CALIB_PARITY_T])).to(dev)
    cfg2 = cfg.replace(num_layers=2)
    p2 = loaded._replace(layers=loaded.layers[:2])
    calib2 = {**calib, "layers": {k: v[:2] for k, v in calib["layers"].items()}}
    sva = served_vs_accuracy(torch, dev, p2, calib2, cfg2, spec, ids)
    log(f"{model} served vs accuracy logits at 2 layers: {sva}")
    # a wiring fault (a reorder, a scale layout, RoPE's place, a routing) takes the correlation to ~0 and the argmax
    # agreement to ~1/vocab; on random full-width weights W4A4's rounding alone sets the floor (Llama-2-7B: corr ~0.88
    # at 2 layers, CPU), so the served logits must stand within it, not at test_calibrated_serving.py's absolute bounds
    # (its tiny model's residual is its embeddings, which quantization leaves alone)
    floor = sva["floor_w4a4_vs_unquantized_activations"]
    require(sva["corr"] > floor["corr"] - 0.05
            and sva["mean_abs_delta_over_mean_abs_logit"] < floor["mean_abs_delta_over_mean_abs_logit"] + 0.05
            and sva["argmax_agreement"] >= 0.5 * floor["argmax_agreement"],
            f"{model}: 2-layer served logits off the accuracy pipeline's by more than W4A4's own floor: {sva}")
    step = (kernel_vs_plain_path(torch, dev, p2, BATCH, spec_l, p2.lm_head, MOE_DECODE_KERNELS[:4], cfg=cfg2,
                                 hidden_fn=moe_mod.decode_hidden_moe) if moe else
            kernel_vs_plain_path(torch, dev, p2, BATCH, spec_l, p2.lm_head, ("packed_w4_gemm_qkv_ring_fused",)))
    res["path_parity_2_layers"] = dict(served_vs_accuracy=sva, decode_step=step)
    res["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del loaded, p2, calib, calib2
    torch.cuda.empty_cache()
    return {counts_key: counts}, res


# the fixture trainer's cell: BYTE_LM at full width with scripts/train_corpus_model.py's batch and seqlen, a short run
# whose warmup ends early enough for the cosine part to run, the chunk losses logged, eval over a few windows
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_CHUNK, TRAIN_BATCH, TRAIN_SEQLEN, TRAIN_EVAL_WINDOWS = 24, 8, 8, 8, 2048, 8


def training_phase(torch, dev) -> dict:
    """Phase 11, last: ``utils/train.py``'s ``train`` on ``BYTE_LM`` (float32,
    random weights from a seed) over ``data/corpus/train.txt``; the loss must
    fall below its first chunk's; steps/s and tokens/s; ``eval_loss`` over a
    few windows of eval.txt; the checkpoint written as
    ``scripts/torch_train_corpus_model.py`` writes it and read back through
    ``main.py``'s ``--ckpt`` path (its perplexity line, unquantized)."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from atom_tpu_torch import main as cli
    from atom_tpu_torch.models import llama
    from atom_tpu_torch.models.configs import BYTE_LM
    from atom_tpu_torch.utils import bytetok
    from atom_tpu_torch.utils.checkpoint import save_pytree
    from atom_tpu_torch.utils.train import eval_loss, train

    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_train_corpus_model import bf16_rounded

    corpus = ROOT / "data" / "corpus"
    tokens = bytetok.encode_file(str(corpus / "train.txt"))
    eval_tokens = bytetok.encode_file(str(corpus / "eval.txt"))
    torch.cuda.reset_peak_memory_stats()
    params = llama.init_params(BYTE_LM, seed=0, dtype=torch.float32, device=dev)
    losses = []

    def record(line):
        losses.append(float(line.split("loss ")[1].split()[0]))
        log(line.strip())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, final = train(params, BYTE_LM, tokens, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seqlen=TRAIN_SEQLEN,
                          warmup=TRAIN_WARMUP, chunk=TRAIN_CHUNK, seed=0, log=record)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    res = dict(model="BYTE_LM (hidden 768, 12 layers, 6 heads of 128, vocabulary 256), float32, random weights (seed 0)",
               steps=TRAIN_STEPS, warmup=TRAIN_WARMUP, batch=TRAIN_BATCH, seqlen=TRAIN_SEQLEN, lr=3e-4,
               chunk_losses=losses, train_s=train_s, steps_per_s=TRAIN_STEPS / train_s,
               tokens_per_s=TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQLEN / train_s,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    require(len(losses) == TRAIN_STEPS // TRAIN_CHUNK and all(math.isfinite(x) for x in losses),
            f"training: chunk losses {losses}")
    require(losses[-1] < losses[0], f"training: the loss did not fall below its first chunk's: {losses}")
    t0 = time.perf_counter()
    res["eval_loss"] = eval_loss(params, BYTE_LM, eval_tokens, TRAIN_SEQLEN, batch=TRAIN_BATCH,
                                 max_windows=TRAIN_EVAL_WINDOWS)
    res["eval_s"] = time.perf_counter() - t0
    require(math.isfinite(res["eval_loss"]) and res["eval_loss"] < losses[0],
            f"training: eval loss {res['eval_loss']} against the first chunk's {losses[0]}")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "byte_lm_ckpt.npz")
        save_pytree(ckpt, bf16_rounded(params))
        del params
        torch.cuda.empty_cache()
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli.main(["byte-lm", "corpus", "--ckpt", ckpt, "--wbits", "16", "--abits", "16", "--eval_ppl",
                      "--seqlen", str(TRAIN_SEQLEN), "--calib_samples", "1", "--corpus_dir", str(corpus)])
        res["ckpt_eval_s"] = time.perf_counter() - t0
    line = [x for x in out.getvalue().splitlines() if x.startswith("targetResult,corpus,")]
    require(len(line) == 1, f"training: main.py --ckpt printed {out.getvalue()!r}")
    res["ckpt_ppl"] = float(line[0].split(",")[2])
    # the trained weights, rounded to bf16, read back by main.py: a byte perplexity well below the untrained model's
    require(res["ckpt_ppl"] < math.exp(losses[0]), f"training: the checkpoint's perplexity {res['ckpt_ppl']} is not "
            f"below exp(first chunk loss) {math.exp(losses[0]):.1f}")
    log(f"training: {TRAIN_STEPS} steps in {train_s:.1f} s ({res['steps_per_s']:.2f} steps/s, {res['tokens_per_s']:.0f} "
        f"tok/s), chunk losses {losses}, eval loss {res['eval_loss']:.4f}, the checkpoint through main.py --ckpt: "
        f"perplexity {res['ckpt_ppl']:.3f}, peak {res['peak_memory_gb']:.2f} GB, {card_line()}")
    return res


# ---------------------------------------------------------------------------
# Phase 12: parallelism on one card
# ---------------------------------------------------------------------------
# 4 ranks on cuda:0 over gloo (NCCL refuses two ranks on one device), spawned once by ``parallel.launch.run_ranks``;
# every sub-check runs over subgroups of them (a (2, 2) mesh: each dp row repeats tp 2, ep 2 and sp 2, and sp x tp
# takes all four).  Ranks sharing one card measure no rate (scripts/torch_parallel_nccl.py runs NCCL on four cards).
PAR_RANKS, PAR_TIMEOUT_S = 4, 600
PAR_SEEDS = dict(llama=12, mixtral=13, ids=14, requests=15)
PAR_TP_KERNELS = ("packed_w4_gemm", "packed_w4_gemm_qkv_ring_fused", "paged_ring_decode_attention", "flush_hot",
                  "embed_gather", "packed_w4_gemm_qkv")
# the TP engine and the SP prefills run their attention through K12 on both sides: it works a (query tile, head)
# a block, so a head's rows do not depend on how many heads or rows a rank holds, where cuBLAS's batched products
# of the default path may pick another algorithm for another batch shape
PAR_ENGINE_KERNELS = PAR_TP_KERNELS + ("flash_code_attention",)
PAR_SP_KERNELS = ("packed_w4_gemm", "packed_w4_gemm_qkv", "embed_gather", "flash_code_attention")


def par_sizes() -> dict:
    """Phase 12's shapes: Llama-2-7B width at 4 layers (the steps and SP on its first 2, the engines on all 4) and
    Mixtral-8x7B width at 2, bf16 heads; a 400-token prompt in the 512 bucket then 33 decode steps (a ring
    flush at the 32nd) at batch 32; SP over a 1,000-token prompt in the 1,024 bucket; 8 engine requests of
    ``synth_requests(maxlen=300)`` (prompts of 47-150 tokens in the 128 and 256 buckets, 230 decode steps; cell
    2's 900 took 730 steps, cut for the phase's time)."""
    from atom_tpu_torch.models.configs import MIXTRAL_8X7B

    return dict(llama=llama7b(4), mixtral=MIXTRAL_8X7B.replace(num_layers=2), batch=BATCH, page=PAGE,
                max_pages=MAX_PAGES, prompt=400, bucket=512, steps=33, sp_prompt=1000, sp_bucket=1024,
                engine_requests=8, engine_maxlen=300)


def state_tensors(state) -> dict:
    """Pages, ring and flushed counts of a serving state, by layer and field, on the host."""
    out = {"flushed": state.flushed.cpu()}
    for l, (pg, hot) in enumerate(zip(state.pages, state.hot)):
        out.update({f"pages{l}.{f}": getattr(pg, f).cpu() for f in pg._fields})
        out.update({f"hot{l}.{f}": getattr(hot, f).cpu() for f in hot._fields})
    return out


# the kv-head axis of each state field: pages and codes dim 1, params and the ring's params dim 2
PAR_HEAD_DIM = {"k_pages": 1, "v_pages": 1, "params": 2, "k_codes": 1, "prm": 2, "v_codes": 1}


def join_heads(torch, shards: list) -> dict:
    """The whole state from ranks' state tensors split by kv head (in rank order)."""
    return {k: shards[0][k] if k == "flushed" else torch.cat([s[k] for s in shards], dim=PAR_HEAD_DIM[k.split(".")[-1]])
            for k in shards[0]}


@contextlib.contextmanager
def record_logits(module, rows: list):
    """Every head product ``module._lm_head_logits`` computes for the duration: its first row, on the host."""
    orig = module._lm_head_logits

    def rec(x, head, vocab=None):
        out = orig(x, head, vocab)
        rows.append(out[0].float().cpu())
        return out

    module._lm_head_logits = rec
    try:
        yield
    finally:
        module._lm_head_logits = orig


def par_prompt(torch, sizes: dict, n: int, bucket: int, dev):
    """A seeded prompt of ``n`` tokens in a ``bucket``-row prefill (the same in every process)."""
    gen = torch.Generator().manual_seed(PAR_SEEDS["ids"])
    ids = torch.randint(1, sizes["llama"].vocab_size, (bucket,), generator=gen, dtype=torch.int32)
    ids[n:] = 0
    return ids.to(dev)


def par_steps(torch, dev, sizes: dict, prefill_fn, decode_fn, state, feed=None):
    """Phase 12's step protocol: the prompt into slot 0 of the batch (pages 1, 2, ...; the other slots idle),
    then ``steps`` decode steps with slot 0 live, fed ``feed`` (the single device's tokens) where given, else
    the tokens it samples -> (slot 0's tokens, state)."""
    b, n = sizes["batch"], sizes["prompt"]
    table = torch.zeros((b, sizes["max_pages"]), dtype=torch.int32, device=dev)
    n_used = -(-(n + sizes["steps"]) // sizes["page"])
    table[0, :n_used] = torch.arange(1, n_used + 1, dtype=torch.int32, device=dev)
    tok, state = prefill_fn(state, par_prompt(torch, sizes, n, sizes["bucket"], dev), table[0], n, 0)
    toks = [int(tok.item())]
    ids = torch.zeros((b,), dtype=torch.int32, device=dev)
    lens = torch.zeros((b,), dtype=torch.int32, device=dev)
    for i in range(sizes["steps"]):
        ids[0], lens[0] = toks[-1] if feed is None else feed[i], n + i + 1
        nxt, state = decode_fn(state, ids, table, lens)
        toks.append(int(nxt[0].item()))
    return toks, state


def par_state(sizes: dict, cfg, dev, mesh=None, axis: str = "tp"):
    from atom_tpu_torch.serving.model import make_serving_state
    from atom_tpu_torch.serving.parallel import make_state_sharded

    shape = (cfg.num_layers, 1 + sizes["max_pages"], sizes["batch"], cfg.num_kv_heads, sizes["page"], cfg.head_dim)
    if mesh is None:
        return make_serving_state(*shape, device=dev)
    return make_state_sharded(*shape, mesh, axis, device=dev)


def par_tg(sizes: dict):
    from atom_tpu_torch.serving import TextGenConfig

    return TextGenConfig(batch_size=sizes["batch"], page_size=sizes["page"], max_seq_len=1024, prefill_buckets=(128, 256, 512))


def par_engine(sizes: dict, cfg, dev, step_fns, mesh=None):
    """Cell 2's engine configuration over ``step_fns`` -> (engine, pool, pool pages, requests)."""
    from atom_tpu_torch.serving import KvPool, TextGenEngine, synth_requests

    tg = par_tg(sizes)
    n_pages = tg.batch_size * tg.max_seq_len // tg.page_size + 16
    pool = KvPool(cfg.num_layers, n_pages, cfg.num_kv_heads, tg.page_size, cfg.head_dim)
    state = par_state(dict(sizes, max_pages=n_pages - 1), cfg, dev, mesh)
    rs = synth_requests(sizes["engine_requests"], cfg.vocab_size, seed=PAR_SEEDS["requests"], maxlen=sizes["engine_maxlen"])
    return TextGenEngine(tg, pool, *step_fns, state), pool, n_pages, rs


def par_sp_prefill(torch, sizes: dict, prefill_fn, state, dev):
    """The SP check's prefill: the seeded prompt of ``sp_prompt`` tokens in the ``sp_bucket`` rows into slot 0."""
    n, bucket = sizes["sp_prompt"], sizes["sp_bucket"]
    row = torch.zeros((sizes["max_pages"],), dtype=torch.int32, device=dev)
    row[: bucket // sizes["page"]] = torch.arange(1, bucket // sizes["page"] + 1, dtype=torch.int32, device=dev)
    tok, state = prefill_fn(state, par_prompt(torch, sizes, n, bucket, dev), row, n, 0)
    return int(tok.item()), state


def par_backend_flags(torch) -> None:
    """The numerics flags ``main`` sets, in a rank process too."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def par_launches(torch, dev) -> dict:
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {k: v for k, v in read_counts().items() if not k.endswith("_by_path")}


def parallel_rank(rank: int, world: int, dev, sizes: dict, feeds: dict) -> dict:
    """Phase 12's rank body (every rank runs it, on the shared card): (a) TP 2 steps fed the single device's
    tokens, and the TP engine; (b) EP 2 steps on Mixtral width; (c) SP 2 and SP 2 x TP 2 prefills -> tokens,
    this rank's state tensors, the head's logits (gathered over the tp / ep ranks) and launches by check."""
    import torch

    import atom_tpu_torch.serving.moe as moe
    import atom_tpu_torch.serving.parallel as par
    import atom_tpu_torch.serving.sp as sp
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.parallel.mesh import all_gather_cols, axis_index, make_mesh
    from atom_tpu_torch.serving.model import init_serving_params

    par_backend_flags(torch)
    out, counts, secs = {}, {}, {}
    t0 = time.perf_counter()
    cfg4 = sizes["llama"]
    cfg2 = cfg4.replace(num_layers=2)
    p4 = init_serving_params(cfg4, ATOM_W4A4, seed=PAR_SEEDS["llama"], device=dev)
    p2 = p4._replace(layers=p4.layers[:2])

    # (a) TP 2 (each dp row of the mesh runs it)
    mesh = make_mesh((2, world // 2), ("dp", "tp"))
    group = mesh.get_group("tp")
    rows = []
    zero_counts()
    with record_logits(par, rows):
        fns = par.make_tp_step_fns(par.shard_serving_params(p2, cfg2, mesh), cfg2, ATOM_W4A4, mesh)
        toks, state = par_steps(torch, dev, sizes, *fns, par_state(sizes, cfg2, dev, mesh), feed=feeds["tp"])
    counts["parallel_tp_steps"] = par_launches(torch, dev)
    secs["tp_steps"] = time.perf_counter() - t0
    out["tp"] = dict(tokens=toks, state=state_tensors(state), logits=all_gather_cols(torch.stack(rows), group),
                     tp_index=axis_index(mesh, "tp"))
    del state, fns
    zero_counts()
    engine, pool, n_pages, rs = par_engine(sizes, cfg4, dev, par.make_tp_step_fns(
        par.shard_serving_params(p4, cfg4, mesh), cfg4, ATOM_W4A4, mesh), mesh)
    with kernel_prefill():
        res = engine.run(rs, record=True)
    counts["parallel_tp_engine"] = par_launches(torch, dev)
    secs["tp_engine"] = time.perf_counter() - t0 - sum(secs.values())
    out["tp_engine"] = dict(tokens=res["tokens"], free=pool.num_free_pages, n_pages=n_pages,
                            decode_steps=res["decode_steps"])
    del engine, pool

    # (c) SP 2 on each dp row, then SP 2 x TP 2 over all four ranks
    mesh = make_mesh((2, world // 2), ("dp", "sp"))
    rows = []
    zero_counts()
    with record_logits(sp, rows), kernel_prefill():
        tok, state = par_sp_prefill(torch, sizes, sp.make_sp_prefill_fn(p2, cfg2, ATOM_W4A4, mesh),
                                    par_state(sizes, cfg2, dev), dev)
    counts["parallel_sp_prefill"] = par_launches(torch, dev)
    out["sp"] = dict(token=tok, state=state_tensors(state), logits=rows[0])
    del state
    mesh = make_mesh((2, world // 2), ("sp", "tp"))
    rows = []
    zero_counts()
    with record_logits(sp, rows), kernel_prefill():
        fn = sp.make_sp_tp_prefill_fn(par.shard_serving_params(p2, cfg2, mesh), cfg2, ATOM_W4A4, mesh)
        tok, state = par_sp_prefill(torch, sizes, fn, par_state(sizes, cfg2, dev, mesh), dev)
    counts["parallel_sp_tp_prefill"] = par_launches(torch, dev)
    secs["sp"] = time.perf_counter() - t0 - sum(secs.values())
    out["sp_tp"] = dict(token=tok, state=state_tensors(state), logits=all_gather_cols(rows[0][None], mesh.get_group("tp"))[0],
                        sp_index=axis_index(mesh, "sp"))
    del state, fn, p2, p4
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (b) EP 2 on Mixtral width (each dp row)
    mcfg = sizes["mixtral"]
    mesh = make_mesh((2, world // 2), ("dp", "ep"))
    sharded = moe.shard_moe_serving_params(moe.init_moe_serving_params(mcfg, ATOM_W4A4, seed=PAR_SEEDS["mixtral"],
                                                                       device=dev), mcfg, mesh)
    rows = []
    zero_counts()
    with record_logits(moe, rows):
        fns = moe.make_moe_ep_step_fns(sharded, mcfg, ATOM_W4A4, mesh)
        toks, state = par_steps(torch, dev, sizes, *fns, par_state(sizes, mcfg, dev, mesh, "ep"), feed=feeds["ep"])
    counts["parallel_ep_steps"] = par_launches(torch, dev)
    secs["ep"] = time.perf_counter() - t0 - sum(secs.values())
    out["ep"] = dict(tokens=toks, state=state_tensors(state),
                     logits=all_gather_cols(torch.stack(rows), mesh.get_group("ep")))
    out["counts"], out["seconds"] = counts, secs
    return out


def par_token_check(torch, what: str, want_toks, want_logits, got_toks, got_logits) -> dict:
    """Tokens equal to the single device's, except at a step where the single device's top-2 logit margin is
    below that step's largest |logit difference| between the two paths (the head's products may reduce in
    another order on a rank's column slice)."""
    diff = (got_logits - want_logits).abs().amax(dim=-1)
    top2 = torch.topk(want_logits, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    mism = [i for i, (a, b) in enumerate(zip(got_toks, want_toks)) if a != b]
    bad = [i for i in mism if margin[i] > diff[i]]
    log(f"phase 12 {what}: {len(want_toks) - len(mism)}/{len(want_toks)} tokens equal, the largest logit difference "
        f"{diff.max().item():.3g}, the smallest top-2 margin {margin.min().item():.3g}"
        + (f", differing at steps {mism} (margins {[round(margin[i].item(), 5) for i in mism]})" if mism else ""))
    require(not bad, f"phase 12 {what}: tokens differ at steps {bad}, where the margin passes the logit difference")
    return dict(tokens=len(want_toks), tokens_equal=len(want_toks) - len(mism), logit_max_abs_diff=diff.max().item(),
                min_top2_margin=margin.min().item(), steps_differing=mism)


def par_state_check(torch, what: str, want: dict, got: dict) -> dict:
    """Pages, ring and flushed counts against the single device's, bit for bit, field by field."""
    differing = {k: bits(got[k]).ne(bits(want[k])).float().mean().item() for k in want}
    require(not any(differing.values()), f"phase 12 {what}: state differs from the single device's: "
            f"{ {k: v for k, v in differing.items() if v} }")
    return dict(entries_differing=0.0)


def parallel_phase(torch, dev, sizes: dict | None = None) -> tuple[dict, dict]:
    """Phase 12: parallelism on one card.  The single-device references on the kernel path in this process (and
    (d), dp 2 groups of tp 1 as threads on the card), then one ``run_ranks`` of 4 gloo ranks on the card for (a)
    TP 2, (b) EP 2, (c) SP 2 and SP 2 x TP 2; each held against the single device: pages, ring and flushed counts
    bit for bit, tokens by ``par_token_check``."""
    import atom_tpu_torch.serving.model as model
    import atom_tpu_torch.serving.moe as moe
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.parallel.launch import run_ranks
    from atom_tpu_torch.serving.dp import make_dp_tp_engines, run_data_parallel, split_requests

    t_phase = time.perf_counter()
    sizes = sizes or par_sizes()
    cfg4 = sizes["llama"]
    cfg2 = cfg4.replace(num_layers=2)
    p4 = model.init_serving_params(cfg4, ATOM_W4A4, seed=PAR_SEEDS["llama"], device=dev)
    p2 = p4._replace(layers=p4.layers[:2])
    ref, counts, res = {}, {}, {}

    rows = []
    with record_logits(model, rows):
        toks, state = par_steps(torch, dev, sizes, *model.make_step_fns(p2, cfg2, ATOM_W4A4), par_state(sizes, cfg2, dev))
    ref["tp"] = dict(tokens=toks, logits=torch.stack(rows), state=state_tensors(state))
    rows = []
    with record_logits(model, rows), kernel_prefill():
        tok, state = par_sp_prefill(torch, sizes, model.make_step_fns(p2, cfg2, ATOM_W4A4)[0], par_state(sizes, cfg2, dev),
                                    dev)
    ref["sp"] = dict(token=tok, logits=rows[0], state=state_tensors(state))
    del state
    engine, pool, n_pages, rs = par_engine(sizes, cfg4, dev, model.make_step_fns(p4, cfg4, ATOM_W4A4))
    with kernel_prefill():
        ref["engine"] = engine.run(rs, record=True)["tokens"]
    require(pool.num_free_pages == n_pages - 1, "phase 12: the single-device engine did not return its pages")
    del engine, pool
    log(f"phase 12: single-device steps, SP prefill and engine in {time.perf_counter() - t_phase:.1f} s")

    # (d) dp 2 groups of tp 1, threads on the card, at 4 layers: each group's tokens against a single-group run
    engines = make_dp_tp_engines(p4, cfg4, ATOM_W4A4, par_tg(sizes), [dev, dev], dp=2, tp=1)
    zero_counts()
    dp_res = run_data_parallel(engines, rs, record=True)
    counts["parallel_dp"] = par_launches(torch, dev)
    parts = split_requests(rs, 2)
    groups_equal = 0
    for i, part in enumerate(parts):
        solo, solo_pool, solo_pages, _ = par_engine(sizes, cfg4, dev, model.make_step_fns(p4, cfg4, ATOM_W4A4))
        want = solo.run(part, record=True)["tokens"]
        got = dp_res["per_group"][i]["tokens"]
        groups_equal += all(got[r] == want[r] for r in range(len(part)))
        require(engines[i].pool.num_free_pages == engines[i].pool.n_pages - 1, f"phase 12 dp group {i}: pages not returned")
    require(groups_equal == 2, f"phase 12 dp: {2 - groups_equal} group(s) differ from the single-group run of their part")
    require(dp_res["output_tokens"] == rs.total_output_tokens, "phase 12 dp: output tokens missing")
    res["dp"] = dict(groups=2, requests=dp_res["requests"], output_tokens=dp_res["output_tokens"], groups_equal=groups_equal)
    log(f"phase 12 dp 2 (threads, tp 1): groups equal to single-group runs 2/2, at {time.perf_counter() - t_phase:.1f} s")
    del engines, p2, p4

    mcfg = sizes["mixtral"]
    mp = moe.init_moe_serving_params(mcfg, ATOM_W4A4, seed=PAR_SEEDS["mixtral"], device=dev)
    rows = []
    with record_logits(moe, rows):
        toks, state = par_steps(torch, dev, sizes, *moe.make_moe_step_fns(mp, mcfg, ATOM_W4A4), par_state(sizes, mcfg, dev))
    ref["ep"] = dict(tokens=toks, logits=torch.stack(rows), state=state_tensors(state))
    del mp, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    feeds = dict(tp=ref["tp"]["tokens"][:-1], ep=ref["ep"]["tokens"][:-1])
    ranks = run_ranks(parallel_rank, PAR_RANKS, backend="gloo", device=str(dev), timeout_s=PAR_TIMEOUT_S,
                      args=(sizes, feeds))
    t_ranks = time.perf_counter() - t0
    for ph in ranks[0]["counts"]:
        counts[ph] = {k: sum(r["counts"][ph][k] for r in ranks) for k in ranks[0]["counts"][ph]}
    for ph, must in (("parallel_tp_steps", PAR_TP_KERNELS), ("parallel_tp_engine", PAR_ENGINE_KERNELS),
                     ("parallel_ep_steps", PAR_TP_KERNELS), ("parallel_sp_prefill", PAR_SP_KERNELS),
                     ("parallel_sp_tp_prefill", PAR_SP_KERNELS), ("parallel_dp", PAR_TP_KERNELS)):
        for name in must:
            par_require_launched(counts[ph], name, ph)

    fails = []

    def gate(check):
        """Run one check; a failed one is logged and kept, so every check of the phase reports."""
        try:
            return check()
        except SmokeError as e:
            log(f"phase 12 check failed: {e}")
            fails.append(str(e))
            return dict(failed=str(e))

    def steps_check(what):
        out = par_token_check(torch, f"{what} 2 steps", ref[what]["tokens"], ref[what]["logits"],
                              ranks[0][what]["tokens"], ranks[0][what]["logits"])
        require(all(r[what]["tokens"] == ranks[0][what]["tokens"] for r in ranks), f"phase 12 {what}: ranks disagree")
        for row in (ranks[0:2], ranks[2:4]):
            out.update(par_state_check(torch, f"{what} 2 state", ref[what]["state"],
                                       join_heads(torch, [r[what]["state"] for r in row])))
        return out

    def engine_check():
        eng = [r["tp_engine"] for r in ranks]
        for r, e in enumerate(eng):
            require(e["free"] == e["n_pages"] - 1, f"phase 12 tp engine, rank {r}: pages not returned")
            require(e["tokens"] == eng[0]["tokens"], f"phase 12 tp engine: rank {r}'s transcripts differ from rank 0's")
            for i, want in enumerate(rs.output_lens):
                require(len(e["tokens"][i]) == int(want), f"phase 12 tp engine, rank {r}, request {i}: tokens missing")
        first = sum(eng[0]["tokens"][i][0] == ref["engine"][i][0] for i in range(len(rs)))
        same = sum(eng[0]["tokens"][i] == ref["engine"][i] for i in range(len(rs)))
        log(f"phase 12 tp 2 engine ({cfg4.num_layers} layers, {len(rs)} requests): first tokens equal in {first}/{len(rs)}, "
            f"transcripts equal in {same}/{len(rs)}, {eng[0]['decode_steps']} decode steps; prompt lengths "
            f"{rs.prompt_lens.tolist()}, first tokens {[eng[0]['tokens'][i][0] for i in range(len(rs))]} against "
            f"{[ref['engine'][i][0] for i in range(len(rs))]}")
        require(first * 8 >= 7 * len(rs), f"phase 12 tp engine: first tokens equal in only {first}/{len(rs)}")
        return dict(requests=len(rs), first_tokens_equal=first, transcripts_equal=same,
                    decode_steps=eng[0]["decode_steps"], layers=cfg4.num_layers)

    def sp_check(what, sp_rows):
        got_tok = ranks[0][what]["token"]
        require(all(r[what]["token"] == got_tok for r in ranks), f"phase 12 {what}: ranks disagree on the token")
        out = par_token_check(torch, f"{what} prefill", [ref["sp"]["token"]], ref["sp"]["logits"][None], [got_tok],
                              ranks[0][what]["logits"][None])
        for row in sp_rows:
            out.update(par_state_check(torch, f"{what} pages", ref["sp"]["state"],
                                       row[0][what]["state"] if what == "sp" else
                                       join_heads(torch, [r[what]["state"] for r in row])))
        return out

    for what in ("tp", "ep"):
        res[what] = gate(lambda: steps_check(what))
    res["tp_engine"] = gate(engine_check)
    res["sp"] = gate(lambda: sp_check("sp", [[r] for r in ranks]))
    res["sp_tp"] = gate(lambda: sp_check("sp_tp", [ranks[0:2], ranks[2:4]]))
    res.update(reference_s=t_ref, ranks_s=t_ranks, rank0_s=ranks[0]["seconds"], phase_s=time.perf_counter() - t_phase,
               ranks=PAR_RANKS,
               backend="gloo, every rank on the one card (no rate: ranks share the card)",
               model=(f"Llama-2-7B width ({cfg2.num_layers} layers for the steps and SP, {cfg4.num_layers} for the "
                      f"engines), Mixtral-8x7B width ({mcfg.num_layers} layers), ATOM_W4A4, bf16 heads; the TP engine's "
                      "and SP's prefill attention through K12 on both sides"))
    log(f"phase 12 (parallelism on one card): references {t_ref:.1f} s, ranks {t_ranks:.1f} s; {res}")
    require(not fails, f"phase 12: {len(fails)} check(s) failed: {fails}")
    return counts, res


def par_require_launched(counts: dict, name: str, phase: str) -> None:
    require(counts[name] > 0, f"kernel {name} was launched no time on {phase}")


SOURCES = {
    "packed_w4_gemm": ("atom_tpu_torch/csrc/gemm_packed.cu", "atom_tpu/ops/pallas_gemm_packed.py:284"),
    "packed_w4_gemm_qkv_ring_fused": ("atom_tpu_torch/csrc/gemm_packed.cu", "atom_tpu/ops/pallas_gemm_packed.py:1261"),
    "paged_ring_decode_attention": ("atom_tpu_torch/csrc/decode.cu", "atom_tpu/ops/pallas_decode.py:416"),
    "flush_hot": ("atom_tpu_torch/csrc/decode.cu", "atom_tpu/ops/pallas_decode.py:720"),
    "w8a16_gemm": ("atom_tpu_torch/csrc/gemm_w8a16.cu", "atom_tpu/ops/pallas_gemm_w4a16.py:203"),
    "embed_gather": ("atom_tpu_torch/csrc/embed_gather.cu", "atom_tpu/ops/pallas_misc.py:30"),
    "packed_w4_gemm_qkv": ("atom_tpu_torch/csrc/gemm_packed.cu", "atom_tpu/ops/pallas_gemm_packed.py:792"),
    "packed_w4_gemm_qkv_ring": ("atom_tpu_torch/csrc/gemm_packed.cu", "atom_tpu/ops/pallas_gemm_packed.py:1196"),
    "packed_w4_gemm_fused_in": ("atom_tpu_torch/csrc/gemm_packed.cu", "atom_tpu/ops/pallas_gemm_packed.py:540"),
    "fused_mlp_packed": ("atom_tpu_torch/csrc/gemm_packed.cu", "atom_tpu/ops/pallas_mlp.py:238"),
    "paged_decode_attention_rotated": ("atom_tpu_torch/csrc/decode.cu", "atom_tpu/ops/pallas_decode.py:533"),
    "flash_code_attention": ("atom_tpu_torch/csrc/prefill.cu", "atom_tpu/ops/pallas_prefill.py:164"),
    "w4a16_gemm": ("atom_tpu_torch/csrc/gemm_w4a16.cu", "atom_tpu/ops/pallas_gemm_w4a16.py:97"),
    "grouped_int8_gemm": ("atom_tpu_torch/csrc/gemm_packed.cu", "atom_tpu/ops/pallas_gemm.py:77"),
    "grouped_int8_gemm_o4": ("atom_tpu_torch/csrc/gemm_packed.cu", "atom_tpu/ops/pallas_gemm.py:203"),
}

# the path whose run gives a kernel's count on the kernels line: the serial
# engine (bf16 head) for K1-K4, K6, K7; K5 by the decode burst with the W8A16
# head; K8 is reached only through a spec off the ring-fused prologue (a
# 2-layer step); K9 and K10 by the fused decode burst; K11 by the mixed engine;
# K12 by the prefills alone with the kernel threshold at 0; K13 by the W4A16
# stack's engine; K14 by the int8-carrier layer (it lies on no serving path)
MAIN_PATH = {
    "w8a16_gemm": "decode_burst",
    "packed_w4_gemm_qkv_ring": "int_input_ring_branch",
    "packed_w4_gemm_fused_in": "fused_decode_burst",
    "fused_mlp_packed": "fused_decode_burst",
    "paged_decode_attention_rotated": "mixed_engine",
    "flash_code_attention": "kernel_prefill",
    "w4a16_gemm": "w4a16_stack_engine",
    "grouped_int8_gemm": "int8_carrier_layer",
    "grouped_int8_gemm_o4": "int8_carrier_layer",
}
# the Mixtral phase's path that must launch each kernel of its table
MOE_PATH = dict({k: "moe_decode_burst" for k in MOE_DECODE_KERNELS}, packed_w4_gemm_qkv="moe_engine",
                **{k: "moe_fused_decode_burst" for k in MOE_FUSED_KERNELS[:2]})
BASELINE_STACKS = ("bf16", "w8a8", "w4a16")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    if not (ROOT / "atom_tpu_torch" / "csrc").is_dir():
        log("chip_smoke: the atom_tpu_torch package is not beside this script")
        return 2
    sys.path.insert(0, str(ROOT))
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.ops import _build
    from atom_tpu_torch.serving.model import init_serving_params, quantize_lm_head

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}; bf16 reduced-"
          f"precision reduction {torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}", flush=True)
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    OUT.mkdir(exist_ok=True)
    (OUT / "ptxas.log").write_text("\n".join(f"--- {k}\n{v}" for k, v in logs.items()))
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    kernels = check_kernels(torch, dev)
    torch.cuda.empty_cache()
    log(f"kernel checks in {time.perf_counter() - t0:.1f} s")
    if "--kernels-only" in sys.argv[1:]:
        print(json.dumps({"kernels_checked": kernels, "card": card}), flush=True)
        return 0

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = init_serving_params(llama7b(32), ATOM_W4A4, seed=0, device=dev)
    qparams, q4params = quantize_lm_head(params), quantize_lm_head(params, bits=4)
    torch.cuda.synchronize()
    log(f"param init (32 layers, bf16, W8A16 and W4A16 heads): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # the W8A16 head's burst feeds the ratios: 3 samples; the other heads 1 (to hold the run's time limit)
    decode_counts, decode_stats = decode_path(torch, dev, (("w8a16", qparams, 3), ("bf16", params, 1), ("w4a16", q4params, 1)))
    decode_stats["w8a16"]["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del q4params
    torch.cuda.empty_cache()
    log(f"decode path in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with fused_flag():
        fused_counts, fused_stats = decode_path(torch, dev, (("w8a16", qparams, 2),), FUSED_DECODE_KERNELS, "profile_fused.txt")
    require(fused_counts["packed_w4_gemm"] == 0, "the fused decode path still launched the unfused GEMM")
    require(fused_counts["fused_mlp_packed_by_path"]["four_launch"] == 0,
            "the fused decode burst ran K10's four-launch form, not the cluster epilogue")
    torch.cuda.empty_cache()
    log(f"fused decode path in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    engine_counts, engine_res = engine_path(torch, dev, params)
    prefill_res = engine_res.pop("prefill_alone")
    del params
    torch.cuda.empty_cache()
    log(f"engine path in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mixed_counts, mixed_res = engine_path(torch, dev, qparams, mixed=True)
    log(f"mixed engine path in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lora_counts, lora_res = lora_phase(torch, dev, qparams, decode_stats["w8a16"])
    log(f"LoRA and native-scheduler phase in {time.perf_counter() - t0:.1f} s")
    del qparams
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    p2 = init_serving_params(llama7b(2), ATOM_W4A4, seed=3, device=dev)
    q2 = quantize_lm_head(p2)
    no_fuse = ATOM_W4A4.replace(fused_serving=False)
    parity = {
        "ring_fused_batch_32": kernel_vs_plain_path(torch, dev, p2, BATCH, ATOM_W4A4, p2.lm_head,
                                                    ("packed_w4_gemm_qkv_ring_fused",)),
        "int_input_ring_batch_32": kernel_vs_plain_path(torch, dev, q2, BATCH, no_fuse, q2.lm_head,
                                                        ("packed_w4_gemm_qkv_ring", "w8a16_gemm")),
        "fallback_batch_8": kernel_vs_plain_path(torch, dev, q2, 8, ATOM_W4A4, q2.lm_head,
                                                 ("packed_w4_gemm_qkv", "w8a16_gemm")),
        "fused_post_attention_batch_32": kernel_vs_plain_path(torch, dev, q2, BATCH, ATOM_W4A4, q2.lm_head,
                                                              ("packed_w4_gemm_fused_in", "fused_mlp_packed"), fused=True),
        "w4a16_head_batch_32": kernel_vs_plain_path(torch, dev, p2, BATCH, ATOM_W4A4, quantize_lm_head(p2, bits=4).lm_head,
                                                    ("packed_w4_gemm_qkv_ring_fused", "w4a16_gemm")),
        "mixed_step_flush_pos0_512": mixed_step_kernel_vs_plain(torch, dev, q2, True, 512, PAGE),
        "mixed_step_first_chunk_100_tokens": mixed_step_kernel_vs_plain(torch, dev, q2, False, 0, 100),
        "kernel_prefill_512": prefill_kernel_vs_plain(torch, dev, q2),
    }
    parity["engine_2_layers"] = engine_kernel_vs_plain(torch, dev, q2)
    parity["mixed_engine_2_layers"] = engine_kernel_vs_plain(torch, dev, q2, mixed=True)
    del p2, q2
    torch.cuda.empty_cache()
    log(f"kernel path vs plain path in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    int8_counts, int8_res = int8_carrier_layer(torch, dev)
    torch.cuda.empty_cache()
    log(f"int8-carrier layer in {time.perf_counter() - t0:.1f} s")

    baselines, base_counts = {}, {}
    for stack in BASELINE_STACKS:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        bp = baseline_params(torch, dev, stack)
        log(f"{stack} stack: params ({sum(t.numel() * t.element_size() for t in _leaves(bp)) / 1e9:.2f} GB) "
            f"in {time.perf_counter() - t0:.1f} s")
        burst_counts, burst_stats = baseline_burst(torch, dev, stack, bp)
        torch.cuda.empty_cache()
        eng_counts, eng_res = baseline_engine(torch, dev, stack, bp)
        baselines[stack] = dict(burst=burst_stats, engine=eng_res,
                                params_gb=sum(t.numel() * t.element_size() for t in _leaves(bp)) / 1e9)
        base_counts[stack] = dict(burst=burst_counts, engine=eng_counts)
        del bp
        torch.cuda.empty_cache()
        log(f"{stack} stack in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    parity["w4a16_stack_2_layers"] = w4a16_stack_vs_plain(torch, dev)
    torch.cuda.empty_cache()
    log(f"W4A16 stack vs plain path in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moe_counts, mixtral = mixtral_phase(torch, dev)
    log(f"Mixtral-8x7B phase in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    calib_counts, calibrated = calibrated_phase(torch, dev, "llama2-7b")
    calibrated["phase_s"] = time.perf_counter() - t0
    log(f"calibrate -> export -> serve phase in {calibrated['phase_s']:.1f} s")
    accuracy = {}
    for model in ("mixtral-8x7b", "opt-6.7b"):
        t0 = time.perf_counter()
        counts, accuracy[model] = calibrated_phase(torch, dev, model)
        accuracy[model]["phase_s"] = time.perf_counter() - t0
        calib_counts.update(counts)
        log(f"{model} accuracy phase in {accuracy[model]['phase_s']:.1f} s")
    t0 = time.perf_counter()
    accuracy["training"] = training_phase(torch, dev)
    accuracy["training"]["phase_s"] = time.perf_counter() - t0
    log(f"training phase in {accuracy['training']['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    par_counts, parallel = parallel_phase(torch, dev)
    log(f"parallelism phase in {parallel['phase_s']:.1f} s")

    w4a4_burst, w4a4_engine = decode_stats["w8a16"]["decode_tok_s"], engine_res["throughput_tok_s"]
    ratios = {b: dict(decode_burst=w4a4_burst / baselines[b]["burst"]["decode_tok_s"],
                      engine_total_tok_s=w4a4_engine / baselines[b]["engine"]["throughput_tok_s"],
                      engine_output_tok_s=engine_res["output_tok_s"] / baselines[b]["engine"]["output_tok_s"])
              for b in BASELINE_STACKS}
    log(f"W4A4 / baseline ratios: {ratios}")

    branch_counts = parity["int_input_ring_batch_32"]["launches"]
    kernel_prefill_launches = sum(v["flash_code_attention_launches"] for k, v in prefill_res.items() if k.startswith("kernel_"))
    rows = []
    for name, k in kernels.items():
        src, rep = SOURCES[name]
        by_phase = dict(decode_burst=decode_counts[name], fused_decode_burst=fused_counts[name], engine=engine_counts[name],
                        mixed_engine=mixed_counts[name], int_input_ring_branch=branch_counts.get(name, 0),
                        kernel_prefill=kernel_prefill_launches if name == "flash_code_attention" else 0,
                        int8_carrier_layer=int8_counts[name],
                        **{f"{b}_stack_{ph}": base_counts[b][ph][name] for b in BASELINE_STACKS for ph in ("burst", "engine")},
                        **{ph: c[name] for ph, c in moe_counts.items()},
                        **{ph: c[name] for ph, c in lora_counts.items()},
                        **{ph: c[name] for ph, c in calib_counts.items()},
                        **{ph: c[name] for ph, c in par_counts.items()})
        path = MAIN_PATH.get(name, "engine")
        launches = by_phase[path]
        require(launches > 0, f"kernel {name} was launched no time on its path ({path})")
        if name in MOE_PATH:
            require(by_phase[MOE_PATH[name]] > 0, f"kernel {name} was launched no time on its MoE path ({MOE_PATH[name]})")
        if name in MOE_ENGINE_KERNELS:
            require(by_phase["calibrated_moe_engine"] > 0,
                    f"kernel {name} was launched no time by the calibrated Mixtral engine")
        rows.append(dict(name=name, route="cuda", source=src, replaces=rep, launches=launches, launches_on=path,
                         launches_by_phase={k_: v_ for k_, v_ in by_phase.items() if v_}, **k))
        if name == "flush_hot":  # K4's launches by form: the live ring in place, pre-rolled blocks
            rows[-1]["launches_by_path"] = dict(engine=engine_counts["flush_hot_by_path"],
                                                decode_burst=decode_counts["flush_hot_by_path"],
                                                mixed_engine=mixed_counts["flush_hot_by_path"])
        if name == "packed_w4_gemm":  # K1's launches by kernel: the decode core (M <= 64), the prefill GEMM above
            rows[-1]["launches_by_path"] = dict(engine=engine_counts["packed_w4_gemm_by_path"],
                                                decode_burst=decode_counts["packed_w4_gemm_by_path"],
                                                mixed_engine=mixed_counts["packed_w4_gemm_by_path"],
                                                **{ph: c["packed_w4_gemm_by_path"] for ph, c in lora_counts.items()},
                                                **{ph: c["packed_w4_gemm_by_path"] for ph, c in calib_counts.items()})
            require(engine_counts["packed_w4_gemm_by_path"]["prefill"] > 0, "the engine's prefills did not run the prefill GEMM")
            require(decode_counts["packed_w4_gemm_by_path"]["prefill"] == 0, "the decode burst ran the prefill GEMM")
        if name == "fused_mlp_packed":  # K10's launches by path: the cluster epilogue (<= 64 rows), four launches
            rows[-1]["launches_by_path"] = dict(fused_decode_burst=fused_counts["fused_mlp_packed_by_path"])
        if name == "paged_decode_attention_rotated":  # K11's launches by path: stream (decode rows), tile (a chunk's prefix)
            rows[-1]["launches_by_path"] = dict(mixed_engine=mixed_counts["paged_decode_attention_rotated_by_path"])
    require(len(rows) == 15, "the kernels line must list K1-K14 (K14's two functions)")
    print(json.dumps({"kernels": rows}), flush=True)
    engine_config = ("batch 32, page 256, max_seq_len 1024, buckets (128, 256, 512), pool 144 pages, "
                     f"synth_requests({N_REQUESTS}, 32000, maxlen={XS_MAXLEN})")
    results = {
        "decode": dict(decode_stats, protocol="slope between 1 and 4 ring windows, median of positive samples",
                       batch=BATCH, context=CTX),
        "decode_fused_post_attention": dict(fused_stats, flag="ATOM_TPU_FUSED_MLP=1", launches=fused_counts),
        "engine": dict(engine_res, config=engine_config + ", bf16 head"),
        "mixed_engine": dict(mixed_res, config=engine_config + ", W8A16 head, make_mixed_step_fns + chunk_fn"),
        "prefill_alone": prefill_res,
        "baselines": dict(baselines, burst_protocol=f"slope between {BURST_LO} and {BURST_HI} steps, 3 samples, median of "
                          f"positive ones, batch {BATCH}, context {CTX}, dense KV of {CTX + BURST_HI * 3 + 64} rows",
                          engine_config=engine_config),
        "int8_carrier_layer": int8_res,
        "mixtral": dict(mixtral, launches=moe_counts),
        "lora": dict(lora_res, launches=lora_counts),
        "calibrated": dict(calibrated, launches=calib_counts),
        "accuracy_phase_11": accuracy,
        "parallelism_phase_12": dict(parallel, launches=par_counts),
        "model": ("Llama-2-7B width, 32 layers; W4A4 (also with LoRA adapters) and the baseline stacks bf16, W8A8, W4A16; "
                  "Mixtral-8x7B W4A4; Llama-2-7B width at 4 layers and Mixtral-8x7B at 2 calibrated (GPTQ) and served; "
                  "OPT-6.7B at 2 calibrated; BYTE_LM trained; tensor-, expert-, sequence- and data-parallel serving "
                  "on 4 gloo ranks sharing the card"),
        "card": card,
        "path_parity_2_layers": parity, "wall_s": time.perf_counter() - t_all,
    }
    print(json.dumps(results), flush=True)
    OUT.mkdir(exist_ok=True)  # both lines whole: the results line outgrows the tail of a run's output
    (OUT / "smoke_results.json").write_text(json.dumps({"kernels": rows, "results": results}, indent=1))
    print(json.dumps({"w4a4_ratios": ratios, "w4a4_burst_head": "w8a16", "w4a4_engine_head": "bf16", "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _leaves(tree):
    """The tensors of a params tree of NamedTuples and lists."""
    if hasattr(tree, "data_ptr"):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            yield from _leaves(item)


if __name__ == "__main__":
    sys.exit(main())
