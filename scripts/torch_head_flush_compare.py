"""The W8A16 head (kernel K5) and the ring flush (kernel K4) timed for the
``atom_tpu_torch`` package of the checkout at ``--root`` (default: this one)
on one CUDA card, so that two checkouts can be compared on the same card:

    python3 scripts/torch_head_flush_compare.py [--root DIR] [--out FILE] [--burst] [--engine]

K5 at the Llama-2-7B head (K 4,096, N 32,256, ``chip_smoke.py``'s inputs) at
1, 32 and 33 rows: CUDA events with L2 flushed (``Timer``), the profiler's
device time (``Timer.device``) and the wrapper's host time.  K4 at
``chip_smoke.py``'s flush shape (batch 32, 32 kv heads, W 32, page 256,
blocks crossing a page): the flush as the serving step calls it in the
checkout (``flush_hot_ring`` on the live ring where the checkout has it, else
``hot_flush_blocks`` + ``flush_hot``: three ``torch.roll`` copies, then the
kernel), and the rolled sequence beside it; the pages of the two forms are
held bit for bit.  Each form is measured, then again in reverse order.  The
instruction counts of K5's kernels come from ``cuobjdump -sass`` of the
built library (conversion-unit instructions: I2F, I2FP, F2F, F2FP).  With
``--burst``: one profiled ring window of the 32-layer W4A4 decode burst
(batch 32, context 512, W8A16 head), default and with
``ATOM_TPU_FUSED_MLP=1``: device time, kernels and ``torch.roll`` kernels a
step (``chip_smoke.py``'s ``profile_decode``).  With ``--engine``: the serial
engine cell (``chip_smoke.py``'s ``engine_setup``: 32 requests, batch 32,
W4A4 with the bf16 head, 32 layers) after a short warm-up run; its result
dictionary (wall time: host-bound).  The yardstick is this
checkout's ``chip_smoke.py``, whichever checkout is measured.  Prints one
JSON line (and writes it to ``--out``).
"""
from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
# conversion-unit opcodes, and the integer and bf16x2 ones the new conversion uses
SASS_OPS = ("I2F", "I2FP", "F2F", "F2FP", "F2I", "PRMT", "LOP3", "SHF", "HFMA2", "HADD2", "HMUL2", "LDS", "LDG",
            "HGMMA", "HMMA", "FMUL", "FADD")


def load_chip_smoke():
    """This checkout's chip_smoke.py as a module (not the measured one's)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass_counts(lib: Path, kernel: str) -> dict:
    """Opcode counts of each function of ``lib`` whose name holds ``kernel``
    (``cuobjdump -sass``), the total and those of ``SASS_OPS``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            funcs[name] = collections.Counter() if kernel in name else None
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)", line)
        if op and name and funcs.get(name) is not None:
            funcs[name][op.group(1)] += 1
    return {f: dict(total=sum(c.values()), **{o: c.get(o, 0) for o in SASS_OPS}) for f, c in funcs.items() if c is not None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--out", default=None)
    ap.add_argument("--burst", action="store_true", help="also profile one window of the 32-layer burst")
    ap.add_argument("--engine", action="store_true", help="also run the serial engine cell")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("torch_head_flush_compare: no CUDA card", file=sys.stderr)
        return 1
    import atom_tpu_torch
    from atom_tpu_torch.ops import _build
    from atom_tpu_torch.ops import decode as dec
    from atom_tpu_torch.ops import gemm_w4a16 as gw
    from atom_tpu_torch.ops.kv_hot import hot_flush_blocks
    from atom_tpu_torch.ops.kv_layout import KVPages

    if root not in Path(atom_tpu_torch.__file__).resolve().parents:
        raise SystemExit(f"atom_tpu_torch came from {atom_tpu_torch.__file__}, not from {root}")
    cs = load_chip_smoke()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    timer = cs.Timer(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    res = dict(root=str(root), card=cs.card_line(),
               sass=sass_counts(_build._lib_path("gemm_w8a16"), "gemm_w8a16_kernel"))

    # K5 at the head
    head = (torch.randn((cs.HID, cs.HEAD_N), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    head[:, cs.VOCAB:] = 0
    wq = gw.quantize_w8a16(head.to(torch.float32))
    del head
    forms = {}
    for m in (1, cs.BATCH, cs.BATCH + 1):
        x = torch.randn((m, cs.HID), generator=gen, device=dev).to(torch.bfloat16)
        got, want = gw.w8a16_gemm(x, wq), gw.w8a16_gemm_plain(x, wq)
        err, top = (got - want).abs().max().item(), want.abs().max().item()
        cs.require(err <= gw.W8A16_RTOL * top, f"w8a16_gemm at M={m}: max |diff| {err} beyond {gw.W8A16_RTOL} x {top}")
        forms[f"k5_m{m}"] = (lambda x=x: gw.w8a16_gemm(x, wq))

    # K4 at the flush shape: the serving step's call, and the rolled sequence
    h, w = 32, 32
    pages, hot, table = cs.kv_inputs(torch, gen, dev, cs.BATCH, h, w)
    lens = (cs.CTX - 12 + torch.arange(cs.BATCH, device=dev, dtype=torch.int32)).to(torch.int32)
    fl = (lens - w).to(torch.int32)
    fl[3], fl[7] = lens[3], lens[7]  # inactive
    active = (lens > 0) & (lens > fl)
    page_lo = torch.div(lens - w, cs.PAGE, rounding_mode="floor")
    slot0 = (page_lo * cs.PAGE).to(torch.int32)
    o_lane = (lens - w - slot0).to(torch.int32)
    pick = lambda i: torch.gather(table, 1, i.clamp(0, cs.MAX_PAGES - 1)[:, None].long())[:, 0]  # noqa: E731
    pg_a = torch.where(active & (page_lo >= 0), pick(page_lo), 0).to(torch.int32)
    pg_b = torch.where(active & ((page_lo + 1) * cs.PAGE < lens), pick(page_lo + 1), 0).to(torch.int32)
    book = (pg_a, pg_b, slot0, o_lane, fl, lens)
    pk = KVPages(*(t.clone() for t in pages))
    has_ring = hasattr(dec, "flush_hot_ring")
    rolled = lambda p_=pk: dec.flush_hot(p_, *hot_flush_blocks(hot, 5), *book)  # noqa: E731
    forms["k4_serving_call"] = (lambda: dec.flush_hot_ring(pk, hot, 5, *book)) if has_ring else rolled
    forms["k4_rolls_then_kernel"] = rolled
    if has_ring:  # the two forms write the same pages, bit for bit
        pr = KVPages(*(t.clone() for t in pages))
        dec.flush_hot_ring(pk, hot, 5, *book)
        rolled(pr)
        for a_, b_ in zip(pk, pr):
            cs.require(torch.equal(cs.bits(a_), cs.bits(b_)), "flush_hot_ring differs from hot_flush_blocks + flush_hot")
        del pr

    times = {k: [] for k in forms}
    device = {k: [] for k in forms}
    host = {k: [] for k in forms}
    for order in (list(forms), list(forms)[::-1]):
        for k in order:
            times[k].append(timer(forms[k]))
            host[k].append(timer.host_us)
            device[k].append(timer.device(forms[k]))
    res.update(has_flush_hot_ring=has_ring, ms={k: statistics.median(v) for k, v in times.items()},
               ms_both_orders=times, host_us=host,
               device_us={k: [d["us"] for d in v] for k, v in device.items()},
               device_kernels={k: v[0]["kernels"] for k, v in device.items()},
               device_by_kernel={k: v[0]["by_kernel"] for k, v in device.items()})
    del wq, pages, hot, pk
    torch.cuda.empty_cache()

    if args.burst:
        from atom_tpu_torch.config import ATOM_W4A4
        from atom_tpu_torch.serving.model import decode_burst, init_serving_params, make_serving_state, quantize_lm_head

        cfg, spec, batch = cs.llama7b(32), ATOM_W4A4, cs.BATCH
        qparams = quantize_lm_head(init_serving_params(cfg, spec, seed=0, device=dev))
        n_pages = batch * cs.MAX_PAGES + 1
        table = (1 + torch.arange(batch * cs.MAX_PAGES, device=dev, dtype=torch.int32)).reshape(batch, cs.MAX_PAGES)
        full = lambda v: torch.full((batch,), v, dtype=torch.int32, device=dev)  # noqa: E731
        for tag, flag in (("burst", False), ("fused_burst", True)):
            state = make_serving_state(cfg.num_layers, n_pages, batch, cfg.num_kv_heads, cs.PAGE, cfg.head_dim, device=dev)
            state = state._replace(flushed=full(cs.CTX))
            ids = torch.ones((batch,), dtype=torch.int32, device=dev)
            w = state.hot[0].window
            with cs.fused_flag() if flag else cs.contextlib.nullcontext():
                ids, state, _ = decode_burst(qparams, state, ids, table, full(cs.CTX), 1, cfg, spec)  # warm-up window
                torch.cuda.synchronize()
                device_ms, kernels, _, _, family = cs.profile_decode(torch, qparams, state, ids, table, full, cfg, spec, w,
                                                                     f"profile_{tag}_compare_{root.name}.txt")
            res[tag] = dict(device_ms_per_step=device_ms, kernels_per_step=kernels,
                            roll_kernels_per_step=family.get("roll", dict(launches_per_step=0.0))["launches_per_step"],
                            k1_family_gathers_rolls=family)
            del state
            torch.cuda.empty_cache()
    if args.engine:
        from atom_tpu_torch.config import ATOM_W4A4
        from atom_tpu_torch.serving import synth_requests
        from atom_tpu_torch.serving.model import init_serving_params, make_serving_state

        cfg = cs.llama7b(32)
        params = init_serving_params(cfg, ATOM_W4A4, seed=0, device=dev)  # the bf16 head, as the engine cell
        tg, pool, n_pages, rs = cs.engine_setup(torch, dev, cfg)
        state = make_serving_state(cfg.num_layers, n_pages, tg.batch_size, cfg.num_kv_heads, tg.page_size,
                                   cfg.head_dim, device=dev)
        engine = cs.make_engine(tg, pool, state, params, cfg, mixed=False)
        engine.run(synth_requests(8, cfg.vocab_size, seed=7, maxlen=128), record=False)  # warm-up
        run = engine.run(rs, record=False)
        torch.cuda.synchronize()
        cs.require(run["output_tokens"] == rs.total_output_tokens and pool.num_free_pages == n_pages - 1,
                   "the engine did not produce every token or return every page")
        res["engine"] = {k: v for k, v in run.items() if isinstance(v, (int, float, str))}
        del params, state, engine
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
