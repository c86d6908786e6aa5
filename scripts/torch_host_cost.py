"""Host time of kernel K13's wrapper (``w4a16_gemm``) per call, and of the
W4A16 baseline stack's decode step, on one CUDA card, for the
``atom_tpu_torch`` package of the checkout at ``--root`` (default: this one),
so that two checkouts can be compared on the same card:

    python3 scripts/torch_host_cost.py [--root DIR] [--layers 32] [--steps 16]

A call's host time is the time until its wrapper returns, the card being
behind or idle: what the host takes to enqueue it.  K13 is timed at the W4A16
stack's seven decode GEMMs (batch 32, Llama-2-7B width, bf16 out) and at the
4-bit head (32 rows and 1, f32 out); K5's wrapper (``w8a16_gemm``, a launch
without a cluster or a tensor map) at the head's 32 rows stands beside it.
The step's host time is taken per step of a burst of decode steps (batch 32,
from context 512), with one synchronisation after the burst; the burst's wall
time per step stands beside it.  Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BATCH, CTX, HID, HEAD_N = 32, 512, 4096, 32256


def host_us(torch, fn, n: int = 200) -> float:
    """Median host time of one call of ``fn``, in µs (a synchronisation
    every 20 calls keeps the launch queue short)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    ts = []
    for i in range(n):
        t = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t)
        if i % 20 == 19:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return statistics.median(ts) * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("torch_host_cost: no CUDA card", file=sys.stderr)
        return 1
    import atom_tpu_torch
    from atom_tpu_torch.models.configs import LLAMA2_7B
    from atom_tpu_torch.ops import gemm_w4a16 as gw
    from atom_tpu_torch.serving import baselines as bl

    if root not in Path(atom_tpu_torch.__file__).resolve().parents:
        raise SystemExit(f"atom_tpu_torch came from {atom_tpu_torch.__file__}, not from {root}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def w4a16_weight(k, n):
        packed = torch.randint(-128, 128, (k // 2, n), generator=gen, device=dev, dtype=torch.int32).to(torch.int8)
        return gw.W4A16Weight(packed, torch.rand((k // 128, n), generator=gen, device=dev) * 0.02 + 0.001)

    inter_p = -(-LLAMA2_7B.intermediate_size // 1024) * 1024
    cases = {**{f"decode_{k}x{n}": (BATCH, k, n, torch.bfloat16) for k, n in ((HID, HID), (HID, inter_p), (inter_p, HID))},
             "head_m32": (BATCH, HID, HEAD_N, torch.float32), "head_m1": (1, HID, HEAD_N, torch.float32)}
    k13 = {}
    for name, (m, k, n, out_dtype) in cases.items():
        a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        wq = w4a16_weight(k, n)
        k13[name] = host_us(torch, lambda: gw.w4a16_gemm(a, wq, out_dtype=out_dtype))
    layer = 4 * k13[f"decode_{HID}x{HID}"] + 2 * k13[f"decode_{HID}x{inter_p}"] + k13[f"decode_{inter_p}x{HID}"]
    a = torch.randn((BATCH, HID), generator=gen, device=dev).to(torch.bfloat16)
    w8 = gw.W8A16Weight(torch.randint(-127, 128, (HID, HEAD_N), generator=gen, device=dev, dtype=torch.int32).to(torch.int8),
                        torch.rand((1, HEAD_N), generator=gen, device=dev) * 0.01)
    k5 = host_us(torch, lambda: gw.w8a16_gemm(a, w8))
    del a, w8

    cfg = LLAMA2_7B.replace(num_layers=args.layers)
    params = bl.init_w4a16_params(cfg, seed=0, device=dev)
    kvs = bl.make_dense_kv(cfg.num_layers, BATCH, CTX + args.steps + 8, cfg.num_kv_heads, cfg.head_dim, device=dev)
    ids = torch.ones((BATCH,), dtype=torch.int32, device=dev)
    lens = torch.full((BATCH,), CTX, dtype=torch.int32, device=dev)
    for _ in range(2):
        ids, kvs = bl.w4a16_decode_step(params, kvs, ids, lens, cfg)
    torch.cuda.synchronize()
    launches0, steps = gw.w4a16_gemm.launches, []
    t0 = time.perf_counter()
    for _ in range(args.steps):
        lens = lens + 1
        t = time.perf_counter()
        ids, kvs = bl.w4a16_decode_step(params, kvs, ids, lens, cfg)
        steps.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.steps
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    print(json.dumps({
        "root": str(root), "card": card, "k13_host_us": k13, "k13_decode_layer_host_us": layer,
        "k5_head_m32_host_us": k5, "w4a16_layers": cfg.num_layers,
        "w4a16_k13_calls_per_step": (gw.w4a16_gemm.launches - launches0) / args.steps,
        "w4a16_step_host_ms": statistics.median(steps) * 1e3, "w4a16_step_wall_ms": wall * 1e3,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
