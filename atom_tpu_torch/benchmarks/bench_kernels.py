"""Kernel micro-benchmarks (port of ``atom_tpu/benchmarks/bench_kernels.py``).

Prints one row per (kernel, shape): time, achieved bandwidth and integer-op
throughput, timed by ``utils/timing.py::bench_op`` (CUDA graph replays on
the card: warm L2; eager calls on the host clock for ``--device cpu``).

    python -m atom_tpu_torch.benchmarks.bench_kernels [--quick] [--only gemm] [--device cpu]

The JAX package's sweeps, rows, byte and op counts: the W4A4 GEMM (kernel
K1: the decode core up to 64 rows, the prefill GEMM above) over batch
{16..4096} x the Llama-2-7B projections, the activation-quantization glue
(the plain PyTorch of ``ops/reference.py``), paged decode attention over
context lengths (K11) and the per-request LoRA delta.
"""
from __future__ import annotations

import argparse

import torch

from atom_tpu_torch.config import ATOM_W4A4
from atom_tpu_torch.models.configs import Arch, ModelConfig
from atom_tpu_torch.ops import reference as R
from atom_tpu_torch.ops.decode import paged_decode_attention_rotated
from atom_tpu_torch.ops.formats import pack_for_kernel, quantize_activation_packed, quantize_weight_packed
from atom_tpu_torch.ops.gemm_packed import quant_gemm_packed
from atom_tpu_torch.ops.kv_layout import make_kv_pages_kernel
from atom_tpu_torch.ops.runtime import resolve_device
from atom_tpu_torch.serving.lora import add_lora, init_llama_lora
from atom_tpu_torch.utils.timing import bench_op, card_line

SPEC = ATOM_W4A4


def row(name, dt, bytes_=None, intops=None):
    parts = [f"{name:44s} {dt*1e6:9.1f} us"]
    if bytes_:
        parts.append(f"{bytes_/dt/1e9:7.0f} GB/s")
    if intops:
        parts.append(f"{intops/dt/1e12:7.1f} Tops/s")
    print("  ".join(parts), flush=True)


def _packed_weight(gen, k_dim: int, n_dim: int, dev):
    w = torch.randn((k_dim, n_dim), generator=gen, dtype=torch.float32, device=dev) * k_dim**-0.5
    return pack_for_kernel(quantize_weight_packed(w, SPEC))


def bench_gemm(quick: bool, device=None):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = (16, 32, 128) if quick else (16, 32, 128, 512, 2048, 4096)
    shapes = ((4096, 4096), (4096, 12288), (4096, 22016), (11008, 4096))
    for k_dim, n_dim in shapes:
        kw = _packed_weight(gen, k_dim, n_dim, dev)
        for m in batches:
            x = torch.randn((m, k_dim), generator=gen, dtype=torch.float32, device=dev)
            qa = quantize_activation_packed(x, SPEC)
            dt = bench_op(quant_gemm_packed, [qa, kw], iters=30)
            bytes_ = m * k_dim + k_dim * n_dim // 2 + 2 * m * n_dim
            row(f"w4a4_gemm M={m} K={k_dim} N={n_dim}", dt, bytes_, 2 * m * k_dim * n_dim)


def bench_epilogues(quick: bool, device=None):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(1)
    for t in (32, 256):
        x = torch.randn((t, 4096), generator=gen, dtype=torch.float32, device=dev).to(torch.bfloat16)
        w = torch.ones((4096,), dtype=torch.bfloat16, device=dev)
        idx = torch.arange(4096, dtype=torch.int32, device=dev)
        dt = bench_op(lambda x_: R.rmsnorm_reorder_quant(x_, w, idx, SPEC).codes, [x], iters=50)
        row(f"rmsnorm+reorder+quant T={t} d=4096", dt, t * 4096 * 3)
        dt = bench_op(lambda x_: R.reorder_quant(x_, idx, SPEC).codes, [x], iters=50)
        row(f"reorder+quant T={t} d=4096", dt, t * 4096 * 3)
        g = torch.randn((t, 11008), generator=gen, dtype=torch.float32, device=dev)
        dt = bench_op(lambda g_: R.silu_mul_quant(g_, g_, SPEC).codes, [g], iters=50)
        row(f"silu_mul+quant T={t} inter=11008", dt, t * 11008 * 9)


def bench_decode(quick: bool, device=None):
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(2)
    B, H, D, S = 32, 32, 128, 256
    ctxs = (512,) if quick else (512, 1024, 2048)
    for ctx in ctxs:
        maxp = ctx // S
        n_pages = B * maxp + 1
        pages = make_kv_pages_kernel(n_pages, H, S, D, dev)
        pages = pages._replace(
            k_pages=torch.randint(-128, 127, pages.k_pages.shape, generator=gen, dtype=torch.int8, device=dev),
            v_pages=torch.randint(-128, 127, pages.v_pages.shape, generator=gen, dtype=torch.int8, device=dev),
            params=(torch.rand(pages.params.shape, generator=gen, device=dev) * 0.09 + 0.01).to(torch.bfloat16),
        )
        table = torch.arange(1, n_pages, dtype=torch.int32, device=dev).reshape(B, maxp)
        lens = torch.full((B,), ctx, dtype=torch.int32, device=dev)
        q = torch.randn((B, H, D), generator=gen, dtype=torch.float32, device=dev).to(torch.bfloat16)
        dt = bench_op(paged_decode_attention_rotated, [q, pages, table, lens], iters=30)
        kv_bytes = B * ctx * H * D + B * ctx * H * 8  # 4-bit K+V + bf16 params
        row(f"paged_decode_attn B={B} H={H} ctx={ctx}", dt, kv_bytes)


def bench_lora(quick: bool, device=None):
    """Per-request adapter gather + products, the BGMV op's analog.  Bytes =
    the B gathered [r, d_in] + [d_out, r] adapter blocks (bf16), what a BGMV
    kernel streams."""
    dev = resolve_device(device)
    cfg = ModelConfig(
        arch=Arch.LLAMA, vocab_size=32000, hidden_size=4096,
        intermediate_size=11008, num_layers=1, num_heads=32,
        num_kv_heads=32, head_dim=128,
    )
    gen = torch.Generator(device=dev).manual_seed(3)
    b = 32
    ranks = (16,) if quick else (8, 16, 64)
    for r in ranks:
        lw = init_llama_lora(cfg, capacity=b, rank=r, seed=3, device=dev)
        idx = torch.arange(b, dtype=torch.int32, device=dev)  # a distinct adapter per request
        x = torch.randn((b, 4096), generator=gen, dtype=torch.float32, device=dev)
        dt = bench_op(lambda x_: add_lora(x_, lw.q, idx, layer=0, scale=1.0), [x], iters=50)
        bytes_ = b * r * (4096 + 4096) * 2  # wa + wb bf16 gathers
        row(f"add_lora B={b} r={r} d=4096->4096", dt, bytes_)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", choices=["gemm", "epilogue", "decode", "lora"], default=None)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    if args.only in (None, "gemm"):
        bench_gemm(args.quick, dev)
    if args.only in (None, "epilogue"):
        bench_epilogues(args.quick, dev)
    if args.only in (None, "decode"):
        bench_decode(args.quick, dev)
    if args.only in (None, "lora"):
        bench_lora(args.quick, dev)


if __name__ == "__main__":
    main()
