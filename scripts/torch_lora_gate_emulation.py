"""How far the 2-layer kernel-vs-plain decode gate of ``chip_smoke.py`` moves
when only attention rounds differently, on the base and the LoRA decode paths.

On the card K3 (``paged_ring_decode_attention``) is the one kernel of these
paths that is not bitwise with its plain version (within ``ATTN_TOL``).  This
script stands in for it on the CPU: the "kernel" path is the plain path with
one bf16 ulp flipped in a share ``--flip`` of the nonzero attention outputs,
and it reads ``chip_smoke.kernel_vs_plain_path``'s numbers (hidden moved >
0.05, max) at Llama-2-7B width, 2 layers, batch 32, for the base decode step,
LoRA over a zero-delta store and LoRA over unit-gain adapters (rank 16, 32
adapters, every sequence its own, as the chip's LoRA phase).  A figure over
the gates' 25% is printed, not raised.

    python3 scripts/torch_lora_gate_emulation.py [--flip 0.0005] [--threads 4]

CPU only (plain versions); ~1 minute a path.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
import atom_tpu_torch.serving.model as sm  # noqa: E402
from atom_tpu_torch.config import ATOM_W4A4  # noqa: E402
from atom_tpu_torch.ops import decode as dec  # noqa: E402
from atom_tpu_torch.serving.lora import init_llama_lora  # noqa: E402
from atom_tpu_torch.serving.model import init_serving_params, quantize_lm_head  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--flip", type=float, default=0.0005, help="share of nonzero attention outputs moved one bf16 ulp")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    dev = torch.device("cpu")
    cs.zero_counts = lambda: None  # no kernel launches on the CPU
    torch.cuda.synchronize = lambda *a, **k: None  # nor a device to wait for
    cs.read_counts = lambda: dict.fromkeys(cs.counters(), 0)
    cfg = cs.llama7b(2)
    params = quantize_lm_head(init_serving_params(cfg, ATOM_W4A4, seed=0, device=dev))
    gen = torch.Generator().manual_seed(1)

    def attention_one_ulp_off(*a):
        out = dec.paged_ring_decode_attention_plain(*a)
        bits = out.view(torch.int16)
        flip = (torch.rand(out.shape, generator=gen) < args.flip) & (out != 0)
        step = torch.where(torch.rand(out.shape, generator=gen) < 0.5, 1, -1).to(torch.int16)
        return torch.where(flip, bits + step, bits).view(torch.bfloat16)

    sm.paged_ring_decode_attention = attention_one_ulp_off  # plain_path() swaps the plain version back in
    stores = {"zero_delta_lora": init_llama_lora(cfg, cs.LORA_CAPACITY, cs.LORA_RANK, seed=0, device=dev, zero_b=True),
              "unit_gain_lora": init_llama_lora(cfg, cs.LORA_CAPACITY, cs.LORA_RANK, seed=0, device=dev)}
    for name in ("base", *stores):
        hidden_fn = None if name == "base" else cs.lora_hidden_fn(torch, dev, stores[name])
        try:
            res = cs.kernel_vs_plain_path(torch, dev, params, cs.BATCH, ATOM_W4A4, params.lm_head, (), cfg=cfg,
                                          hidden_fn=hidden_fn)
            print(f"{name}: {res['moved_gt_0p05']:.4%} of hidden moved > 0.05, max {res['max_abs']:.4f}", flush=True)
        except cs.SmokeError as e:
            print(f"{name}: {e}", flush=True)


if __name__ == "__main__":
    main()
