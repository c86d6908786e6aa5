"""Kernel K12 (``flash_code_attention``) timed at the kernel prefill's shapes,
and the 2-layer kernel-prefill gate read, for the ``atom_tpu_torch`` package
of the checkout at ``--root`` (default: this one) on one CUDA card, so that
two checkouts can be compared on the same card:

    python3 scripts/torch_flash_compare.py [--root DIR] [--prefill] [--out FILE]

K12 is timed on the inputs ``chip_smoke.py`` builds (q of scale 12, K/V from
the asymmetric u4 quantizer, Llama-2-7B heads) at T = 128, 256, 512 and 1,024
(MHA, 32 heads) and GQA 64/8 at 1,024, CUDA events with L2 flushed, each
held to the plain version within ``ATTN_TOL``.  The gate is
``chip_smoke.py``'s ``prefill_kernel_vs_plain`` (one 512-row prefill at 2
layers through K12 against the plain path: the share of page entries that
differ, the share of the prompt's rows whose layer-1 K codes are bitwise
equal).  With ``--prefill``, one 32-layer prefill alone at 256 and 1,024 rows
through K12, its device time by the profiler.  The yardstick is this
checkout's ``chip_smoke.py``, whichever checkout is measured.  Prints one JSON
line (and writes it to ``--out``).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def load_chip_smoke():
    """This checkout's chip_smoke.py as a module (not the measured one's)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--prefill", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("torch_flash_compare: no CUDA card", file=sys.stderr)
        return 1
    import atom_tpu_torch
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.ops import prefill as pf
    from atom_tpu_torch.ops.reference import quantize_kv_asym
    from atom_tpu_torch.serving.model import init_serving_params, make_serving_state, quantize_lm_head

    if root not in Path(atom_tpu_torch.__file__).resolve().parents:
        raise SystemExit(f"atom_tpu_torch came from {atom_tpu_torch.__file__}, not from {root}")
    cs = load_chip_smoke()
    dev = torch.device("cuda")
    timer = cs.Timer(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    t0 = time.perf_counter()

    def normal(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    k12 = {}
    for name, (t, hq, hkv) in {"t128": (128, 32, 32), "t256": (256, 32, 32), "t512": (512, 32, 32),
                               "t1024": (1024, 32, 32), "gqa_64q_8kv_t1024": (1024, 64, 8)}.items():
        q = normal((t, hq, 128), 12.0, torch.bfloat16)
        kq, vq = quantize_kv_asym(normal((t, hkv, 128))), quantize_kv_asym(normal((t, hkv, 128)))
        a = (q, kq.codes, kq.params, vq.codes, vq.params, hq // hkv, 128 ** -0.5)
        got, want = pf.flash_code_attention(*a), pf.flash_code_attention_plain(*a)
        torch.testing.assert_close(got.float(), want.float(), **cs.ATTN_TOL, msg=f"flash_code_attention {name}")
        k12[name] = dict(ms=timer(lambda: pf.flash_code_attention(*a), n=10),
                         max_abs_err=(got.float() - want.float()).abs().max().item())
    res = dict(root=str(root), card=cs.card_line(), flash_code_attention=k12)

    p2 = init_serving_params(cs.llama7b(2), ATOM_W4A4, seed=3, device=dev)
    gate = cs.prefill_kernel_vs_plain(torch, dev, quantize_lm_head(p2))
    res["kernel_prefill_512_gate"] = {k: gate[k] for k in ("token_equal", "page_entries_differing",
                                                           "rows_layer1_k_bitwise_equal")}
    del p2
    torch.cuda.empty_cache()

    if args.prefill:
        cfg = cs.llama7b(32)
        qparams = quantize_lm_head(init_serving_params(cfg, ATOM_W4A4, seed=0, device=dev))
        state = make_serving_state(cfg.num_layers, 8, cs.BATCH, cfg.num_kv_heads, cs.PAGE, cfg.head_dim, device=dev)
        with cs.kernel_prefill():
            res["kernel_prefill_alone"] = {
                bucket: cs.profile_prefill(torch, dev, qparams, state, cfg, ATOM_W4A4, bucket,
                                           f"profile_prefill_kernel_{bucket}_compare.txt")
                for bucket in (256, 1024)}
    res["seconds"] = time.perf_counter() - t0
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
