#!/usr/bin/env python
"""Generate text with the W4A4 engine from a serving export, with the
PyTorch port (port of ``scripts/generate.py``).

Loads the ``ServingParams`` (Llama) or ``MoEServingParams`` (Mixtral)
written by ``python -m atom_tpu_torch.main byte-lm corpus --use_gptq
--export_serving DIR`` (or either package's ``save_serving``), feeds
byte-level prompts through the continuous-batching engine and prints the
generated text.  Runs on the card unless ``--device cpu``.

    python3 scripts/torch_generate.py --serving_dir /tmp/byte_lm_serving \\
        --prompt "The captain stood on the deck" --tokens 160
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--serving_dir", required=True, help="dir written by main.py --export_serving")
    ap.add_argument("--prompt", action="append", default=None, help="repeatable; default: one built-in prompt")
    ap.add_argument("--tokens", type=int, default=160, help="bytes to generate per prompt")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=None, help="torch device (default: the card; cpu runs the plain versions)")
    args = ap.parse_args(argv)

    from atom_tpu_torch.models.configs import Arch
    from atom_tpu_torch.ops.runtime import resolve_device
    from atom_tpu_torch.serving import KvPool, RequestSet, TextGenConfig, TextGenEngine
    from atom_tpu_torch.serving.model import make_serving_state, make_step_fns
    from atom_tpu_torch.serving.moe import make_moe_step_fns
    from atom_tpu_torch.utils import bytetok
    from atom_tpu_torch.utils.checkpoint import load_serving

    dev = resolve_device(args.device)
    params, cfg, spec = load_serving(args.serving_dir, device=dev)
    step_fns = make_moe_step_fns if cfg.arch == Arch.MIXTRAL else make_step_fns
    print(f"loaded {args.serving_dir}: L={cfg.num_layers} d={cfg.hidden_size} "
          f"W{spec.wbits}A{spec.abits} gptq={spec.use_gptq} device={dev}", flush=True)

    prompts = args.prompt or ["The captain stood on the deck and "]
    enc = [bytetok.encode(p) for p in prompts]

    page = 256
    ecfg = TextGenConfig(
        batch_size=args.batch,
        page_size=page,
        max_seq_len=max(len(e) for e in enc) + args.tokens + page,
        prefill_buckets=(128, 256, 512, 1024),
    )
    npages = args.batch * (-(-ecfg.max_seq_len // page)) + ecfg.pool_slack_pages
    pool = KvPool(cfg.num_layers, npages, cfg.num_kv_heads, page, cfg.head_dim)
    state = make_serving_state(cfg.num_layers, npages, args.batch, cfg.num_kv_heads, page, cfg.head_dim, device=dev)
    prefill_fn, decode_fn = step_fns(params, cfg, spec)
    engine = TextGenEngine(ecfg, pool, prefill_fn, decode_fn, state)

    rs = RequestSet(
        np.asarray([len(e) for e in enc], np.int32),
        np.full((len(enc),), args.tokens, np.int32),
        [e.astype(np.int32) for e in enc],
    )
    result = engine.run(rs, record=True)
    print(f"{result['throughput_tok_s']:.1f} tok/s ({result['output_tokens']} bytes generated)\n", flush=True)
    for i, p in enumerate(prompts):
        text = bytetok.decode(result["tokens"][i])
        print(f"--- prompt {i}: {p!r}")
        print(p + text)
        print()
    return result


if __name__ == "__main__":
    main()
