#!/usr/bin/env python
"""Deployment PPL parity with the PyTorch port (port of
``scripts/serve_byte_lm.py``): the calibrated byte-LM served through the
kernels.

Calibrates the trained byte-LM (W4A4 GPTQ with reorder and KV quantization,
``ATOM_W4A4``), computes the accuracy pipeline's perplexity, exports it with
``pack_calibrated_params`` on the GPTQ scales, and scores the same eval text
through the served prefill (``prefill_hidden`` and the head).  The served
byte-PPL should track the accuracy pipeline's within the rounding of two
implementations.  Runs on the card unless ``--device cpu``.

    python3 scripts/torch_serve_byte_lm.py --ckpt data/byte_lm_ckpt.npz --seqlen 512 --windows 12
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="data/byte_lm_ckpt.npz")
    ap.add_argument("--corpus_dir", default="data/corpus")
    ap.add_argument("--seqlen", type=int, default=512)
    ap.add_argument("--windows", type=int, default=12)
    ap.add_argument("--calib_samples", type=int, default=16)
    ap.add_argument("--layers", type=int, default=0, help="truncate (smoke)")
    ap.add_argument("--page", type=int, default=256)
    ap.add_argument("--device", default=None, help="torch device (default: the card; cpu runs the plain versions)")
    args = ap.parse_args(argv)

    import torch

    from atom_tpu_torch.calib.data import corpus_loaders
    from atom_tpu_torch.calib.pipeline import calibrate
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.models import llama
    from atom_tpu_torch.models.configs import BYTE_LM
    from atom_tpu_torch.models.hf_loader import pack_calibrated_params
    from atom_tpu_torch.ops.runtime import resolve_device
    from atom_tpu_torch.serving.model import _lm_head_logits, make_serving_state, prefill_hidden
    from atom_tpu_torch.utils.checkpoint import restore_model_params
    from atom_tpu_torch.utils.eval import perplexity

    dev = resolve_device(args.device)
    cfg = BYTE_LM
    spec = ATOM_W4A4  # gptq + reorder + kv quant: the ablation ladder's final rung

    params = restore_model_params(args.ckpt, llama, cfg, args.layers, dev)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    batches, test = corpus_loaders(nsamples=args.calib_samples, seqlen=args.seqlen, corpus_dir=args.corpus_dir)
    test = np.asarray(test).reshape(-1)[: args.seqlen * args.windows]
    print(f"byte-LM L={cfg.num_layers} eval={len(test)} tokens ({args.windows} x {args.seqlen}) device={dev}",
          flush=True)

    t0 = time.time()
    scales = {}
    calib, _ = calibrate(params, cfg, spec, [torch.from_numpy(b).to(dev) for b in batches], scales_out=scales)
    calib_s = time.time() - t0
    print(f"calibrated in {calib_s:.0f}s", flush=True)

    t0 = time.time()
    ppl_acc = perplexity(calib, cfg, spec, test, seqlen=args.seqlen, progress=True)
    print(f"accuracy-pipeline PPL in {time.time()-t0:.0f}s", flush=True)

    sp = pack_calibrated_params(calib, cfg, spec, gptq_scales=scales)

    npp = -(-args.seqlen // args.page)
    state = make_serving_state(cfg.num_layers, npp + 1, 1, cfg.num_kv_heads, args.page, cfg.head_dim, device=dev)
    table_row = torch.arange(1, npp + 1, dtype=torch.int32, device=dev)

    def serving_forward(p, ids_b, cfg_, spec_):
        x, _ = prefill_hidden(p, state.pages, ids_b[0], table_row, cfg_, spec_)
        return _lm_head_logits(x, p.lm_head, cfg_.vocab_size)[None]

    t0 = time.time()
    ppl_srv = perplexity(sp, cfg, spec, test, seqlen=args.seqlen, forward=serving_forward, progress=True)
    print(f"served PPL in {time.time()-t0:.0f}s", flush=True)

    delta = ppl_srv - ppl_acc
    print(f"targetResult,corpus_accuracy_pipeline,{ppl_acc:.6f}", flush=True)
    print(f"targetResult,corpus_served_kernels,{ppl_srv:.6f}", flush=True)
    print(f"served-vs-accuracy byte-PPL delta: {delta:+.4f} ({100 * delta / ppl_acc:+.2f}%)", flush=True)
    return dict(ppl_accuracy=ppl_acc, ppl_served=ppl_srv, calibration_s=calib_s)


if __name__ == "__main__":
    main()
