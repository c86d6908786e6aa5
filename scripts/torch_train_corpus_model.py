#!/usr/bin/env python
"""Train the BYTE_LM accuracy-fixture model on the corpus with the PyTorch
port (``atom_tpu_torch.utils.train``), on one GPU (or ``--device cpu``).

Produces the pretrained checkpoint the real-text ablation ladder quantizes
and evaluates, in the format of ``scripts/train_corpus_model.py``: a
``save_pytree`` npz of float32 carriers holding bf16-rounded values, which
``python -m atom_tpu_torch.main byte-lm corpus --ckpt FILE`` (and the JAX
package's ``main.py``) restore through ``restore_model_params``.

    python3 scripts/torch_train_corpus_model.py --steps 2400 --out data/byte_lm_ckpt.npz
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seqlen", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--chunk", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corpus", default="data/corpus")
    ap.add_argument("--out", default="data/byte_lm_ckpt.npz")
    ap.add_argument("--device", default=None, help="torch device (default: the card; cpu runs on the host)")
    args = ap.parse_args(argv)

    import torch

    from atom_tpu_torch.models import llama as M
    from atom_tpu_torch.models.configs import BYTE_LM
    from atom_tpu_torch.ops.runtime import resolve_device
    from atom_tpu_torch.utils import bytetok
    from atom_tpu_torch.utils.checkpoint import save_pytree
    from atom_tpu_torch.utils.train import eval_loss, train

    cfg = BYTE_LM
    dev = resolve_device(args.device)
    print(f"device: {dev}")
    print(f"BYTE_LM: L={cfg.num_layers} d={cfg.hidden_size} heads={cfg.num_heads}x{cfg.head_dim} vocab={cfg.vocab_size}")

    train_tokens = bytetok.encode_file(os.path.join(args.corpus, "train.txt"))
    eval_tokens = bytetok.encode_file(os.path.join(args.corpus, "eval.txt"))
    print(f"corpus: {len(train_tokens) / 1e6:.1f}M train / {len(eval_tokens) / 1e3:.0f}K eval bytes")

    params = M.init_params(cfg, seed=args.seed, dtype=torch.float32, device=dev)
    n_params = sum(v.numel() for v in [params["embed"], params["final_norm"], params["lm_head"],
                                       *params["layers"].values()])
    print(f"{n_params / 1e6:.1f}M params (fp32 train)")

    t0 = time.time()
    params, final = train(params, cfg, train_tokens, steps=args.steps, batch=args.batch, seqlen=args.seqlen,
                          lr=args.lr, chunk=args.chunk, seed=args.seed)
    print(f"trained {args.steps} steps in {time.time() - t0:.0f}s (final train loss {final:.4f})")

    ev = eval_loss(params, cfg, eval_tokens, args.seqlen)
    print(f"eval: {ev:.4f} nats/byte = {ev / np.log(2):.3f} bits/byte (byte-PPL {np.exp(ev):.3f})")

    save_pytree(args.out, bf16_rounded(params))
    print(f"saved checkpoint to {args.out}")


def bf16_rounded(params):
    """Float leaves rounded through bf16 and kept as float32 carriers (the
    ladder evaluates from reduced-precision weights, as from HF fp16
    checkpoints), the rest as they are, on the host."""
    import torch

    def leaf(v):
        v = v.detach().cpu()
        return v.to(torch.bfloat16).to(torch.float32) if v.dtype == torch.float32 else v

    return {k: ({n: leaf(t) for n, t in v.items()} if isinstance(v, dict) else leaf(v)) for k, v in params.items()}


if __name__ == "__main__":
    main()
