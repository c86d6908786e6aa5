"""Accuracy-pipeline CLI of the port (``atom_tpu/main.py``).

The same flags, pipeline (calibrate -> reorder -> weight quant -> eval) and
grep-able result lines (``targetResult,<dataset>,<ppl>``, ``INFO <task> :
acc``) as the JAX package's, plus ``--device`` (the card unless ``cpu``):

    python -m atom_tpu_torch.main llama2-7b corpus --layers 8 --reorder --use_gptq \\
        --calib_samples 8 --seqlen 512 --eval_ppl --export_serving /tmp/srv

Model names resolve to built-in geometries (random weights from ``--seed``)
or, with ``--hf_path``, to a local HF checkpoint directory.  Llama, OPT and
Mixtral calibrate and evaluate; ``--export_serving`` covers the two served
architectures, Llama and Mixtral, and refuses OPT before anything runs.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

MODEL_PRESETS = {
    "llama-7b": "LLAMA_7B",
    "llama-13b": "LLAMA_13B",
    "llama-30b": "LLAMA_30B",
    "llama-65b": "LLAMA_65B",
    "llama2-7b": "LLAMA2_7B",
    "llama2-13b": "LLAMA2_13B",
    "llama2-70b": "LLAMA2_70B",
    "opt-125m": "OPT_125M",
    "opt-1.3b": "OPT_1_3B",
    "opt-6.7b": "OPT_6_7B",
    "mixtral-8x7b": "MIXTRAL_8X7B",
    "byte-lm": "BYTE_LM",
    "tiny-llama": "TINY_LLAMA",
    "tiny-llama-gqa": "TINY_LLAMA_GQA",
    "tiny-opt": "TINY_OPT",
    "tiny-mixtral": "TINY_MIXTRAL",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("atom_tpu_torch.main", description="Atom W4A4 quantization + evaluation pipeline")
    p.add_argument("model", choices=sorted(MODEL_PRESETS), help="model geometry")
    p.add_argument("dataset", choices=["wikitext2", "ptb", "c4", "synthetic", "corpus"],
                   help="calibration dataset (corpus = the repository's real-text byte corpus)")
    p.add_argument("--wbits", type=int, default=4)
    p.add_argument("--abits", type=int, default=4)
    p.add_argument("--w_asym", action="store_true")
    p.add_argument("--a_asym", action="store_true")
    p.add_argument("--weight_group_size", type=int, default=128)
    p.add_argument("--act_group_size", type=int, default=128)
    p.add_argument("--weight_channel_group", type=int, default=2)
    p.add_argument("--reorder", action="store_true")
    p.add_argument("--no-reorder", dest="reorder", action="store_false")
    p.add_argument("--act_sort_metric", choices=["hessian", "abs_mean"], default="hessian")
    p.add_argument("--keeper", type=int, default=128)
    p.add_argument("--keeper_precision", type=int, default=3, help="0=float 1=E5M2 2=E4M3 3=INT8")
    p.add_argument("--a_clip_ratio", type=float, default=0.9)
    p.add_argument("--w_clip_ratio", type=float, default=0.85)
    p.add_argument("--kv_clip_ratio", type=float, default=1.0)
    p.add_argument("--kv_cache", action="store_true", default=True)
    p.add_argument("--no-kv_cache", dest="kv_cache", action="store_false")
    p.add_argument("--use_gptq", action="store_true")
    p.add_argument("--percdamp", type=float, default=0.01)
    p.add_argument("--quant_type", choices=["int", "fp"], default="int")
    p.add_argument("--calib_samples", type=int, default=16)
    p.add_argument("--seqlen", type=int, default=0, help="0 = model default")
    p.add_argument("--eval_ppl", action="store_true")
    p.add_argument("--eval_common_sense", action="store_true")
    p.add_argument("--zs_tasks", nargs="*", default=["piqa", "arc_easy", "boolq"],
                   help="zero-shot tasks (+ corpus_cloze; a synthetic stand-in without HF data)")
    p.add_argument("--zs_limit", type=int, default=0)
    p.add_argument("--eval_datasets", nargs="*", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt", type=str, default=None, help="npz checkpoint of the accuracy model's params")
    p.add_argument("--corpus_dir", type=str, default="data/corpus")
    p.add_argument("--hf_path", type=str, default=None, help="local HF checkpoint dir (weights + tokenizer)")
    p.add_argument("--save_dir", type=str, default=None,
                   help="save the calibrated params + reorder indices here")
    p.add_argument("--export_serving", type=str, default=None,
                   help="pack the calibrated model into the serving model's params and save them to this dir "
                        "(Llama, Mixtral; exact code transfer: GPTQ scales are exported, RTN re-packs the "
                        "reordered originals)")
    p.add_argument("--layers", type=int, default=0, help="truncate to N layers (smoke runs)")
    p.add_argument("--device", type=str, default=None, help="torch device (default: the card; cpu runs on the host)")
    return p


def make_spec(args):
    from atom_tpu_torch.config import KeeperPrecision, QuantSpec, QuantType

    return QuantSpec(
        wbits=args.wbits,
        abits=args.abits,
        w_sym=not args.w_asym,
        a_sym=not args.a_asym,
        weight_group_size=args.weight_group_size,
        act_group_size=args.act_group_size,
        weight_channel_group=args.weight_channel_group,
        keeper=args.keeper,
        keeper_precision=KeeperPrecision(args.keeper_precision),
        w_clip_ratio=args.w_clip_ratio,
        a_clip_ratio=args.a_clip_ratio,
        kv_clip_ratio=args.kv_clip_ratio,
        kv_cache=args.kv_cache,
        quant_type=QuantType(args.quant_type),
        reorder=args.reorder,
        act_sort_metric=args.act_sort_metric,
        use_gptq=args.use_gptq,
        percdamp=args.percdamp,
    )


def load_data(args, cfg):
    """(calibration batches, {dataset: test stream}, seqlen), with a
    synthetic fallback when HF data is not available."""
    from atom_tpu_torch.calib import data as D

    seqlen = args.seqlen or min(cfg.max_position_embeddings, 2048)
    eval_sets = args.eval_datasets or [args.dataset]
    if args.dataset == "corpus":
        batches, test = D.corpus_loaders(nsamples=args.calib_samples, seqlen=seqlen, seed=args.seed,
                                         corpus_dir=args.corpus_dir)
        return batches, {name: test for name in eval_sets}, seqlen
    if args.dataset == "synthetic" or args.hf_path is None:
        batches, test = D.synthetic_loaders(cfg.vocab_size, nsamples=args.calib_samples, seqlen=seqlen,
                                            seed=args.seed)
        return batches, {name: test for name in eval_sets}, seqlen
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(args.hf_path)
        batches, _ = D.get_loaders(args.dataset, tok, nsamples=args.calib_samples, seed=args.seed, seqlen=seqlen)
        tests = {}
        for name in eval_sets:
            _, tests[name] = D.get_loaders(name, tok, nsamples=1, seqlen=seqlen)
        return batches, tests, seqlen
    except Exception as e:  # no local cache
        print(f"[warn] HF data unavailable ({e}); synthetic fallback", file=sys.stderr)
        batches, test = D.synthetic_loaders(cfg.vocab_size, nsamples=args.calib_samples, seqlen=seqlen,
                                            seed=args.seed)
        return batches, {name: test for name in eval_sets}, seqlen


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from atom_tpu_torch.calib.pipeline import _model_api, calibrate
    from atom_tpu_torch.models import configs
    from atom_tpu_torch.models.configs import Arch
    from atom_tpu_torch.ops.runtime import resolve_device
    from atom_tpu_torch.utils.eval import perplexity

    dev = resolve_device(args.device)
    cfg = getattr(configs, MODEL_PRESETS[args.model])
    if args.hf_path:
        # the geometry comes from the checkpoint; the preset then only names it
        from atom_tpu_torch.models.hf_loader import config_from_hf

        cfg = config_from_hf(args.hf_path)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    spec = make_spec(args)
    m = _model_api(cfg)
    if args.export_serving and cfg.arch not in (Arch.LLAMA, Arch.MIXTRAL):
        raise SystemExit(f"--export_serving covers the two served architectures (Llama, Mixtral), not "
                         f"{cfg.arch.value}")

    print(f"model={args.model} cfg={cfg.arch.value} L={cfg.num_layers} d={cfg.hidden_size} "
          f"spec: W{spec.wbits}A{spec.abits} g{spec.weight_group_size} keeper={spec.keeper} "
          f"gptq={spec.use_gptq} reorder={spec.reorder} device={dev}", flush=True)

    t0 = time.time()
    if args.hf_path:
        params = m.load_hf_params(args.hf_path, cfg, device=dev)
    elif args.ckpt:
        from atom_tpu_torch.utils.checkpoint import restore_model_params

        full_cfg = getattr(configs, MODEL_PRESETS[args.model])
        params = restore_model_params(args.ckpt, m, full_cfg, args.layers, dev)
    else:
        params = m.init_params(cfg, seed=args.seed, dtype=torch.bfloat16, device=dev)
    print(f"params ready in {time.time() - t0:.1f}s", flush=True)

    batches, tests, seqlen = load_data(args, cfg)

    t0 = time.time()
    # the exact serving export needs the GPTQ grid, or for RTN the reordered originals
    gptq_scales = {} if (args.export_serving and spec.use_gptq) else None
    orig_params = params if (args.export_serving and not spec.use_gptq) else None
    params, indices = calibrate(params, cfg, spec, [torch.from_numpy(b).to(dev) for b in batches],
                                scales_out=gptq_scales)
    print(f"calibration in {time.time() - t0:.1f}s", flush=True)

    if args.save_dir:
        from atom_tpu_torch.utils.checkpoint import save_quantized

        save_quantized(args.save_dir, params, indices, cfg, spec)
        print(f"saved quantized model to {args.save_dir}", flush=True)

    if args.export_serving:
        from atom_tpu_torch.calib.pipeline import reorder_model
        from atom_tpu_torch.models.hf_loader import pack_calibrated_params, pack_calibrated_params_moe
        from atom_tpu_torch.utils.checkpoint import save_serving

        if not (spec.quantize_weights and spec.wbits == 4):
            raise SystemExit(f"--export_serving requires the W4 packed serving scheme (got wbits={spec.wbits}); "
                             "the serving stack takes INT4 bodies + INT8 keepers only")
        orig_reordered = (reorder_model(orig_params, cfg, indices) if orig_params is not None and spec.reorder
                          else orig_params)
        pack = pack_calibrated_params_moe if cfg.arch == Arch.MIXTRAL else pack_calibrated_params
        sp = pack(params, cfg, spec, orig_params=orig_reordered, gptq_scales=gptq_scales)
        save_serving(args.export_serving, sp, cfg, spec)
        print(f"exported serving weights to {args.export_serving}", flush=True)

    if args.eval_ppl:
        for name, stream in tests.items():
            t0 = time.time()
            ppl = perplexity(params, cfg, spec, np.asarray(stream), seqlen=seqlen)
            print(f"eval {name} in {time.time() - t0:.1f}s", flush=True)
            print(f"targetResult,{name},{ppl:.6f}", flush=True)

    if args.eval_common_sense:
        from atom_tpu_torch.utils.zeroshot import (
            corpus_cloze_task,
            evaluate_multiple_choice,
            hf_task_examples,
            synthetic_task,
        )

        def fwd(ids):
            return m.forward(params, ids, cfg, spec)

        tokenizer = None
        if args.hf_path:
            try:
                from transformers import AutoTokenizer

                tokenizer = AutoTokenizer.from_pretrained(args.hf_path)
            except Exception:
                tokenizer = None
        for task in args.zs_tasks:
            try:
                if task == "corpus_cloze":
                    from atom_tpu_torch.calib import data as D

                    _, ev = D.corpus_loaders(nsamples=1, seqlen=256, corpus_dir=args.corpus_dir)
                    examples = corpus_cloze_task(np.asarray(ev), n_examples=args.zs_limit or 64)
                elif tokenizer is None:
                    raise RuntimeError("no tokenizer; synthetic stand-in")
                else:
                    examples = hf_task_examples(task, tokenizer, limit=args.zs_limit)
            except Exception as e:
                print(f"[warn] {task}: {e}", file=sys.stderr)
                examples = synthetic_task(cfg.vocab_size, n_examples=8)
            res = evaluate_multiple_choice(fwd, examples, device=dev)
            print(f"INFO {task} : acc {res['acc']:.4f} (n={res['n']})", flush=True)


if __name__ == "__main__":
    main()
