"""The prefill GEMMs of the ``atom_tpu_torch`` package of the checkout at
``--root`` (default: this one) on one CUDA card, so that two checkouts can
be compared on the same card, and the launch layouts of this one:

    python3 scripts/torch_prefill_gemm.py [--root DIR] [--rows 128,256,288,512,1024]
                                          [--prefill] [--crossover] [--out FILE]

* K1 (``packed_w4_gemm``) at Llama-2-7B's o_proj (4096 -> 4096), gate/up
  (4096 -> 22016) and down (11008 -> 4096), summed, and K7
  (``packed_w4_gemm_qkv``, 4096 -> 12288 with RoPE and the per-head K/V
  codes) at each row count of ``--rows``, each held bit for bit
  (``torch.equal``) against its plain version and timed beside its bound;
* ``--crossover``: K1 at the three shapes and at qkv (4096 -> 12288) under
  each launch the checkout's ``packed_w4_plan(path=..., tile_m=...,
  tile_n=...)`` offers, at 32 to 1,024 rows (the decode core up to 128 rows,
  the prefill GEMM's four tiles at every row count), each checked bit for
  bit, with the layout the plan picks (``planned``);
* ``--prefill``: one 32-layer W4A4 prefill (``prefill_step``, random weights
  from seed 0) at 256 and 1,024 rows alone on the card: wall and device
  time, the profile under ``chiprun_out/``.

The yardstick is this checkout's ``chip_smoke.py``, whichever checkout is
measured: its ``Timer`` (CUDA events, median, the L2 flushed before each
call), its bound (bytes over the HBM rate or int8 operations over the
tensor-core peak), K1's operands and the prefill's profile.  Prints one
JSON line (and writes it to ``--out``).
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


def require_equal(torch, got, want, what: str) -> None:
    """Stop unless ``got`` is bitwise ``want``; say where they differ."""
    if torch.equal(got, want):
        return
    bad = (got != want) & ~(torch.isnan(got) & torch.isnan(want))
    idx = bad.nonzero()
    raise SystemExit(f"{what} is not bitwise its plain version: {idx.shape[0]} of {got.numel()} differ, "
                     f"first at {idx[:8].tolist()}, rows {sorted(set(idx[:, 0].tolist()))[:16]}, "
                     f"columns {sorted(set(idx[:, 1].tolist()))[:16]}, max |diff| {(got - want)[bad].abs().max().item()}")


def gemm_times(cs, torch, gp, timer, gen, dev, rows) -> dict:
    """K1 summed over the three MLP/o_proj shapes and K7, per row count."""
    from atom_tpu_torch.models.nn import rope_tables

    hid, inter = cs.HID, cs.INTER
    res = {}
    for m in rows:
        k1 = dict(ms=0.0, ms_by_shape={})
        nbytes = ops = 0
        for tag, ktot, n in (("o_proj", hid, hid), ("gate_up", hid, 2 * inter), ("down", inter, hid)):
            args = cs.k1_operands(torch, gen, dev, m, ktot, n)
            require_equal(torch, gp.packed_w4_gemm(*args), gp.packed_w4_gemm_plain(*args), f"packed_w4_gemm at M={m} ({tag})")
            ms = timer(lambda: gp.packed_w4_gemm(*args))
            k1["ms"] += ms
            k1["ms_by_shape"][tag] = ms
            b, o = cs.k1_bound(m, ktot, n)
            nbytes, ops = nbytes + b, ops + o
            del args
        k1["bound_ms"], k1["bound_by"] = cs.bound(nbytes, ops, cs.PEAK_INT8_OPS)
        # K7 at the 7B qkv: a [m, 4096] -> 12288 columns, q RoPE'd, K/V per-head codes
        n_q = hid
        a, wp, wk, sa, sw = cs.k1_operands(torch, gen, dev, m, hid, 3 * hid)
        cos, sin = rope_tables(torch.arange(m, device=dev), 128, 10000.0)
        got = gp.packed_w4_gemm_qkv(a, wp, wk, sa, sw, cos, sin, n_q, n_q)
        want = gp.packed_w4_gemm_qkv_plain(a, wp, wk, sa, sw, cos, sin, n_q, n_q)
        if not all(torch.equal(cs.bits(g_), cs.bits(w_)) for g_, w_ in zip(got, want)):
            raise SystemExit(f"packed_w4_gemm_qkv at M={m} is not bitwise its plain version")
        h = n_q // 128
        b7 = (a.numel() + wp.numel() + wk.numel() + 4 * (sa.numel() + sw.numel()) + 2 * 4 * m * 128
              + m * n_q * 2 + 2 * m * h * (128 + 8))
        k7 = dict(ms=timer(lambda: gp.packed_w4_gemm_qkv(a, wp, wk, sa, sw, cos, sin, n_q, n_q)))
        k7["bound_ms"], k7["bound_by"] = cs.bound(b7, 2 * m * 3 * hid * hid, cs.PEAK_INT8_OPS)
        res[str(m)] = dict(k1=k1, k7=k7)
        del a, wp, wk, sa, sw, got, want
        torch.cuda.empty_cache()
        cs.log(f"M={m}: K1 {k1['ms']:.4f} ms (bound {k1['bound_ms']:.4f}), K7 {k7['ms']:.4f} ms "
               f"(bound {k7['bound_ms']:.4f})")
    return res


def crossover(cs, torch, gp, timer, gen, dev) -> dict:
    """K1 under every launch the checkout's plan offers, per shape and row
    count, and the layout the plan picks."""
    import inspect

    if "path" not in inspect.signature(gp.packed_w4_plan).parameters:
        return {"note": "this checkout's packed_w4_plan takes no path"}
    hid, inter = cs.HID, cs.INTER
    res = {}
    layouts = [("core", None, None)] + [("prefill", tm, tn) for tm in (64, 128) for tn in (64, 128)]
    for m in (32, 48, 64, 80, 100, 128, 192, 256, 288, 512, 1024):
        by_m = res.setdefault(str(m), {"planned": {}})
        for tag, ktot, n in (("o_proj", hid, hid), ("gate_up", hid, 2 * inter), ("down", inter, hid), ("qkv", hid, 3 * hid)):
            args = cs.k1_operands(torch, gen, dev, m, ktot, n)
            want = gp.packed_w4_gemm_plain(*args)
            planned = gp.packed_w4_plan(m, ktot, n)
            by_m["planned"][tag] = f"{planned.path} {planned.tile_m}x{planned.tile_n}"
            for path, tm, tn in layouts:
                if path == "core" and m > 128:
                    continue
                try:
                    plan = gp.packed_w4_plan(m, ktot, n, path=path, tile_m=tm, tile_n=tn)
                except ValueError:
                    continue
                t0 = time.perf_counter()
                try:
                    got = gp.packed_w4_gemm_with_plan(*args, plan)
                    torch.cuda.synchronize()
                except Exception:
                    cs.log(f"packed_w4_gemm at M={m} ({tag}) under {plan} failed after {time.perf_counter() - t0:.2f} s")
                    raise
                require_equal(torch, got, want, f"packed_w4_gemm at M={m} ({tag}) under {plan}")
                key = f"{path} {plan.tile_m}x{plan.tile_n}"
                by_m.setdefault(key, {})[tag] = timer(lambda: gp.packed_w4_gemm_with_plan(*args, plan))
            del args, want
        for key, by in by_m.items():
            cs.log(f"crossover M={m} {key:16s} " + " ".join(f"{t}={v if key == 'planned' else round(v, 4)}"
                                                           for t, v in by.items()))
    return res


def prefill_device(cs, torch, dev, tag: str) -> dict:
    """One 32-layer W4A4 prefill alone on the card at 256 and 1024 rows
    (chip_smoke's ``profile_prefill``; the profile in
    ``chiprun_out/prefill_gemm_<tag>_<rows>.txt``)."""
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.models.configs import LLAMA2_7B
    from atom_tpu_torch.serving.model import init_serving_params, make_serving_state

    cfg = LLAMA2_7B.replace(num_layers=32)
    params = init_serving_params(cfg, ATOM_W4A4, seed=0, device=dev)
    state = make_serving_state(cfg.num_layers, 9, 1, cfg.num_kv_heads, cs.PAGE, cfg.head_dim, device=dev)
    return {str(bucket): cs.profile_prefill(torch, dev, params, state, cfg, ATOM_W4A4, bucket,
                                            f"prefill_gemm_{tag}_{bucket}.txt") for bucket in (256, 1024)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--rows", default="128,256,288,512,1024")
    ap.add_argument("--prefill", action="store_true")
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    cs = load_chip_smoke()

    import torch

    if not torch.cuda.is_available():
        print("torch_prefill_gemm: no CUDA card", file=sys.stderr)
        return 1
    import atom_tpu_torch
    from atom_tpu_torch.ops import gemm_packed as gp

    if root not in Path(atom_tpu_torch.__file__).resolve().parents:
        raise SystemExit(f"atom_tpu_torch came from {atom_tpu_torch.__file__}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    timer = cs.Timer(torch, dev)
    res = dict(root=str(root), card=cs.card_line())
    if args.crossover:
        res["crossover"] = crossover(cs, torch, gp, timer, gen, dev)
    res["rows"] = gemm_times(cs, torch, gp, timer, gen, dev, [int(r) for r in args.rows.split(",") if r])
    if args.prefill:
        res["prefill"] = prefill_device(cs, torch, dev, root.name)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
