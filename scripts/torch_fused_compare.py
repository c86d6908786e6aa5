"""The fused post-attention half (kernels K9 and K10) timed alone and in the
32-layer fused decode burst, for the ``atom_tpu_torch`` package of the
checkout at ``--root`` (default: this one) on one CUDA card, so that two
checkouts can be compared on the same card:

    python3 scripts/torch_fused_compare.py [--root DIR] [--out FILE]

K9 at o_proj's shape and K10 at the Llama-2-7B MLP, 32 rows, on the inputs
``chip_smoke.py`` builds: each on a gathered input, as ``index_select`` then
the kernel (the burst's call before the gather moved into the prologue) and,
where the checkout's wrappers take ``reorder``, on the ungathered input with
the index; CUDA events with L2 flushed and the profiler's device time (the
event interval holds the wrappers' host time where it passes the flush's),
each form measured, then again in reverse order.  Then the 32-layer W4A4
decode burst (batch 32, context 512, W8A16 head) with
``ATOM_TPU_FUSED_MLP=1``: one ring window under the
profiler, its device time, kernels and the K1 family's kernels and the
reorder gathers a step (``chip_smoke.py``'s ``profile_decode``).  The
yardstick is this checkout's ``chip_smoke.py``, whichever checkout is
measured.  Prints one JSON line (and writes it to ``--out``).
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import statistics
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
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("torch_fused_compare: no CUDA card", file=sys.stderr)
        return 1
    import atom_tpu_torch
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.numerics import rms_rstd
    from atom_tpu_torch.ops import gemm_packed as gp
    from atom_tpu_torch.ops import mlp
    from atom_tpu_torch.serving.model import (
        _rand_packed, decode_burst, init_serving_params, make_serving_state, quantize_lm_head)

    if root not in Path(atom_tpu_torch.__file__).resolve().parents:
        raise SystemExit(f"atom_tpu_torch came from {atom_tpu_torch.__file__}, not from {root}")
    cs = load_chip_smoke()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    timer = cs.Timer(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    t0 = time.perf_counter()
    spec, hid, inter, batch = ATOM_W4A4, cs.HID, cs.INTER, cs.BATCH

    wo = _rand_packed(gen, hid, hid, spec, dev)
    gu = _rand_packed(gen, hid, 2 * inter, spec, dev)
    dn = _rand_packed(gen, inter, hid, spec, dev)
    y = (torch.randn((batch, hid), generator=gen, device=dev)).to(torch.bfloat16)
    resid = (torch.randn((batch, hid), generator=gen, device=dev)).to(torch.bfloat16)
    norm_w = (torch.rand((hid,), generator=gen, device=dev) * 0.6 + 0.7).to(torch.bfloat16)
    rstd = rms_rstd(y)
    perm = torch.argsort(torch.rand(hid, generator=gen, device=dev)).to(torch.int32)
    q = dict(abits=spec.abits, a_clip=spec.a_clip_ratio)
    takes_reorder = "reorder" in inspect.signature(mlp.fused_mlp_packed).parameters

    forms = {
        "k9_ms": lambda: gp.packed_w4_gemm_fused_in(y, wo, resid=resid, **q),
        "k9_index_select_then_kernel_ms": lambda: gp.packed_w4_gemm_fused_in(
            torch.index_select(y, -1, perm), wo, resid=resid, **q),
        "k10_ms": lambda: mlp.fused_mlp_packed(y, resid, gu, dn, norm_w=norm_w, rstd=rstd, **q),
        "k10_index_select_then_kernel_ms": lambda: mlp.fused_mlp_packed(
            torch.index_select(y, -1, perm), resid, gu, dn, norm_w=norm_w, rstd=rstd, **q),
    }
    if takes_reorder:
        forms["k9_reorder_ms"] = lambda: gp.packed_w4_gemm_fused_in(y, wo, resid=resid, reorder=perm, **q)
        forms["k10_reorder_ms"] = lambda: mlp.fused_mlp_packed(y, resid, gu, dn, norm_w=norm_w, rstd=rstd,
                                                                reorder=perm, **q)
        for name in ("k9", "k10"):  # the index read in the prologue changes nothing, bit for bit
            got, want = forms[f"{name}_reorder_ms"](), forms[f"{name}_index_select_then_kernel_ms"]()
            cs.require(torch.equal(cs.bits(got), cs.bits(want)), f"{name} with reorder differs from index_select + {name}")
    times = {k: [] for k in forms}
    device = {k: [] for k in forms}
    for order in (list(forms), list(forms)[::-1]):
        for k in order:
            times[k].append(timer(forms[k]))
            device[k].append(timer.device(forms[k]))
    res = dict(root=str(root), card=cs.card_line(), takes_reorder=takes_reorder,
               **{k: statistics.median(v) for k, v in times.items()}, times_both_orders=times,
               device_us={k.replace("_ms", "", 1): [d["us"] for d in v] for k, v in device.items()},
               device_by_kernel={k.replace("_ms", "", 1): v[0]["by_kernel"] for k, v in device.items()})
    del wo, gu, dn
    torch.cuda.empty_cache()

    cfg = cs.llama7b(32)
    qparams = quantize_lm_head(init_serving_params(cfg, spec, seed=0, device=dev))
    n_pages = batch * cs.MAX_PAGES + 1
    table = (1 + torch.arange(batch * cs.MAX_PAGES, device=dev, dtype=torch.int32)).reshape(batch, cs.MAX_PAGES)
    state = make_serving_state(cfg.num_layers, n_pages, batch, cfg.num_kv_heads, cs.PAGE, cfg.head_dim, device=dev)
    full = lambda v: torch.full((batch,), v, dtype=torch.int32, device=dev)  # noqa: E731
    state = state._replace(flushed=full(cs.CTX))
    ids = torch.ones((batch,), dtype=torch.int32, device=dev)
    w = state.hot[0].window
    with cs.fused_flag():
        ids, state, _ = decode_burst(qparams, state, ids, table, full(cs.CTX), 1, cfg, spec)  # warm-up window
        torch.cuda.synchronize()
        device_ms, kernels, _, _, family = cs.profile_decode(torch, qparams, state, ids, table, full, cfg, spec, w,
                                                             f"profile_fused_compare_{root.name}.txt")
    res["fused_burst"] = dict(device_ms_per_step=device_ms, kernels_per_step=kernels, k1_family_and_gathers=family)
    res["seconds"] = time.perf_counter() - t0
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
