"""K10's gate/up launch with the SiLU-quant epilogue (``csrc/gemm_packed.cu``,
``gemm_core_kernel<NT, EPI_SILU_QUANT, ..>``) against patched copies of it, on
one CUDA card, to say where its time goes:

    python3 scripts/torch_fused_variants.py [--rounds 2] [--out FILE]

Variants (patched copies of ``gemm_packed.cu``, built beside the checkout's):

- ``no_l2_promotion`` / ``l2_promotion_256``: the paired 3D tensor maps
  without L2 promotion, or promoting 256 bytes (the checkout: 128);
- ``loop_only``: the epilogue cut after the f32 tile is stored (no SiLU, no
  cluster barrier, no quantization): the paired main loop under the cluster
  launch; its act codes are garbage (timing only);
- ``loop_only_no_cluster``: the same, launched without clusters.

K10 runs at 32 rows at the Llama-2-7B MLP (``chip_smoke.py``'s inputs), in
its three-launch form and its four-launch form (``path=FOUR_LAUNCH``: the
gate/up GEMM into f32 and the SiLU launch, the yardstick); each kernel's
device time per call by ``chip_smoke.py``'s ``Timer.device`` (the profiler,
L2 flushed before each call), the checkout first and last in each round.
The checkout and the promotion variants are held bit for bit to the
four-launch form.  One JSON object goes to ``--out`` (default
``fused_variants.json`` in ``chip_smoke.py``'s output directory), one line
per run to stdout.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PROMOTION = "CU_TENSOR_MAP_L2_PROMOTION_L2_128B"
CUT = "    const int ct = tid - 32, tpr = 2 * BN / BM"
PRODUCER_BARRIER = "      cg::this_cluster().sync();\n"
CLUSTER_DIM = "attr[0].val.clusterDim.x = 2 * GROUP / pl.tile_n;"
VARIANTS = {
    "no_l2_promotion": [(PROMOTION, "CU_TENSOR_MAP_L2_PROMOTION_NONE")],
    "l2_promotion_256": [(PROMOTION, "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")],
    "loop_only": [(CUT, "    return;\n" + CUT), (PRODUCER_BARRIER, "")],
    "loop_only_no_cluster": [(CUT, "    return;\n" + CUT), (PRODUCER_BARRIER, ""),
                             (CLUSTER_DIM, "attr[0].val.clusterDim.x = 1;")],
}
EXACT = ("no_l2_promotion", "l2_promotion_256")  # the variants whose results must not change


def build_variants() -> dict:
    """Patched copies of gemm_packed.cu built in parallel -> {name: .so path or error}."""
    from atom_tpu_torch.ops import _build

    src = (_build.CSRC / "gemm_packed.cu").read_text()
    out_dir = _build.BUILD / "fused_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, result = {}, {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                result[name] = f"patch anchor found {text.count(old)} times"
                break
            text = text.replace(old, new)
        else:
            cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
            cu.write_text(text)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        result[name] = str(so) if proc.returncode == 0 else f"nvcc exit {proc.returncode}: {log[-2000:]}"
    return result


def use_library(path: str | None) -> None:
    """Route the K1 family's wrappers to the library at ``path`` (None: the checkout's)."""
    from atom_tpu_torch.ops import _build
    from atom_tpu_torch.ops import gemm_packed as gp

    if not hasattr(use_library, "orig"):
        use_library.orig = _build.load
    gp._lib.cache_clear()
    _build.load = use_library.orig if path is None else (
        lambda stem: ctypes.CDLL(path) if stem == "gemm_packed" else use_library.orig(stem))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_fused_variants: no CUDA card", file=sys.stderr)
        return 1
    from atom_tpu_torch.config import ATOM_W4A4
    from atom_tpu_torch.numerics import rms_rstd
    from atom_tpu_torch.ops import _build, mlp
    from atom_tpu_torch.serving.model import _rand_packed

    spec_ = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(cs)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    built = build_variants()
    timer = cs.Timer(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    spec = ATOM_W4A4
    gu = _rand_packed(gen, cs.HID, 2 * cs.INTER, spec, dev)
    dn = _rand_packed(gen, cs.INTER, cs.HID, spec, dev)
    y = torch.randn((cs.BATCH, cs.HID), generator=gen, device=dev).to(torch.bfloat16)
    resid = torch.randn((cs.BATCH, cs.HID), generator=gen, device=dev).to(torch.bfloat16)
    norm_w = (torch.rand((cs.HID,), generator=gen, device=dev) * 0.6 + 0.7).to(torch.bfloat16)
    kw = dict(norm_w=norm_w, rstd=rms_rstd(y), abits=spec.abits, a_clip=spec.a_clip_ratio)
    out = Path(args.out) if args.out else cs.OUT / "fused_variants.json"
    report = dict(card=cs.card_line(), built=built, runs=[])
    for _ in range(args.rounds):
        for name in ("checkout", *VARIANTS, "checkout"):
            if name != "checkout" and not built[name].endswith(".so"):
                continue
            use_library(None if name == "checkout" else built[name])
            three = mlp.fused_mlp_packed_stages(y, resid, gu, dn, **kw)
            four = mlp.fused_mlp_packed_stages(y, resid, gu, dn, path=mlp.FOUR_LAUNCH, **kw)
            run = dict(variant=name, bitwise_with_four_launch=all(
                torch.equal(cs.bits(a), cs.bits(b)) for a, b in zip(three, four)))
            if name == "checkout" or name in EXACT:
                cs.require(run["bitwise_with_four_launch"], f"{name}: the three-launch form differs from the four-launch form")
            for form, fn in (("three_launch", lambda: mlp.fused_mlp_packed_stages(y, resid, gu, dn, **kw)),
                             ("four_launch", lambda: mlp.fused_mlp_packed_stages(y, resid, gu, dn,
                                                                                 path=mlp.FOUR_LAUNCH, **kw))):
                d = timer.device(fn, n=40)
                run[form] = dict(us=d["us"], by_kernel=d["by_kernel"])
            report["runs"].append(run)
            print(json.dumps(run), flush=True)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
