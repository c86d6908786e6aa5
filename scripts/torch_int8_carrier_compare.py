"""The int8-carrier GEMMs (kernels K14a and K14b) timed for the
``atom_tpu_torch`` package of the checkout at ``--root`` (default: this one)
on one CUDA card, so that two checkouts can be compared on the same card:

    python3 scripts/torch_int8_carrier_compare.py [--root DIR] [--out FILE] [--stages] [--sass DIR]

K14a at M 32 and 1,024, N 4,096 and 11,008 (K 4,096), and K14b at M 32 and
1,024, N 4,096, on ``chip_smoke.py``'s operands (``int8_operands``), each
held bit for bit against its plain version, then timed: CUDA events with L2
flushed (``Timer``) and the profiler's device time (``Timer.device``).
``--stages``: K14a also at every block layout the plans take
(``STAGE_SWEEP``: core blocks of 16, 32 and 64 rows, prefill blocks of 64
and 128 rows, the 70B down depth) under each ring depth of ``RING_STAGES``,
and at the 70B down depth in 32-column core tiles (twice the blocks), where
the checkout has them (``grouped_int8_plan``).
``--sass DIR``: ``cuobjdump -sass`` of the built ``gemm_packed`` library of
the checkout at ``DIR`` (run this script on it first, which builds it) and
of this one: each of ``DIR``'s kernel functions matched with this one's
function of the same name, or for ``gemm_core_kernel`` and
``gemm_prefill_kernel`` with the instance of the same template arguments and
the int8 parameter false, and their instruction lines (with encodings) compared.
The yardstick is this checkout's ``chip_smoke.py``, whichever checkout is
measured.  Prints one JSON line (and writes it to ``--out``).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
K14A_SHAPES = [(32, 4096), (32, 11008), (1024, 4096), (1024, 11008)]  # (M, N) at K 4,096
K14B_SHAPES = [(32, 4096), (1024, 4096)]
STAGE_SWEEP = [(1, 4096, 4096), (32, 4096, 4096), (64, 4096, 4096), (32, 11008, 4096), (32, 4096, 11008),
               (64, 4096, 11008), (32, 28672, 1024), (65, 4096, 4096), (288, 4096, 4096), (288, 4096, 11008),
               (288, 28672, 1024), (1024, 4096, 4096), (1024, 4096, 11008)]  # (M, K, N)
RING_STAGES = {"core": (4, 6, 8), "prefill": (3, 4, 6)}


def ring_layouts(g8, m: int, k: int, n: int) -> list:
    """(label, plan) of K14a at one shape under each ring depth of
    ``RING_STAGES`` (the plan's tiles), and at the 70B down depth on the
    core in 32-column tiles at the plan's depth."""
    plan = g8.grouped_int8_plan(m, k, n)
    out = [(f"st{st}", g8.grouped_int8_plan(m, k, n, stages=st)) for st in RING_STAGES[plan.path]]
    if k == 28672 and plan.path == "core":
        out.append((f"st{plan.stages}_tn32", g8.grouped_int8_plan(m, k, n, tile_n=32)))
    return out


def load_chip_smoke():
    """This checkout's chip_smoke.py as a module (not the measured one's)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass_functions(lib: Path) -> dict:
    """{function name: its instruction lines without addresses} of ``lib``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            name = head.group(1)
            funcs[name] = []
        elif name and re.search(r"/\* 0x[0-9a-f]+ \*/", line):
            funcs[name].append(re.sub(r"^\s*/\*[0-9a-f]+\*/", "", line).strip())
    return funcs


def with_int8_off(name: str) -> str:
    """A kernel's mangled name without its anonymous namespace's hash (it
    differs between two builds of the file), a GEMM kernel's with one more
    template argument, bool false (the int8-weight parameter off)."""
    name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", name)
    return re.sub(r"(gemm_(?:core|prefill)_kernelI(?:L[a-z]+\d+E)+)E", r"\1Lb0EE", name)


def compare_sass(parent_lib: Path, lib: Path) -> dict:
    old = sass_functions(parent_lib)
    new = {re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", n): lines for n, lines in sass_functions(lib).items()}
    differing, missing = {}, []
    for name, lines in old.items():
        mine = new.get(with_int8_off(name))
        if mine is None:
            missing.append(name)
        elif mine != lines:
            differing[name] = dict(lines=len(lines), new_lines=len(mine),
                                   lines_differing=sum(a != b for a, b in zip(lines, mine)) + abs(len(lines) - len(mine)))
    matched = {with_int8_off(n) for n in old}
    return dict(parent_lib=str(parent_lib), lib=str(lib), parent_functions=len(old), functions=len(new),
                identical=len(old) - len(differing) - len(missing), differing=differing, missing=missing,
                new_only=sorted(n for n in new if n not in matched))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--out", default=None)
    ap.add_argument("--stages", action="store_true", help="also time K14a under other ring depths")
    ap.add_argument("--sass", default=None, help="compare gemm_packed's SASS with the checkout at this directory")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("torch_int8_carrier_compare: no CUDA card", file=sys.stderr)
        return 1
    import atom_tpu_torch
    from atom_tpu_torch.ops import _build
    from atom_tpu_torch.ops import gemm as g8

    if root not in Path(atom_tpu_torch.__file__).resolve().parents:
        raise SystemExit(f"atom_tpu_torch came from {atom_tpu_torch.__file__}, not from {root}")
    cs = load_chip_smoke()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    timer = cs.Timer(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(14)
    res = dict(root=str(root), card=cs.card_line(), has_plans=hasattr(g8, "grouped_int8_plan"))
    if args.sass:
        parent_libs = sorted(Path(args.sass).resolve().glob("atom_tpu_torch/build/gemm_packed-*.so"),
                             key=lambda p: p.stat().st_mtime)
        cs.require(bool(parent_libs), f"no built gemm_packed library under {args.sass}: run this script there first")
        res["sass"] = compare_sass(parent_libs[-1], _build._lib_path("gemm_packed"))

    def timed(fn, m: int) -> dict:
        ms = timer(fn, n=10 if m > 32 else 25)
        dev_ = timer.device(fn)
        return dict(ms=ms, host_us=timer.host_us, device_us=dev_["us"], device_by_kernel=dev_["by_kernel"])

    for m, n in K14A_SHAPES:
        ops = cs.int8_operands(torch, gen, dev, m, n)
        cs.require(torch.equal(g8.grouped_int8_gemm(*ops), g8.grouped_int8_gemm_plain(*ops)),
                   f"grouped_int8_gemm at M={m}, N={n} is not bitwise its plain version")
        row = res[f"k14a_m{m}_n{n}"] = timed(lambda: g8.grouped_int8_gemm(*ops), m)
        if (m, n) in K14B_SHAPES:
            got, want = g8.grouped_int8_gemm_o4(*ops), g8.grouped_int8_gemm_o4_plain(*ops)
            cs.require(all(torch.equal(x, y) for x, y in zip(got, want)),
                       f"grouped_int8_gemm_o4 at M={m}, N={n}: codes or params differ from its plain version")
            res[f"k14b_m{m}_n{n}"] = timed(lambda: g8.grouped_int8_gemm_o4(*ops), m)
        del ops
        torch.cuda.empty_cache()
    if args.stages and res["has_plans"]:
        for m, k, n in STAGE_SWEEP:
            ops = cs.int8_operands(torch, gen, dev, m, n, k)
            want = g8.grouped_int8_gemm_plain(*ops)
            row = res[f"stages_m{m}_k{k}_n{n}"] = dict(plan=str(g8.grouped_int8_plan(m, k, n)))
            for label, plan in ring_layouts(g8, m, k, n):
                cs.require(torch.equal(g8.grouped_int8_gemm_with_plan(*ops, plan), want),
                           f"grouped_int8_gemm at M={m}, K={k}, N={n} under {plan} is not bitwise its plain version")
                row[label] = dict(timed(lambda: g8.grouped_int8_gemm_with_plan(*ops, plan), m),
                                  plan=f"{plan.path} {plan.tile_m}x{plan.tile_n} st{plan.stages} smem{plan.smem}")
            del ops, want
    res["seconds"] = time.perf_counter() - t0
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
