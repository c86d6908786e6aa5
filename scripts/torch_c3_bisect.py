"""Bisect of fault C3 (``ROADMAP.md`` section C) on one CUDA card: K1's decode
core (``csrc/gemm_packed.cu::gemm_core_kernel``) in 32- and 64-row blocks over
more than 64 rows gave outputs that differed from the plain version in some
launches.  The cause: a ring slot given back (``release_slot``) while a
generic-proxy load of it was still in flight, with no proxy fence before the
TMA refilled it.  The checkout has the fence; the variants below take it out.

    python3 scripts/torch_c3_bisect.py [--launches 40] [--sanitizer] [--variants] [--time]
                                       [--out chiprun_out/c3_bisect.json]

1. ``--sanitizer``: ``compute-sanitizer --tool racecheck``, then ``synccheck``,
   on a few launches of one refused layout at a small grid (this script in
   ``--repro`` mode as the child); each tool's last lines are kept.
2. Layouts: each case (M, tile_m, tile_n, stages, ng, N) is launched
   ``--launches`` times on the same inputs against the plain version.  For a
   launch that differs: the blocks (row tile, column tile) and consumer warps
   (16 columns each) with a differing output, whether every row of such a warp
   differs, and which single substitution of one group's weights, weight scales
   or both by another ring round's group (the slot's previous or next
   occupant, ``g -/+ stages``) reproduces the warp's outputs bit for bit.
3. ``--variants``: patched copies of ``gemm_packed.cu``, built beside the
   checkout's, each run 100 times on the two most failing layouts: the
   fence taken out ("no_fence", the fault), and with it taken out one other
   change at a suspect place each.
4. ``--time``: K1 with and without the fence (the checkout against
   "no_fence"), in the order with, without, without, with, on the same card:
   the decode core at M = 32 (o_proj, gate/up, down, qkv), the core at 256
   rows in 64 x 64 blocks and the prefill GEMM at 1,024 rows (gate/up), each
   by ``chip_smoke.py``'s Timer (CUDA events, L2 flushed).

One JSON object with every case goes to ``--out``; one line per case to
stdout.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

HID = 4096
QKV_N = 3 * HID
# (M, tile_m, tile_n, stages, ng, N); stages None = the core's ring (min(ng + 2, 8))
CASES = [
    (64, 64, 64, None, 31, QKV_N), (128, 64, 64, None, 31, QKV_N), (256, 64, 64, None, 31, QKV_N),
    (96, 32, 64, None, 31, QKV_N), (128, 32, 64, None, 31, QKV_N), (256, 32, 64, None, 31, QKV_N),
    (128, 32, 128, None, 31, QKV_N), (256, 32, 128, None, 31, QKV_N), (256, 64, 128, None, 31, QKV_N),
    (256, 16, 64, None, 31, QKV_N), (256, 16, 128, None, 31, QKV_N),
    (256, 64, 64, 3, 31, QKV_N), (256, 64, 64, 4, 31, QKV_N), (256, 64, 64, 16, 31, QKV_N),
    (256, 64, 64, None, 3, QKV_N), (256, 64, 64, None, 7, QKV_N), (256, 64, 64, None, 15, QKV_N),
    (256, 64, 64, None, 31, 1024), (128, 32, 64, None, 31, 1024), (256, 64, 64, None, 31, 4096),
]
REPRO = (128, 32, 64, None, 31, 1024)
NO_FENCE = ("  asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");\n  __syncwarp();\n"
            "  if (lane == 0) mbar_arrive(bar);",
            "  __syncwarp();\n  if (lane == 0) mbar_arrive(bar);")
# name -> [(old, new)], each old found exactly once in gemm_packed.cu; every one without the fence
VARIANTS = {
    "no_fence": [NO_FENCE],
    # the weight-scale load before the slot's products instead of after them
    "no_fence_w2_first": [
        NO_FENCE,
        ("    w2 = *reinterpret_cast<const float2*>(ringS + s * BN + c0);\n", ""),
        ("    const unsigned at = smem_u32(ringA + s * BM * GROUP);\n",
         "    const unsigned at = smem_u32(ringA + s * BM * GROUP);\n"
         "    w2 = *reinterpret_cast<const float2*>(ringS + s * BN + c0);\n"),
    ],
    # one block an SM (the whole shared memory asked for)
    "no_fence_one_block_per_sm": [
        NO_FENCE,
        ("kernel<<<grid, 32 * (1 + pl.tile_n / 16), smem, st>>>(ta, tw, tk, p);",
         "kernel<<<grid, 32 * (1 + pl.tile_n / 16), 232448, st>>>(ta, tw, tk, p);"),
    ],
    # no minimum-blocks hint to ptxas
    "no_fence_no_min_blocks": [
        NO_FENCE,
        ("__global__ void __launch_bounds__(32 * (1 + MAX_CONSUMERS), 1)\ngemm_core_kernel",
         "__global__ void __launch_bounds__(32 * (1 + MAX_CONSUMERS))\ngemm_core_kernel"),
    ],
}
VARIANT_CASES = [(256, 64, 64, None, 31, QKV_N), (128, 32, 64, None, 31, QKV_N)]


def build_variants(names) -> dict:
    """Patched copies of gemm_packed.cu built in parallel -> {name: .so path or error}."""
    from atom_tpu_torch.ops import _build

    src = (_build.CSRC / "gemm_packed.cu").read_text()
    out_dir = _build.BUILD / "c3_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, result = {}, {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                result[name] = f"patch anchor found {text.count(old)} times"
                break
            text = text.replace(old, new)
        else:
            cu = out_dir / f"{name}.cu"
            cu.write_text(text)
            so = out_dir / f"{name}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        result[name] = str(so) if proc.returncode == 0 else f"nvcc exit {proc.returncode}: {log[-2000:]}"
    return result


def use_library(path: str | None) -> None:
    """Route K1's wrapper to the library at ``path`` (None: the checkout's)."""
    from atom_tpu_torch.ops import _build
    from atom_tpu_torch.ops import gemm_packed as gp

    if not hasattr(use_library, "orig"):
        use_library.orig = _build.load
    gp._lib.cache_clear()
    _build.load = use_library.orig if path is None else (
        lambda stem: ctypes.CDLL(path) if stem == "gemm_packed" else use_library.orig(stem))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--launches", type=int, default=40)
    ap.add_argument("--sanitizer", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--repro", action="store_true", help="a few launches of one refused layout (the sanitizer's child)")
    ap.add_argument("--out", default="chiprun_out/c3_bisect.json")
    args = ap.parse_args()
    import torch

    from atom_tpu_torch.ops import gemm_packed as gp

    if not torch.cuda.is_available():
        print("torch_c3_bisect: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the integer dots below are exact only in full float32

    def operands(m, ng, n, seed=0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        ri = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=gen, device=dev,  # noqa: E731
                                                 dtype=torch.int32).to(torch.int8)
        un = lambda lo, hi, shape: torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo  # noqa: E731
        a = torch.cat([ri(-8, 8, (m, ng * 128)), ri(-127, 128, (m, 128))], dim=1)
        return a, ri(-128, 128, (ng * 64, n)), ri(-127, 128, (128, n)), un(0.01, 0.2, (m, ng + 1)), un(0.001, 0.02, (ng + 1, n))

    def plan_of(m, tile_m, tile_n, stages, ng, n):
        stages = stages or min(ng + 2, gp._STAGES)
        return gp.PackedW4Plan("core", tile_m, tile_n, stages, gp.core_smem(tile_m, tile_n, stages, ng, False),
                               (n // tile_n, -(-m // tile_m)))

    if args.repro:
        m, tm, tn, st, ng, n = REPRO
        ops = operands(m, ng, n)
        for _ in range(3):
            gp.packed_w4_gemm_with_plan(*ops, plan_of(m, tm, tn, st, ng, n))
        torch.cuda.synchronize()
        print("repro done")
        return 0

    report = dict(card=torch.cuda.get_device_name(0), launches=args.launches, cases=[], sanitizer={}, variants={},
                  timing={})
    try:
        report["card_line"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                             capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        report["card_line"] = repr(e)
    print(report["card_line"], flush=True)
    out_path = ROOT / args.out
    out_path.parent.mkdir(parents=True, exist_ok=True)

    def save():
        out_path.write_text(json.dumps(report, indent=1))

    if args.sanitizer:
        for tool in ("racecheck", "synccheck"):
            t0 = time.time()
            cmd = ["compute-sanitizer", "--tool", tool, sys.executable, __file__, "--repro"]
            try:
                r = subprocess.run(cmd, capture_output=True, text=True, timeout=150)
                text, rc = (r.stdout + r.stderr)[-3000:], r.returncode
            except FileNotFoundError:
                sanitizer = "/usr/local/cuda/bin/compute-sanitizer"
                try:
                    r = subprocess.run([sanitizer] + cmd[1:], capture_output=True, text=True, timeout=150)
                    text, rc = (r.stdout + r.stderr)[-3000:], r.returncode
                except (OSError, subprocess.SubprocessError) as e:
                    text, rc = repr(e), None
            except subprocess.TimeoutExpired as e:
                text, rc = f"timed out after 150 s: {str(e.stdout)[-1500:]}", None
            report["sanitizer"][tool] = dict(rc=rc, seconds=round(time.time() - t0, 1), tail=text)
            print(f"sanitizer {tool}: rc {rc} in {time.time() - t0:.0f} s; last line: {text.strip().splitlines()[-1:]}",
                  flush=True)
            save()

    def run_case(case, launches, tag=""):
        m, tile_m, tile_n, stages, ng, n = case
        plan = plan_of(*case)
        a, wp, wk, sa, sw = ops = operands(m, ng, n)
        want = gp.packed_w4_gemm_plain(*ops)
        codes = gp.unpack_nibble_planes(wp).to(torch.float32)  # [ng, 128, N]
        ag = a[:, : ng * 128].reshape(m, ng, 128).transpose(0, 1).to(torch.float32)
        acc_k = a[:, ng * 128:].to(torch.float32) @ wk.to(torch.float32)
        keeper = acc_k * sa[:, ng: ng + 1] * sw[ng: ng + 1, :]
        row = dict(case=dict(M=m, tile_m=tile_m, tile_n=tile_n, stages=plan.stages, ng=ng, N=n), grid=list(plan.grid),
                   smem=plan.smem, differ=0, failures=[])
        for li in range(launches):
            got = gp.packed_w4_gemm_with_plan(*ops, plan)
            if torch.equal(got, want):
                continue
            row["differ"] += 1
            if len(row["failures"]) >= 6:
                continue
            bad = (got != want)
            warps = []
            for rt in range(-(-m // tile_m)):
                r0, r1 = rt * tile_m, min(m, (rt + 1) * tile_m)
                blk = bad[r0:r1].reshape(r1 - r0, n // 16, 16).any(dim=2)  # [rows, warp columns]
                for wcol in blk.any(dim=0).nonzero().flatten().tolist():
                    c0 = wcol * 16
                    info = dict(row_tile=rt, m0=r0, col_tile=c0 // tile_n, warp=(c0 % tile_n) // 16,
                                rows_differing=int(blk[:, wcol].sum()), rows=r1 - r0)
                    if len(warps) < 2 and len(row["failures"]) < 2:
                        info["explained_by"] = explain(got[r0:r1, c0:c0 + 16], ag[:, r0:r1], codes[:, :, c0:c0 + 16],
                                                       sa[r0:r1], sw[:, c0:c0 + 16], keeper[r0:r1, c0:c0 + 16], plan.stages)
                    warps.append(info)
            row["failures"].append(dict(launch=li, warps_differing=len(warps), warps=warps[:8]))
        return row

    def explain(got, ag, codes, sa, sw, keeper, stages):
        """Which one substitution of group g's term reproduces ``got`` bit for bit:
        weights and/or weight scales of group g +/- stages (the slot's other occupants)."""
        ng = codes.shape[0]
        terms = torch.stack([(ag[g] @ codes[g]) * sa[:, g: g + 1] * sw[g: g + 1] for g in range(ng)])

        def chain(ts):
            acc = torch.zeros_like(keeper)
            for t in ts:
                acc = acc + t
            return acc + keeper

        found = []
        for g in range(ng):
            for src in (g - stages, g + stages):
                if not 0 <= src < ng:
                    continue
                for what, t in (("weights+scales", (ag[g] @ codes[src]) * sa[:, g: g + 1] * sw[src: src + 1]),
                                ("weights", (ag[g] @ codes[src]) * sa[:, g: g + 1] * sw[g: g + 1]),
                                ("scales", (ag[g] @ codes[g]) * sa[:, g: g + 1] * sw[src: src + 1])):
                    ts = list(terms)
                    ts[g] = t
                    if torch.equal(chain(ts), got):
                        found.append(dict(group=g, slot=g % stages, from_group=src, what=what))
        return found or "no single substitution"

    for case in CASES:
        row = run_case(case, args.launches)
        report["cases"].append(row)
        print(f"{row['case']} grid {row['grid']} smem {row['smem']}: {row['differ']} of {args.launches} differ; "
              f"{json.dumps(row['failures'][:2])[:600]}", flush=True)
        save()

    if args.variants:
        t0 = time.time()
        built = dict(checkout="", **build_variants(VARIANTS))
        print(f"variants built in {time.time() - t0:.0f} s: {built}", flush=True)
        for name, so in built.items():
            if name != "checkout" and not so.endswith(".so"):
                report["variants"][name] = dict(error=so)
                continue
            use_library(so or None)
            rows = []
            for case in VARIANT_CASES:
                r = run_case(case, 100)
                rows.append(dict(case=r["case"], differ=r["differ"], failures=r["failures"][:2]))
                print(f"variant {name} {r['case']}: {r['differ']} of 100 differ", flush=True)
            report["variants"][name] = rows
            use_library(None)
            save()
    if args.time:
        report["timing"] = time_fence(torch, dev, gp, plan_of, operands)
        save()
    save()
    return 0


def time_fence(torch, dev, gp, plan_of, operands) -> dict:
    """K1 with the checkout's fence and without (the "no_fence" variant), in
    the order with, without, without, with -> {library: {case: [ms, ms]}}."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import Timer

    built = build_variants(["no_fence"])
    if not built["no_fence"].endswith(".so"):
        return dict(error=built["no_fence"])
    timer = Timer(torch, dev)
    hid, inter = HID, 11008
    shapes = {"o_proj_m32": (32, hid, hid), "gate_up_m32": (32, hid, 2 * inter), "down_m32": (32, inter, hid),
              "qkv_m32": (32, hid, QKV_N), "core_64x64_m256": (256, hid, QKV_N), "prefill_gate_up_m1024": (1024, hid, 2 * inter)}
    cases = {}
    for name, (m, k, n) in shapes.items():
        ng = k // 128 - 1
        ops = operands(m, ng, n, seed=1)
        plan = plan_of(m, 64, 64, None, ng, n) if name.startswith("core") else gp.packed_w4_plan(m, k, n)
        cases[name] = (ops, plan)
    out = {"with_fence": {}, "without_fence": {}}
    for lib in ("with_fence", "without_fence", "without_fence", "with_fence"):
        use_library(None if lib == "with_fence" else built["no_fence"])
        for name, (ops, plan) in cases.items():
            out[lib].setdefault(name, []).append(timer(lambda: gp.packed_w4_gemm_with_plan(*ops, plan)))
        use_library(None)
    for lib in out:
        out[lib]["decode_m32_summed_ms"] = [sum(out[lib][f"{s}_m32"][i] for s in ("o_proj", "gate_up", "down"))
                                            for i in range(2)]
    print(f"timing (ms): {json.dumps(out)}", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
