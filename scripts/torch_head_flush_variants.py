"""K5, the W8A16 head (``csrc/gemm_w8a16.cu``), and K4, the ring flush
(``csrc/decode.cu::flush_kernel``), against patched copies of them, on one
CUDA card, to say where their time goes:

    python3 scripts/torch_head_flush_variants.py [--out FILE]

K5's variants change its consumers' pipeline (``NBUF`` fragment buffers,
``AHEAD`` K steps converted ahead of the wgmmas, ``INFLIGHT`` wgmma groups
left pending at a step's wait; the source: 2, 1, 1):

- ``inflight3``: 4 buffers, 3 groups in flight;
- ``ahead2``: 4 buffers, 2 steps ahead, 2 groups in flight;
- ``sink`` / ``inflight3_sink``: each fragment buffer folded into a word once
  its wgmmas are done, stored behind a branch no launch takes (keeps the
  buffers live until then);
- ``convert_only``: the conversion without the wgmmas (with the sink, so that
  it is not optimised away); its outputs are garbage (timing only);
- ``stream_only``: the consumers only wait for and release the TMA stages
  (the weight stream alone); timing only.

Each variant is a patched copy of the checkout's source, built beside the
checkout's source as it is, under ``atom_tpu_torch/build/head_flush_variants/``,
with ptxas's notes where it serialized the wgmmas; the checkout's build is the
yardstick.  K5 runs at the Llama-2-7B head (K 4,096, N 32,256,
``chip_smoke.py``'s inputs) at 1, 32 and 33 rows through each library with the
wrapper's plan (``w8a16_plan``), held to the plain version within
``W8A16_RTOL`` and two launches bit for bit (not the timing-only builds), then
timed by CUDA events (L2 flushed) and by the profiler's device time, the
checkout first and last; the checkout and the stream alone also after an L2
flush that leaves clean lines (a read of 256 MB).  Each variant's SASS opcode
counts (``cuobjdump``) go beside it, and the checkout's SASS of the 32-row
kernel is written out whole (``head_sass_32.txt`` in ``chip_smoke.py``'s output
directory).  One JSON object goes to ``--out`` (default
``head_flush_variants.json`` there).

K4's variants change ``FLUSH_MIN_BLOCKS``, the blocks an SM must hold at once
(its register budget; the source: 8), to 1 and 12.  Each K4 build flushes
``chip_smoke.py``'s flush shape (the live ring, 30 active sequences of 32, 32
kv heads, W 32, page 256), held bit for bit to the checkout's build, timed as
K5 is.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# anchors in gemm_w8a16.cu
PIPE = "constexpr int NBUF = 2, AHEAD = 1, INFLIGHT = 1;"
FOLD_AT = "// shared-memory matrix descriptor"
FOLD = """__device__ __forceinline__ uint32_t fold(const uint32_t (&f)[2][2][4]) {
  uint32_t r = 0;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) r ^= f[t][e][0] ^ f[t][e][1] ^ f[t][e][2] ^ f[t][e][3];
  return r;
}

"""
DECL = "  uint32_t fr[NBUF][2][2][4];\n"
RELEASE = "      if (kk == INFLIGHT - 1 && i > 0) release_stage"
TAIL = "  wgmma_wait<0>();\n  fence_operands(acc0);\n  fence_operands(acc1);\n"
WGMMAS = """      wgmma_fence();
      fence_operands(acc0);
      fence_operands(acc1);
      wgmma_rs<NA>(acc0, cur[0][0], desc, 1);  // a . 16h
      wgmma_rs<NA>(acc0, cur[0][1], desc, 1);  // a . l
      wgmma_rs<NA>(acc1, cur[1][0], desc, 1);
      wgmma_rs<NA>(acc1, cur[1][1], desc, 1);
      wgmma_commit();
      wgmma_wait<INFLIGHT>();  // groups up to this step's INFLIGHT-th before are done
"""
NCH = "  const int nch = (K + KC - 1) / KC;"
CONSUMERS_START = "  if (nch > 0) {\n    mbar_wait(full, 0);"
SINK = [
    (FOLD_AT, FOLD + FOLD_AT),
    (DECL, "  uint32_t fr[NBUF][2][2][4] = {};\n  uint32_t sink = 0;\n"),
    (RELEASE, "      sink ^= fold(nxt);  // its wgmmas are done: from here it may be written\n" + RELEASE),
    (TAIL, TAIL + "#pragma unroll\n  for (int q = 0; q < NBUF; ++q) sink ^= fold(fr[q]);\n"
           "  if (M < 0) out[0] = __uint_as_float(sink);  // no launch has M < 0\n"),
]
INFLIGHT3 = [(PIPE, "constexpr int NBUF = 4, AHEAD = 1, INFLIGHT = 3;")]
VARIANTS = {  # name: (anchor, replacement) patches of gemm_w8a16.cu
    "inflight3": INFLIGHT3,
    "ahead2": [(PIPE, "constexpr int NBUF = 4, AHEAD = 2, INFLIGHT = 2;")],
    "sink": SINK,
    "inflight3_sink": INFLIGHT3 + SINK,
    "convert_only": SINK + [(WGMMAS, "")],
    "stream_only": [(NCH, "  int nch = (K + KC - 1) / KC;"),
                    (CONSUMERS_START, "  for (int i = 0; i < nch; ++i) {\n    mbar_wait(full + i % ST, (i / ST) & 1);\n"
                                      "    release_stage(empty + i % ST, lane);\n  }\n  nch = 0;\n" + CONSUMERS_START)],
}
TIMING_ONLY = ("convert_only", "stream_only")

FLUSH_BLOCKS = "constexpr int FLUSH_MIN_BLOCKS = 8;"
FLUSH_VARIANTS = {  # name: patches of decode.cu
    "k4_min_blocks_1": [(FLUSH_BLOCKS, "constexpr int FLUSH_MIN_BLOCKS = 1;")],  # no register bound
    "k4_min_blocks_12": [(FLUSH_BLOCKS, "constexpr int FLUSH_MIN_BLOCKS = 12;")],
}


def load_module(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variants(stem: str, variants: dict) -> tuple[dict, dict]:
    """``csrc/<stem>.cu`` built as it is ("checkout") and a patched copy of it
    per variant, in parallel -> ({name: .so path or error}, {name: ptxas's
    notes that it serialized the wgmmas, C751x, and why})."""
    from atom_tpu_torch.ops import _build

    src = (_build.CSRC / f"{stem}.cu").read_text()
    out_dir = _build.BUILD / "head_flush_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, result, notes = {}, {}, {}
    for name, patches in {"checkout": [], **variants}.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                result[name] = f"patch anchor {old[:40]!r} found {text.count(old)} times"
                break
            text = text.replace(old, new)
        else:
            cu, so = out_dir / f"{stem}_{name}.cu", out_dir / f"{stem}_{name}.so"
            cu.write_text(text)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        result[name] = str(so) if proc.returncode == 0 else f"nvcc exit {proc.returncode}: {log[-2000:]}"
        notes[name] = [line.split("due to ")[-1].split(" in the function")[0] + " (rows " + line.split("kernelILi")[-1][:2] + ")"
                       for line in log.splitlines() if "C751" in line]
    return result, notes


def entry(path: str):
    fn = ctypes.CDLL(path).atom_gemm_w8a16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flush_variants(torch, cs, timer, clean_flush_ms) -> dict:
    """K4's builds at chip_smoke.py's flush shape: bitwise with the
    checkout's, then timed (events, device time, clean-flush events)."""
    from atom_tpu_torch.ops import _build
    from atom_tpu_torch.ops.kv_layout import KVPages

    dev = torch.device("cuda")
    libs, _ = build_variants("decode", FLUSH_VARIANTS)
    res = dict(builds={k: v if not v.endswith(".so") else "ok" for k, v in libs.items()}, ms={}, device_us={},
               ms_clean_flush={})
    libs = {k: v for k, v in libs.items() if v.endswith(".so")}
    gen = torch.Generator(device=dev).manual_seed(2)
    h, w, row = 32, 32, 5
    pages, hot, table = cs.kv_inputs(torch, gen, dev, cs.BATCH, h, w)
    lens = (cs.CTX - 12 + torch.arange(cs.BATCH, device=dev, dtype=torch.int32)).to(torch.int32)
    fl = (lens - w).to(torch.int32)
    fl[3], fl[7] = lens[3], lens[7]  # inactive
    active = (lens > 0) & (lens > fl)
    page_lo = torch.div(lens - w, cs.PAGE, rounding_mode="floor")
    slot0 = (page_lo * cs.PAGE).to(torch.int32)
    o_lane = (lens - w - slot0).to(torch.int32)
    pick = lambda i: torch.gather(table, 1, i.clamp(0, cs.MAX_PAGES - 1)[:, None].long())[:, 0]  # noqa: E731
    pg_a = torch.where(active & (page_lo >= 0), pick(page_lo), 0).to(torch.int32)
    pg_b = torch.where(active & ((page_lo + 1) * cs.PAGE < lens), pick(page_lo + 1), 0).to(torch.int32)
    book = (pg_a, pg_b, slot0, o_lane, fl, lens)
    fns = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(path).atom_flush_hot
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    def call(fn, p_):
        _build.check(fn(*(t.data_ptr() for t in hot), *(t.data_ptr() for t in book), p_.k_pages.data_ptr(),
                        p_.params.data_ptr(), p_.v_pages.data_ptr(), cs.BATCH, h, cs.PAGE, w, 128, (row + 1) % w,
                        _build.stream()), "flush variant")

    want = None
    for name, fn in fns.items():
        p_ = KVPages(*(t.clone() for t in pages))
        call(fn, p_)
        if want is None:
            want = p_
        for a_, b_ in zip(p_, want):
            cs.require(torch.equal(cs.bits(a_), cs.bits(b_)), f"flush {name} differs from the checkout's build")
    pk = KVPages(*(t.clone() for t in pages))
    for name in ["checkout", *[k for k in fns if k != "checkout"], "checkout"]:
        res["ms"].setdefault(name, []).append(timer(lambda: call(fns[name], pk)))
        res["device_us"].setdefault(name, []).append(timer.device(lambda: call(fns[name], pk))["us"])
        res["ms_clean_flush"].setdefault(name, []).append(clean_flush_ms(lambda: call(fns[name], pk)))
    print(json.dumps({"flush_device_us": res["device_us"]}), flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_head_flush_variants: no CUDA card", file=sys.stderr)
        return 1
    from atom_tpu_torch.ops import _build
    from atom_tpu_torch.ops import gemm_w4a16 as gw

    cs = load_module("chip_smoke", ROOT / "chip_smoke.py")
    cmp = load_module("torch_head_flush_compare", ROOT / "scripts" / "torch_head_flush_compare.py")
    dev = torch.device("cuda")
    _build.build_all()
    libs, notes = build_variants("gemm_w8a16", VARIANTS)
    res = dict(card=cs.card_line(), variants=sorted(VARIANTS), ptxas_serialized=notes,
               builds={k: v if not v.endswith(".so") else "ok" for k, v in libs.items()}, sass={}, ms={}, device_us={})
    libs = {k: v for k, v in libs.items() if v.endswith(".so")}
    for name, path in libs.items():
        res["sass"][name] = cmp.sass_counts(Path(path), "gemm_w8a16_kernel")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", libs["checkout"]], capture_output=True, text=True).stdout
    cs.OUT.mkdir(exist_ok=True)
    part = text[text.find("gemm_w8a16_kernelILi32E"):]
    (cs.OUT / "head_sass_32.txt").write_text(part[: part.find("Function :", 10)] if "Function :" in part[10:] else part)

    timer = cs.Timer(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    head = (torch.randn((cs.HID, cs.HEAD_N), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    head[:, cs.VOCAB:] = 0
    wq = gw.quantize_w8a16(head.to(torch.float32))
    del head
    fns = {name: entry(path) for name, path in libs.items()}

    def call(fn, x):
        m, k = x.shape
        n = wq.codes.shape[1]
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
        plan = gw.w8a16_plan(m, k, n)
        _build.check(fn(x.data_ptr(), wq.codes.data_ptr(), wq.scale.data_ptr(), out.data_ptr(), m, n, k, plan.rows,
                        *plan.grid, _build.stream()), "w8a16 variant")
        return out

    def clean_flush_ms(fn, n=25):
        """Median event time of one call after an L2 flush that reads 256 MB
        (the lines it leaves are clean) where ``Timer`` writes it (dirty
        lines, whose write-back then rides on the call's reads)."""
        for _ in range(3):
            fn()
        times = []
        for _ in range(n):
            timer.l2.sum()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return sorted(times)[n // 2]

    order = ["checkout", *[k for k in fns if k != "checkout"], "checkout"]
    for m in (cs.BATCH, 1, cs.BATCH + 1):
        x = torch.randn((m, cs.HID), generator=gen, device=dev).to(torch.bfloat16)
        want = gw.w8a16_gemm_plain(x, wq)
        top = want.abs().max().item()
        for name, fn in fns.items():
            if name in TIMING_ONLY:
                continue
            got = call(fn, x)
            err = (got - want).abs().max().item()
            cs.require(err <= gw.W8A16_RTOL * top, f"{name} at M={m}: max |diff| {err} beyond {gw.W8A16_RTOL} x {top}")
            cs.require(torch.equal(call(fn, x), got), f"{name} at M={m}: two launches differ")
        for name in order:
            print(f"timing {name} at M={m}", file=sys.stderr, flush=True)
            res["ms"].setdefault(f"m{m}", {}).setdefault(name, []).append(timer(lambda: call(fns[name], x)))
            res["device_us"].setdefault(f"m{m}", {}).setdefault(name, []).append(
                timer.device(lambda: call(fns[name], x))["us"])
        for name in ("checkout", "stream_only", "checkout"):
            res.setdefault("ms_clean_flush", {}).setdefault(f"m{m}", {}).setdefault(name, []).append(
                clean_flush_ms(lambda: call(fns[name], x)))
        print(json.dumps({f"m{m}": {k: res["device_us"][f"m{m}"][k] for k in fns}}), flush=True)
    res["flush"] = flush_variants(torch, cs, timer, clean_flush_ms)
    out = Path(args.out) if args.out else cs.OUT / "head_flush_variants.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
