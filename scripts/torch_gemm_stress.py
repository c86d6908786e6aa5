"""Repeated launches of the K1 family's GEMM kernels on one CUDA card, each
held bit for bit against its plain version:

    python3 scripts/torch_gemm_stress.py [--launches 100]

Planned launches, at the plans ``packed_w4_plan`` makes: K1 on the decode
core at 32 and 64 rows, on the core asked for above 64 rows (the layouts
fault C3 was found in: 64 x 64 blocks at 256 rows, 32 x 64 and 32 x 128 at
128, 16 x 64 at 256), and on the prefill GEMM at 128, 288 and 1,024 rows; K7
at 128 rows; K2 (the core with the ring epilogue) at 64, 96 and 128 rows
(32-row head blocks).  Also the per-rank shapes of tensor parallelism at
tp 2 on Llama-2-7B (o_proj and down to N 2,048, gate/up to N 11,008, qkv to
N 6,144: K1 at 32 and 512 rows, K7 and K2 at the qkv shard) and of expert
parallelism at ep 2 on Mixtral-8x7B (qkv to N 3,072, o_proj to N 2,048; K2
at 16 / 4 heads), whose launch layouts differ from the whole weights'.
Each is launched ``--launches`` times on the same
inputs, and a launch whose outputs are not ``torch.equal`` to the plain
version's counts as differing.  K5 (the W8A16 head, ``w8a16_plan``'s
launches: the Llama-2-7B head at 1, 32, 33, 64 and 65 rows, and a ragged
shape) is held within ``W8A16_RTOL`` of its plain version once, and every
launch bit for bit to the first.  K14a and K14b (the int8-carrier GEMMs on
K1's two kernels in their int8-weight form, ``grouped_int8_plan``'s
launches: 1 to 65 rows and 288 at N 4,096, K14a also at N 11,008 and the
70B down depth) are held bit for bit against their plain versions once, and
every launch bit for bit to the first.  One line per case; exit 1 if any
launch differs.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

HID, INTER = 4096, 11008  # Llama-2-7B
QKV, GATE_UP, O_PROJ = (HID, 3 * HID), (HID, 2 * INTER), (HID, HID)
# K1: (M, (K, N), path, tile_m, tile_n): None plans as packed_w4_gemm does
K1_PLANNED = [(32, QKV, None, None, None), (32, GATE_UP, None, None, None), (64, QKV, None, None, None),
              (64, GATE_UP, None, None, None), (256, QKV, "core", None, None), (128, QKV, "core", 32, 64),
              (128, QKV, "core", 32, 128), (256, QKV, "core", 16, None), (128, QKV, None, None, None),
              (288, GATE_UP, None, None, None), (1024, O_PROJ, None, None, None)]
K2_PLANNED = (64, 96, 128)
# the per-rank shards of TP 2 (Llama-2-7B) and EP 2 (Mixtral-8x7B's attention, 32 / 8 heads): K1 (M, (K, N)),
# K7 (M, n_q, n_kv) and K2 (M, n_q, n_kv)
K1_SHARDS = [(m, kn) for m in (32, 512) for kn in ((HID, HID // 2), (HID, INTER), (INTER, HID // 2), (HID, 3 * HID // 2))]
K1_SHARDS += [(32, (HID, 3072)), (32, (HID, HID // 2))]
K7_SHARDS = [(512, HID // 2, HID // 2), (512, HID // 2, 512)]
K2_SHARDS = [(32, HID // 2, HID // 2), (32, HID // 2, 512)]
VOCAB, HEAD_N = 32000, 32256  # the head padded to whole 64-column tiles
K5_PLANNED = [(m, HID, HEAD_N) for m in (1, 32, 33, 64, 65)] + [(17, 4000, 4160)]
# K14a (M, K, N) and K14b (M, N at K 4,096)
K14A_PLANNED = [(m, HID, HID) for m in (1, 17, 32, 48, 64, 65, 288)] + [(32, HID, INTER), (32, 28672, 1024)]
K14B_PLANNED = [(m, HID) for m in (1, 17, 32, 64, 65, 288)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--launches", type=int, default=100)
    args = ap.parse_args()
    import torch

    from atom_tpu_torch.models.nn import rope_tables
    from atom_tpu_torch.ops import gemm as g8
    from atom_tpu_torch.ops import gemm_packed as gp
    from atom_tpu_torch.ops import gemm_w4a16 as gw

    if not torch.cuda.is_available():
        print("torch_gemm_stress: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev, dtype=torch.int32).to(torch.int8)

    def uniform(lo, hi, shape):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def k1_inputs(m, ktot, n):
        ng = ktot // 128 - 1
        a = torch.cat([randint(-8, 8, (m, ng * 128)), randint(-127, 128, (m, 128))], dim=1)
        return (a, randint(-128, 128, (ng * 64, n)), randint(-127, 128, (128, n)), uniform(0.01, 0.2, (m, ng + 1)),
                uniform(0.001, 0.02, (ng + 1, n)))

    def int8_inputs(m, k, n):
        ng = k // 128
        a = torch.cat([randint(-128, 128, (m, (ng - 1) * 128)), randint(-127, 128, (m, 128))], dim=1)
        return a, randint(-128, 128, (k, n)), uniform(0.01, 0.2, (m, ng)), uniform(0.001, 0.02, (ng, n))

    def same(got, want):
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        bits = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t  # noqa: E731
        return all(torch.equal(bits(g), bits(w)) for g, w in zip(got, want))

    def count(what, launch, want) -> int:
        differ = sum(int(not same(launch(), want)) for _ in range(args.launches))
        print(f"{what}: {differ} of {args.launches} launches differ", flush=True)
        return differ

    def k2_case(m, n_q=HID, n_kv=HID):
        """K2 at a qkv of n_q + 2 n_kv columns on m rows: a launch (ring tensors fresh each time) and the plain
        outputs."""
        h, w = n_kv // 128, 32
        y = (torch.randn((m, HID), generator=gen, device=dev)).to(torch.bfloat16)
        norm_w = uniform(0.5, 1.5, (HID,)).to(torch.bfloat16)
        _, wp, wk, _, sw = k1_inputs(1, HID, n_q + 2 * n_kv)
        cos, sin = rope_tables(torch.arange(m, device=dev) + 100, 128, 10000.0)
        ring = (randint(-128, 128, (m, h, 64, w)), uniform(0.1, 1.0, (m, 4, h, w)).to(torch.bfloat16),
                randint(0, 16, (m, h, w, 128)))

        def run(fn):
            k_codes, prm, v_codes = (t.clone() for t in ring)
            q = fn(y, norm_w, wp, wk, sw, cos, sin, k_codes, prm, v_codes, 7, n_q, n_kv)
            return q, k_codes, prm, v_codes

        return (lambda: run(gp.packed_w4_gemm_qkv_ring_fused)), run(gp.packed_w4_gemm_qkv_ring_fused_plain)

    differ = 0
    for m, (ktot, n), path, tile_m, tile_n in K1_PLANNED:
        ops = k1_inputs(m, ktot, n)
        plan = gp.packed_w4_plan(m, ktot, n, path=path, tile_m=tile_m, tile_n=tile_n)
        differ += count(f"K1 M={m} K={ktot} N={n} {plan.path} {plan.tile_m}x{plan.tile_n} grid {plan.grid}",
                        lambda: gp.packed_w4_gemm_with_plan(*ops, plan), gp.packed_w4_gemm_plain(*ops))
    ops = k1_inputs(128, *QKV)
    cos, sin = rope_tables(torch.arange(128, device=dev), 128, 10000.0)
    differ += count(f"K7 M=128 K={HID} N={3 * HID} under {gp.packed_w4_plan(128, *QKV, path='prefill')}",
                    lambda: gp.packed_w4_gemm_qkv(*ops, cos, sin, HID, HID),
                    gp.packed_w4_gemm_qkv_plain(*ops, cos, sin, HID, HID))
    for m in K2_PLANNED:
        launch, want = k2_case(m)
        differ += count(f"K2 M={m} under {gp.packed_w4_plan(m, *QKV, head=True)}", launch, want)
    for m, (ktot, n) in K1_SHARDS:
        ops = k1_inputs(m, ktot, n)
        plan = gp.packed_w4_plan(m, ktot, n)
        differ += count(f"K1 shard M={m} K={ktot} N={n} {plan.path} {plan.tile_m}x{plan.tile_n} grid {plan.grid}",
                        lambda: gp.packed_w4_gemm_with_plan(*ops, plan), gp.packed_w4_gemm_plain(*ops))
    for m, n_q, n_kv in K7_SHARDS:
        ops = k1_inputs(m, HID, n_q + 2 * n_kv)
        cos, sin = rope_tables(torch.arange(m, device=dev), 128, 10000.0)
        differ += count(f"K7 shard M={m} n_q={n_q} n_kv={n_kv}", lambda: gp.packed_w4_gemm_qkv(*ops, cos, sin, n_q, n_kv),
                        gp.packed_w4_gemm_qkv_plain(*ops, cos, sin, n_q, n_kv))
    for m, n_q, n_kv in K2_SHARDS:
        launch, want = k2_case(m, n_q, n_kv)
        differ += count(f"K2 shard M={m} n_q={n_q} n_kv={n_kv} under "
                        f"{gp.packed_w4_plan(m, HID, n_q + 2 * n_kv, head=True)}", launch, want)
    for m, k, n in K5_PLANNED:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        wq = gw.quantize_w8a16(torch.randn((k, n), generator=gen, device=dev) * 0.02)
        first, want = gw.w8a16_gemm(x, wq), gw.w8a16_gemm_plain(x, wq)
        err, top = (first - want).abs().max().item(), want.abs().max().item()
        print(f"K5 M={m} K={k} N={n}: max |diff| {err} against {gw.W8A16_RTOL} x {top}", flush=True)
        differ += int(err > gw.W8A16_RTOL * top)
        differ += count(f"K5 M={m} K={k} N={n} under {gw.w8a16_plan(m, k, n)}", lambda: gw.w8a16_gemm(x, wq), first)
    for m, k, n in K14A_PLANNED:
        ops = int8_inputs(m, k, n)
        first = g8.grouped_int8_gemm(*ops)
        differ += int(not same(first, g8.grouped_int8_gemm_plain(*ops)))
        differ += count(f"K14a M={m} K={k} N={n} under {g8.grouped_int8_plan(m, k, n)}",
                        lambda: g8.grouped_int8_gemm(*ops), first)
    for m, n in K14B_PLANNED:
        ops = int8_inputs(m, HID, n)
        first = g8.grouped_int8_gemm_o4(*ops)
        differ += int(not same(first, g8.grouped_int8_gemm_o4_plain(*ops)))
        differ += count(f"K14b M={m} K={HID} N={n}", lambda: g8.grouped_int8_gemm_o4(*ops), first)
    print(f"planned launches: {differ} differ", flush=True)
    return int(differ > 0)


if __name__ == "__main__":
    sys.exit(main())
