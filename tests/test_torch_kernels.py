"""The port's kernels K1-K4, through their CPU (plain PyTorch) versions, held
against the JAX package's Pallas kernels in interpret mode on shared inputs.

The CUDA kernels themselves are held against these same plain versions on
the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu.numerics import rms_rstd as j_rms_rstd
from atom_tpu.ops.kv_hot import HotKV as JHot
from atom_tpu.ops.kv_hot import hot_flush_blocks as j_hot_flush_blocks
from atom_tpu.ops.kv_layout import KVPages as JPages
from atom_tpu.ops.pallas_decode import flush_hot_pallas, paged_ring_decode_attention as j_attn
from atom_tpu.ops.pallas_gemm_packed import packed_w4_gemm as j_gemm
from atom_tpu.ops.pallas_gemm_packed import packed_w4_gemm_qkv_ring_fused as j_qkv
from atom_tpu_torch.ops.decode import flush_hot, paged_ring_decode_attention as t_attn
from atom_tpu_torch.ops.gemm_packed import packed_w4_gemm as t_gemm
from atom_tpu_torch.ops.gemm_packed import packed_w4_gemm_qkv_ring_fused as t_qkv
from atom_tpu_torch.ops.kv_hot import HotKV as THot
from atom_tpu_torch.ops.kv_hot import hot_flush_blocks as t_hot_flush_blocks
from atom_tpu_torch.ops.kv_layout import KVPages as TPages
from atom_tpu_torch.serving.convert import tensor_from_numpy
from test_torch_serving import cap_torch_threads

cap_torch_threads()


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _tbits(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _bf16(rng, shape, scale=1.0, lo=None):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    if lo is not None:
        x = rng.uniform(lo, scale, shape).astype(np.float32)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16))


def _gemm_inputs(rng, m, ktot, n):
    ng = ktot // 128 - 1
    a = np.concatenate(
        [rng.integers(-8, 8, (m, ng * 128)), rng.integers(-127, 128, (m, 128))], axis=1
    ).astype(np.int8)
    wp = rng.integers(-128, 128, (ng * 64, n)).astype(np.int8)
    wk = rng.integers(-127, 128, (128, n)).astype(np.int8)
    sa = rng.uniform(0.01, 0.2, (m, ng + 1)).astype(np.float32)
    sw = rng.uniform(0.001, 0.02, (ng + 1, n)).astype(np.float32)
    return a, wp, wk, sa, sw


@pytest.mark.parametrize(
    "m,ktot,n",
    [(32, 256, 384), (32, 640, 256), (32, 1152, 640), (32, 15488, 256), (160, 640, 256)],
    ids=["256-384", "640-256", "1152-640", "15488-256", "m160-640-256"],
)
def test_packed_w4_gemm_matches_pallas(m, ktot, n):
    """K1 at M=32 with ng from 1 to 8 and N not a multiple of 512, and at
    ng = 120, past the 112 groups above which the TPU kernel sums K-blocked
    (partials of 16 groups, the keeper before the last; one serial chain
    puts 5 of these outputs outside the tolerance); and at a prefill M of
    160 rows, where the TPU kernel takes its scratch body (M > 64) and the
    port its prefill GEMM.
    rtol 1e-5: both sum the f32 group terms in the same order; only XLA's
    choice to fuse a multiply-add could move the last bit."""
    rng = np.random.default_rng(ktot + n + m - 32)
    args = _gemm_inputs(rng, m, ktot, n)
    want = np.asarray(j_gemm(*(jnp.asarray(x) for x in args), interpret=True))
    got = t_gemm(*(_t(x) for x in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _ring(rng, b, h, w, d=128):
    return (
        rng.integers(-128, 128, (b, h, d // 2, w)).astype(np.int8),
        _bf16(rng, (b, 4, h, w), 0.1, lo=0.01),
        rng.integers(0, 16, (b, h, w, d)).astype(np.int8),
    )


def test_quant_prologue_matches_jax_chain_bitwise():
    """K2's prologue (pinned bf16 roundings of the norm, then dual-path
    quantization) against the JAX package's eager op chain: codes and scales
    bitwise."""
    from atom_tpu.config import ATOM_W4A4
    from atom_tpu.ops.formats import quantize_activation_packed
    from atom_tpu_torch.ops.gemm_packed import quant_prologue_plain

    rng = np.random.default_rng(3)
    y = _bf16(rng, (32, 640), 1.5)
    norm_w = _bf16(rng, (640,), 1.3, lo=0.7)
    rstd = np.asarray(j_rms_rstd(jnp.asarray(y)))
    xn = (jnp.asarray(y).astype(jnp.float32) * rstd).astype(jnp.bfloat16)
    qa = quantize_activation_packed(xn * jnp.asarray(norm_w), ATOM_W4A4)
    a, sa = quant_prologue_plain(_t(y), _t(norm_w), _t(rstd), 4, ATOM_W4A4.a_clip_ratio)
    np.testing.assert_array_equal(a.numpy(), np.concatenate([qa.body, qa.keeper], 1))
    np.testing.assert_array_equal(sa.numpy(), np.concatenate([qa.body_scale, qa.keeper_scale], 1))


@pytest.mark.parametrize("heads,kv_heads,row", [(4, 4, 5), (8, 4, 31)])
def test_qkv_ring_fused_matches_pallas(heads, kv_heads, row):
    """K2 against the Pallas kernel in interpret mode.

    Jitted on the CPU, that kernel computes its quantizer scales through a
    reciprocal multiply, 1 ulp off its own eager chain for about two thirds
    of the scales, which flips about 0.02% of the activation codes; the port
    follows the eager chain bitwise (previous test).  One flipped activation
    code moves every q, K and V of its row by up to a code step times the
    weights.  So: q within 1 bf16 ulp in at least 75% of the rows (measured:
    29 of 32) and within 0.25 (two code steps at these scales) everywhere;
    in the rows within 1 ulp the ring bytes and params are bitwise but for at
    most 0.1% quantizer flips (measured: none); in the other rows at most 5%
    of the ring codes (measured: under 1%) and 25% of the bf16 scales
    (measured: 12.5%, 1-ulp moves) differ.  Untouched ring columns identical.
    """
    rng = np.random.default_rng(heads * 100 + row)
    m, k, w = 32, 512, 32
    n_q, n_kv = heads * 128, kv_heads * 128
    y = _bf16(rng, (m, k), 1.5)
    norm_w = _bf16(rng, (k,), 1.3, lo=0.7)
    _, wp, wk, _, sw = _gemm_inputs(rng, m, k, n_q + 2 * n_kv)
    pos = rng.integers(0, 1000, m)
    ang = pos[:, None] * (1.0 / 10000 ** (np.arange(64) / 64))[None]
    ang = np.concatenate([ang, ang], 1)
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    rstd = np.asarray(j_rms_rstd(jnp.asarray(y)))
    ring = _ring(rng, m, kv_heads, w)

    jq, jkc, jprm, jvc = j_qkv(
        jnp.asarray(y), jnp.asarray(norm_w), jnp.asarray(wp), jnp.asarray(wk), jnp.asarray(sw),
        jnp.asarray(cos), jnp.asarray(sin), *(jnp.asarray(r.copy()) for r in ring), row,
        n_q=n_q, n_kv=n_kv, abits=4, a_clip=0.9, rstd=jnp.asarray(rstd), interpret=True,
    )
    tring = [_t(r) for r in ring]
    tq = t_qkv(
        _t(y), _t(norm_w), _t(wp), _t(wk), _t(sw), _t(cos), _t(sin), *tring, row,
        n_q=n_q, n_kv=n_kv, abits=4, a_clip=0.9, rstd=_t(rstd),
    )
    qj = np.asarray(jq, np.float32)
    qd = np.abs(tq.to(torch.float32).numpy() - qj)
    flip_rows = (qd > np.abs(qj) * 2**-7 + 1e-6).any(axis=1)
    assert flip_rows.mean() <= 0.25, f"{flip_rows.mean():.2%} of rows beyond 1 bf16 ulp"
    assert qd.max() <= 0.25, f"max |dq| {qd.max()}"

    for i, (want, got, axis) in enumerate(((jkc, tring[0], 3), (jprm, tring[1], 3), (jvc, tring[2], 2))):
        want, got = _bits(want), _tbits(got)
        other = [c for c in range(w) if c != row]
        np.testing.assert_array_equal(np.take(got, other, axis), np.take(_bits(ring[i]), other, axis))
        col_w, col_g = np.take(want, row, axis), np.take(got, row, axis)
        same = col_w[~flip_rows] == col_g[~flip_rows]
        assert 1 - same.mean() <= 1e-3, f"ring {i}: {1 - same.mean():.4%} of entries differ"
        moved = np.mean(col_w[flip_rows] != col_g[flip_rows]) if flip_rows.any() else 0.0
        assert moved <= (0.25 if i == 1 else 0.05), f"ring {i}: {moved:.2%} of flip-row entries differ"


def _pages(rng, n_pages, h, s, d=128):
    return (
        rng.integers(-128, 128, (n_pages, h, d // 2, s)).astype(np.int8),
        rng.integers(-128, 128, (n_pages, h, s // 2, d)).astype(np.int8),
        _bf16(rng, (n_pages, 4, h, s), 0.1, lo=0.01),
    )


@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (8, 4)])
def test_paged_ring_decode_attention_matches_pallas(heads, kv_heads):
    """K3, MHA and GQA: wrapped ring, n_hot from 0 to W, empty / partial /
    full pages.  atol = rtol = 2e-2 on the bf16 output: the f32 softmax runs in
    another order (one pass here, online over ring then pages there)."""
    rng = np.random.default_rng(heads)
    b, s, w, max_pages = 8, 256, 32, 3
    kp, vp, prm = _pages(rng, 1 + b * max_pages, kv_heads, s)
    # k_zero rows: negative-ish offsets like real codes' zero_val
    prm[:, 1] = np.asarray(jnp.asarray(-7.5 * np.asarray(prm[:, 0], np.float32)).astype(jnp.bfloat16))
    prm[:, 3] = np.asarray(jnp.asarray(-7.5 * np.asarray(prm[:, 2], np.float32)).astype(jnp.bfloat16))
    table = (1 + np.arange(b * max_pages).reshape(b, max_pages)).astype(np.int32)
    seq_lens = np.array([0, 0, 255, 256, 257, 600, 768, 1], np.int32)
    n_hot = np.array([5, 0, 32, 1, 17, 31, 32, 9], np.int32)
    row = 7  # rings have wrapped: valid columns run backwards from row through W-1
    ring = _ring(rng, b, kv_heads, w)
    q = _bf16(rng, (b, heads, 128), 1.0)

    want = j_attn(
        jnp.asarray(q), JPages(*(jnp.asarray(x) for x in (kp, vp, prm))), jnp.asarray(table),
        jnp.asarray(seq_lens), JHot(*(jnp.asarray(x) for x in ring)), jnp.asarray(n_hot),
        jnp.int32(row), interpret=True,
    )
    got = t_attn(
        _t(q), TPages(*(_t(x) for x in (kp, vp, prm))), _t(table), _t(seq_lens),
        THot(*(_t(x) for x in ring)), _t(n_hot), row,
    )
    np.testing.assert_allclose(
        got.to(torch.float32).numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2
    )
    assert np.all(got[1].to(torch.float32).numpy() == 0)  # nothing to attend to


def test_flush_hot_matches_pallas():
    """K4: blocks inside one page, crossing a page boundary, starting at
    slot 0, and inactive sequences (sink page 0): pages bitwise."""
    rng = np.random.default_rng(11)
    b, h, s, w, max_pages = 6, 4, 256, 32, 3
    kp, vp, prm = _pages(rng, 1 + b * max_pages, h, s)
    table = (1 + np.arange(b * max_pages).reshape(b, max_pages)).astype(np.int32)
    lens = np.array([100, 270, 32, 40, 0, 512], np.int32)
    flushed = np.array([68, 238, 0, 40, 0, 480], np.int32)  # seq 3 and 4 inactive
    active = (lens > 0) & (lens > flushed)
    page_lo = (lens - w) // s
    slot0 = page_lo * s
    o = lens - w - slot0
    tbl = lambda i: table[np.arange(b), np.clip(i, 0, max_pages - 1)]  # noqa: E731
    pg_a = np.where(active & (page_lo >= 0), tbl(page_lo), 0).astype(np.int32)
    pg_b = np.where(active & ((page_lo + 1) * s < lens), tbl(page_lo + 1), 0).astype(np.int32)
    ring = _ring(rng, b, h, w)
    row = 12
    book = [x.astype(np.int32) for x in (pg_a, pg_b, slot0, o, flushed, lens)]

    jpages = flush_hot_pallas(
        JPages(*(jnp.asarray(x.copy()) for x in (kp, vp, prm))),
        *j_hot_flush_blocks(JHot(*(jnp.asarray(x) for x in ring)), jnp.int32(row)),
        *(jnp.asarray(x) for x in book), interpret=True,
    )
    tpages = flush_hot(
        TPages(*(_t(x) for x in (kp, vp, prm))),
        *t_hot_flush_blocks(THot(*(_t(x) for x in ring)), row),
        *(_t(x) for x in book),
    )
    for a, t0, name in zip(jpages, tpages, ("k", "v", "params")):
        np.testing.assert_array_equal(_tbits(t0), _bits(a), err_msg=name)
    assert not np.array_equal(_tbits(tpages.v_pages), vp)  # something was written
    np.testing.assert_array_equal(_tbits(tpages.k_pages)[0], kp[0])  # sink untouched


def test_idle_rows_attention_and_flush_match_pallas():
    """The engine steps every slot of its batch; idle ones have ``seq_lens ==
    0``, ``flushed == 0``, ``n_hot == 0``, an all-zero page-table row and
    another request's leftovers in their ring rows.  K3 returns a finite
    (zero) row for them and leaves live rows alone; K4 skips them: pages
    bitwise equal to the Pallas kernel's, sink page 0 untouched."""
    rng = np.random.default_rng(21)
    b, h, s, w, max_pages, row = 8, 4, 256, 32, 2, 31
    kp, vp, prm = _pages(rng, 1 + b * max_pages, h, s)
    table = (1 + np.arange(b * max_pages).reshape(b, max_pages)).astype(np.int32)
    idle = np.array([1, 0, 1, 1, 0, 0, 1, 0], bool)
    table[idle] = 0
    lens = np.where(idle, 0, [0, 300, 0, 0, 40, 290, 0, 257]).astype(np.int32)
    flushed = np.where(idle, 0, [0, 268, 0, 0, 8, 270, 0, 225]).astype(np.int32)  # slot 5 joined mid-window
    ring = _ring(rng, b, h, w)
    q = _bf16(rng, (b, 4, 128), 1.0)

    # the flushing step: attention sees flushed_new = lens for active rows, n_hot = 0
    for fl, n_hot in ((flushed, lens - flushed), (lens, np.zeros_like(lens))):
        want = j_attn(
            jnp.asarray(q), JPages(*(jnp.asarray(x) for x in (kp, vp, prm))), jnp.asarray(table),
            jnp.asarray(fl), JHot(*(jnp.asarray(x) for x in ring)), jnp.asarray(n_hot.astype(np.int32)),
            jnp.int32(row), interpret=True,
        )
        got = t_attn(
            _t(q), TPages(*(_t(x) for x in (kp, vp, prm))), _t(table), _t(fl),
            THot(*(_t(x) for x in ring)), _t(n_hot.astype(np.int32)), row,
        ).to(torch.float32).numpy()
        assert np.isfinite(got).all() and not got[idle].any()
        np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)

    active = (lens > 0) & (lens > flushed)
    assert not active[idle].any() and active[~idle].all()
    page_lo = (lens - w) // s
    slot0 = page_lo * s
    o = lens - w - slot0
    tbl = lambda i: table[np.arange(b), np.clip(i, 0, max_pages - 1)]  # noqa: E731
    pg_a = np.where(active & (page_lo >= 0), tbl(page_lo), 0)
    pg_b = np.where(active & ((page_lo + 1) * s < lens), tbl(page_lo + 1), 0)
    book = [x.astype(np.int32) for x in (pg_a, pg_b, slot0, o, flushed, lens)]
    jpages = flush_hot_pallas(
        JPages(*(jnp.asarray(x.copy()) for x in (kp, vp, prm))),
        *j_hot_flush_blocks(JHot(*(jnp.asarray(x) for x in ring)), jnp.int32(row)),
        *(jnp.asarray(x) for x in book), interpret=True,
    )
    tpages = flush_hot(
        TPages(*(_t(x) for x in (kp, vp, prm))), *t_hot_flush_blocks(THot(*(_t(x) for x in ring)), row),
        *(_t(x) for x in book),
    )
    for a, t0, x0, name in zip(jpages, tpages, (kp, vp, prm), ("k", "v", "params")):
        np.testing.assert_array_equal(_tbits(t0), _bits(a), err_msg=name)
        np.testing.assert_array_equal(_tbits(t0)[0], _bits(x0)[0], err_msg=f"{name}: sink page written")
    assert not np.array_equal(_tbits(tpages.k_pages), kp)  # the live rows were flushed


@pytest.mark.parametrize("mutation", ["ring skipped", "one ring lane short", "one page lane extra", "one page lane short"])
def test_chip_smoke_attention_gate_catches_masking_errors(mutation):
    """``chip_smoke.py`` holds K3 to its plain version within ``ATTN_TOL`` on
    inputs from ``attention_args``.  Those inputs give outputs of order 1, so
    that each masking error of a single lane moves the output past the gate."""
    import chip_smoke

    gen = torch.Generator().manual_seed(1)
    n_hot = torch.randint(1, 33, (8,), generator=gen, dtype=torch.int32)
    flushed = (chip_smoke.CTX - n_hot).to(torch.int32)
    q, pages, table, fl, hot, nh, row = chip_smoke.attention_args(torch, gen, "cpu", 4, 4, flushed, n_hot)
    base = t_attn(q, pages, table, fl, hot, nh, row).float()
    assert base.abs().mean() > 0.3
    fl_m, nh_m = {
        "ring skipped": (fl, torch.zeros_like(nh)),
        "one ring lane short": (fl, nh - 1),
        "one page lane extra": (fl + 1, nh),
        "one page lane short": (fl - 1, nh),
    }[mutation]
    with pytest.raises(AssertionError):
        torch.testing.assert_close(t_attn(q, pages, table, fl_m, hot, nh_m, row).float(), base, **chip_smoke.ATTN_TOL)
