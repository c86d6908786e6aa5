"""The ring flush read in place (kernel K4, ``flush_hot_ring``) and the W8A16
head (kernel K5) as the CUDA kernels compute them, on the CPU.

* ``flush_hot_ring``'s plain version against the Pallas kernel (interpret
  mode) on the pre-rolled ring, pages bit for bit;
* a numpy emulation of K4's one pass (``csrc/decode.cu::flush_kernel``): its
  blocks and rounds, each token's ring column ``(roll + t) mod W``, page,
  lane and nibble half, its flat indices and 32-bit nibble merges, against
  ``flush_hot_plain``, bit for bit;
* K5's conversion of an int8 code into two exact bf16 terms, ``16 * (c >> 4)``
  and ``c & 15``, as bit operations, over every pair of codes;
* a numpy emulation of K5's data path (``csrc/gemm_w8a16.cu``): the launch
  plan, the weight boxes under the 128-byte swizzle, each thread's reads,
  byte permutes and fragments, the two terms a K step, the accumulator's
  columns and the scale, against the Pallas kernel;
* the plan covers every column once and takes every shape the wrapper takes.

The kernels themselves run only on the card (``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu.ops import pallas_gemm_w4a16 as jw
from atom_tpu.ops.kv_hot import HotKV as JHot
from atom_tpu.ops.kv_hot import hot_flush_blocks as j_hot_flush_blocks
from atom_tpu.ops.kv_layout import KVPages as JPages
from atom_tpu.ops.pallas_decode import flush_hot_pallas
from atom_tpu_torch.ops import decode as dec
from atom_tpu_torch.ops import gemm_w4a16 as tw
from atom_tpu_torch.ops.kv_hot import HotKV as THot
from atom_tpu_torch.ops.kv_hot import hot_flush_blocks
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


def _bf16(x):
    return np.array(jnp.asarray(np.asarray(x, np.float32)).astype(jnp.bfloat16))


# ---------------------------------------------------------------------------
# K4: the flush
# ---------------------------------------------------------------------------


def _flush_case(rng, s, w, h, b=8, d=128):
    """Pages, a ring and the flush bookkeeping of ``serving/model.py::
    _flush_plan`` for sequences that cover the cases: a block at slot 0 (o =
    0), one crossing a page boundary, one ending at a page's last lane, one
    joined mid-window (flushed above lens - W), one shorter than W (its early
    slots fall before slot 0), an inactive one (flushed = lens) and an idle
    slot."""
    max_pages = 3
    n_pages = 1 + b * max_pages
    kp = rng.integers(-128, 128, (n_pages, h, d // 2, s)).astype(np.int8)
    vp = rng.integers(-128, 128, (n_pages, h, s // 2, d)).astype(np.int8)
    prm = _bf16(rng.uniform(0.01, 0.1, (n_pages, 4, h, s)))
    ring = (rng.integers(-128, 128, (b, h, d // 2, w)).astype(np.int8),
            _bf16(rng.uniform(0.01, 0.1, (b, 4, h, w))),
            rng.integers(0, 16, (b, h, w, d)).astype(np.int8))
    table = (1 + np.arange(b * max_pages).reshape(b, max_pages)).astype(np.int32)
    lens = np.array([w, s + 5, 2 * s, s + w - 3, w - 7, s + 9, 0, 3 * s - 1], np.int32)[:b]
    flushed = (lens - w).clip(0).astype(np.int32)
    flushed[3] = lens[3] - w + 11  # joined mid-window
    flushed[5] = lens[5]  # inactive
    active = (lens > 0) & (lens > flushed)
    page_lo = np.floor_divide(lens - w, s)
    slot0 = page_lo * s
    o = lens - w - slot0
    tbl = lambda i: table[np.arange(b), np.clip(i, 0, max_pages - 1)]  # noqa: E731
    pg_a = np.where(active & (page_lo >= 0), tbl(page_lo), 0)
    pg_b = np.where(active & ((page_lo + 1) * s < lens), tbl(page_lo + 1), 0)
    book = [x.astype(np.int32) for x in (pg_a, pg_b, slot0, o, flushed, lens)]
    assert (o[active] == 0).any() and (pg_b > 0).any() and not active[5:7].any()
    return (kp, vp, prm), ring, book


def _torch_pages(pages):
    return TPages(*(_t(x.copy()) for x in pages))


@pytest.mark.parametrize("row,kv_heads", [(0, 4), (12, 2), (31, 4)])
def test_flush_hot_ring_plain_matches_pallas(row, kv_heads):
    """``flush_hot_ring``'s plain version (the ring rolled by ``-(row + 1)``,
    then the plain flush) against the Pallas kernel on the JAX package's own
    rolled blocks: pages bit for bit, the sink page untouched.  kv heads 2
    stand for a GQA model's ring."""
    rng = np.random.default_rng(100 + row)
    s, w = 64, 32
    pages, ring, book = _flush_case(rng, s, w, kv_heads)
    jpages = flush_hot_pallas(
        JPages(*(jnp.asarray(x.copy()) for x in pages)),
        *j_hot_flush_blocks(JHot(*(jnp.asarray(x) for x in ring)), jnp.int32(row)),
        *(jnp.asarray(x) for x in book), interpret=True,
    )
    before = dec.flush_hot.launches
    tpages = dec.flush_hot_ring(_torch_pages(pages), THot(*(_t(x) for x in ring)), row, *(_t(x) for x in book))
    assert dec.flush_hot.launches == before  # a CPU tensor takes the plain version
    for a, t0, x0, name in zip(jpages, tpages, pages, ("k", "v", "params")):
        np.testing.assert_array_equal(_tbits(t0), _bits(a), err_msg=name)
        np.testing.assert_array_equal(_tbits(t0)[0], _bits(x0)[0], err_msg=f"{name}: sink page written")
    assert not np.array_equal(_tbits(tpages.v_pages), pages[1])  # something was written


def _emulate_flush(pages, ring, book, roll):
    """K4's one pass in numpy, on flat byte arrays with the kernel's indices:
    grid (sequence, kv head), rounds of 32 tokens, a token's ring column, page
    and lane decided once by comparisons, the K rows of each warp in batches
    of 16 (rows warp + 4 i, then 64 rows on) and its params row, V in pieces
    (piece p of a round: token p // pieces) merged on 32-bit words: 16-byte
    pieces at head_dim 128 (``flush_kernel<128>``), single bytes at any other
    (the generic ``flush_kernel<0>``).  A round's stores all come after its
    loads (the kernel issues a thread's loads before its stores): that is only
    right if no two pieces share a page address, which it asserts."""
    k_ring, prm_ring, v_ring = (np.ascontiguousarray(x) for x in ring)
    bsz, h, dh, w = k_ring.shape
    d = 2 * dh
    kp, vp, prm = (x.copy() for x in pages)
    s = kp.shape[3]
    kf, vf, pf = kp.reshape(-1), vp.reshape(-1).view(np.uint8), prm.view(np.uint16).reshape(-1)
    krf, vrf, prf = k_ring.reshape(-1), v_ring.reshape(-1).view(np.uint8), prm_ring.view(np.uint16).reshape(-1)
    page_a, page_b, slot0, o, lo, hi = (np.asarray(x, np.int64) for x in book)
    pb = 16 if d == 128 else 1  # bytes a V piece
    pieces = d // pb
    word = np.uint32 if pb == 16 else np.uint8  # the merge's unit
    m_lo, m_hi = (word(int(x * word(0).itemsize, 16)) for x in ("0F", "F0"))
    # a warp's K rows: batches r0 = warp, warp + 64, .. of rows r0 + 4 i, i < 16
    rows = np.array([r0 + 4 * i for warp in range(4) for r0 in range(warp, dh, 64) for i in range(16)
                     if r0 + 4 * i < dh])[:, None]
    assert np.array_equal(np.sort(rows[:, 0]), np.arange(dh))
    for b in range(bsz):
        lane0 = o[b]
        gs0 = slot0[b] + lane0
        t_lo, t_hi = max(0, lo[b] - gs0), min(w, hi[b] - gs0)
        for hh in range(h):
            for t0 in range(t_lo, t_hi, 32):
                # the K rows and the params row of each warp: lanes are tokens
                t = np.arange(t0, min(t0 + 32, t_hi))
                col = np.where(roll + t < w, roll + t, roll + t - w)
                pg = np.where(lane0 + t < s, page_a[b], page_b[b])
                ln = np.where(lane0 + t < s, lane0 + t, lane0 + t - s)
                k_dst = ((pg * h + hh) * dh + rows) * s + ln
                k_val = krf[((b * h + hh) * dh + rows) * w + col]
                j = np.arange(4)[:, None]
                p_dst = ((pg * 4 + j) * h + hh) * s + ln
                p_val = prf[((b * 4 + j) * h + hh) * w + col]
                # V piece p of the round: token t0 + p // pieces, bytes pb (p % pieces) ..
                p = np.arange(32 * pieces)
                tv, piece = t0 + p // pieces, p % pieces
                tv, piece = tv[tv < t_hi], piece[tv < t_hi]
                lnv = np.where(lane0 + tv < s, lane0 + tv, lane0 + tv - s)
                high = lnv >= s // 2
                v_src = ((b * h + hh) * w + np.where(roll + tv < w, roll + tv, roll + tv - w)) * d + piece * pb
                v_dst = ((np.where(lane0 + tv < s, page_a[b], page_b[b]) * h + hh) * (s // 2)
                         + np.where(high, lnv - s // 2, lnv)) * d + piece * pb
                byte = np.arange(pb)
                new = vrf[v_src[:, None] + byte].copy().view(word) & m_lo
                old = vf[v_dst[:, None] + byte].copy().view(word)
                for name, dst in (("k", k_dst), ("params", p_dst), ("v", v_dst)):
                    assert np.unique(dst).size == dst.size, f"two {name} stores of one round share an address"
                # every load of the round is taken above; the stores follow
                kf[k_dst] = k_val
                pf[p_dst] = p_val
                merged = np.where(high[:, None], (old & m_lo) | (new << word(4)), (old & m_hi) | new)
                vf[v_dst[:, None] + byte] = merged.view(np.uint8)
    return kp, vp, prm


@pytest.mark.parametrize("s,w,kv_heads", [(64, 32, 4), (256, 32, 6), (256, 16, 2), (64, 16, 4)])
@pytest.mark.parametrize("form", ["ring_row_0", "ring_row_12", "ring_row_last", "rolled"])
def test_flush_emulation_matches_plain(s, w, kv_heads, form):
    """The emulation of K4 on the live ring (roll = row + 1, rows 0, 12 and
    W - 1) and on pre-rolled blocks (roll = 0) against ``flush_hot_plain``
    on the rolled ring: pages bit for bit; page sizes 64 and 256, W 16 and
    32, kv heads 4, 6 and 2."""
    _check_flush_emulation(s, w, kv_heads, form, 128)


@pytest.mark.parametrize("d,s,w,kv_heads", [(64, 64, 32, 4), (256, 256, 16, 2)])
@pytest.mark.parametrize("form", ["ring_row_12", "rolled"])
def test_flush_emulation_generic_head_dim_matches_plain(d, s, w, kv_heads, form):
    """The same for the generic instance at head dims 64 and 256 (single-byte
    V pieces; at 256 two K batches a warp): pages bit for bit."""
    _check_flush_emulation(s, w, kv_heads, form, d)


def _check_flush_emulation(s, w, kv_heads, form, d):
    rng = np.random.default_rng(s + w + kv_heads + (d != 128) * d)
    pages, ring, book = _flush_case(rng, s, w, kv_heads, d=d)
    row = {"ring_row_0": 0, "ring_row_12": 12, "ring_row_last": w - 1, "rolled": 5}[form]
    k_r, prm_r, v_r = hot_flush_blocks(THot(*(_t(x) for x in ring)), row)
    rolled = (k_r.numpy(), _bf16(prm_r.to(torch.float32).numpy()), v_r.numpy())
    if form == "rolled":
        got = _emulate_flush(pages, rolled, book, 0)
    else:
        got = _emulate_flush(pages, ring, book, (row + 1) % w)
    want = dec.flush_hot_plain(_torch_pages(pages), *(_t(x) for x in rolled), *(_t(x) for x in book))
    for g, t0, name in zip(got, want, ("k", "v", "params")):
        np.testing.assert_array_equal(_bits(g), _tbits(t0), err_msg=name)
    np.testing.assert_array_equal(got[1][0], pages[1][0], err_msg="sink page written")


# ---------------------------------------------------------------------------
# K5: the conversion and the data path
# ---------------------------------------------------------------------------


def _bf16_value(bits):
    """float32 values of bf16 bit patterns (uint16 or uint32 low halves)."""
    return np.asarray(np.asarray(bits, np.uint32) << np.uint32(16)).view(np.float32)


def _bf16_round(f):
    """bf16 bit patterns of float32 values, round to nearest even."""
    u = np.asarray(f, np.float32).view(np.uint32)
    return ((u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) >> np.uint32(16)).astype(np.uint32)


def _prmt(x, y, sel):
    """``__byte_perm(x, y, sel)``: result byte i is byte ``(sel >> 4i) & 7`` of
    the 8 bytes {y, x}."""
    both = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint64)
    out = np.zeros(np.broadcast(x, y).shape, np.uint64)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        out |= ((both >> np.uint64(8 * src)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _halves(x):
    return x & np.uint32(0xFFFF), x >> np.uint32(16)


def _low_term(x):
    """``low_term``: bf16x2 (x & 0x000F000F) | 0x43004300, less 128 each half."""
    v = (x & np.uint32(0x000F000F)) | np.uint32(0x43004300)
    return [_bf16_round(_bf16_value(half) - np.float32(128)) for half in _halves(v)]


def _high_term(x):
    """``high_term``: bf16x2 ((x >> 4) & 0x000F000F) ^ 0x43084308, then
    fma(v, 16, -2176) each half (one rounding: the float32 value is exact)."""
    v = ((x >> np.uint32(4)) & np.uint32(0x000F000F)) ^ np.uint32(0x43084308)
    return [_bf16_round(_bf16_value(half) * np.float32(16) + _bf16_value(0xC508)) for half in _halves(v)]


def test_k5_conversion_exact_over_every_code_pair():
    """Every pair of codes (c1, c2), as the byte permute leaves them in bytes
    0 and 2 of a word (bytes 1 and 3 their copies): the high term's bf16 is
    exactly 16 * (c >> 4), the low term's exactly c & 15, and 16h + l == c.
    The constants are the bf16 patterns of 16 and -2176."""
    c1, c2 = (x.ravel() for x in np.meshgrid(np.arange(-128, 128), np.arange(-128, 128)))
    b1, b2 = (c & 0xFF for c in (c1, c2))
    word = _prmt((b1 * 0x01010101).astype(np.uint32), (b2 * 0x01010101).astype(np.uint32), 0x4400)
    assert np.array_equal(word, (b1 * 0x0101 + b2 * 0x01010000).astype(np.uint32))
    for c, hi, lo in zip((c1, c2), _high_term(word), _low_term(word)):
        h, l = c >> 4, c & 15
        np.testing.assert_array_equal(hi, _bf16_round((16 * h).astype(np.float32)))
        np.testing.assert_array_equal(lo, _bf16_round(l.astype(np.float32)))
        np.testing.assert_array_equal(_bf16_value(hi) + _bf16_value(lo), c.astype(np.float32))
    assert _bf16_round(np.float32(16)) == 0x4180 and _bf16_round(np.float32(-2176)) == 0xC508


KC, BOX_N, TN = 128, 128, 256  # K rows a stage, columns a weight box, columns a block


def _swizzled(box):
    """A [128 rows x 128 columns] byte box as TMA writes it under the 128-byte
    swizzle: row r's 16-byte chunk j at chunk j ^ (r % 8)."""
    img = np.zeros(KC * BOX_N, np.uint8)
    r, c = np.meshgrid(np.arange(KC), np.arange(BOX_N), indexing="ij")
    img[r * BOX_N + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15))] = box
    return img


def _fragments(img, kk):
    """Every consumer thread of a warpgroup (warp, gid, tig) at K step kk:
    its four 4-byte reads of the swizzled box, the byte permutes and the two
    terms, placed where wgmma takes register A (row gid + 8c, K slots 2tig,
    2tig + 1 from a[c]; + 8 from a[2 + c]).  Returns the two terms' [tile][64
    x 16] matrices and each tile's column of an accumulator row."""
    warp, gid, tig = np.meshgrid(np.arange(4), np.arange(8), np.arange(4), indexing="ij")
    x = 32 * warp + 4 * gid
    words = []
    for dr in (0, 1, 8, 9):
        r = kk * 16 + 2 * tig + dr
        addr = r * BOX_N + ((((x >> 4) ^ (r & 7)) << 4) | (x & 15))
        words.append(sum(img[addr + j].astype(np.uint32) << np.uint32(8 * j) for j in range(4)))
    terms = np.zeros((2, 2, 64, 16), np.float32)  # [tile][16h, l][row][k]
    col = np.zeros((2, 64), np.int64)
    for t in range(2):
        for c in range(2):
            sel = 0x4400 + 0x1111 * (2 * t + c)
            row = warp * 16 + gid + 8 * c
            col[t, row] = x + 2 * t + c
            for word, k0 in ((_prmt(words[0], words[1], sel), 2 * tig), (_prmt(words[2], words[3], sel), 2 * tig + 8)):
                for e, term in enumerate((_high_term(word), _low_term(word))):
                    terms[t, e, row, k0] = _bf16_value(term[0])
                    terms[t, e, row, k0 + 1] = _bf16_value(term[1])
    return terms, col


def _emulate_k5(a, codes, scale):
    """K5 as launched by ``w8a16_plan``: per block of ``rows`` activation rows
    x 256 columns, per 128-row stage (TMA boxes zero past K, N and M), per K
    step, per warpgroup and tile: acc += (16h) . a, then acc += l . a, in
    float32; then the scale, once."""
    m, k = a.shape
    n = codes.shape[1]
    plan = tw.w8a16_plan(m, k, n)
    na = plan.rows
    kp = -(-k // KC) * KC
    w_pad = np.zeros((kp, plan.grid[0] * TN), np.uint8)
    w_pad[:k, :n] = codes.view(np.uint8)
    out = np.zeros((m, n), np.float32)
    for by in range(plan.grid[1]):
        act = np.zeros((na, kp), np.float32)
        rows = a[by * na:(by + 1) * na]
        act[: rows.shape[0], :k] = rows
        for bx in range(plan.grid[0]):
            acc = np.zeros((2, 2, 64, na), np.float32)  # [warpgroup][tile]
            col = None
            for i in range(kp // KC):
                imgs = [_swizzled(w_pad[i * KC:(i + 1) * KC, bx * TN + g * BOX_N: bx * TN + (g + 1) * BOX_N]) for g in range(2)]
                for kk in range(KC // 16):
                    b_op = act[:, i * KC + kk * 16: i * KC + kk * 16 + 16].T  # [16 x na]
                    for g in range(2):
                        terms, col = _fragments(imgs[g], kk)
                        for t in range(2):
                            acc[g, t] = acc[g, t] + terms[t, 0] @ b_op
                            acc[g, t] = acc[g, t] + terms[t, 1] @ b_op
            for g in range(2):
                for t in range(2):
                    cols = bx * TN + g * BOX_N + col[t]
                    keep = cols < n
                    out[by * na:(by + 1) * na, cols[keep]] = (acc[g, t][keep].T * scale[0, cols[keep]])[: rows.shape[0]]
    return out


@pytest.mark.parametrize("m,k,n", [(1, 512, 384), (33, 1024, 512), (40, 256, 640)])
def test_k5_emulation_matches_pallas(m, k, n):
    """The emulation of K5's data path against the Pallas kernel in interpret
    mode, within ``W8A16_RTOL`` of the largest output (float32 sums of exact
    products in another order); the terms' sum is the code on every column
    (N past whole 256-column tiles: 384, 640; 33 and 40 rows: 40-row blocks)."""
    rng = np.random.default_rng(m + k + n)
    a = _bf16(rng.standard_normal((m, k)))
    wq = jw.quantize_w8a16(jnp.asarray((rng.standard_normal((k, n)) * 0.02).astype(np.float32)))
    codes, scale = np.asarray(wq.codes), np.asarray(wq.scale, np.float32)
    want = np.asarray(jw.w8a16_gemm(jnp.asarray(a), wq, interpret=True))
    got = _emulate_k5(a.astype(np.float32), codes, scale)
    err = np.abs(got - want).max()
    assert err <= tw.W8A16_RTOL * np.abs(want).max(), f"max |diff| {err} vs max |out| {np.abs(want).max()}"
    exact = (a.astype(np.float64) @ codes.astype(np.float64)) * scale.astype(np.float64)
    assert np.abs(got - exact).max() <= 1e-5 * np.abs(exact).max()


def test_k5_fragments_hold_every_code_once():
    """One swizzled box of random codes: the two terms of every thread's
    fragments add up to the box's codes, each column of the 128 once, in the
    column the accumulator row maps to."""
    rng = np.random.default_rng(5)
    box = rng.integers(-128, 128, (KC, BOX_N)).astype(np.int8)
    img = _swizzled(box.view(np.uint8))
    for kk in range(KC // 16):
        terms, col = _fragments(img, kk)
        assert sorted(col.ravel()) == list(range(BOX_N))
        for t in range(2):
            np.testing.assert_array_equal(terms[t, 0] + terms[t, 1], box[kk * 16:(kk + 1) * 16, col[t]].T.astype(np.float32))


def test_w8a16_plan_covers_every_column_and_takes_every_shape():
    """The plan takes every shape the wrapper takes (any M, K a multiple of
    16, N a multiple of 64): the block's rows hold M up to 64 (the fewest of
    8, 16, 32, 40, 48, 64), above it passes of 64 cover M; the column tiles
    cover N once, the last one ragged.  Other shapes raise."""
    for m in list(range(1, 70)) + [100, 128, 129, 1024]:
        for k in (0, 16, 4000, 4096):
            for n in (64, 192, 256, 4160, 32256):
                plan = tw.w8a16_plan(m, k, n)
                assert plan.rows in (8, 16, 32, 40, 48, 64)
                assert (plan.rows >= m and plan.grid[1] == 1) if m <= 64 else plan.rows == 64
                assert plan.rows * (plan.grid[1] - 1) < m <= plan.rows * plan.grid[1]
                assert TN * (plan.grid[0] - 1) < n <= TN * plan.grid[0]
                if m <= 64:
                    assert plan.rows == min(r for r in (8, 16, 32, 40, 48, 64) if r >= m)
    assert tw.w8a16_plan(33, 4096, 32256) == tw.W8A16Plan(40, (126, 1))
    for bad in ((1, 4096, 96), (1, 4100, 64), (0, 4096, 64), (1, 4096, 0)):
        with pytest.raises(ValueError):
            tw.w8a16_plan(*bad)
