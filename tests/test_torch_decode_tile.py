"""K11's tile path (a chunk's prefix: more than 8 query rows per kv head), its
order of arithmetic on the CPU.

On the card ``csrc/decode.cu::paged_tile_kernel`` runs a block per 64 query
rows of one kv head and walks the head's pages 64 slots at a time: 32 of the
page's first half and the 32 that share their V bytes in the second, every
other such chunk in each half of the block, whose states merge at the end.  q.K and
p.V run on bf16 tensor-core fragments whose k index follows the bytes (a K
byte holds channels c and c + 64, a V byte slots r and r + S/2) and whose n
index puts 4 consecutive slots in one load; p * v_scale enters p.V as a bf16
term and its bf16 remainder, and each chunk's p.V joins the running output
from a fresh accumulator.  That walk is emulated here in plain PyTorch, each
fragment built from the page bytes by the kernel's index arithmetic, and held
against the plain version and against the JAX package's Pallas kernel in
interpret mode.  The shapes each path takes (``check_rotated_decode_shape``)
are checked too.  The CUDA kernel itself is held against the plain version on
the card by ``chip_smoke.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu.ops.kv_layout import KVPages as JPages
from atom_tpu.ops.pallas_decode import paged_decode_attention_rotated as j_paged
from atom_tpu_torch.ops import decode as dec
from atom_tpu_torch.ops.kv_layout import KVPages as TPages
from atom_tpu_torch.serving.convert import tensor_from_numpy
from test_torch_serving import cap_torch_threads

cap_torch_threads()

NEG = -1e30
TQ = 64  # query rows of a tile


@pytest.mark.parametrize(
    "args,path",
    [((256, 32, 32), "stream"), ((256, 64, 8), "stream"), ((16, 4, 4), "stream"), ((256, 32 * 256, 32), "tile"),
     ((256, 64 * 256, 8), "tile"), ((64, 9, 1), "tile"), ((512, 40, 2), "tile")],
    ids=["decode_mha", "decode_gqa_8", "smallest_page", "prefix_mha", "prefix_gqa_64_8", "nine_rows", "widest_page"],
)
def test_rotated_decode_shape_picks_the_path(args, path):
    assert dec.check_rotated_decode_shape(*args) == path


@pytest.mark.parametrize(
    "args",
    [(32, 1024, 32), (8, 32, 32), (200, 32, 32), (1024, 32, 32), (256, 30, 4), (256, 32, 32, 64), (384, 8192, 32)],
    ids=["tile_page_too_small", "stream_page_too_small", "page_not_pow2", "page_too_wide", "hq_not_multiple",
         "head_dim_64", "tile_page_not_pow2"],
)
def test_rotated_decode_shape_refuses_what_neither_path_runs(args):
    with pytest.raises(ValueError):
        dec.check_rotated_decode_shape(*args)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16).float()


def _tile_walk(qf, kb, vb, prm, seq_len, s, terms):
    """One tile: rows qf f32 [64, 128] (bf16 values), the head's pages (K bytes
    [P, 64, S], V bytes [P, S/2, 128] as uint8, params f32 [P, 4, S]) ->
    (out, m, l) of the rows, in the kernel's order: the walk's 64-slot chunks
    alternate between two halves of the block, each with its own state, and
    the halves merge at the end; each chunk's p.V from zero, then added to
    the running output.  ``terms``: p * v_scale as that many bf16 terms, each
    the rounding of what the ones before leave (the kernel: 2)."""
    rows = qf.shape[0]
    sm_scale = 1.0 / math.sqrt(128)
    # q's A fragment of k-step kk: k = 2 tig + e -> channel 8 kk + tig + 64 e, k = 8 + 2 tig + e -> 8 kk + 4 + tig + 64 e
    k = torch.arange(16)
    row_of_k = (k // 8) * 4 + (k % 8) // 2  # the K byte row within the k-step's 8, and nibble k % 2
    chan = torch.stack([8 * kk + row_of_k + 64 * (k % 2) for kk in range(8)])  # [8, 16]
    qa = qf[:, chan]  # [rows, 8, 16]
    qsum = qf.sum(-1)
    state = [(torch.full((rows,), NEG), torch.zeros(rows), torch.zeros(rows), torch.zeros(rows, 128)) for _ in range(2)]
    n = torch.arange(8)
    n_page = min(-(-seq_len // s), kb.shape[0])
    for i in range(n_page):
        pos0 = i * s
        for t in range(s // 64):
            if pos0 + 32 * t >= seq_len:
                break
            half = (i * (s // 64) + t) % 2
            m, l, z, o = state[half]
            # scores [rows, hg, u, n]: n-tile (hg, u), column n = slot half + 32 t + 4 n + u
            sc = torch.zeros(rows, 2, 4, 8)
            for kk in range(8):
                for hg in range(2):
                    for u in range(4):
                        slot = (s // 2 if hg else 0) + 32 * t + 4 * n + u  # [8]
                        byte = kb[i][(8 * kk + row_of_k)[:, None], slot[None, :]]  # [16, 8]
                        code = ((byte >> (4 * (k % 2))[:, None]) & 0x0F).float()
                        sc[:, hg, u] = sc[:, hg, u] + qa[:, kk] @ code
            slot = torch.stack([torch.stack([(s // 2 if hg else 0) + 32 * t + 4 * n + u for u in range(4)])
                                for hg in range(2)])  # [2, 4, 8]
            valid = pos0 + slot < seq_len
            ks, kz, vs, vz = (prm[i, j][slot] for j in range(4))
            sc = torch.where(valid, (sc * ks + qsum[:, None, None, None] * kz) * sm_scale, NEG)
            m_new = torch.maximum(m, sc.amax((1, 2, 3)))
            alpha = torch.exp(m - m_new)
            m, l, z = m_new, l * alpha, z * alpha
            p = torch.where(valid, torch.exp(sc - m[:, None, None, None]), 0.0)
            l = l + p.sum((1, 2, 3))
            z = z + (p * vz).sum((1, 2, 3))
            rest, parts = p * vs, []
            for _ in range(terms):
                parts.append(_bf16(rest.numpy()))
                rest = rest - parts[-1]
            # p.V k-step (kp, hg): A[k] = the scores' n-tiles 2 kp (k < 8) and 2 kp + 1, column 2 tig + e;
            # B[k][channel] = the V byte of row 32 t + 8 tig + 2 kp + (k >= 8) + 4 e, nibble hg
            tig, e = (k % 8) // 2, k % 2
            ntile = 2 * (torch.arange(2)[:, None]) + (k >= 8).long()[None, :]  # [kp, 16]
            pv = torch.zeros(rows, 128)
            for kp in range(2):
                for hg in range(2):
                    cols = 2 * tig + e
                    vrow = 32 * t + 8 * tig + 2 * kp + (k >= 8).long() + 4 * e  # [16]
                    bv = ((vb[i][vrow] >> (4 * hg)) & 0x0F).float()  # [16, 128]
                    for part in parts:
                        pv = pv + part[:, hg, ntile[kp], cols] @ bv  # A [rows, 16]
            o = o * alpha[:, None] + pv
            state[half] = (m, l, z, o)
    (m0, l0, z0, o0), (m1, l1, z1, o1) = state
    m = torch.maximum(m0, m1)
    a0, a1 = torch.exp(m0 - m), torch.exp(m1 - m)
    l, z, o = l0 * a0 + l1 * a1, z0 * a0 + z1 * a1, o0 * a0[:, None] + o1 * a1[:, None]
    out = (o + z[:, None]) / torch.clamp_min(l, 1e-20)[:, None]
    return out, m, l


def tile_emulation(q, pages: TPages, table, seq_lens, terms=2):
    """K11's tile path in plain PyTorch -> (out f32 [B, HQ, D], m [B, HQ], l [B, HQ])."""
    b, hq, d = q.shape
    h, s = pages.kv_heads, pages.page_size
    r = hq // h
    kb = pages.k_pages.view(torch.uint8).long()
    vb = pages.v_pages.view(torch.uint8).long()
    prm = pages.params.float()
    out, m, l = torch.zeros(b, hq, d), torch.zeros(b, hq), torch.zeros(b, hq)
    for bi in range(b):
        pt = table[bi].long()
        for hi in range(h):
            for r0 in range(0, r, TQ):
                rows = min(TQ, r - r0)
                qf = torch.zeros(TQ, d)
                qf[:rows] = q[bi, hi * r + r0: hi * r + r0 + rows].float()
                o_, m_, l_ = _tile_walk(qf, kb[pt, hi], vb[pt, hi], prm[pt][:, :, hi], int(seq_lens[bi]), s, terms)
                sl = slice(hi * r + r0, hi * r + r0 + rows)
                out[bi, sl], m[bi, sl], l[bi, sl] = o_[:rows], m_[:rows], l_[:rows]
    return out, m, l


def _inputs(rng, b, heads, kv_heads, s, max_pages, q_scale=4.0):
    kp = rng.integers(-128, 128, (1 + b * max_pages, kv_heads, 64, s)).astype(np.int8)
    vp = rng.integers(-128, 128, (1 + b * max_pages, kv_heads, s // 2, 128)).astype(np.int8)
    prm = rng.uniform(0.01, 0.1, (1 + b * max_pages, 4, kv_heads, s)).astype(np.float32)
    prm[:, 1] = -7.5 * prm[:, 0]
    prm[:, 3] = rng.uniform(-1.0, 1.0, prm[:, 3].shape)
    prm = np.asarray(jnp.asarray(prm).astype(jnp.bfloat16))
    table = (1 + np.arange(b * max_pages).reshape(b, max_pages)).astype(np.int32)
    q = np.asarray(jnp.asarray(rng.standard_normal((b, heads, 128)).astype(np.float32) * q_scale).astype(jnp.bfloat16))
    return q, (kp, vp, prm), table


@pytest.mark.parametrize(
    "heads,kv_heads,s,prefix",
    [(64, 2, 64, 0), (64, 2, 64, 100), (64, 2, 128, 300), (96, 2, 64, 190), (32, 2, 64, 128)],
    ids=["mha_prefix_0", "mha_mid_page", "mha_pages_128", "gqa_rows_48_mid_page", "page_boundary"],
)
def test_tile_emulation_matches_plain_and_pallas(heads, kv_heads, s, prefix):
    """A prefix of 0, ending mid-page, several whole pages; a second sequence
    with nothing flushed (out = 0, m = -1e30, l = 0); rows per kv head past a
    tile of 64 (96 / 2 = 48 rows: one partial tile; 64 / 2 = 32).  The
    emulation, the plain version and the Pallas kernel agree within atol = rtol
    = 1e-4 on the float32 output (float32 sums in other orders, p * v_scale
    as a bf16 term and remainder), m within 1e-5 and l within 1e-5 relative."""
    rng = np.random.default_rng(prefix + heads + s)
    b, max_pages = 2, 5
    q, pg, table = _inputs(rng, b, heads, kv_heads, s, max_pages)
    seq_lens = np.array([prefix, 0], np.int32)
    tq, tpg = tensor_from_numpy(q, "cpu"), TPages(*(tensor_from_numpy(x, "cpu") for x in pg))
    ttab, tlen = tensor_from_numpy(table, "cpu"), tensor_from_numpy(seq_lens, "cpu")
    assert dec.check_rotated_decode_shape(s, heads, kv_heads) == "tile"

    got, gm, gl = tile_emulation(tq, tpg, ttab, tlen)
    want, wm, wl = dec.paged_decode_attention_rotated_plain(tq, tpg, ttab, tlen, torch.float32, True)
    jout, jm, jl = j_paged(jnp.asarray(q), JPages(*(jnp.asarray(x) for x in pg)), jnp.asarray(table),
                           jnp.asarray(seq_lens), head_block=8, out_dtype=jnp.float32, return_state=True,
                           interpret=True)
    for ref_out, ref_m, ref_l in ((want.numpy(), wm.numpy(), wl.numpy()),
                                  (np.asarray(jout), np.asarray(jm), np.asarray(jl))):
        np.testing.assert_allclose(got.numpy(), ref_out, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(gm.numpy(), ref_m, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gl.numpy(), ref_l, rtol=1e-5, atol=1e-7)
    assert torch.isfinite(got).all()
    assert not got[1].any() and (gm[1] == NEG).all() and not gl[1].any()  # nothing flushed
    if prefix == 0:
        assert not got.any() and (gm == NEG).all() and not gl.any()
    else:
        assert float(got[0].abs().max()) > 0.1  # outputs of order 1: the tolerance has teeth


@pytest.mark.parametrize("terms,within", [(1, None), (2, 2e-6)], ids=["one", "two"])
def test_tile_emulation_terms_of_p_times_v_scale(terms, within):
    """Why p.V takes p * v_scale as two bf16 terms: rounded to bf16 once, the
    walk falls outside the card's float32 tolerance (atol = rtol = 2e-4,
    ``chip_smoke.py``'s ``F32_OUT_TOL``) on queries of scale 12 (a peaked
    softmax, as the card's check builds them); with the remainder it is
    within 2e-6 of the plain version."""
    rng = np.random.default_rng(7)
    q, pg, table = _inputs(rng, 1, 32, 2, 64, 4, q_scale=12.0)
    lens = np.array([250], np.int32)
    tq, tpg = tensor_from_numpy(q, "cpu"), TPages(*(tensor_from_numpy(x, "cpu") for x in pg))
    ttab, tlen = tensor_from_numpy(table, "cpu"), tensor_from_numpy(lens, "cpu")
    want = dec.paged_decode_attention_rotated_plain(tq, tpg, ttab, tlen, torch.float32)
    got, _, _ = tile_emulation(tq, tpg, ttab, tlen, terms=terms)
    if within is None:
        assert not torch.allclose(got, want, atol=2e-4, rtol=2e-4)
    else:
        assert float((got - want).abs().max()) < within
