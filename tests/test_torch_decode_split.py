"""K3's order of arithmetic, on the CPU (and K11's on its decode rows, which
run K3's kernel without the ring).

The kernel runs one block per (sequence, kv head): an online softmax over
the ring's chunk, then over the sequence's page-table columns in order, up to
its last flushed page, and out = acc / max(l, 1e-20).  That order is emulated
here in plain PyTorch and held against the plain version and against the JAX
package's Pallas kernel in interpret mode; the shapes the wrapper refuses
are checked too.  The CUDA kernel itself is held against the plain version on
the card by ``chip_smoke.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu.ops.kv_hot import HotKV as JHot
from atom_tpu.ops.kv_layout import KVPages as JPages
from atom_tpu.ops.pallas_decode import paged_decode_attention_rotated as j_paged
from atom_tpu.ops.pallas_decode import paged_ring_decode_attention as j_attn
from atom_tpu_torch.ops import decode as dec
from atom_tpu_torch.ops.kv_hot import HotKV as THot
from atom_tpu_torch.ops.kv_layout import KVPages as TPages
from atom_tpu_torch.serving.convert import tensor_from_numpy
from test_torch_serving import cap_torch_threads

cap_torch_threads()

NEG = -1e30


@pytest.mark.parametrize(
    "args", [(16, 16, 32, 32), (32, 256, 32, 32), (512, 512, 64, 8)], ids=["smallest", "main", "widest_gqa_8"]
)
def test_ring_decode_shape_accepts_what_the_kernel_runs(args):
    dec.check_ring_decode_shape(*args)


@pytest.mark.parametrize(
    "args",
    [(32, 200, 32, 32), (24, 256, 32, 32), (32, 1024, 32, 32), (32, 256, 72, 8), (32, 256, 30, 4)],
    ids=["page_not_pow2", "ring_not_pow2", "page_too_wide", "gqa_9", "hq_not_multiple"],
)
def test_ring_decode_shape_refuses_what_the_kernel_cannot_run(args):
    with pytest.raises(ValueError):
        dec.check_ring_decode_shape(*args)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _bf16(rng, shape, scale=1.0, lo=None):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    if lo is not None:
        x = rng.uniform(lo, scale, shape).astype(np.float32)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16))


def _inputs(rng, b, heads, kv_heads, s, w, max_pages):
    """Pages and ring as ``tests/test_torch_kernels.py`` builds them for K3."""
    kp = rng.integers(-128, 128, (1 + b * max_pages, kv_heads, 64, s)).astype(np.int8)
    vp = rng.integers(-128, 128, (1 + b * max_pages, kv_heads, s // 2, 128)).astype(np.int8)
    prm = _bf16(rng, (1 + b * max_pages, 4, kv_heads, s), 0.1, lo=0.01)
    prm[:, 1] = np.asarray(jnp.asarray(-7.5 * np.asarray(prm[:, 0], np.float32)).astype(jnp.bfloat16))
    prm[:, 3] = np.asarray(jnp.asarray(-7.5 * np.asarray(prm[:, 2], np.float32)).astype(jnp.bfloat16))
    table = (1 + np.arange(b * max_pages).reshape(b, max_pages)).astype(np.int32)
    ring = (
        rng.integers(-128, 128, (b, kv_heads, 64, w)).astype(np.int8),
        _bf16(rng, (b, 4, kv_heads, w), 0.1, lo=0.01),
        rng.integers(0, 16, (b, kv_heads, w, 128)).astype(np.int8),
    )
    q = _bf16(rng, (b, heads, 128), 1.0)
    return q, (kp, vp, prm), table, ring


def stream_emulation(q, pages, table, seq_lens, hot, n_hot, row):
    """K3's order in plain PyTorch -> (output bf16 [B, HQ, D], the (m, l,
    acc) state after each chunk).  The emulation walks every column of the
    table; the kernel skips the ring when it is empty and the columns past a
    sequence's last flushed page, which are wholly masked here, so that
    walking them leaves the state as it was, bit for bit."""
    b, hq, d = q.shape
    h, w = pages.kv_heads, hot.window
    g = hq // h
    sm_scale = 1.0 / math.sqrt(d)
    qf = q.to(torch.float32).reshape(b, h, g, d)
    q_sum = qf.sum(-1)
    kc, prm, vc, valid_p = dec._gather_pages(pages, table, seq_lens)
    cols = torch.arange(w)
    ring = (dec._planes(hot.k_codes, dim=-2), hot.prm.to(torch.float32).permute(0, 2, 1, 3),
            hot.v_codes.to(torch.float32), ((row - cols + w) % w)[None, :] < n_hot[:, None])

    def step(state, chunk):
        m, l, acc = state
        kcod, pr, vcod, valid = chunk  # [B, H, D, L], [B, H, 4, L], [B, H, L, D], [B, L]
        valid = valid[:, None, None]
        sc = (torch.einsum("bhgd,bhdl->bhgl", qf, kcod) * pr[:, :, None, 0] + q_sum[..., None] * pr[:, :, None, 1]) * sm_scale
        sc = torch.where(valid, sc, NEG)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(sc - m_new[..., None]), 0.0)
        pw = torch.where(valid, p * pr[:, :, None, 2], 0.0)
        pv = torch.einsum("bhgl,bhld->bhgd", pw, vcod)
        z = torch.where(valid, p * pr[:, :, None, 3], 0.0).sum(-1)
        return m_new, l * alpha + p.sum(-1), acc * alpha[..., None] + pv + z[..., None]

    states = [step((torch.full((b, h, g), NEG), torch.zeros(b, h, g), torch.zeros(b, h, g, d)), ring)]
    for i in range(table.shape[1]):
        states.append(step(states[-1], (kc[:, i], prm[:, :, :, i], vc[:, i], valid_p[:, i])))
    _, l, acc = states[-1]
    out = acc / torch.clamp_min(l, 1e-20)[..., None]
    return out.reshape(b, hq, d).to(torch.bfloat16), states


def _torch_args(q, pg, table, seq_lens, ring, n_hot, row):
    return (_t(q), TPages(*(_t(x) for x in pg)), _t(table), _t(seq_lens), THot(*(_t(x) for x in ring)),
            _t(n_hot), row)


def _check(args):
    """The emulation against the plain version: atol = rtol = 2e-2 on the
    bf16 output (float32 softmax in another order), finite everywhere."""
    got, states = stream_emulation(*args)
    want = dec.paged_ring_decode_attention_plain(*args)
    for m, l, acc in states:
        assert torch.isfinite(m).all() and torch.isfinite(l).all() and torch.isfinite(acc).all()
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=2e-2, rtol=2e-2)
    return got, states


def _unchanged(before, after, rows):
    """The state of ``rows`` is bitwise the same after a wholly masked chunk."""
    return all(torch.equal(x[rows], y[rows]) for x, y in zip(before, after))


@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (8, 4)], ids=["mha", "gqa_8_4"])
def test_stream_emulation_matches_plain_and_pallas(heads, kv_heads):
    """The inputs of ``test_paged_ring_decode_attention_matches_pallas``:
    wrapped ring, n_hot from 0 to W, empty / partial / full pages, a row with
    nothing to attend to; the last column reached only by the longest two
    sequences."""
    rng = np.random.default_rng(heads)
    b, s, w, max_pages, row = 8, 256, 32, 3, 7
    q, pg, table, ring = _inputs(rng, b, heads, kv_heads, s, w, max_pages)
    seq_lens = np.array([0, 0, 255, 256, 257, 600, 768, 1], np.int32)
    n_hot = np.array([5, 0, 32, 1, 17, 31, 32, 9], np.int32)
    args = _torch_args(q, pg, table, seq_lens, ring, n_hot, row)
    got, states = _check(args)
    want = j_attn(
        jnp.asarray(q), JPages(*(jnp.asarray(x) for x in pg)), jnp.asarray(table), jnp.asarray(seq_lens),
        JHot(*(jnp.asarray(x) for x in ring)), jnp.asarray(n_hot), jnp.int32(row), interpret=True,
    )
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)
    assert not got[1].float().any()  # nothing to attend to: a zero row
    assert _unchanged(states[2], states[3], [0, 1, 2, 3, 4, 7])  # column 2: only rows 5 and 6 reach it


@pytest.mark.parametrize("case", ["idle_rows", "ring_only", "pages_only", "wide_table"])
def test_stream_emulation_edge_cases(case):
    """Idle rows (nothing flushed, nothing in the ring, page-table row 0),
    the ring alone (every column wholly masked), the pages alone (the ring's
    chunk wholly masked: the -1e30 sentinels stand and weigh exactly 0), a
    table of 10 columns whose last three no sequence reaches."""
    rng = np.random.default_rng(len(case))
    b, kv_heads, w, row = 6, 2, 32, 30
    wide = case == "wide_table"
    s, max_pages = (64, 10) if wide else (256, 3)
    q, pg, table, ring = _inputs(rng, b, 4, kv_heads, s, w, max_pages)
    seq_lens = np.array([0, 300, 64, 1, 500, 700], np.int32)
    n_hot = np.array([0, 12, 32, 1, 3, 20], np.int32)
    if wide:
        seq_lens = np.array([0, 63, 64, 129, 400, 383], np.int32)
    idle = np.zeros(b, bool)
    if case == "idle_rows":
        idle[[0, 2, 5]] = True
        table[idle] = 0
        seq_lens[idle] = 0
        n_hot[idle] = 0
    elif case == "ring_only":
        seq_lens[:] = 0
    elif case == "pages_only":
        n_hot[:] = 0
    args = _torch_args(q, pg, table, seq_lens, ring, n_hot, row)
    got, states = _check(args)
    every = list(range(b))
    if wide:  # columns 7-9 (slots 448-639): no sequence reaches them
        assert all(_unchanged(states[7], st, every) for st in states[8:])
    if case == "ring_only":  # every column masked: the state after the ring stands
        assert all(_unchanged(states[0], st, every) for st in states[1:])
    if case == "pages_only":  # the ring's lanes masked: the sentinels stand
        m0, l0, acc0 = states[0]
        assert (m0 == NEG).all() and (l0 == 0).all() and (acc0 == 0).all()
    empty = (seq_lens == 0) & (n_hot == 0)
    assert not got[torch.from_numpy(empty)].float().any()  # finite zero rows
    assert not empty.all()


@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (8, 1)], ids=["mha", "gqa_8"])
def test_stream_emulation_without_ring_is_k11_decode_rows(heads, kv_heads):
    """K11's decode rows (up to 8 query rows per kv head) run K3's kernel
    without the ring: the same walk with the ring's chunk wholly masked
    (n_hot = 0) gives K11's float32 output and state (m, l), within atol =
    rtol = 1e-4 of the plain version and of the Pallas kernel in interpret
    mode (m within 1e-5, l within 1e-5 relative); idle sequences keep
    out = 0, m = -1e30, l = 0."""
    rng = np.random.default_rng(10 + heads)
    b, s, w, max_pages = 6, 256, 32, 3
    q, pg, table, ring = _inputs(rng, b, heads, kv_heads, s, w, max_pages)
    seq_lens = np.array([0, 300, 1, 0, 768, 511], np.int32)
    table[seq_lens == 0] = 0
    args = _torch_args(q, pg, table, seq_lens, ring, np.zeros(b, np.int32), 0)
    _, states = stream_emulation(*args)
    m, l, acc = states[-1]
    got = (acc / torch.clamp_min(l, 1e-20)[..., None]).reshape(b, heads, 128)
    m, l = m.reshape(b, heads), l.reshape(b, heads)
    assert dec.check_rotated_decode_shape(s, heads, kv_heads) == "stream"
    want, wm, wl = dec.paged_decode_attention_rotated_plain(args[0], args[1], args[2], args[3], torch.float32, True)
    jout, jm, jl = j_paged(jnp.asarray(q), JPages(*(jnp.asarray(x) for x in pg)), jnp.asarray(table),
                           jnp.asarray(seq_lens), out_dtype=jnp.float32, return_state=True, interpret=True)
    for ref_out, ref_m, ref_l in ((want.numpy(), wm.numpy(), wl.numpy()),
                                  (np.asarray(jout), np.asarray(jm), np.asarray(jl))):
        np.testing.assert_allclose(got.numpy(), ref_out, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(m.numpy(), ref_m, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(l.numpy(), ref_l, rtol=1e-5, atol=1e-7)
    idle = torch.from_numpy(seq_lens == 0)
    assert not got[idle].any() and (m[idle] == NEG).all() and not l[idle].any()
