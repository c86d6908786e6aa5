"""The port's mixed prefill+decode path held against the JAX package's: the
pages-only attention kernel K11 (through its plain version) against the Pallas
kernel in interpret mode, ``hot_attention`` / ``merge_attention``,
``mixed_step`` op by op, and the mixed-scheduling engine.

Geometry of the step and engine tests: ``tests/test_serving_mixed.py``'s
2-layer model (hidden 1024, 8 heads of 128, page = chunk = 128, W 32), on the
same weights converted from the JAX package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu.config import QuantSpec
from atom_tpu.models.configs import Arch, ModelConfig
from atom_tpu.ops.kv_hot import HotKV as JHot
from atom_tpu.ops.kv_hot import hot_attention as j_hot_attention
from atom_tpu.ops.kv_hot import merge_attention as j_merge_attention
from atom_tpu.ops.kv_layout import KVPages as JPages
from atom_tpu.ops.kv_layout import kv_codes_from_kernel
from atom_tpu.ops.pallas_decode import paged_decode_attention_rotated as j_paged
from atom_tpu.serving import engine as jeng
from atom_tpu.serving import kvpool as jpool
from atom_tpu.serving import model as jm
from atom_tpu.serving import workload as jwl
from atom_tpu_torch.config import QuantSpec as TQuantSpec
from atom_tpu_torch.models.configs import Arch as TArch
from atom_tpu_torch.models.configs import ModelConfig as TModelConfig
from atom_tpu_torch.ops.decode import paged_decode_attention_rotated as t_paged
from atom_tpu_torch.ops.kv_hot import HotKV as THot
from atom_tpu_torch.ops.kv_hot import hot_attention as t_hot_attention
from atom_tpu_torch.ops.kv_hot import merge_attention as t_merge_attention
from atom_tpu_torch.ops.kv_layout import KVPages as TPages
from atom_tpu_torch.serving import KvPool, RequestSet, TextGenConfig, TextGenEngine
from atom_tpu_torch.serving import model as tm
from atom_tpu_torch.serving.convert import serving_params_from_numpy, tensor_from_numpy
from test_torch_serving import cap_torch_threads

cap_torch_threads()

CFG_KW = dict(vocab_size=256, hidden_size=1024, intermediate_size=2048, num_layers=2,
              num_heads=8, num_kv_heads=8, head_dim=128)
JCFG, TCFG = ModelConfig(arch=Arch.LLAMA, **CFG_KW), TModelConfig(arch=TArch.LLAMA, **CFG_KW)
JSPEC, TSPEC = QuantSpec(weight_channel_group=1), TQuantSpec(weight_channel_group=1)
PAGE = 128  # == chunk size


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _bf16(rng, shape, scale=1.0, lo=None):
    x = rng.standard_normal(shape).astype(np.float32) * scale
    if lo is not None:
        x = rng.uniform(lo, scale, shape).astype(np.float32)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16))


def _pages(rng, n_pages, h, s, d=128):
    kp = rng.integers(-128, 128, (n_pages, h, d // 2, s)).astype(np.int8)
    vp = rng.integers(-128, 128, (n_pages, h, s // 2, d)).astype(np.int8)
    prm = _bf16(rng, (n_pages, 4, h, s), 0.1, lo=0.01)
    # zero rows like real codes' zero_val
    prm[:, 1] = np.asarray(jnp.asarray(-7.5 * np.asarray(prm[:, 0], np.float32)).astype(jnp.bfloat16))
    prm[:, 3] = np.asarray(jnp.asarray(-7.5 * np.asarray(prm[:, 2], np.float32)).astype(jnp.bfloat16))
    return kp, vp, prm


def _ring(rng, b, h, w, d=128):
    return (rng.integers(-128, 128, (b, h, d // 2, w)).astype(np.int8), _bf16(rng, (b, 4, h, w), 0.1, lo=0.01),
            rng.integers(0, 16, (b, h, w, d)).astype(np.int8))


# ---------------------------------------------------------------------------
# K11
# ---------------------------------------------------------------------------


def _check_state(got, want, lens_per_row):
    """m and l within 1e-5 relative (float32 sums in another order: one pass
    here, online over pages there); empty rows exactly m = -1e30, l = 0."""
    (gm, gl), (wm, wl) = got, want
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-5, atol=1e-7)
    empty = lens_per_row == 0
    assert np.all(gm.numpy()[empty] == np.float32(-1e30)) and np.all(gl.numpy()[empty] == 0)


@pytest.mark.parametrize("heads,kv_heads,out_dtype", [(4, 4, "bfloat16"), (8, 4, "bfloat16"), (4, 4, "float32")])
def test_paged_decode_attention_rotated_matches_pallas(heads, kv_heads, out_dtype):
    """K11, MHA and GQA, bf16 and f32 out: idle rows, a partial last page, full
    pages.  Out within K3's tolerance (atol = rtol = 2e-2 on the bf16 output; the
    f32 output to 1e-4); idle rows are finite zero rows."""
    rng = np.random.default_rng(heads + kv_heads)
    b, s, max_pages = 8, 256, 3
    kp, vp, prm = _pages(rng, 1 + b * max_pages, kv_heads, s)
    table = (1 + np.arange(b * max_pages).reshape(b, max_pages)).astype(np.int32)
    seq_lens = np.array([0, 0, 255, 256, 257, 600, 768, 1], np.int32)
    table[:2] = 0
    q = _bf16(rng, (b, heads, 128), 1.0)
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)

    want, wm, wl = j_paged(jnp.asarray(q), JPages(*(jnp.asarray(x) for x in (kp, vp, prm))), jnp.asarray(table),
                           jnp.asarray(seq_lens), out_dtype=jdt, return_state=True, interpret=True)
    got, gm, gl = t_paged(_t(q), TPages(*(_t(x) for x in (kp, vp, prm))), _t(table), _t(seq_lens),
                          out_dtype=tdt, return_state=True)
    assert got.dtype == tdt and got.shape == (b, heads, 128)
    tol = dict(atol=2e-2, rtol=2e-2) if out_dtype == "bfloat16" else dict(atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    _check_state((gm, gl), (wm, wl), np.repeat(seq_lens, heads).reshape(b, heads))
    assert np.isfinite(got.float().numpy()).all() and not got[:2].any()
    # without return_state: the output alone
    alone = t_paged(_t(q), TPages(*(_t(x) for x in (kp, vp, prm))), _t(table), _t(seq_lens), out_dtype=tdt)
    assert torch.equal(alone, got)


@pytest.mark.parametrize("heads,kv_heads,prefix", [(4, 4, 0), (4, 4, 300), (8, 4, 256)])
def test_paged_decode_attention_chunk_prefix_shape_matches_pallas(heads, kv_heads, prefix):
    """The chunk-prefix call: one batch row whose query axis holds all C chunk
    queries of every q head (G' = G * C rows per kv head), f32 out with state.
    ``prefix = 0`` (a prompt's first chunk) gives out = 0, m = -1e30, l = 0."""
    rng = np.random.default_rng(prefix + heads)
    s, c, max_pages = 128, 16, 4
    kp, vp, prm = _pages(rng, 1 + max_pages, kv_heads, s)
    table = (1 + np.arange(max_pages)).astype(np.int32)[None]
    lens = np.array([prefix], np.int32)
    q = _bf16(rng, (1, heads * c, 128), 1.0)
    want, wm, wl = j_paged(jnp.asarray(q), JPages(*(jnp.asarray(x) for x in (kp, vp, prm))), jnp.asarray(table),
                           jnp.asarray(lens), head_block=8, out_dtype=jnp.float32, return_state=True, interpret=True)
    got, gm, gl = t_paged(_t(q), TPages(*(_t(x) for x in (kp, vp, prm))), _t(table), _t(lens),
                          out_dtype=torch.float32, return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    _check_state((gm, gl), (wm, wl), np.full((1, heads * c), prefix))
    if prefix == 0:
        assert not got.any()


# ---------------------------------------------------------------------------
# hot_attention / merge_attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (8, 4)])
def test_hot_attention_and_merge_match_jax(heads, kv_heads):
    """The ring part and the two-part merge against the JAX functions (plain
    tensor code on both sides): rtol 1e-5 on the f32 parts, one bf16 ulp on the
    merged output; the merge with an empty paged part (``l1 = 0``) included."""
    rng = np.random.default_rng(heads)
    b, w, row = 6, 32, 7
    ring = _ring(rng, b, kv_heads, w)
    n_hot = np.array([0, 1, 8, 32, 17, 31], np.int32)
    q = _bf16(rng, (b, heads, 128), 1.0)
    sm_scale = 128 ** -0.5
    wo, wm, wl = j_hot_attention(jnp.asarray(q), JHot(*(jnp.asarray(x) for x in ring)), jnp.asarray(n_hot),
                                 jnp.int32(row), sm_scale)
    go, gm, gl = t_hot_attention(_t(q), THot(*(_t(x) for x in ring)), _t(n_hot), row, sm_scale)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-5, atol=1e-7)
    assert np.all(gm.numpy()[0] == np.float32(-1e30)) and not gl.numpy()[0].any()

    out1 = rng.standard_normal((b, heads, 128)).astype(np.float32)
    m1 = rng.uniform(-3, 3, (b, heads)).astype(np.float32)
    l1 = rng.uniform(0.5, 40, (b, heads)).astype(np.float32)
    out1[2:4], m1[2:4], l1[2:4] = 0.0, -1e30, 0.0  # nothing flushed: the paged part is empty
    want = j_merge_attention(jnp.asarray(out1), jnp.asarray(m1), jnp.asarray(l1), wo, wm, wl)
    got = t_merge_attention(_t(out1), _t(m1), _t(l1), _t(np.asarray(wo)), _t(np.asarray(wm)), _t(np.asarray(wl)))
    assert got.dtype == torch.bfloat16 and np.isfinite(got.float().numpy()).all()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2**-7, atol=1e-6)
    # rows whose paged part is empty are the ring part alone, normalised
    alone = np.asarray(wo)[2:4] / np.maximum(np.asarray(wl)[2:4], 1e-20)[..., None]
    np.testing.assert_allclose(got.float().numpy()[2:4], alone, rtol=2**-7, atol=1e-6)


# ---------------------------------------------------------------------------
# mixed_step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixed_params():
    jparams = jm.init_serving_params(jax.random.PRNGKey(0), JCFG, JSPEC)
    return jparams, serving_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _codes(pages, torch_side):
    """(k codes, k params, v codes, v params) of pages 1..3 as numpy, slot-major."""
    if torch_side:
        pages = JPages(*(jnp.asarray(np.asarray(t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()))
                         for t in pages))
        pages = pages._replace(params=jax.lax.bitcast_convert_type(pages.params, jnp.bfloat16))
    return [np.asarray(x)[1:4] for x in kv_codes_from_kernel(pages)]


def test_mixed_step_matches_jax_opbyop(mixed_params):
    """A 300-token prompt in three chunks beside two decoding sequences, the
    third step flushing the ring, against ``jm.mixed_step`` run op by op
    (``jax.disable_jit``, Pallas kernels in interpret mode).

    Layer-0 pages (the prompt's three and the decoding sequences') bitwise,
    ``flushed``, ``row`` and ``chunk_tok`` equal, next ids equal.  Layer 1 sees
    attention outputs whose f32 sums ran in another order, so a few 4-bit codes
    on a rounding boundary flip: the bound of ``tests/test_serving_mixed.py``
    (under 5% of K codes differing, under 0.5% of dequantized values beyond 2.5
    steps)."""
    jparams, tparams = mixed_params
    n_pages, batch, w = 10, 3, 32
    rng = np.random.Generator(np.random.PCG64(3))
    t_true = 300
    prompt = rng.integers(1, JCFG.vocab_size, t_true).astype(np.int32)
    chunk_row = np.asarray([1, 2, 3, 0], np.int32)
    # slots 0 and 1 decode (contexts 40 and 70, pages 4 and 5), slot 2 is the prompt's
    dec_table = np.asarray([[4, 0, 0, 0], [5, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    lens0 = np.asarray([40, 70, 0], np.int32)
    ids = rng.integers(1, JCFG.vocab_size, (3, batch)).astype(np.int32)
    ids[:, 2] = 0

    jstate = jm.make_serving_state(JCFG.num_layers, n_pages, batch, JCFG.num_kv_heads, PAGE, JCFG.head_dim)
    tstate = tm.make_serving_state(TCFG.num_layers, n_pages, batch, TCFG.num_kv_heads, PAGE, TCFG.head_dim, device="cpu")
    # the decoding sequences' tokens so far sit in the ring (nothing flushed): the
    # step at ring row 31 flushes them, so start at row 29
    ring = [_ring(rng, batch, JCFG.num_kv_heads, w) for _ in range(JCFG.num_layers)]
    jstate = jstate._replace(hot=[JHot(*(jnp.asarray(x) for x in r)) for r in ring], row=jnp.int32(29),
                             flushed=jnp.asarray(np.maximum(lens0 - 29, 0)))
    tstate = tstate._replace(hot=[THot(*(_t(x) for x in r)) for r in ring], row=29,
                             flushed=_t(np.maximum(lens0 - 29, 0).astype(np.int32)))

    mixed = jm.mixed_step.__wrapped__
    pos, step = 0, 0
    with jax.disable_jit():
        while pos < t_true:
            clen = min(PAGE, t_true - pos)
            cids = np.zeros((PAGE,), np.int32)
            cids[:clen] = prompt[pos : pos + clen]
            lens = np.where(lens0 > 0, lens0 + step + 1, 0).astype(np.int32)
            flush = step == 2
            jn, jtok, jstate = mixed(jparams, jstate, jnp.asarray(ids[step]), jnp.asarray(dec_table), jnp.asarray(lens),
                                     jnp.asarray(cids), jnp.asarray(chunk_row), jnp.int32(pos), jnp.int32(clen),
                                     jnp.int32(2), JCFG, JSPEC, flush=flush)
            tn, ttok, tstate = tm.mixed_step(tparams, tstate, _t(ids[step]), _t(dec_table), _t(lens), _t(cids),
                                             _t(chunk_row), pos, clen, 2, TCFG, TSPEC, flush=flush)
            np.testing.assert_array_equal(tn.numpy()[:2], np.asarray(jn)[:2], err_msg=f"next ids, step {step}")
            assert tstate.row == int(jstate.row)
            np.testing.assert_array_equal(tstate.flushed.numpy(), np.asarray(jstate.flushed))
            pos += clen
            step += 1
    assert step == 3 and int(ttok) == int(jtok)
    assert tstate.flushed.tolist() == [43, 73, t_true] and tstate.row == 0

    def valid_mask(arr):  # [3 pages, H, S, D] -> slots < t_true
        m = np.zeros(arr.shape, bool)
        for p in range(3):
            m[p, :, : min(PAGE, t_true - p * PAGE)] = True
        return m

    ka, _, va, _ = _codes(jstate.pages[0], False)
    kb, _, vb, _ = _codes(tstate.pages[0], True)
    m = valid_mask(ka)
    assert ((ka != kb) & m).sum() == 0 and ((va != vb) & m).sum() == 0
    # the decoding sequences' flushed pages (4 and 5) of layer 0: every array bitwise
    for jarr, tarr in zip(jstate.pages[0], tstate.pages[0]):
        jb = np.asarray(jarr)
        jb = jb.view(np.int16) if jb.dtype.name == "bfloat16" else jb
        tb = tarr.view(torch.int16).numpy() if tarr.dtype == torch.bfloat16 else tarr.numpy()
        np.testing.assert_array_equal(tb[4:6], jb[4:6])

    ka, kpa, _, _ = _codes(jstate.pages[1], False)
    kb, kpb, _, _ = _codes(tstate.pages[1], True)
    frac = ((ka != kb) & m).sum() / m.sum()
    assert frac < 0.05, f"{frac:.2%} of layer-1 K codes differ"
    deq_a, deq_b = ka * kpa[..., 0:1] + kpa[..., 1:2], kb * kpb[..., 0:1] + kpb[..., 1:2]
    step_sz = np.maximum(kpa[..., 0:1], kpb[..., 0:1])
    big = (np.abs(deq_a - deq_b) * m > 2.5 * step_sz + 1e-6).sum() / m.sum()
    assert big < 0.005, f"{big:.3%} of layer-1 K values deviate > 2.5 steps"


def test_mixed_step_rejects_a_chunk_that_is_not_a_page(mixed_params):
    _, tparams = mixed_params
    state = tm.make_serving_state(TCFG.num_layers, 4, 2, TCFG.num_kv_heads, PAGE, TCFG.head_dim, device="cpu")
    z = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="chunk size"):
        tm.mixed_step(tparams, state, z, torch.zeros((2, 4), dtype=torch.int32), z, torch.zeros((64,), dtype=torch.int32),
                      torch.zeros((4,), dtype=torch.int32), 0, 64, 0, TCFG, TSPEC)


def test_mixed_step_fns_share_the_ring_counter(mixed_params, monkeypatch):
    """``decode_fn`` and ``chunk_fn`` of ``make_mixed_step_fns`` count ring steps
    together: the W-th call of either kind flushes, as in the JAX package."""
    _, tparams = mixed_params
    flushes = []
    monkeypatch.setattr(tm, "decode_step", lambda *a, flush=False, **k: flushes.append(("d", flush)))
    monkeypatch.setattr(tm, "mixed_step", lambda *a, flush=False, **k: flushes.append(("m", flush)))
    _, dec, chunk = tm.make_mixed_step_fns(tparams, TCFG, TSPEC)
    for i in range(64):
        (chunk if i % 3 == 0 else dec)(*([None] * (9 if i % 3 == 0 else 4)))
    assert [i for i, (_, f) in enumerate(flushes) if f] == [31, 63]
    assert flushes[63][0] == "m" and flushes[31][0] == "d"


# ---------------------------------------------------------------------------
# the mixed engine
# ---------------------------------------------------------------------------


def _workload():
    rng = np.random.Generator(np.random.PCG64(5))
    prompts = [rng.integers(1, JCFG.vocab_size, int(rng.integers(40, 300))).astype(np.int32) for _ in range(5)]
    prompt_lens = np.asarray([len(p) for p in prompts])
    return prompt_lens, np.asarray([6, 9, 40, 5, 7]), prompts  # one output crosses the ring flush


def _op_by_op_mixed_fns(jparams):
    """``make_mixed_step_fns`` over the JAX step functions without their outer
    ``jax.jit`` (the chain of roundings the port follows op by op)."""
    from atom_tpu.ops.kv_hot import HOT_W

    prefill, _ = jm.make_step_fns(jparams, JCFG, JSPEC)
    decode, mixed = jm.decode_step.__wrapped__, jm.mixed_step.__wrapped__
    counter = {"n": 0}

    def flush_now():
        counter["n"] += 1
        return counter["n"] % HOT_W == 0

    def decode_fn(state, ids, page_table, seq_lens):
        return decode(jparams, state, ids, page_table, seq_lens, JCFG, JSPEC, flush=flush_now())

    def chunk_fn(state, ids, page_table, seq_lens, *chunk_args):
        return mixed(jparams, state, ids, page_table, seq_lens, *chunk_args, JCFG, JSPEC, flush=flush_now())

    return prefill, decode_fn, chunk_fn


def _jax_mixed_run(fns, requests, n_pool, bsz):
    pool = jpool.KvPool(JCFG.num_layers, n_pool, JCFG.num_kv_heads, PAGE, JCFG.head_dim)
    state = jm.make_serving_state(JCFG.num_layers, n_pool, bsz, JCFG.num_kv_heads, PAGE, JCFG.head_dim)
    tg = jeng.TextGenConfig(batch_size=bsz, page_size=PAGE, max_seq_len=512, prefill_buckets=(128, 256, 512))
    pre, dec, chunk = fns
    res = jeng.TextGenEngine(tg, pool, pre, dec, state, chunk_fn=chunk).run(jwl.RequestSet(*requests), record=True)
    return res, pool.num_free_pages


def test_mixed_engine_matches_jax(mixed_params):
    """The mixed-scheduling engine on the workload of
    ``tests/test_serving_mixed.py`` (5 requests, batch 2, prompts of 40-299
    tokens arriving mid-stream) in both packages.

    Against the JAX mixed engine as its tests run it (jitted steps): the same
    ``decode_steps`` and ``mixed_steps``, every request's token count, the pool
    drained.  Against the JAX engine driving ``mixed_step`` and ``decode_step``
    op by op: first tokens (which depend on the prompt alone) equal in at least
    4 of 5 requests, the share ``tests/test_torch_engine.py`` holds the serial
    engine to (7 of 8).  The port is deterministic over two runs."""
    jparams, tparams = mixed_params
    requests = _workload()
    n_pool, bsz = 24, 2
    jres, jfree = _jax_mixed_run(jm.make_mixed_step_fns(jparams, JCFG, JSPEC), requests, n_pool, bsz)
    eres, efree = _jax_mixed_run(_op_by_op_mixed_fns(jparams), requests, n_pool, bsz)

    def run():
        pool = KvPool(TCFG.num_layers, n_pool, TCFG.num_kv_heads, PAGE, TCFG.head_dim)
        state = tm.make_serving_state(TCFG.num_layers, n_pool, bsz, TCFG.num_kv_heads, PAGE, TCFG.head_dim, device="cpu")
        tg = TextGenConfig(batch_size=bsz, page_size=PAGE, max_seq_len=512, prefill_buckets=(128, 256, 512))
        pre, dec, chunk = tm.make_mixed_step_fns(tparams, TCFG, TSPEC)
        engine = TextGenEngine(tg, pool, pre, dec, state, chunk_fn=chunk)
        res = engine.run(RequestSet(*requests), record=True)
        assert engine.last_prefill_s == []  # no serial prefill ran
        return res, pool.num_free_pages

    tres, tfree = run()
    assert set(tres) == set(jres)
    for key in ("requests", "decode_steps", "mixed_steps", "total_tokens", "output_tokens", "scheduler", "prompt_lens"):
        assert tres[key] == jres[key] == eres[key], key
    assert tres["mixed_steps"] > 0  # decode kept stepping during at least one admission
    assert tfree == jfree == efree == n_pool - 1
    first = 0
    for r in range(5):
        assert len(tres["tokens"][r]) == len(jres["tokens"][r]) == int(requests[1][r])
        assert all(0 <= t < TCFG.vocab_size for t in tres["tokens"][r])
        first += tres["tokens"][r][0] == eres["tokens"][r][0]
    assert first >= 4, f"first tokens agree in {first}/5 requests"
    tres2, _ = run()
    assert tres2["tokens"] == tres["tokens"], "the mixed engine must be deterministic"
