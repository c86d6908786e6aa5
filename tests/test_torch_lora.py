"""The port's LoRA serving (``atom_tpu_torch/serving/lora.py``) held against
``atom_tpu/serving/lora.py``, the step hooks it rides on, and the seven
properties of ``tests/test_serving_lora.py`` on the port.

Geometry: the JAX LoRA tests' TINY model (vocab 199, hidden 256, inter 384,
2 layers, 2 heads of 128), where both packages' base decode step takes the
unfused qkv path as LoRA does; the decode comparisons use
``tests/test_torch_serving.py``'s state (batch 32, page 256, W 32) and its
fused geometry for the hooks.  The JAX side runs its Pallas kernels in
interpret mode, eagerly (the steps' ``__wrapped__`` forms), computed once per
module; the port its plain versions.

Tolerances.  XLA and PyTorch round three float32 computations differently in
the last bit on the CPU: the deltas' sums (``einsum`` against ``bmm``), the
norm of a float32 residual and SiLU.  So ``add_lora`` and the post-attention
block (float32 out) hold within rtol = atol = 1e-5, the JAX test's own
tolerance; the attention block (bf16 q, u4 K/V) within one bf16 rounding and
0.5% of codes flipped (measured: bitwise).  In the steps layer 0 is bitwise
(ring, pages, measured and required); the float32 residual entering layer 1
differs in the last bit, so layer 1's quantizers flip near-tied codes in the
entries this step writes: at most ``LAYER1_FLIPS`` of them (measured: in a
decode step's new ring column 1.9-2.3% of K codes, 7-8% of params, 0.7-2.2%
of V codes; in a 70-token prefill's layer-1 pages 2.1%, 4.5% and 1.7%).
Everything else, and the prefill's token, is bitwise; next ids agree in 75% of
the batch (measured 31 of 32), as ``tests/test_torch_moe.py`` holds them.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu.config import ATOM_W4A4
from atom_tpu.models.configs import Arch, ModelConfig
from atom_tpu.models.nn import rope_tables as j_rope_tables
from atom_tpu.serving import lora as jlora
from atom_tpu.serving import model as jm
from atom_tpu_torch.config import ATOM_W4A4 as T_SPEC
from atom_tpu_torch.models.configs import Arch as TArch
from atom_tpu_torch.models.configs import ModelConfig as TModelConfig
from atom_tpu_torch.models.nn import rope_tables
from atom_tpu_torch.serving import KvPool, RequestSet, TextGenConfig, TextGenEngine
from atom_tpu_torch.serving import lora as tlora
from atom_tpu_torch.serving import model as tm
from atom_tpu_torch.serving.convert import lora_from_numpy, serving_params_from_numpy, serving_state_from_numpy
from atom_tpu_torch.serving.kvpool import SeqKvCache, batch_page_table
from test_torch_serving import B, PAGE, W, _bits, _cfgs, _inputs, _state, _tbits, _to_jax, cap_torch_threads

cap_torch_threads()

KW = dict(vocab_size=199, hidden_size=256, intermediate_size=384, num_layers=2, num_heads=2, num_kv_heads=2,
          head_dim=128)
JCFG, TCFG = ModelConfig(arch=Arch.LLAMA, **KW), TModelConfig(arch=TArch.LLAMA, **KW)
TPAGE = 64  # the JAX LoRA tests' page
RANK, CAP, SCALE = 8, 2, 0.75
FLIP_FRAC = 5e-3  # quantizer codes that a last-bit float32 difference may flip in the attention block
LAYER1_FLIPS = 0.12  # entries written in layer 1 that may differ from JAX's (see the module docstring)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.to(torch.float32).numpy()


def _jax_to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the JAX oracle, once per module
# ---------------------------------------------------------------------------


def _decode_case(flush):
    rng = np.random.default_rng(40 + flush)
    table, ids = _inputs(rng, KW["vocab_size"])
    flushed = rng.integers(0, 2 * PAGE - W, B)
    flushed[:4] = [0, 230, 250, PAGE - W]  # from empty; crossing slot 256; ending at it
    lens = (flushed + W).astype(np.int32)
    flushed[5], lens[5] = 0, 0  # inactive slot
    st = _state(rng, KW["num_kv_heads"], flushed, row=W - 1)
    adapters = rng.integers(0, CAP, B).astype(np.int32)
    return dict(table=table, ids=ids, flushed=flushed, lens=lens, st=st, adapters=adapters)


def _prefill_case():
    rng = np.random.default_rng(5)
    true_len, bucket = 70, 128
    ids = np.zeros((bucket,), np.int32)
    ids[:true_len] = rng.integers(1, KW["vocab_size"], true_len)
    return dict(ids=ids, table_row=np.asarray([4, 2, 0, 0], np.int32), true_len=true_len, slot=1, adapter=1)


@pytest.fixture(scope="module")
def oracle():
    """Carried params and adapter store, and the JAX package's answers: the
    delta, the two blocks, the decode step with and without a flush, and a
    prefill."""
    jparams = jm.init_serving_params(jax.random.PRNGKey(1), JCFG, ATOM_W4A4)
    jlw = jlora.init_llama_lora(jax.random.PRNGKey(4), JCFG, capacity=CAP, rank=RANK)
    o = types.SimpleNamespace(jparams=jparams, jlw=jlw, tparams=serving_params_from_numpy(_jax_to_numpy(jparams), "cpu"),
                              tlw=lora_from_numpy(_jax_to_numpy(jlw), "cpu"))
    rng = np.random.default_rng(11)
    # add_lora: per-row and one adapter for all rows
    o.x_delta = rng.standard_normal((5, KW["hidden_size"])).astype(np.float32)
    o.idx_rows = np.asarray([1, 0, 1, 1, 0], np.int32)
    o.delta_rows = np.asarray(jlora.add_lora(jnp.asarray(o.x_delta), jlw.q, jnp.asarray(o.idx_rows), 1, SCALE))
    o.delta_one = np.asarray(jlora.add_lora(jnp.asarray(o.x_delta), jlw.q, jnp.int32(1), 0, SCALE))
    # the blocks on 6 rows of layer 1, per-row adapters
    t = 6
    o.idx_blk = np.asarray([0, 1, 1, 0, 1, 0], np.int32)
    o.x_blk = np.asarray(jnp.asarray(rng.standard_normal((t, KW["hidden_size"])), jnp.bfloat16))
    o.pos_blk = np.asarray([0, 3, 7, 40, 100, 255], np.int32)
    lp = jparams.layers[1]
    jq, jk, jv = jlora._lora_attn_block(jnp.asarray(o.x_blk), lp, JCFG, ATOM_W4A4,
                                        j_rope_tables(jnp.asarray(o.pos_blk), 128, JCFG.rope_theta), jlw,
                                        jnp.asarray(o.idx_blk), 1, SCALE)
    o.attn_blk = (np.asarray(jq), np.asarray(jk.codes), np.asarray(jk.params), np.asarray(jv.codes),
                  np.asarray(jv.params))
    o.attn_in = np.asarray(jnp.asarray(rng.standard_normal((t, 256)) * 0.5, jnp.bfloat16))
    o.post_blk = {}
    for dt in ("bfloat16", "float32"):
        x = jnp.asarray(o.x_blk).astype(dt)
        o.post_blk[dt] = np.asarray(jlora._lora_post_attn(x, jnp.asarray(o.attn_in), lp, ATOM_W4A4, jlw,
                                                          jnp.asarray(o.idx_blk), 1, SCALE, JCFG.norm_eps))
    # the decode step, eagerly, with and without the ring flush
    o.decode = {}
    for flush in (False, True):
        c = _decode_case(flush)
        jids, jst = jlora.lora_decode_step.__wrapped__(
            jparams, jlw, _to_jax(c["st"]), jnp.asarray(c["ids"]), jnp.asarray(c["table"]), jnp.asarray(c["lens"]),
            jnp.asarray(c["adapters"]), JCFG, ATOM_W4A4, SCALE, flush=flush)
        o.decode[flush] = (c, np.asarray(jids), _jax_to_numpy(jst))
    # a prefill of 70 tokens in a 128-row bucket
    c = _prefill_case()
    jstate = jm.make_serving_state(2, 6, 2, KW["num_kv_heads"], TPAGE, 128)
    jtok, jst = jlora.lora_prefill_step.__wrapped__(
        jparams, jlw, jstate, jnp.asarray(c["ids"]), jnp.asarray(c["table_row"]), jnp.int32(c["true_len"]),
        jnp.int32(c["slot"]), jnp.int32(c["adapter"]), JCFG, ATOM_W4A4, SCALE)
    o.prefill = (c, int(jtok), _jax_to_numpy(jst))
    return o


# ---------------------------------------------------------------------------
# the hooks
# ---------------------------------------------------------------------------


def _parent_decode_hidden(params, state, ids, page_table, seq_lens, cfg, spec, flush=False):
    """``decode_hidden`` as it stood before the hooks, line for line."""
    b = ids.shape[0]
    dh = cfg.head_dim
    x = tm._embed_lookup(params.embed, ids)
    pos = torch.clamp_min(seq_lens - 1, 0)
    cos, sin = rope_tables(pos, dh, cfg.rope_theta)
    w = state.hot[0].window
    row = state.row
    flush_args, flushed_new = tm._flush_plan(state, page_table, seq_lens, flush)
    n_hot = seq_lens - flushed_new
    for l, lp in enumerate(params.layers):
        hot = state.hot[l]
        q = tm._attn_block_decode_ring(x, lp, cfg, spec, (cos, sin), hot, row)
        if flush:
            tm.flush_hot_ring(state.pages[l], hot, row, *flush_args)
        attn = tm.paged_ring_decode_attention(q, state.pages[l], page_table, flushed_new, hot, n_hot, row)
        x = tm._post_attn(x, attn.reshape(b, cfg.num_heads * dh), lp, spec)
    new_state = tm.ServingState(pages=state.pages, hot=state.hot, row=(row + 1) % w, flushed=flushed_new)
    return tm.rmsnorm(x, params.final_norm, cfg.norm_eps), new_state


def _parent_prefill_hidden(params, pages, ids, table_row, cfg, spec):
    """``prefill_hidden`` as it stood before the hooks (the one-pass
    attention of prompts up to ``PREFILL_SCAN_THRESHOLD``)."""
    t = ids.shape[0]
    dh = cfg.head_dim
    x = tm._embed_lookup(params.embed, ids)
    cos, sin = rope_tables(torch.arange(t), dh, cfg.rope_theta)
    for l, lp in enumerate(params.layers):
        q, kq, vq = tm._attn_block_common(x, lp, cfg, spec, (cos, sin))
        tm.append_kv_prefill_kernel(pages[l], kq, vq, table_row)
        attn = tm.causal_code_attention(q, kq, vq, cfg.kv_groups, dh**-0.5)
        x = tm._post_attn(x, attn, lp, spec)
    return tm.rmsnorm(x, params.final_norm, cfg.norm_eps), pages


def _base_hooks(cfg, spec, decode):
    """Hooks that are the base blocks themselves."""

    def post_fn(x, attn, lp, layer, gather):
        assert gather is None
        return tm._post_attn(x, attn, lp, spec)

    if decode:
        def attn_fn(x, lp, layer, rope, hot, row):
            return tm._attn_block_decode_ring(x, lp, cfg, spec, rope, hot, row), hot
    else:
        def attn_fn(x, lp, layer, rope):
            return tm._attn_block_common(x, lp, cfg, spec, rope)
    return dict(attn_block_fn=attn_fn, post_attn_fn=post_fn)


def _state_bits(state):
    out = [_tbits(t) for pg in state.pages for t in pg]
    if hasattr(state, "hot"):
        out += [_tbits(t) for h in state.hot for t in h] + [state.flushed.numpy(), np.asarray(state.row)]
    return out


@pytest.mark.parametrize("case", ["decode", "decode_flush", "prefill"])
def test_hooks_absent_is_the_parent_path(case):
    """``decode_hidden`` / ``prefill_hidden`` with no hook equal the parent's
    functions bit for bit (hidden, pages, ring), and so do hooks that are the
    base blocks, on the fused MHA geometry of ``tests/test_torch_serving.py``
    (K2 in decode, K7 in prefill)."""
    _, tcfg = _cfgs(4, 4)
    params = tm.init_serving_params(tcfg, T_SPEC, seed=3, device="cpu")
    prompt = _t(np.random.default_rng(7).integers(0, tcfg.vocab_size, 96).astype(np.int32))
    outs = []
    for fn in ("parent", "none", "hooks"):
        if case == "prefill":
            ids = prompt
            pages = tm.make_serving_state(2, 4, 1, 4, 64, 128, device="cpu").pages
            table_row = _t(np.asarray([2, 3], np.int32))
            if fn == "parent":
                x, pages = _parent_prefill_hidden(params, pages, ids, table_row, tcfg, T_SPEC)
            else:
                kw = _base_hooks(tcfg, T_SPEC, decode=False) if fn == "hooks" else {}
                x, pages = tm.prefill_hidden(params, pages, ids, table_row, tcfg, T_SPEC, **kw)
            outs.append([_tbits(x)] + _state_bits(types.SimpleNamespace(pages=pages)))
            continue
        flush = case == "decode_flush"
        r = np.random.default_rng(9)
        table, ids = _inputs(r, tcfg.vocab_size)
        flushed = r.integers(0, 2 * PAGE - W, B)
        lens = (flushed + W).astype(np.int32)
        st = serving_state_from_numpy(_state(r, 4, flushed, row=W - 1), "cpu")
        args = (params, st, _t(ids), _t(table), _t(lens), tcfg, T_SPEC)
        if fn == "parent":
            x, st = _parent_decode_hidden(*args, flush=flush)
        else:
            kw = _base_hooks(tcfg, T_SPEC, decode=True) if fn == "hooks" else {}
            x, st = tm.decode_hidden(*args, flush=flush, **kw)
        outs.append([_tbits(x)] + _state_bits(st))
    for got in outs[1:]:
        assert len(got) == len(outs[0])
        for a, b in zip(got, outs[0]):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# conversion, the delta, the blocks
# ---------------------------------------------------------------------------


def test_lora_from_numpy_round_trip(oracle):
    """Every site's ``wa`` [A, L, r, d_in] and ``wb`` [A, L, d_out, r] carried
    across bit for bit, bf16, with the port's own site widths; and the
    port's own store has the same shapes and dtypes."""
    dims = tlora.lora_site_dims(TCFG)
    own = tlora.init_llama_lora(TCFG, CAP, RANK, seed=0, device="cpu")
    assert tlora.LlamaLora._fields == jlora.LlamaLora._fields == tuple(dims)
    for name, (d_in, d_out) in dims.items():
        js, ts = getattr(oracle.jlw, name), getattr(oracle.tlw, name)
        for a, t, shape in ((js.wa, ts.wa, (CAP, 2, RANK, d_in)), (js.wb, ts.wb, (CAP, 2, d_out, RANK))):
            assert t.dtype == torch.bfloat16 and tuple(t.shape) == shape
            np.testing.assert_array_equal(_tbits(t), _bits(a))
        assert getattr(own, name).wa.shape == ts.wa.shape and getattr(own, name).wb.shape == ts.wb.shape
    zero = tlora.init_llama_lora(TCFG, CAP, RANK, seed=0, device="cpu", zero_b=True)
    assert all(not s.wb.any() and s.wa.any() for s in zero)


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "scalar"])
def test_add_lora_matches_jax(oracle, per_row):
    """The delta against JAX's, per-row adapters and one adapter for all
    rows (int and 0-dim tensor), within rtol = atol = 1e-5, float32."""
    x = _t(oracle.x_delta)
    if per_row:
        got = tlora.add_lora(x, oracle.tlw.q, _t(oracle.idx_rows), 1, SCALE)
        want = oracle.delta_rows
    else:
        got = tlora.add_lora(x, oracle.tlw.q, 1, 0, SCALE)
        np.testing.assert_array_equal(tlora.add_lora(x, oracle.tlw.q, torch.tensor(1), 0, SCALE).numpy(), got.numpy())
        want = oracle.delta_one
    assert got.dtype == torch.float32 and got.shape == (5, KW["num_heads"] * 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_add_lora_matches_per_request_loop(oracle):
    """The batched gather-product equals each request's own
    ``x[i] @ wa[idx[i]].T @ wb[idx[i]].T * scale``, and one adapter for the
    whole batch equals the per-row form with that adapter in every row."""
    x = _t(oracle.x_delta)
    idx = _t(np.asarray([1, 0, 0, 1, 1], np.int32))
    got = tlora.add_lora(x, oracle.tlw.q, idx, 1, 0.7).numpy()
    for i in range(5):
        wa = oracle.tlw.q.wa[int(idx[i]), 1].to(torch.float32).numpy()
        wb = oracle.tlw.q.wb[int(idx[i]), 1].to(torch.float32).numpy()
        np.testing.assert_allclose(got[i], (oracle.x_delta[i] @ wa.T @ wb.T) * 0.7, rtol=1e-5, atol=1e-5)
    one = tlora.add_lora(x, oracle.tlw.q, 1, 0, 0.7).numpy()
    rows = tlora.add_lora(x, oracle.tlw.q, torch.full((5,), 1, dtype=torch.int32), 0, 0.7).numpy()
    np.testing.assert_allclose(one, rows, rtol=1e-6, atol=1e-6)


def _flip_frac(a, b):
    return float(np.mean(np.asarray(a) != np.asarray(b)))


def test_lora_attn_block_matches_jax(oracle):
    """``_lora_attn_block`` against JAX's on carried params (layer 1, six rows
    with per-row adapters): q within one bf16 rounding, K/V codes and params
    equal but for near-tie flips."""
    lp = oracle.tparams.layers[1]
    q, kq, vq = tlora._lora_attn_block(_t(oracle.x_blk.view(np.int16)).view(torch.bfloat16), lp, TCFG, T_SPEC,
                                       rope_tables(_t(oracle.pos_blk), 128, TCFG.rope_theta), oracle.tlw,
                                       _t(oracle.idx_blk), 1, SCALE)
    jq, jkc, jkp, jvc, jvp = oracle.attn_blk
    assert q.dtype == torch.bfloat16 and q.shape == (6, 2, 128)
    np.testing.assert_allclose(_np(q), np.asarray(jq, np.float32), rtol=2**-7, atol=1e-6)
    for got, want in ((kq.codes, jkc), (vq.codes, jvc), (kq.params, jkp), (vq.params, jvp)):
        assert got.shape == want.shape
        assert _flip_frac(_tbits(got), _bits(want)) <= FLIP_FRAC


@pytest.mark.parametrize("resid", ["bfloat16", "float32"])
def test_lora_post_attn_matches_jax(oracle, resid):
    """``_lora_post_attn`` against JAX's with a bf16 residual (layer 0's
    input) and a float32 one (every later layer's): the output is float32
    both ways, within rtol = atol = 1e-5."""
    lp = oracle.tparams.layers[1]
    x = _t(oracle.x_blk.view(np.int16)).view(torch.bfloat16).to(getattr(torch, resid))
    attn = _t(oracle.attn_in.view(np.int16)).view(torch.bfloat16)
    got = tlora._lora_post_attn(x, attn, lp, T_SPEC, oracle.tlw, _t(oracle.idx_blk), 1, SCALE, TCFG.norm_eps)
    want = oracle.post_blk[resid]
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the steps against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flush", [False, True])
def test_lora_decode_step_matches_jax(oracle, flush):
    """``lora_decode_step`` from a state whose ring holds W-1 tokens, per-slot
    adapters, against the JAX step run eagerly: layer 0's ring and pages
    bitwise; layer 1's ring bitwise but for the column this step wrote (at
    most ``LAYER1_FLIPS`` of it) and its pages but for the new token's lane
    (at most 2e-3 of the entries); ``flushed`` and ``row`` equal, next ids
    agreeing in 75% of the batch."""
    c, jids, jst = oracle.decode[flush]
    tids, tst = tlora.lora_decode_step(oracle.tparams, oracle.tlw, serving_state_from_numpy(c["st"], "cpu"),
                                       _t(c["ids"]), _t(c["table"]), _t(c["lens"]), _t(c["adapters"]), TCFG, T_SPEC,
                                       SCALE, flush=flush)
    assert tids.dtype == torch.int32 and np.mean(tids.numpy() == jids) >= 0.75
    np.testing.assert_array_equal(tst.flushed.numpy(), jst.flushed)
    assert tst.row == int(jst.row) == 0
    lens, flushed, table = c["lens"], c["flushed"], c["table"]
    active = lens > flushed
    new_slot = lens - 1
    page_of = table[np.arange(B), np.clip(new_slot // PAGE, 0, table.shape[1] - 1)]
    for layer in range(2):
        jr, tr = jst.hot[layer], tst.hot[layer]
        for a, t, axis in ((jr.k_codes, tr.k_codes, 3), (jr.prm, tr.prm, 3), (jr.v_codes, tr.v_codes, 2)):
            t, a = _tbits(t), _bits(a)
            np.testing.assert_array_equal(np.delete(t, W - 1, axis), np.delete(a, W - 1, axis))
            column = _flip_frac(np.take(t, [W - 1], axis), np.take(a, [W - 1], axis))
            assert column <= (LAYER1_FLIPS if layer else 0.0), f"layer {layer}: {column:.2%} of the new column"
        for field, lane_axis, in_plane in (("k_pages", 3, False), ("params", 3, False), ("v_pages", 2, True)):
            a, t = _bits(getattr(jst.pages[layer], field)), _tbits(getattr(tst.pages[layer], field))
            allowed = np.zeros(a.shape, bool)
            if flush:
                for b in np.nonzero(active)[0]:
                    lane = new_slot[b] % PAGE
                    idx = [page_of[b]] + [slice(None)] * (a.ndim - 1)
                    idx[lane_axis] = lane % (PAGE // 2) if in_plane else lane
                    allowed[tuple(idx)] = True
            assert not ((a != t) & ~allowed).any(), f"layer {layer} {field}: entries differ off the new token"
            assert np.mean(a != t) <= (2e-3 if layer else 0.0)


def test_lora_prefill_step_matches_jax(oracle):
    """``lora_prefill_step`` (true length 70 of a 128-row bucket, pages 4 and
    2, adapter 1) against the JAX step run eagerly: the same token, layer
    0's pages bitwise, layer 1's written pages but for at most
    ``LAYER1_FLIPS`` of their entries, the other pages untouched, ``flushed``
    set for the slot only."""
    c, jtok, jst = oracle.prefill
    tstate = tm.make_serving_state(2, 6, 2, KW["num_kv_heads"], TPAGE, 128, device="cpu")._replace(row=7)
    ttok, tst = tlora.lora_prefill_step(oracle.tparams, oracle.tlw, tstate, _t(c["ids"]), _t(c["table_row"]),
                                        c["true_len"], c["slot"], c["adapter"], TCFG, T_SPEC, SCALE)
    assert ttok.dtype == torch.int32 and ttok.ndim == 0 and int(ttok) == jtok
    assert tst.flushed.tolist() == [0, c["true_len"]] and tst.row == 7
    for layer in range(2):
        for f in ("k_pages", "v_pages", "params"):
            a, t = _bits(getattr(jst.pages[layer], f)), _tbits(getattr(tst.pages[layer], f))
            written = _flip_frac(t[[4, 2]], a[[4, 2]])
            assert written <= (LAYER1_FLIPS if layer else 0.0), f"layer {layer} {f}: {written:.2%} differ"
            np.testing.assert_array_equal(np.delete(t, [4, 2], 0), np.delete(a, [4, 2], 0))
    assert tst.pages[1].k_pages[[4, 2]].any()


# ---------------------------------------------------------------------------
# the properties of tests/test_serving_lora.py on the port
# ---------------------------------------------------------------------------


def _mini(oracle, batch, n_pages=12):
    return oracle.tparams, tm.make_serving_state(2, n_pages, batch, KW["num_kv_heads"], TPAGE, 128, device="cpu")


def test_zero_adapter_decode_matches_base(oracle):
    """``wb`` = 0: the LoRA step gives the base ``decode_step``'s tokens.  Both
    take the unfused qkv path at this geometry (n_q 256 is off K2's and K7's
    geometry, so the base step runs K1 into float32 + ``write_hot``), and
    layer 0's attention half is the same bit for bit: its ring column is
    equal.  The deltas are float32 zeros, but they make the residual float32,
    so from layer 0's MLP norm on the LoRA step quantizes an unrounded
    normalised value where the base step rounds it to bf16 first; activation
    codes flip, and the final hidden states differ (measured: max 0.35, mean
    0.080; bounded at 0.5 and 0.12), the tokens not."""
    lw0 = tlora.init_llama_lora(TCFG, 2, RANK, seed=2, device="cpu", zero_b=True)
    ids, table = _t(np.asarray([3, 7], np.int32)), _t(np.asarray([[1, 0], [2, 0]], np.int32))
    lens, adapters = _t(np.asarray([1, 1], np.int32)), _t(np.asarray([0, 1], np.int32))
    params, st_b = _mini(oracle, 2)
    _, st_l = _mini(oracle, 2)
    tok_b, _ = tm.decode_step(params, st_b, ids, table, lens, TCFG, T_SPEC)
    tok_l, _ = tlora.lora_decode_step(params, lw0, st_l, ids, table, lens, adapters, TCFG, T_SPEC, 1.0)
    np.testing.assert_array_equal(tok_b.numpy(), tok_l.numpy())
    _, st_b = _mini(oracle, 2)
    _, st_l = _mini(oracle, 2)
    x_b, st_b = tm.decode_hidden(params, st_b, ids, table, lens, TCFG, T_SPEC)
    x_l, st_l = tlora.lora_decode_hidden(params, lw0, st_l, ids, table, lens, adapters, TCFG, T_SPEC, 1.0)
    for a, b in zip(st_b.hot[0], st_l.hot[0]):
        assert torch.equal(a, b)
    assert x_b.dtype == torch.bfloat16 and x_l.dtype == torch.float32
    diff = (x_l - x_b.to(torch.float32)).abs()
    assert diff.max() <= 0.5 and diff.mean() <= 0.12, (diff.max(), diff.mean())


def test_adapter_isolation_in_mixed_batch(oracle):
    """A mixed batch [adapter 0, adapter 1] gives each slot the token a
    uniform batch of its own adapter gives it, and the two adapters
    disagree somewhere."""
    ids, table = _t(np.asarray([3, 3], np.int32)), _t(np.asarray([[1, 0], [2, 0]], np.int32))
    lens = _t(np.asarray([1, 1], np.int32))
    toks = {}
    for name, adapters in (("mixed", [0, 1]), ("all0", [0, 0]), ("all1", [1, 1])):
        params, st = _mini(oracle, 2)
        tok, _ = tlora.lora_decode_step(params, oracle.tlw, st, ids, table, lens, _t(np.asarray(adapters, np.int32)),
                                        TCFG, T_SPEC, 1.0)
        toks[name] = tok.numpy()
    assert toks["mixed"][0] == toks["all0"][0] and toks["mixed"][1] == toks["all1"][1]
    assert (toks["all0"] != toks["all1"]).any()


def test_lora_decode_matches_prefill_continuation(oracle):
    """With a live adapter, step-by-step decode (ring, a flush crossing)
    reproduces what a longer prefill predicts: at most 1 of 4 checks may
    diverge, as in the JAX test."""
    n_pages = 12
    pool = KvPool(2, n_pages, KW["num_kv_heads"], TPAGE, 128)
    params, state = _mini(oracle, 1, n_pages)
    rng = np.random.Generator(np.random.PCG64(9))
    prompt = rng.integers(1, KW["vocab_size"], 27).astype(np.int32)
    n_gen = 40

    def prefill(seq, bucket, state):
        kv = SeqKvCache(pool, len(seq))
        ids = np.zeros((bucket,), np.int32)
        ids[: len(seq)] = seq
        tr = np.zeros((4,), np.int32)
        tr[: len(kv.page_ids)] = kv.page_ids
        tok, state = tlora.lora_prefill_step(params, oracle.tlw, state, _t(ids), _t(tr), len(seq), 0, 1, TCFG, T_SPEC,
                                             1.0)
        return int(tok), state, kv

    tok, state, kv = prefill(prompt, 32, state)
    generated = [tok]
    for i in range(n_gen - 1):
        kv.acquire_one()
        table, lens = batch_page_table([kv], 4)
        tok, state = tlora.lora_decode_step(params, oracle.tlw, state, _t(np.asarray([generated[-1]], np.int32)),
                                            _t(table), _t(lens), _t(np.asarray([1], np.int32)), TCFG, T_SPEC, 1.0,
                                            flush=(i + 1) % 32 == 0)
        generated.append(int(tok[0]))
    mismatches = 0
    checks = (1, 5, 33, n_gen - 1)
    for k in checks:
        tok2, state, kv2 = prefill(np.concatenate([prompt, np.asarray(generated[:k], np.int32)]), 128, state)
        mismatches += tok2 != generated[k]
        kv2.release()
    kv.release()
    assert mismatches <= 1, f"{mismatches}/{len(checks)} prefill-continuation checks diverged"


def _engine(oracle, lw, b, n_pages, lora=True):
    params, state = _mini(oracle, b, n_pages)
    pool = KvPool(2, n_pages, KW["num_kv_heads"], TPAGE, 128)
    tg = TextGenConfig(batch_size=b, max_seq_len=TPAGE * 4, page_size=TPAGE, prefill_buckets=(32,))
    fns = tlora.make_lora_step_fns(params, lw, TCFG, T_SPEC, scale=1.0) if lora else tm.make_step_fns(params, TCFG,
                                                                                                       T_SPEC)
    return TextGenEngine(tg, pool, *fns, state, lora=lora), pool


def test_lora_engine_end_to_end(oracle):
    """``TextGenEngine(lora=True)`` over a ``RequestSet`` with
    ``adapter_ids``: the same prompt under the same adapter gives the same
    stream, under different adapters different ones; the adapter table goes
    up only when an admission changes it; every page comes back; a
    delta-free store agrees with the base engine on each stream's first two
    tokens (the JAX test's contract); ``chunk_fn`` is refused."""
    b, n_pages = 4, 24
    rng = np.random.Generator(np.random.PCG64(3))
    prompt = rng.integers(1, KW["vocab_size"], 9).astype(np.int32)
    rs = RequestSet(prompt_lens=np.full(6, 9, np.int32), output_lens=np.asarray([12, 12, 12, 12, 5, 5], np.int32),
                    prompts=[prompt.copy() for _ in range(6)], adapter_ids=np.asarray([0, 1, 0, 1, 1, 0], np.int32))
    eng, pool = _engine(oracle, oracle.tlw, b, n_pages)
    seen = []
    pre = eng.prefill_fn
    dec = eng.decode_fn
    eng.prefill_fn = lambda *a: (seen.append(("prefill", a[4], a[5])), pre(*a))[1]
    eng.decode_fn = lambda *a: (seen.append(("decode", a[4].tolist())), dec(*a))[1]
    res = eng.run(rs, record=True)
    toks = res["tokens"]
    assert toks[0] == toks[2] and toks[1] == toks[3] and toks[0] != toks[1]
    assert pool.num_free_pages == n_pages - 1 and res["output_tokens"] == 58
    assert [s[1:] for s in seen if s[0] == "prefill"] == [(0, 0), (1, 1), (2, 0), (3, 1), (0, 1), (1, 0)]
    assert seen[4] == ("decode", [0, 1, 0, 1]) and ("decode", [1, 0, 0, 1]) in seen

    lw0 = tlora.init_llama_lora(TCFG, 2, RANK, seed=6, device="cpu", zero_b=True)
    res0 = _engine(oracle, lw0, b, n_pages)[0].run(rs, record=True)
    res_b = _engine(oracle, None, b, n_pages, lora=False)[0].run(rs, record=True)
    for r in range(6):
        assert res0["tokens"][r][:2] == res_b["tokens"][r][:2]

    with pytest.raises(ValueError, match="serially"):
        pf, df, cf = tm.make_mixed_step_fns(oracle.tparams, TCFG, T_SPEC)
        TextGenEngine(eng.cfg, pool, pf, df, eng.state, chunk_fn=cf, lora=True)


def test_lora_decode_burst_matches_step_loop(oracle):
    """One ``lora_decode_burst`` window equals W ``lora_decode_step`` calls
    with the last one flushing: ids, lengths, pages and ring bit for bit."""
    adapters = _t(np.asarray([1, 0], np.int32))
    table = _t(np.asarray([[1, 2], [3, 4]], np.int32))
    ids0, lens0 = _t(np.asarray([3, 7], np.int32)), _t(np.asarray([5, 9], np.int32))
    params, st = _mini(oracle, 2)
    st = st._replace(flushed=lens0.clone())
    ids_b, st_b, lens_b = tlora.lora_decode_burst(params, oracle.tlw, st, ids0, table, lens0, 1, adapters, TCFG, T_SPEC)
    _, st = _mini(oracle, 2)
    st = st._replace(flushed=lens0.clone())
    ids_s, lens_s = ids0, lens0
    for i in range(W):
        lens_s = lens_s + 1
        ids_s, st = tlora.lora_decode_step(params, oracle.tlw, st, ids_s, table, lens_s, adapters, TCFG, T_SPEC, 1.0,
                                           flush=i == W - 1)
    np.testing.assert_array_equal(ids_b.numpy(), ids_s.numpy())
    np.testing.assert_array_equal(lens_b.numpy(), lens_s.numpy())
    for a, b in zip(_state_bits(st_b), _state_bits(st)):
        np.testing.assert_array_equal(a, b)
    assert st.row == 0 and st.flushed.tolist() == [5 + W, 9 + W]


def test_lora_manager_alloc_load_free():
    """Slots handed out in the JAX manager's order, exhaustion raises
    ``KeyError``, ``load`` installs a site's weights in place (rounded to
    bf16), ``free`` returns a slot."""
    lw = tlora.init_llama_lora(TCFG, 2, 4, seed=7, device="cpu", zero_b=True)
    jmgr = jlora.LoraManager(types.SimpleNamespace(q=types.SimpleNamespace(wa=np.zeros((2, 1)))))
    mgr = tlora.LoraManager(lw)
    assert mgr.capacity == 2
    s0, s1 = mgr.alloc(), mgr.alloc()
    assert (s0, s1) == (jmgr.alloc(), jmgr.alloc()) and {s0, s1} == {0, 1}
    with pytest.raises(KeyError):
        mgr.alloc()
    other = lw.q.wa[s1].clone()
    wa = np.full((2, 4, KW["hidden_size"]), 1.0 + 2**-10, np.float32)  # rounds to 1.0 in bf16
    wb = np.ones((2, KW["num_heads"] * 128, 4), np.float32)
    mgr.load(s0, "q", wa, wb)
    assert mgr.store is lw
    np.testing.assert_array_equal(lw.q.wa[s0].to(torch.float32).numpy(), np.ones_like(wa))
    np.testing.assert_array_equal(lw.q.wb[s0].to(torch.float32).numpy(), wb)
    assert torch.equal(lw.q.wa[s1], other)
    mgr.free(s0)
    assert mgr.alloc() == s0
