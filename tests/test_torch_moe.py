"""The port's MoE (Mixtral) serving slice held against the JAX package's
``atom_tpu/serving/moe.py`` on shared seeded inputs, and the port's named
model configs against the JAX package's.

Geometry: vocab 256, hidden 512, inter 512, 2 layers, 8 query and 4 kv heads
of 128, 4 experts, top-2; decode batch 32, page 256, W 32: the ring-fused qkv
branch (K2), and under ``ATOM_TPU_FUSED_MLP=1`` K9 and K10.  The JAX side
runs its Pallas kernels in interpret mode and its step functions eagerly
(their ``__wrapped__`` forms: the quantization chains the port follows op by
op), the port its plain versions.  The JAX results are computed once per
module.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atom_tpu.models.configs as jconfigs
import atom_tpu_torch.models.configs as tconfigs
from atom_tpu.config import ATOM_W4A4
from atom_tpu.models.configs import Arch, ModelConfig
from atom_tpu.serving import model as jm
from atom_tpu.serving import moe as jmoe
from atom_tpu_torch.config import ATOM_W4A4 as T_SPEC
from atom_tpu_torch.models.configs import Arch as TArch
from atom_tpu_torch.models.configs import ModelConfig as TModelConfig
from atom_tpu_torch.serving import KvPool, TextGenConfig, TextGenEngine, make_moe_step_fns, synth_requests
from atom_tpu_torch.serving import model as tm
from atom_tpu_torch.serving import moe as tmoe
from atom_tpu_torch.serving.convert import moe_serving_params_from_numpy, serving_state_from_numpy, tensor_from_numpy
from test_torch_serving import B, PAGE, W, _bits, _inputs, _state, _tbits, _to_jax, cap_torch_threads

cap_torch_threads()

KW = dict(vocab_size=256, hidden_size=512, intermediate_size=512, num_layers=2, num_heads=8, num_kv_heads=4,
          head_dim=128, num_experts=4, num_experts_per_tok=2, max_position_embeddings=1024)
JCFG, TCFG = ModelConfig(arch=Arch.MIXTRAL, **KW), TModelConfig(arch=TArch.MIXTRAL, **KW)
N_Q = KW["num_heads"] * KW["head_dim"]


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _bf16(x):
    return np.array(jnp.asarray(np.asarray(x, np.float32)).astype(jnp.bfloat16))


@pytest.fixture(scope="module")
def moe_params():
    jparams = jmoe.init_moe_serving_params(jax.random.PRNGKey(0), JCFG, ATOM_W4A4)
    return jparams, moe_serving_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


# ---------------------------------------------------------------------------
# configs, conversion, routing and the gates
# ---------------------------------------------------------------------------


NAMED_CONFIGS = sorted(n for n, v in vars(jconfigs).items() if isinstance(v, jconfigs.ModelConfig))


@pytest.mark.parametrize("name", NAMED_CONFIGS)
def test_named_config_equals_jax(name):
    """Every named config of the JAX package exists in the port, field by
    field equal (the architecture by its value)."""
    j, t = getattr(jconfigs, name), getattr(tconfigs, name)
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        assert (a.value, type(a).__name__) == (b.value, type(b).__name__) if f.name == "arch" else a == b, f.name
    assert t.kv_groups == j.kv_groups


def test_opt_config_function_equals_jax():
    assert dataclasses.astuple(tconfigs.opt(512, 2048, 3, 8, vocab=300))[1:] == dataclasses.astuple(
        jconfigs.opt(512, 2048, 3, 8, vocab=300))[1:]


def test_params_convert_bitwise(moe_params):
    """Every array bitwise; each expert's body and keeper scales arrive merged
    on the group axis (keeper scale last); ``ln_attn_g`` is
    ``ln_attn[attn_reorder]``; expert ``e`` is a contiguous view."""
    jparams, tparams = moe_params

    def eq(t, a):
        np.testing.assert_array_equal(_tbits(t), _bits(a))

    for f in ("embed", "final_norm", "lm_head"):
        eq(getattr(tparams, f), getattr(jparams, f))
    assert len(tparams.layers) == len(jparams.layers) == 2
    n_exp = KW["num_experts"]
    for jl, tl in zip(jparams.layers, tparams.layers):
        for f in tmoe.MoEServingLayerParams._fields[:-1]:
            jv, tv = getattr(jl, f), getattr(tl, f)
            if not f.startswith("w"):
                eq(tv, jv)
                continue
            eq(tv.body_packed, jv.body_packed)
            eq(tv.keeper, jv.keeper)
            body_s, keep_s = np.asarray(jv.body_scale), np.asarray(jv.keeper_scale)
            if f in ("wgateup", "wdown"):
                assert tv.scales.shape[0] == n_exp
                for e in range(n_exp):
                    eq(tv.scales[e], np.concatenate([body_s[e], keep_s[e][None]], 0))
                    w_e = tmoe.expert(tv, e)
                    assert all(x.is_contiguous() and x.data_ptr() % 16 == 0 for x in w_e)
                    assert w_e.body_packed.data_ptr() == tv.body_packed[e].data_ptr()
            else:
                eq(tv.scales, np.concatenate([body_s, keep_s[None]], 0))
        eq(tl.ln_attn_g, np.asarray(jl.ln_attn)[np.asarray(jl.attn_reorder)])


def test_ln_attn_g_follows_the_reorder(moe_params):
    """With a permuted ``attn_reorder`` and a non-uniform norm weight the
    gathered weight is the norm weight in the reorder's order."""
    jparams, _ = moe_params
    rng = np.random.default_rng(3)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    lp = tree.layers[0]
    perm = rng.permutation(KW["hidden_size"]).astype(np.int32)
    ln = _bf16(rng.uniform(0.5, 1.5, KW["hidden_size"]))
    tree.layers[0] = lp._replace(attn_reorder=perm, ln_attn=ln)
    got = moe_serving_params_from_numpy(tree, "cpu").layers[0].ln_attn_g
    np.testing.assert_array_equal(_tbits(got), ln[perm].view(np.int16))


@pytest.mark.parametrize("n_exp", [4, 8])
def test_route_top_k_matches_jax(n_exp):
    """The same float32 logits route to the same experts, the weights within
    4 ulp (XLA's and PyTorch's exp differ in the last bits on the CPU); ties
    rank the lower expert first in both."""
    rng = np.random.default_rng(n_exp)
    logits = (rng.standard_normal((512, n_exp)) * 1.3).astype(np.float32)
    logits[:4] = 0.5  # all tied
    logits[4, :3] = 10.0  # three tied for two places
    want = np.asarray(jmoe._route_top_k(jnp.asarray(logits), 2))
    got = tmoe._route_top_k(torch.from_numpy(logits), 2).numpy()
    np.testing.assert_array_equal(got != 0, want != 0)
    assert ((got != 0).sum(axis=1) == 2).all()
    assert (np.abs(got - want) <= 4 * np.spacing(np.abs(want))).all(), np.abs(got - want).max()
    np.testing.assert_array_equal(np.nonzero(got[:5])[1], [0, 1] * 5)


def test_moe_capacity_matches_jax():
    for n_exp, k in ((4, 2), (8, 2), (8, 1), (16, 4)):
        jc, tc = JCFG.replace(num_experts=n_exp, num_experts_per_tok=k), TCFG.replace(num_experts=n_exp, num_experts_per_tok=k)
        for t in list(range(1, 300, 7)) + [512, 1000, 1024, 2048, 4096]:
            for slack in (2.0, 1.0, 1.25):
                assert tmoe._moe_capacity(t, tc, slack) == jmoe._moe_capacity(t, jc, slack), (n_exp, k, t, slack)


@pytest.mark.parametrize("flag", ["1", None])
def test_fused_expert_gate_matches_jax(monkeypatch, flag):
    """The fused-expert gate equals the JAX package's over widths (hidden and
    attention output), intermediates, rows and specs, flag set to ``1`` or
    unset."""
    monkeypatch.delenv("ATOM_TPU_NO_FUSED_MLP", raising=False)
    if flag is None:
        monkeypatch.delenv("ATOM_TPU_FUSED_MLP", raising=False)
    else:
        monkeypatch.setenv("ATOM_TPU_FUSED_MLP", flag)
    taken = 0
    for inter in (512, 768, 1000, 14336, 14464):
        lp = types.SimpleNamespace(wgateup=types.SimpleNamespace(body_packed=np.empty((4, 1, 2 * inter), np.int8)))
        for d in (256, 512, 640, 1024, 4096):
            for m in (1, 8, 32, 33, 288):
                for jspec, tspec in ((ATOM_W4A4, T_SPEC), (ATOM_W4A4.replace(fused_serving=False),
                                                           T_SPEC.replace(fused_serving=False))):
                    want = jmoe._fused_expert_ok((m, d), lp, jspec)
                    assert tmoe._fused_expert_ok((m, d), lp, tspec) == want, (inter, d, m, tspec.fused_serving)
                    taken += want
    assert (taken > 0) == (flag == "1")


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def block(moe_params):
    """A decode batch's residual and attention output and the JAX block's
    output on them, unfused and with the flag on."""
    jparams, _ = moe_params
    rng = np.random.default_rng(11)
    x = _bf16(rng.standard_normal((B, KW["hidden_size"])))
    attn = _bf16(rng.standard_normal((B, N_Q)) * 0.3)
    lp = jparams.layers[0]
    out = {"unfused": np.asarray(jmoe._moe_mlp(jnp.asarray(x), jnp.asarray(attn), lp, JCFG, ATOM_W4A4), np.float32)}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("ATOM_TPU_NO_FUSED_MLP", raising=False)
        mp.setenv("ATOM_TPU_FUSED_MLP", "1")
        out["fused"] = np.asarray(jmoe._moe_mlp(jnp.asarray(x), jnp.asarray(attn), lp, JCFG, ATOM_W4A4), np.float32)
    return x, attn, out


def _count(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*a, **k):
        calls.append((a[0].codes if isinstance(a[0], tuple) else a[0]).shape[0])  # rows, of a quantized activation too
        return real(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_moe_mlp_unfused_matches_jax(moe_params, block, monkeypatch):
    """Unfused, the JAX block and the port's share every quantized operand;
    only the router's float32 sums and softmax differ by ulps, so the routing
    weights do, and an output element moves by at most one bf16 ulp where
    the weighted sum lands next to a rounding boundary (measured: 2 of 32
    rows, max 0.0039).  Bound: every element within one bf16 ulp, 75% of rows
    bitwise."""
    _, tparams = moe_params
    x, attn, out = block
    monkeypatch.delenv("ATOM_TPU_FUSED_MLP", raising=False)
    k1 = _count(monkeypatch, tmoe, "quant_gemm_packed")
    got = tmoe._moe_mlp(_t(x), _t(attn), tparams.layers[0], TCFG, T_SPEC).float().numpy()
    assert k1 == [B] * (1 + 2 * KW["num_experts"])  # o_proj, then gate/up and down of every expert
    want = out["unfused"]
    beyond = np.abs(got - want) > np.abs(want) * 2**-7 + 1e-6
    assert not beyond.any(), f"{beyond.sum()} elements beyond one bf16 ulp"
    assert np.mean((got == want).all(axis=1)) >= 0.75


def test_moe_mlp_fused_matches_jax(moe_params, block, monkeypatch):
    """With the flag on the port runs K9 and one K10 per expert
    (``row_scale``, a float32 accumulator) and equals its own unfused block
    bit for bit.  Against the JAX fused block (the Pallas kernels jitted in
    interpret mode, their quantizers 1 ulp off the eager chain) bound as
    ``tests/test_serving_moe.py`` bounds the JAX package's own two paths,
    plus the structural share: under 25% of elements moved by more than 0.05
    (measured: 27% of elements differ at all, max 0.27)."""
    _, tparams = moe_params
    x, attn, out = block
    monkeypatch.delenv("ATOM_TPU_NO_FUSED_MLP", raising=False)
    monkeypatch.setenv("ATOM_TPU_FUSED_MLP", "1")
    k9, k10 = _count(monkeypatch, tmoe, "packed_w4_gemm_fused_in"), _count(monkeypatch, tmoe, "fused_mlp_packed")
    k1 = _count(monkeypatch, tmoe, "quant_gemm_packed")
    got = tmoe._moe_mlp(_t(x), _t(attn), tparams.layers[0], TCFG, T_SPEC)
    assert k9 == [B] and k10 == [B] * KW["num_experts"] and k1 == []
    got = got.float().numpy()
    monkeypatch.setenv("ATOM_TPU_FUSED_MLP", "0")
    np.testing.assert_array_equal(tmoe._moe_mlp(_t(x), _t(attn), tparams.layers[0], TCFG, T_SPEC).float().numpy(), got)
    want = out["fused"]
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=0.5)
    diff = np.abs(got - want)
    assert np.mean(diff > 0.05) < 0.25 and diff.max() < 1.5, (np.mean(diff > 0.05), diff.max())


def test_routed_equals_dense_bitwise_and_capacity_drops_overflow_only(moe_params):
    """At full capacity the routed block is bitwise the dense one (the same
    quantized rows, the same expert-major float32 order).  With a capacity
    below the experts' loads, the rows whose every routed expert kept them
    stay bitwise; each row some expert dropped differs, and stays finite."""
    _, tparams = moe_params
    lp = tparams.layers[0]
    rng = np.random.default_rng(3)
    t = 96
    x = _t(_bf16(rng.standard_normal((t, KW["hidden_size"]))))
    attn = _t(rng.standard_normal((t, N_Q)).astype(np.float32) * 0.3)
    dense = tmoe._moe_mlp(x, attn, lp, TCFG, T_SPEC)
    assert torch.equal(dense.view(torch.int16), tmoe._moe_mlp_routed(x, attn, lp, TCFG, T_SPEC, t).view(torch.int16))

    cap = 16
    tight = tmoe._moe_mlp_routed(x, attn, lp, TCFG, T_SPEC, cap)
    _, _, weights = tmoe._o_proj_and_route(x, attn, lp, TCFG, T_SPEC, False)
    routed = weights > 0
    rank = torch.cumsum(routed.to(torch.int32), dim=0) - 1
    dropped = (routed & (rank >= cap)).any(dim=1)
    assert 0 < int(dropped.sum()) < t
    same = (tight == dense).all(dim=1)
    assert torch.equal(same, ~dropped)
    assert bool(torch.isfinite(tight.float()).all())


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flush", [False, True])
def test_decode_step_moe_matches_jax(moe_params, flush):
    """``decode_step_moe`` from a state whose ring holds W-1 tokens (row W-1),
    so the flushing step writes every active sequence's W-token block into
    its pages (blocks inside a page, crossing a page boundary, an inactive
    slot), against the JAX step run eagerly.

    As the Llama decode step (``tests/test_torch_serving.py``): the ring is
    bitwise but for the column this step wrote, and the pages but for the new
    token's lane; those hold the quantizer flips of K2 (the Pallas kernel's
    quantizers jitted in interpret mode sit 1 ulp off the eager chain) and,
    in layer 1, what they and the router's ulps move.  Next ids agree in 75%
    of the batch (measured: 29 and 32 of 32)."""
    jparams, tparams = moe_params
    rng = np.random.default_rng(20 + flush)
    table, ids = _inputs(rng, KW["vocab_size"])
    flushed = rng.integers(0, 2 * PAGE - W, B)
    flushed[:4] = [0, 230, 250, PAGE - W]
    lens = (flushed + W).astype(np.int32)
    flushed[5], lens[5] = 0, 0
    st = _state(rng, KW["num_kv_heads"], flushed, row=W - 1)
    jids, jst = jmoe.decode_step_moe.__wrapped__(jparams, _to_jax(st), jnp.asarray(ids), jnp.asarray(table),
                                                 jnp.asarray(lens), JCFG, ATOM_W4A4, flush=flush)
    tids, tst = tmoe.decode_step_moe(tparams, serving_state_from_numpy(st, "cpu"), _t(ids), _t(table), _t(lens), TCFG,
                                     T_SPEC, flush=flush)
    assert np.mean(tids.numpy() == np.asarray(jids)) >= 0.75
    np.testing.assert_array_equal(tst.flushed.numpy(), np.asarray(jst.flushed))
    assert tst.row == int(jst.row) == 0
    active = lens > flushed
    new_slot = lens - 1
    page_of = table[np.arange(B), np.clip(new_slot // PAGE, 0, table.shape[1] - 1)]
    for layer in range(2):
        jr, tr = jst.hot[layer], tst.hot[layer]
        for a, t, axis in ((jr.k_codes, tr.k_codes, 3), (jr.prm, tr.prm, 3), (jr.v_codes, tr.v_codes, 2)):
            np.testing.assert_array_equal(np.delete(_tbits(t), W - 1, axis), np.delete(_bits(a), W - 1, axis))
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
            assert np.mean(a != t) <= 2e-3


@pytest.mark.parametrize("routed", [False, True], ids=["dense", "routed"])
def test_prefill_step_moe_matches_jax(moe_params, monkeypatch, routed):
    """``prefill_step_moe`` against the JAX step run eagerly (true length 70
    of a 128-row bucket, pages 4 and 2): pages bitwise in both layers and the
    same token, with dense experts and, ``MOE_ROUTED_THRESHOLD`` lowered in
    both packages, routed ones (capacity 128 = T at 4 experts, top-2)."""
    jparams, tparams = moe_params
    if routed:
        monkeypatch.setattr(jmoe, "MOE_ROUTED_THRESHOLD", 64)
        monkeypatch.setattr(tmoe, "MOE_ROUTED_THRESHOLD", 64)
    calls = _count(monkeypatch, tmoe, "_moe_mlp_routed")
    page, n_pages, slot, true_len, bucket = 64, 6, 1, 70, 128
    rng = np.random.default_rng(5)
    ids = np.zeros((bucket,), np.int32)
    ids[:true_len] = rng.integers(1, KW["vocab_size"], true_len)
    table_row = np.asarray([4, 2, 0, 0], np.int32)
    jstate = jm.make_serving_state(2, n_pages, 2, KW["num_kv_heads"], page, 128)
    jtok, jst = jmoe.prefill_step_moe.__wrapped__(jparams, jstate, jnp.asarray(ids), jnp.asarray(table_row),
                                                  jnp.int32(true_len), jnp.int32(slot), JCFG, ATOM_W4A4)
    tstate = tm.make_serving_state(2, n_pages, 2, KW["num_kv_heads"], page, 128, device="cpu")
    tstate = tstate._replace(row=7)
    ttok, tst = tmoe.prefill_step_moe(tparams, tstate, _t(ids), _t(table_row), true_len, slot, TCFG, T_SPEC)
    assert len(calls) == (2 if routed else 0)
    assert ttok.dtype == torch.int32 and ttok.ndim == 0 and int(ttok) == int(jtok)
    assert tst.flushed.tolist() == [0, true_len] and tst.row == 7
    for layer in range(2):
        for f in ("k_pages", "v_pages", "params"):
            np.testing.assert_array_equal(_tbits(getattr(tst.pages[layer], f)), _bits(getattr(jst.pages[layer], f)),
                                          err_msg=f"layer {layer} {f}")
    assert tst.pages[1].k_pages[[4, 2]].any()


def test_engine_serves_moe():
    """``TextGenEngine`` over ``make_moe_step_fns`` on the CPU: every request
    gets its tokens, in range, crossing ring flushes, and the pool is drained
    back."""
    params = tmoe.init_moe_serving_params(TCFG, T_SPEC, seed=1, device="cpu")
    tg = TextGenConfig(batch_size=4, page_size=64, max_seq_len=256, prefill_buckets=(64, 128))
    n_pages = 4 * 4 + 4
    pool = KvPool(TCFG.num_layers, n_pages, TCFG.num_kv_heads, tg.page_size, TCFG.head_dim)
    state = tm.make_serving_state(TCFG.num_layers, n_pages, tg.batch_size, TCFG.num_kv_heads, tg.page_size,
                                  TCFG.head_dim, device="cpu")
    engine = TextGenEngine(tg, pool, *make_moe_step_fns(params, TCFG, T_SPEC), state)
    rs = synth_requests(6, TCFG.vocab_size, seed=3, maxlen=120)
    res = engine.run(rs, record=True)
    assert res["requests"] == 6 and res["output_tokens"] == rs.total_output_tokens
    assert res["decode_steps"] > W
    for r, want in enumerate(rs.output_lens):
        toks = res["tokens"][r]
        assert len(toks) == int(want) and all(0 <= t < TCFG.vocab_size for t in toks)
    assert pool.num_free_pages == n_pages - 1
