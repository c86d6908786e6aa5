"""The port's prefill path held against the JAX package on shared seeded
inputs: kernels K7 and K8 through their plain versions (the JAX Pallas
kernels run in interpret mode), the page append and ring write glue, the
prefill attention core, and ``prefill_step`` as a whole.

The CUDA kernels are held against the same plain versions on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu.config import ATOM_W4A4, QuantSpec
from atom_tpu.models.configs import Arch, ModelConfig
from atom_tpu.ops import kv_hot as jhot
from atom_tpu.ops import kv_layout as jlay
from atom_tpu.ops import reference as JR
from atom_tpu.ops.pallas_gemm_packed import packed_w4_gemm_qkv as j_qkv
from atom_tpu.ops.pallas_gemm_packed import packed_w4_gemm_qkv_ring as j_qkv_ring
from atom_tpu.serving import model as jm
from atom_tpu_torch.config import ATOM_W4A4 as T_W4A4
from atom_tpu_torch.config import QuantSpec as TQuantSpec
from atom_tpu_torch.models.configs import Arch as TArch
from atom_tpu_torch.models.configs import ModelConfig as TModelConfig
from atom_tpu_torch.ops import gemm_packed as tgp
from atom_tpu_torch.ops import kv_hot as thot
from atom_tpu_torch.ops import kv_layout as tlay
from atom_tpu_torch.ops import reference as TR
from atom_tpu_torch.serving import model as tm
from atom_tpu_torch.serving.convert import serving_params_from_numpy, tensor_from_numpy
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


def _gemm_inputs(rng, m, ktot, n):
    ng = ktot // 128 - 1
    a = np.concatenate([rng.integers(-8, 8, (m, ng * 128)), rng.integers(-127, 128, (m, 128))], axis=1).astype(np.int8)
    wp = rng.integers(-128, 128, (ng * 64, n)).astype(np.int8)
    wk = rng.integers(-127, 128, (128, n)).astype(np.int8)
    sa = rng.uniform(0.01, 0.2, (m, ng + 1)).astype(np.float32)
    sw = rng.uniform(0.001, 0.02, (ng + 1, n)).astype(np.float32)
    return a, wp, wk, sa, sw


def _rope(rng, m):
    pos = rng.integers(0, 1000, m)
    ang = pos[:, None] * (1.0 / 10000 ** (np.arange(64) / 64))[None]
    ang = np.concatenate([ang, ang], 1)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _flip_rows(q_t, q_j):
    """Rows of q beyond one bf16 ulp of the JAX kernel's."""
    qj = np.asarray(q_j, np.float32)
    qd = np.abs(q_t.to(torch.float32).numpy() - qj)
    return (qd > np.abs(qj) * 2**-7 + 1e-6).any(axis=1), qd.max()


# The Pallas qkv kernels quantize K and V inside a jitted program; on the CPU
# XLA may turn their divisions into reciprocal multiplies, 1 ulp off the eager
# chain the port follows (the fuzz recorded for K2).  The GEMM itself is exact
# integer math summed in the same f32 order.  Bounds: q within one bf16 ulp in
# every row; codes differing in at most 0.1% of entries; scales and zero values
# in at most 5% (bf16-rounded, so a 1-ulp f32 move rarely shows).
CODE_FLIPS, PRM_FLIPS = 1e-3, 5e-2


@pytest.mark.parametrize("heads,kv_heads,m", [(4, 4, 32), (8, 4, 40), (4, 4, 8)])
def test_qkv_matches_pallas(heads, kv_heads, m):
    """K7 against the Pallas kernel in interpret mode, at M a multiple of 32,
    an M the TPU kernel pads (40) and the decode fallback's batch of 8."""
    rng = np.random.default_rng(heads * 10 + m)
    k = 512
    n_q, n_kv = heads * 128, kv_heads * 128
    args = _gemm_inputs(rng, m, k, n_q + 2 * n_kv)
    cos, sin = _rope(rng, m)
    want = j_qkv(*(jnp.asarray(x) for x in args), jnp.asarray(cos), jnp.asarray(sin),
                 n_q=n_q, n_kv=n_kv, interpret=True)
    got = tgp.packed_w4_gemm_qkv(*(_t(x) for x in args), _t(cos), _t(sin), n_q=n_q, n_kv=n_kv)
    q, kc, kp, vc, vp = got
    assert q.dtype == torch.bfloat16 and tuple(q.shape) == (m, n_q)
    assert kc.dtype == torch.int8 and tuple(kc.shape) == (m, kv_heads, 128) and tuple(kp.shape) == (m, kv_heads, 2)
    assert kp.dtype == torch.float32 and tuple(vc.shape) == (m, kv_heads, 128) and tuple(vp.shape) == (m, kv_heads, 2)
    flips, qmax = _flip_rows(q, want[0])
    assert not flips.any(), f"q rows beyond 1 bf16 ulp: {flips.sum()}, max |dq| {qmax}"
    for name, t0, j0, bound in (("k codes", kc, want[1], CODE_FLIPS), ("k params", kp, want[2], PRM_FLIPS),
                                ("v codes", vc, want[3], CODE_FLIPS), ("v params", vp, want[4], PRM_FLIPS)):
        diff = np.mean(t0.numpy() != np.asarray(j0))
        assert diff <= bound, f"{name}: {diff:.4%} of entries differ"
    # params are already on the bf16 grid, as quantize_kv_asym's
    assert torch.equal(kp, kp.to(torch.bfloat16).to(torch.float32))
    assert int(kc.min()) >= 0 and int(kc.max()) <= 15


@pytest.mark.parametrize("heads,kv_heads,row", [(4, 4, 5), (8, 4, 31)])
def test_qkv_ring_matches_pallas(heads, kv_heads, row):
    """K8 against the Pallas kernel in interpret mode: q, the written ring
    column within the flip bounds above, every other ring column untouched."""
    rng = np.random.default_rng(heads * 100 + row)
    m, k, w = 32, 512, 32
    n_q, n_kv = heads * 128, kv_heads * 128
    args = _gemm_inputs(rng, m, k, n_q + 2 * n_kv)
    cos, sin = _rope(rng, m)
    ring = (rng.integers(-128, 128, (m, kv_heads, 64, w)).astype(np.int8),
            _bf16(rng.uniform(0.01, 0.1, (m, 4, kv_heads, w))),
            rng.integers(0, 16, (m, kv_heads, w, 128)).astype(np.int8))
    jq, jkc, jprm, jvc = j_qkv_ring(*(jnp.asarray(x) for x in args), jnp.asarray(cos), jnp.asarray(sin),
                                    *(jnp.asarray(r.copy()) for r in ring), jnp.int32(row),
                                    n_q=n_q, n_kv=n_kv, interpret=True)
    tring = [_t(r) for r in ring]
    tq = tgp.packed_w4_gemm_qkv_ring(*(_t(x) for x in args), _t(cos), _t(sin), *tring, row, n_q=n_q, n_kv=n_kv)
    flips, qmax = _flip_rows(tq, jq)
    assert not flips.any(), f"q rows beyond 1 bf16 ulp: {flips.sum()}, max |dq| {qmax}"
    for i, (want, got, axis) in enumerate(((jkc, tring[0], 3), (jprm, tring[1], 3), (jvc, tring[2], 2))):
        want, got = _bits(want), _tbits(got)
        other = [c for c in range(w) if c != row]
        np.testing.assert_array_equal(np.take(got, other, axis), np.take(_bits(ring[i]), other, axis))
        diff = np.mean(np.take(want, row, axis) != np.take(got, row, axis))
        assert diff <= (PRM_FLIPS if i == 1 else CODE_FLIPS), f"ring {i}: {diff:.4%} of column {row} differs"


def test_qkv_plain_versions_share_their_arithmetic():
    """K2, K7 and K8 cannot drift apart: on the same quantized activation the
    ring written by K8 holds exactly K7's codes and params, and K2 fed the
    float activation gives the same q and ring as K8 fed its prologue's output."""
    rng = np.random.default_rng(5)
    m, k, h, w, row = 32, 512, 4, 32, 9
    n_q = n_kv = h * 128
    _, wp, wk, _, sw = _gemm_inputs(rng, m, k, n_q + 2 * n_kv)
    cos, sin = (_t(x) for x in _rope(rng, m))
    y = _t(_bf16(rng.standard_normal((m, k)) * 1.5))
    norm_w = _t(_bf16(rng.uniform(0.7, 1.3, (k,))))
    from atom_tpu_torch.numerics import rms_rstd

    rstd = rms_rstd(y)
    a, sa = tgp.quant_prologue_plain(y, norm_w, rstd, 4, 0.9)
    wp, wk, sw = _t(wp), _t(wk), _t(sw)

    def ring():
        return (torch.zeros((m, h, 64, w), dtype=torch.int8), torch.zeros((m, 4, h, w), dtype=torch.bfloat16),
                torch.zeros((m, h, w, 128), dtype=torch.int8))

    r2, r8 = ring(), ring()
    q2 = tgp.packed_w4_gemm_qkv_ring_fused(y, norm_w, wp, wk, sw, cos, sin, *r2, row, n_q, n_kv, abits=4, a_clip=0.9, rstd=rstd)
    q8 = tgp.packed_w4_gemm_qkv_ring(a, wp, wk, sa, sw, cos, sin, *r8, row, n_q, n_kv)
    q7, kc, kp, vc, vp = tgp.packed_w4_gemm_qkv(a, wp, wk, sa, sw, cos, sin, n_q, n_kv)
    assert torch.equal(_as_bits(q2), _as_bits(q8)) and torch.equal(_as_bits(q7), _as_bits(q8))
    for x2, x8 in zip(r2, r8):
        assert torch.equal(_as_bits(x2), _as_bits(x8))
    via_write_hot = thot.write_hot(thot.HotKV(*ring()), row, TR.KVQuant(kc, kp), TR.KVQuant(vc, vp))
    for x7, x8 in zip(via_write_hot, r8):
        assert torch.equal(_as_bits(x7), _as_bits(x8))


def _as_bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _kvq(rng, t, h, mod):
    x = (rng.standard_normal((t, h, 128)) * 2.0).astype(np.float32)
    if mod is JR:
        return JR.quantize_kv_asym(jnp.asarray(x))
    return TR.quantize_kv_asym(_t(x))


@pytest.mark.parametrize("t,page,table", [(128, 128, [5, 0, 0, 0]), (256, 64, [7, 2, 0, 0]), (40, 64, [3, 0, 0, 0])])
def test_append_kv_prefill_matches_jax_bitwise(t, page, table):
    """Whole-page prefill writes: every touched page fully overwritten (tail
    slots zeroed), entries past the allocation landing in sink page 0 (the
    last such write wins, as in the JAX loop); pages bitwise."""
    h, n_pages = 2, 9
    jk, jv = _kvq(np.random.default_rng(t), t, h, JR), _kvq(np.random.default_rng(t + 1), t, h, JR)
    tk, tv = _kvq(np.random.default_rng(t), t, h, TR), _kvq(np.random.default_rng(t + 1), t, h, TR)
    np.testing.assert_array_equal(tk.codes.numpy(), np.asarray(jk.codes))
    np.testing.assert_array_equal(tk.params.numpy(), np.asarray(jk.params))
    rng = np.random.default_rng(0)
    init = (rng.integers(-128, 128, (n_pages, h, 64, page)).astype(np.int8),
            rng.integers(-128, 128, (n_pages, h, page // 2, 128)).astype(np.int8),
            _bf16(rng.uniform(0.01, 0.1, (n_pages, 4, h, page))))
    row = np.asarray(table, np.int32)
    want = jlay.append_kv_prefill_kernel(jlay.KVPages(*(jnp.asarray(x) for x in init)), jk, jv, jnp.asarray(row))
    got = tlay.append_kv_prefill_kernel(tlay.KVPages(*(_t(x) for x in init)), tk, tv, _t(row))
    for a, b, name in zip(want, got, ("k_pages", "v_pages", "params")):
        np.testing.assert_array_equal(_tbits(b), _bits(a), err_msg=name)
    untouched = [p for p in range(1, n_pages) if p not in table]
    np.testing.assert_array_equal(got.k_pages.numpy()[untouched], init[0][untouched])


def test_write_hot_matches_jax_bitwise():
    rng = np.random.default_rng(4)
    b, h, w, row = 8, 2, 32, 13
    ring = (rng.integers(-128, 128, (b, h, 64, w)).astype(np.int8), _bf16(rng.uniform(0.01, 0.1, (b, 4, h, w))),
            rng.integers(0, 16, (b, h, w, 128)).astype(np.int8))
    jk, jv = _kvq(np.random.default_rng(1), b, h, JR), _kvq(np.random.default_rng(2), b, h, JR)
    tk, tv = _kvq(np.random.default_rng(1), b, h, TR), _kvq(np.random.default_rng(2), b, h, TR)
    want = jhot.write_hot(jhot.HotKV(*(jnp.asarray(x) for x in ring)), jnp.int32(row), jk, jv)
    got = thot.write_hot(thot.HotKV(*(_t(x) for x in ring)), row, tk, tv)
    for a, b_, name in zip(want, got, ("k_codes", "prm", "v_codes")):
        np.testing.assert_array_equal(_tbits(b_), _bits(a), err_msg=name)


def test_pack_slot_planes_and_merge_params_match_jax_bitwise():
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 16, (3, 2, 64, 128)).astype(np.int8)
    np.testing.assert_array_equal(tlay.pack_slot_planes(_t(codes)).numpy(), np.asarray(jlay.pack_slot_planes(jnp.asarray(codes))))
    np.testing.assert_array_equal(tlay.pack_channel_planes(_t(codes)).numpy(), np.asarray(jlay.pack_channel_planes(jnp.asarray(codes))))
    kp = rng.uniform(-1, 1, (3, 2, 2, 64)).astype(np.float32)
    vp = rng.uniform(-1, 1, (3, 2, 2, 64)).astype(np.float32)
    want = jlay.merge_params(jnp.asarray(kp), jnp.asarray(vp))
    got = tlay.merge_params(_t(kp), _t(vp))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (3, 4, 2, 64)
    np.testing.assert_array_equal(_tbits(got), _bits(want))


@pytest.mark.parametrize("groups", [1, 2])
def test_causal_code_attention_onepass_matches_jax(groups):
    """The one-pass prefill attention core on identical codes, MHA and GQA,
    with and without explicit query positions.  Both compute in float32 and
    round once to bf16: atol 1e-2 on outputs of order 1 covers one bf16
    rounding step after float32 sums in another order."""
    rng = np.random.default_rng(groups)
    t, h = 96, 2
    qn = _bf16(rng.standard_normal((t, h * groups, 128)))
    jk, jv = _kvq(np.random.default_rng(7), t, h, JR), _kvq(np.random.default_rng(8), t, h, JR)
    tk, tv = _kvq(np.random.default_rng(7), t, h, TR), _kvq(np.random.default_rng(8), t, h, TR)
    want = jm.causal_code_attention(jnp.asarray(qn), jk, jv, groups, 128**-0.5)
    got = tm.causal_code_attention(_t(qn), tk, tv, groups, 128**-0.5)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (t, h * groups * 128)
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32), atol=1e-2, rtol=2**-7)
    # a chunk of queries at positions 40.. over the full key range
    pos = np.arange(40, 56)
    want = jm.causal_code_attention(jnp.asarray(qn[40:56]), jk, jv, groups, 128**-0.5, row_pos=jnp.asarray(pos))
    got2 = tm.causal_code_attention(_t(qn[40:56]), tk, tv, groups, 128**-0.5, row_pos=_t(pos))
    np.testing.assert_allclose(got2.to(torch.float32).numpy(), np.asarray(want, np.float32), atol=1e-2, rtol=2**-7)
    np.testing.assert_array_equal(_tbits(got2), _tbits(got.reshape(t, -1)[40:56]))


def test_scanned_prefill_attention_matches_onepass():
    """``causal_code_attention(key_block > 0)``, the online-softmax form, must
    match the one-pass softmax on the bf16 output grid (rtol = atol = 2e-2, the
    JAX test's bound), for a block that divides Tk and one that is halved
    until it does; so must ``kernel=True``, the flash kernel K12 (its plain
    version here)."""
    rng = np.random.default_rng(0)
    t, h, groups = 640, 4, 2
    q = _t(_bf16(rng.standard_normal((t, h * groups, 128))))
    kq, vq = _kvq(np.random.default_rng(1), t, h, TR), _kvq(np.random.default_rng(2), t, h, TR)
    ref = tm.causal_code_attention(q, kq, vq, groups, 128**-0.5, key_block=0)
    for kb in (128, 320):
        out = tm.causal_code_attention(q, kq, vq, groups, 128**-0.5, key_block=kb)
        np.testing.assert_allclose(out.to(torch.float32).numpy(), ref.to(torch.float32).numpy(), rtol=2e-2, atol=2e-2)
    out = tm.causal_code_attention(q, kq, vq, groups, 128**-0.5, kernel=True)
    np.testing.assert_allclose(out.to(torch.float32).numpy(), ref.to(torch.float32).numpy(), rtol=2e-2, atol=2e-2)


GEOMS = {
    # unfused qkv (n_kv % 512 != 0): K1 + RoPE + quantize_kv_asym
    "unfused": (dict(vocab_size=199, hidden_size=256, intermediate_size=384, num_layers=2, num_heads=2,
                     num_kv_heads=2, head_dim=128, max_position_embeddings=512), QuantSpec(weight_channel_group=1),
                TQuantSpec(weight_channel_group=1)),
    # fused qkv (K7), GQA
    "fused_gqa": (dict(vocab_size=256, hidden_size=512, intermediate_size=768, num_layers=2, num_heads=8,
                       num_kv_heads=4, head_dim=128, max_position_embeddings=1024), ATOM_W4A4, T_W4A4),
}


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_prefill_step_matches_jax(geom):
    """``prefill_step`` on the same converted weights and prompt (true length
    below the bucket, the allocation below the bucket's pages, so padding rows
    land in the sequence's last page and in sink page 0).

    ``flushed[slot]`` becomes the true length; ring and ``row`` are untouched.

    Pages and first token are held to the JAX layer stack run eagerly
    (``prefill_hidden`` + ``_lm_head_logits``: the quantization chains the port
    follows op by op): layer 0's pages bitwise, at most 1% of the bytes of the
    sequence's pages differing over all layers (measured 0.3-0.6%: near-tie
    codes of layer 0's output flip and move layer 1's inputs), the same token.

    The jitted ``prefill_step`` is one XLA program whose quantizers sit 1 ulp
    off that chain: the JAX package's own two forms differ in 0.1-0.9% of layer
    0's page bytes and in over a third of layer 1's on these inputs, and in
    the token at the GQA geometry (measured).  Against it only layer 0 is
    bounded, at 2% of bytes."""
    kw, jspec, tspec = GEOMS[geom]
    jcfg, tcfg = ModelConfig(arch=Arch.LLAMA, **kw), TModelConfig(arch=TArch.LLAMA, **kw)
    page, n_pages, slot, true_len, bucket = 64, 6, 1, 70, 256
    jparams = jm.init_serving_params(jax.random.PRNGKey(4), jcfg, jspec)
    tparams = serving_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(5)
    ids = np.zeros((bucket,), np.int32)
    ids[:true_len] = rng.integers(1, kw["vocab_size"], true_len)
    table_row = np.asarray([4, 2, 0, 0], np.int32)

    jstate = jm.make_serving_state(2, n_pages, 2, jcfg.num_kv_heads, page, 128)
    jstate = jstate._replace(row=jnp.int32(7), flushed=jnp.asarray([11, 3], jnp.int32))
    jstate0 = jax.tree_util.tree_map(jnp.copy, jstate)  # the step donates its state
    jtok, jnew = jm.prefill_step(jparams, jstate, jnp.asarray(ids), jnp.asarray(table_row), jnp.int32(true_len),
                                 jnp.int32(slot), jcfg, jspec)
    tstate = tm.make_serving_state(2, n_pages, 2, tcfg.num_kv_heads, page, 128, device="cpu")
    tstate = tstate._replace(row=7, flushed=torch.tensor([11, 3], dtype=torch.int32))
    ttok, tnew = tm.prefill_step(tparams, tstate, _t(ids), _t(table_row), true_len, slot, tcfg, tspec)

    np.testing.assert_array_equal(tnew.flushed.numpy(), np.asarray(jnew.flushed))
    assert tnew.flushed.tolist() == [11, true_len] and tnew.row == 7
    assert ttok.dtype == torch.int32 and ttok.ndim == 0 and jtok.shape == ()
    for hot in tnew.hot:
        assert not any(bool(x.any()) for x in hot)

    xe, eager_pages = jm.prefill_hidden(jparams, jstate0.pages, jnp.asarray(ids), jnp.asarray(table_row), jcfg, jspec)
    eager_logits = jm._lm_head_logits(xe[true_len - 1][None], jparams.lm_head, jcfg.vocab_size)[0]
    assert int(ttok) == int(jnp.argmax(eager_logits))
    own = [p for p in table_row if p]  # the sequence's pages; sink page 0 holds padding rows only
    total = differing = 0
    for layer in range(2):
        for f in ("k_pages", "v_pages", "params"):
            t0 = _tbits(getattr(tnew.pages[layer], f))
            e0, j0 = _bits(getattr(eager_pages[layer], f)), _bits(getattr(jnew.pages[layer], f))
            assert not t0[[1, 3, 5]].any()  # pages outside the table row stay zero
            if layer == 0:
                np.testing.assert_array_equal(t0, e0, err_msg=f"layer 0 {f}")
                assert np.mean(t0 != j0) <= 0.02, f"layer 0 {f} vs the jitted step: {np.mean(t0 != j0):.3%}"
            total, differing = total + e0[own].size, differing + int((e0[own] != t0[own]).sum())
    assert differing / total <= 0.01, f"{differing / total:.3%} of the sequence's page bytes differ"
    # the tail of the last allocated page holds the padding rows' K/V, not zeros
    assert tnew.pages[0].k_pages[2, :, :, true_len - page :].any()
