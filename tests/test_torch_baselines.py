"""The port's baseline serving stacks (bf16, W8A8, W4A16), their weight-only
INT4 GEMM (kernel K13 through its plain version) and the W4A16 head of the
W4A4 stack, held against the JAX package on shared seeded inputs.

Geometry: ``tests/test_baselines.py``'s TINY model (vocab 101, hidden 256,
2 layers, 2 query heads on 1 kv head: GQA).  Weights are drawn by the JAX
init and carried over bit for bit (``serving/convert.py``).  The JAX steps run
op by op (``.__wrapped__``: a jitted step is one XLA program whose roundings
differ from the same functions dispatched one by one, ``ROADMAP.md`` §C), the
Pallas kernel in interpret mode; the port runs its plain versions.

The CUDA kernel itself is held against the same plain version on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu.config import QuantSpec
from atom_tpu.models.configs import Arch, ModelConfig
from atom_tpu.ops import pallas_gemm_w4a16 as jw
from atom_tpu.serving import baselines as jb
from atom_tpu.serving import engine as jeng
from atom_tpu.serving import kvpool as jpool
from atom_tpu.serving import model as jm
from atom_tpu.serving import workload as jwl
from atom_tpu_torch.config import QuantSpec as TQuantSpec
from atom_tpu_torch.models.configs import Arch as TArch
from atom_tpu_torch.models.configs import ModelConfig as TModelConfig
from atom_tpu_torch.models import nn as tnn
from atom_tpu_torch.ops import gemm_w4a16 as tw
from atom_tpu_torch.serving import KvPool, RequestSet, TextGenConfig, TextGenEngine
from atom_tpu_torch.serving import baselines as tb
from atom_tpu_torch.serving import model as tm
from atom_tpu_torch.serving.convert import (
    baseline_params_from_numpy,
    dense_kv_from_numpy,
    serving_params_from_numpy,
    tensor_from_numpy,
)
from test_torch_serving import cap_torch_threads

cap_torch_threads()

TINY_KW = dict(vocab_size=101, hidden_size=256, intermediate_size=384, num_layers=2, num_heads=2, num_kv_heads=1,
               head_dim=128)
JTINY, TTINY = ModelConfig(arch=Arch.LLAMA, **TINY_KW), TModelConfig(arch=TArch.LLAMA, **TINY_KW)
STACKS = ("bf16", "w8a8", "w4a16")
J_INIT = {"bf16": jb.init_bf16_params, "w8a8": jb.init_w8_params, "w4a16": jb.init_w4a16_params}
J_STEP = {"bf16": jb.bf16_decode_step, "w8a8": jb.w8a8_decode_step, "w4a16": jb.w4a16_decode_step}
J_MATMUL = {"bf16": jb._bf16_matmul, "w8a8": jb._w8a8_matmul, "w4a16": jb._w4a16_matmul}
T_STEP = {"bf16": tb.bf16_decode_step, "w8a8": tb.w8a8_decode_step, "w4a16": tb.w4a16_decode_step}
T_BURST = {"bf16": tb.bf16_decode_burst, "w8a8": tb.w8a8_decode_burst, "w4a16": tb.w4a16_decode_burst}
B, MAX_T = 4, 64


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bf16(x):
    return np.array(jnp.asarray(np.asarray(x, np.float32)).astype(jnp.bfloat16))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _tbits(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).contiguous().numpy()


def _kv_dtype(stack):
    return jnp.int8 if stack == "w8a8" else jnp.bfloat16


# ---------------------------------------------------------------------------
# K13: quantizer and GEMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,n", [(256, 192), (384, 200), (1024, 512)])
def test_quantize_w4a16_matches_jax_bitwise(k, n):
    """Per-group scales and nibble planes bit for bit (one IEEE division for the
    scale, round-half-to-even for the codes); an all-zero column keeps the 1e-8
    floor; dequantization agrees too."""
    rng = np.random.default_rng(k + n)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    w[:, 5] = 0.0
    want = jw.quantize_w4a16(jnp.asarray(w))
    got = tw.quantize_w4a16(_t(w))
    assert got.packed.dtype == torch.int8 and got.packed.shape == (k // 2, n) and got.scale.shape == (k // 128, n)
    np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(tw.dequantize_w4a16(got).numpy(), np.asarray(jw.dequantize_w4a16(want)))


@pytest.mark.parametrize(
    "m,k,kw,n",
    [(8, 256, 256, 192),  # M padded to the 32-row tile, N to 128 columns
     (5, 384, 384, 200),  # three groups (one K block of 3), N not a multiple of 32
     (40, 1408, 1408, 256),  # 11 groups: K padded to two blocks of 8
     (3, 256, 1024, 512)],  # a head padded to K 1024 under a 256-wide activation: its first 2 groups
)
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_w4a16_gemm_matches_pallas(m, k, kw, n, out_dtype):
    """K13's plain version against the Pallas kernel in interpret mode, with the
    wrapper's M, N and K padding.  Every product (bf16 x 4-bit code) is exact in
    float32 and each group's scale multiplies its partial sum in both, so they
    differ only by the order of the float32 additions: within ``W4A16_RTOL``
    (1e-4) of the largest output, and for a bf16 output within one bf16
    rounding.  The float32 output equals a float64 reference to 1e-5 of its
    largest value (no partial sum rounded to bf16)."""
    rng = np.random.default_rng(m * 11 + n)
    a = _bf16(rng.standard_normal((m, k)))
    wq = jw.quantize_w4a16(jnp.asarray((rng.standard_normal((kw, n)) * 0.05).astype(np.float32)))
    jdt, tdt = getattr(jnp, out_dtype), getattr(torch, out_dtype)
    want = np.asarray(jw.w4a16_gemm(jnp.asarray(a), wq, out_dtype=jdt, interpret=True)).astype(np.float32)
    before = tw.w4a16_gemm.launches
    got = tw.w4a16_gemm(_t(a), tw.W4A16Weight(_t(wq.packed), _t(wq.scale)), out_dtype=tdt)
    assert tw.w4a16_gemm.launches == before  # a CPU tensor takes the plain version
    assert got.dtype == tdt and got.shape == (m, n)
    got = got.to(torch.float32).numpy()
    top = np.abs(want).max()
    if out_dtype == "float32":
        assert np.abs(got - want).max() <= tw.W4A16_RTOL * top
        w64 = np.asarray(jw.dequantize_w4a16(wq), np.float64)[:k]
        ref = a.astype(np.float64) @ w64
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    else:
        np.testing.assert_allclose(got, want, rtol=2**-8, atol=tw.W4A16_RTOL * top)


# ---------------------------------------------------------------------------
# W4A16 head of the W4A4 stack
# ---------------------------------------------------------------------------

HEAD_KW = dict(vocab_size=199, hidden_size=256, intermediate_size=384, num_layers=2, num_heads=2, num_kv_heads=2,
               head_dim=128, max_position_embeddings=512)
JHEAD, THEAD = ModelConfig(arch=Arch.LLAMA, **HEAD_KW), TModelConfig(arch=TArch.LLAMA, **HEAD_KW)
JSPEC, TSPEC = QuantSpec(weight_channel_group=1), TQuantSpec(weight_channel_group=1)
PAGE = 128


@pytest.fixture(scope="module")
def heads4():
    jparams = jm.init_serving_params(jax.random.PRNGKey(2), JHEAD, JSPEC)
    jq = jm.quantize_lm_head(jparams, bits=4)
    tparams = serving_params_from_numpy(_np(jparams), "cpu")
    return jparams, jq, tparams, tm.quantize_lm_head(tparams, bits=4)


def test_quantize_lm_head_int4_matches_jax(heads4):
    """``quantize_lm_head(bits=4)``: K padded to 1024 and N to 512 before
    quantization, nibble planes and scales bit for bit, pad rows and columns
    zero codes; the converter carries the JAX W4A16 head bit for bit too."""
    _, jq, _, tq = heads4
    assert isinstance(tq.lm_head, tw.W4A16Weight)
    assert tuple(tq.lm_head.packed.shape) == (512, 512) and tuple(tq.lm_head.scale.shape) == (8, 512)
    np.testing.assert_array_equal(tq.lm_head.packed.numpy(), np.asarray(jq.lm_head.packed))
    np.testing.assert_array_equal(tq.lm_head.scale.numpy(), np.asarray(jq.lm_head.scale))
    codes = tq.lm_head.packed
    assert not codes[128:].any() and not codes[:, 199:].any()  # K rows 256.. live in byte rows 128..
    conv = serving_params_from_numpy(_np(jq), "cpu")
    assert isinstance(conv.lm_head, tw.W4A16Weight)
    assert torch.equal(conv.lm_head.packed, tq.lm_head.packed) and torch.equal(conv.lm_head.scale, tq.lm_head.scale)


def test_lm_head_logits_w4a16_matches_jax(heads4):
    """``_lm_head_logits`` with the W4A16 head: the activation's 2 groups of the
    8 the padded head holds, pad columns sliced off by ``vocab``, logits equal
    to the JAX head's within the float32 reordering bound."""
    _, jq, _, tq = heads4
    rng = np.random.default_rng(4)
    x = _bf16(rng.standard_normal((4, JHEAD.hidden_size)))
    want = np.asarray(jm._lm_head_logits(jnp.asarray(x), jq.lm_head, JHEAD.vocab_size))
    got = tm._lm_head_logits(_t(x), tq.lm_head, THEAD.vocab_size)
    assert got.dtype == torch.float32 and got.shape == (4, 199)
    assert np.abs(got.numpy() - want).max() <= tw.W4A16_RTOL * np.abs(want).max()
    assert tm._lm_head_logits(_t(x), tq.lm_head).shape == (4, 512)


def test_w4a16_head_in_decode_step(heads4):
    """The W4A16 head inside the W4A4 stack's decode step, against the JAX
    package's step op by op on the same weights: two sequences' first tokens
    on fresh states (their K/V go to the hot ring, nothing flushes); the
    next tokens equal and in range."""
    _, jq, _, tq = heads4
    ids = np.array([17, 150], np.int32)
    lens = np.ones((2,), np.int32)
    table = np.array([[1, 0, 0, 0], [2, 0, 0, 0]], np.int32)
    jstate = jm.make_serving_state(JHEAD.num_layers, 4, 2, JHEAD.num_kv_heads, PAGE, JHEAD.head_dim)
    tstate = tm.make_serving_state(THEAD.num_layers, 4, 2, THEAD.num_kv_heads, PAGE, THEAD.head_dim, device="cpu")
    jtok, _ = jm.decode_step.__wrapped__(jq, jstate, jnp.asarray(ids), jnp.asarray(table), jnp.asarray(lens), JHEAD,
                                         JSPEC)
    ttok, tstate = tm.decode_step(tq, tstate, _t(ids), _t(table), _t(lens), THEAD, TSPEC)
    assert ttok.dtype == torch.int32 and tstate.row == 1
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert all(0 <= int(t) < THEAD.vocab_size for t in ttok)


# ---------------------------------------------------------------------------
# the stacks' building blocks
# ---------------------------------------------------------------------------


def test_nn_repeat_kv_and_causal_mask_match_jax():
    from atom_tpu.models import nn as jnn

    x = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    for groups in (1, 2, 4):
        np.testing.assert_array_equal(tnn.repeat_kv(_t(x), groups).numpy(), np.asarray(jnn.repeat_kv(jnp.asarray(x), groups)))
    for q, kv in ((5, 5), (3, 7)):
        np.testing.assert_array_equal(tnn.causal_mask(q, kv).numpy(), np.asarray(jnn.causal_mask(q, kv)))


@pytest.mark.parametrize("m,k,n", [(8, 256, 128), (3, 384, 256)])
def test_w8_quant_and_matmul_match_jax_bitwise(m, k, n):
    """``_quant_w8`` (per-column scale with its 1e-8 floor, codes clipped to
    +-127) and ``_w8a8_matmul`` (per-token activation codes, exact int32
    products, the same float32 epilogue) bit for bit."""
    rng = np.random.default_rng(m + k)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    w[:, 2] = 0.0
    x = _bf16(rng.standard_normal((m, k)))
    jq, tq = jb._quant_w8(jnp.asarray(w)), tb._quant_w8(_t(w))
    np.testing.assert_array_equal(tq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    got = tb._w8a8_matmul(_t(x), tq)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_tbits(got), _bits(jb._w8a8_matmul(jnp.asarray(x), jq)))


def test_dense_kv_layout_and_convert():
    """``make_dense_kv``: the JAX shape [B, maxT, H, Dh] in head-major memory;
    the converter keeps values and layout."""
    kvs = tb.make_dense_kv(2, 3, 16, 2, 128, dtype=torch.int8, device="cpu")
    assert len(kvs) == 2 and kvs[0].k.shape == (3, 16, 2, 128) and kvs[0].k.dtype == torch.int8
    assert kvs[0].k.transpose(1, 2).is_contiguous() and not kvs[0].k.any()
    rng = np.random.default_rng(0)
    jkv = [jb.DenseKV(*(jnp.asarray(rng.integers(-127, 128, (3, 16, 2, 128)).astype(np.int8)) for _ in range(2)))]
    conv = dense_kv_from_numpy(_np(jkv), "cpu")
    np.testing.assert_array_equal(conv[0].k.numpy(), np.asarray(jkv[0].k))
    np.testing.assert_array_equal(conv[0].v.numpy(), np.asarray(jkv[0].v))
    assert conv[0].k.transpose(1, 2).is_contiguous()


def test_init_params_layer_by_layer():
    """The port's own inits: dtypes and scales of the JAX init (bf16 weights
    of std ``in ** -0.5``, embedding and head 0.02, norms of ones), seeded, and
    the W4A16 stack's MLP padded to a multiple of 1024 where the hidden size
    and kv width sit on the kernel's tile grid (zero codes in the pad)."""
    cfg = TModelConfig(arch=TArch.LLAMA, vocab_size=64, hidden_size=1024, intermediate_size=1408, num_layers=1,
                       num_heads=8, num_kv_heads=4, head_dim=128)
    p = tb.init_bf16_params(cfg, seed=3, device="cpu")
    assert p.embed.dtype == p.layers[0].wq.dtype == p.final_norm.dtype == torch.bfloat16
    assert p.layers[0].wk.shape == (1024, 512) and p.layers[0].wdown.shape == (1408, 1024)
    assert abs(float(p.layers[0].wq.float().std()) - 1024**-0.5) < 2e-3
    assert abs(float(p.embed.float().std()) - 0.02) < 2e-3 and bool((p.layers[0].ln_mlp == 1).all())
    assert torch.equal(tb.init_bf16_params(cfg, seed=3, device="cpu").layers[0].wq, p.layers[0].wq)
    w8 = tb.init_w8_params(cfg, seed=3, device="cpu")
    assert w8.layers[0].wq.codes.dtype == torch.int8 and w8.layers[0].wq.scale.shape == (1024,)
    assert torch.equal(w8.layers[0].wq.codes, tb._quant_w8(p.layers[0].wq).codes)  # same draws, quantized
    w4 = tb.init_w4a16_params(cfg, seed=3, device="cpu")
    lp = w4.layers[0]
    assert lp.wgate.packed.shape == (512, 2048) and lp.wdown.packed.shape == (1024, 1024)
    assert not lp.wgate.packed[:, 1408:].any() and not lp.wdown.packed[704:].any()
    tiny = tb.init_w4a16_params(TTINY, device="cpu")  # off the tile grid: no pad, as in the JAX package
    assert tiny.layers[0].wup.packed.shape == (128, 384)


# ---------------------------------------------------------------------------
# the stacks' steps against the JAX package's, op by op
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=STACKS)
def stack_params(request):
    stack = request.param
    jp = J_INIT[stack](jax.random.PRNGKey(0), JTINY)
    return stack, jp, baseline_params_from_numpy(_np(jp), "cpu")


def _random_kvs(rng, stack, max_t=MAX_T):
    """Random dense KV for both packages (int8 codes for W8A8)."""
    dt = _kv_dtype(stack)
    kvs = []
    for _ in range(JTINY.num_layers):
        pair = []
        for _ in range(2):
            a = rng.standard_normal((B, max_t, JTINY.num_kv_heads, JTINY.head_dim)).astype(np.float32)
            pair.append(jnp.asarray(np.round(a * 16).clip(-127, 127) if dt == jnp.int8 else a).astype(dt))
        kvs.append(jb.DenseKV(*pair))
    return kvs


def _jax_hidden(jp, kvs, ids, lens, stack):
    """The JAX decode step's layer stack op by op -> (final-norm hidden, kvs)."""
    from atom_tpu.models.nn import rmsnorm

    x = jm._embed_lookup(jp.embed, ids)
    out = []
    for lp, kv in zip(jp.layers, kvs):
        x, kv = jb._decode_layer_common(x, lp, J_MATMUL[stack], kv, lens, JTINY)
        out.append(kv)
    return rmsnorm(x, jp.final_norm, JTINY.norm_eps), out


def _assert_kv_close(jkvs, tkvs, stack):
    """Every cache entry within 2**-7 of its array's largest entry (int8
    codes within one step), at most 2% of them differing at all; layer 0
    bitwise but with K13, whose bf16 output can round the other way (its
    float32 sums run in another order than the Pallas kernel's)."""
    for layer, (jk, tk) in enumerate(zip(jkvs, tkvs)):
        for a, t in zip(jk, tk):
            if layer == 0 and stack != "w4a16":
                np.testing.assert_array_equal(_tbits(t), _bits(a))
            a32, t32 = np.asarray(a, np.float32), t.float().numpy()
            if t.dtype == torch.int8:
                assert np.abs(a32 - t32).max() <= 1
            else:
                assert np.abs(t32 - a32).max() <= 2**-7 * np.abs(a32).max()
            assert np.mean(_bits(a) != _tbits(t)) <= 0.02


def test_decode_step_matches_jax(stack_params):
    """One decode step on a random dense cache (an idle slot, lens 1..7)
    against the JAX step op by op: the next tokens equal; the cache after the
    step (this step's K/V written in place; int8 codes for W8A8) as
    ``_assert_kv_close`` bounds it (measured: bitwise for all three stacks);
    the final-norm hidden within 2**-7 of its largest element: with K13 a
    GEMM's bf16 output rounds the other way now and then (measured: 5.7% of
    the W4A16 stack's hidden elements by one bf16 rounding, the other stacks
    bitwise)."""
    stack, jp, tp = stack_params
    rng = np.random.default_rng(5)
    jkvs = _random_kvs(rng, stack)
    tkvs = dense_kv_from_numpy(_np(jkvs), "cpu")
    ids = np.array([3, 50, 7, 90], np.int32)
    lens = np.array([3, 5, 0, 7], np.int32)  # slot 2 idle
    jtok, jout = J_STEP[stack].__wrapped__(jp, jkvs, jnp.asarray(ids), jnp.asarray(lens), JTINY)
    jx, _ = _jax_hidden(jp, jkvs, jnp.asarray(ids), jnp.asarray(lens), stack)
    tkvs2 = dense_kv_from_numpy(_np(jkvs), "cpu")
    ttok, tout = T_STEP[stack](tp, tkvs, torch.from_numpy(ids), torch.from_numpy(lens), TTINY)
    assert tout is tkvs and ttok.dtype == torch.int32  # updated in place, the same list returned
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _assert_kv_close(jout, tout, stack)
    # the port's own layer stack gives the hidden the step's head saw
    x = tm._embed_lookup(tp.embed, torch.from_numpy(ids))
    for lp, kv in zip(tp.layers, tkvs2):
        x, _ = tb._decode_layer_common(x, lp, tb._MATMULS[stack], kv, torch.from_numpy(lens), TTINY)
    x, jx = tnn.rmsnorm(x, tp.final_norm, TTINY.norm_eps).float().numpy(), np.asarray(jx, np.float32)
    assert np.abs(x - jx).max() <= 2**-7 * np.abs(jx).max()


def test_decode_burst_matches_jax(stack_params):
    """``*_decode_burst`` over 6 steps from lens 3..9 against the JAX step run
    op by op 6 times (the body of its ``fori_loop``): lengths advanced by 6,
    the last step's tokens equal, the whole cache as ``_assert_kv_close``
    bounds it (measured: bitwise but for 0.18% of the W4A16 stack's entries)."""
    stack, jp, tp = stack_params
    rng = np.random.default_rng(6)
    jkvs = _random_kvs(rng, stack)
    tkvs = dense_kv_from_numpy(_np(jkvs), "cpu")
    ids = np.array([1, 2, 3, 4], np.int32)
    lens = np.array([3, 9, 5, 4], np.int32)
    jids, jlens = jnp.asarray(ids), jnp.asarray(lens)
    for _ in range(6):
        jlens = jlens + 1
        jids, jkvs = J_STEP[stack].__wrapped__(jp, jkvs, jids, jlens, JTINY)
    tids, tkvs, tlens = T_BURST[stack](tp, tkvs, torch.from_numpy(ids), torch.from_numpy(lens), 6, TTINY)
    np.testing.assert_array_equal(tlens.numpy(), lens + 6)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _assert_kv_close(jkvs, tkvs, stack)


def test_prefill_step_matches_jax(stack_params):
    """``baseline_prefill_step`` of an 11-token prompt in a 32-row bucket into
    slot 1 against the JAX function op by op: the token equal; the slot's cache
    rows [0, 32) as ``_assert_kv_close`` bounds them: layer 0's float32
    attention sums in another order, which moves a few hidden elements by one
    bf16 rounding (measured: layer 0 bitwise, 0.9-5% of layer 1's bf16 entries
    in the slot's rows by at most 0.023, none of W8A8's int8 codes); the other
    slots untouched."""
    stack, jp, tp = stack_params
    rng = np.random.default_rng(7)
    jkvs = _random_kvs(rng, stack)
    tkvs = dense_kv_from_numpy(_np(jkvs), "cpu")
    ids = np.zeros((32,), np.int32)
    ids[:11] = rng.integers(1, JTINY.vocab_size, 11)
    jtok, jout = jb.baseline_prefill_step.__wrapped__(jp, jkvs, jnp.asarray(ids), 11, 1, JTINY, stack)
    ttok, tout = tb.baseline_prefill_step(tp, tkvs, torch.from_numpy(ids), 11, 1, TTINY, stack)
    assert ttok.ndim == 0 and ttok.dtype == torch.int32 and int(ttok) == int(jtok)
    _assert_kv_close(jout, tout, stack)
    before = dense_kv_from_numpy(_np(jkvs), "cpu")
    for b_, t_ in zip(before, tout):
        for x_, y_ in zip(b_, t_):
            assert torch.equal(_other_rows(x_, 1), _other_rows(y_, 1))


def _other_rows(t, slot):
    """All of a cache but slot ``slot``'s first 32 rows."""
    keep = torch.ones(t.shape[:2], dtype=torch.bool)
    keep[slot, :32] = False
    return t[keep]


def test_bf16_prefill_decode_continuation():
    """``tests/test_baselines.py``'s property in the port: decoding over the
    dense cache reproduces the token a longer prefill of the same text predicts."""
    tp = baseline_params_from_numpy(_np(jb.init_bf16_params(jax.random.PRNGKey(1), JTINY)), "cpu")
    rng = np.random.Generator(np.random.PCG64(7))
    prompt = rng.integers(1, TTINY.vocab_size, 11).astype(np.int32)
    kvs = tb.make_dense_kv(TTINY.num_layers, 2, 128, TTINY.num_kv_heads, TTINY.head_dim, device="cpu")
    ids = np.zeros((32,), np.int32)
    ids[:11] = prompt
    tok, kvs = tb.baseline_prefill_step(tp, kvs, torch.from_numpy(ids), 11, 0, TTINY, "bf16")
    seq, cur = list(prompt), int(tok)
    for _ in range(6):
        seq.append(cur)
        nxt, kvs = tb.bf16_decode_step(tp, kvs, torch.tensor([cur, 0], dtype=torch.int32),
                                       torch.tensor([len(seq), 0], dtype=torch.int32), TTINY)
        cur = int(nxt[0])
    kvs2 = tb.make_dense_kv(TTINY.num_layers, 1, 128, TTINY.num_kv_heads, TTINY.head_dim, device="cpu")
    ids2 = np.zeros((32,), np.int32)
    ids2[: len(seq)] = seq
    want, _ = tb.baseline_prefill_step(tp, kvs2, torch.from_numpy(ids2), len(seq), 0, TTINY, "bf16")
    assert cur == int(want)


# ---------------------------------------------------------------------------
# the engine over each stack
# ---------------------------------------------------------------------------


def _engine_requests():
    """``tests/test_baselines.py::test_baseline_engine_and_prefill_consistency``'s requests."""
    rng = np.random.Generator(np.random.PCG64(7))
    prompt_lens = rng.integers(3, 30, 5).astype(np.int32)
    output_lens = rng.integers(2, 20, 5).astype(np.int32)
    prompts = [rng.integers(1, TINY_KW["vocab_size"], p).astype(np.int32) for p in prompt_lens]
    return prompt_lens, output_lens, prompts


def test_engine_matches_jax(stack_params):
    """``TextGenEngine`` over ``make_baseline_step_fns`` in both packages (batch
    4, page 64, buckets 32 / 64, 5 requests), the JAX engine driving its step
    functions op by op: every request served with its output count, the same
    decode-step count, the pool returned, and the first tokens (which depend on
    the prompt alone) equal in all 5 requests (measured: 5 of 5 for every
    stack); later tokens are compared up to each request's first divergence,
    at least 70% of the positions before it."""
    stack, jp, tp = stack_params
    requests = _engine_requests()
    bsz, max_seq = 4, 256

    jstep = J_STEP[stack].__wrapped__
    jfns = (
        lambda state, ids, table_row, true_len, slot: jb.baseline_prefill_step.__wrapped__(
            jp, state, ids, true_len, slot, JTINY, stack),
        lambda state, ids, page_table, seq_lens: jstep(jp, state, ids, seq_lens, JTINY),
    )
    jtg = jeng.TextGenConfig(batch_size=bsz, page_size=64, max_seq_len=max_seq, prefill_buckets=(32, 64))
    jpool_ = jpool.KvPool(JTINY.num_layers, 24, JTINY.num_kv_heads, 64, JTINY.head_dim)
    jstate = jb.make_dense_kv(JTINY.num_layers, bsz, max_seq, JTINY.num_kv_heads, JTINY.head_dim, dtype=_kv_dtype(stack))
    jres = jeng.TextGenEngine(jtg, jpool_, *jfns, jstate).run(jwl.RequestSet(*requests), record=True)

    tg = TextGenConfig(batch_size=bsz, page_size=64, max_seq_len=max_seq, prefill_buckets=(32, 64))
    pool = KvPool(TTINY.num_layers, 24, TTINY.num_kv_heads, 64, TTINY.head_dim)
    state = tb.make_dense_kv(TTINY.num_layers, bsz, max_seq, TTINY.num_kv_heads, TTINY.head_dim,
                             dtype=torch.int8 if stack == "w8a8" else torch.bfloat16, device="cpu")
    engine = TextGenEngine(tg, pool, *tb.make_baseline_step_fns(tp, TTINY, stack), state)
    res = engine.run(RequestSet(*requests), record=True)

    output_lens = requests[1]
    assert res["requests"] == jres["requests"] == 5
    assert res["output_tokens"] == jres["output_tokens"] == int(output_lens.sum())
    assert res["decode_steps"] == jres["decode_steps"]
    assert pool.num_free_pages == jpool_.num_free_pages == 23
    first = before = total = 0
    for r in range(5):
        tt, jt = res["tokens"][r], jres["tokens"][r]
        assert len(tt) == len(jt) == output_lens[r] and all(0 <= t < TTINY.vocab_size for t in tt)
        first += tt[0] == jt[0]
        same = np.asarray(tt) == np.asarray(jt)
        before += len(same) if same.all() else int(np.argmin(same))
        total += len(same)
    assert first == 5, f"{stack}: first tokens agree in {first}/5 requests"
    assert before / total >= 0.7, f"{stack}: {before}/{total} positions before the first divergence"
