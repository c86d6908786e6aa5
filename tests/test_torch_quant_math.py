"""The port's fake-quantization math (``quant/fp.py``, the rest of
``quant/core.py``), the rest of ``ops/formats.py`` and the accuracy model's
``attention`` / ``layernorm``, held against the JAX package on shared
numpy-seeded inputs.

Tolerances: the quantizers, FP casts and packing bitwise, on float32 and
bfloat16 inputs; the exponent-only quantizer within one power-of-two step on
at most 0.1% of the entries (``log2`` may differ by an ulp between PyTorch
and XLA, which moves an entry sitting on a rounding boundary); attention and
layernorm within rtol 1e-6 (float32 sums and ``exp`` in another order; for
entries near zero, where a relative bound means nothing, 1e-6 of the largest),
bfloat16 attention within one bfloat16 ulp (2^-8 relative, or of the largest).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu import config as jconf
from atom_tpu.calib import gptq as jg
from atom_tpu.models import nn as jnn
from atom_tpu.ops import formats as jf
from atom_tpu.quant import core as jc
from atom_tpu.quant import fp as jfp
from atom_tpu_torch import config as tconf
from atom_tpu_torch.models import nn as tnn
from atom_tpu_torch.ops import formats as tf
from atom_tpu_torch.quant import core as tc
from atom_tpu_torch.quant import fp as tfp
from atom_tpu_torch.serving.convert import tensor_from_numpy
from test_torch_serving import cap_torch_threads

cap_torch_threads()

DTYPES = ("float32", "bfloat16")
SPECS = ("ATOM_W4A4", "ATOM_W4A4_FP4", "ATOM_W8A8", "FP16_BASELINE")


def _rand(shape, dtype="float32", seed=0, scale=1.0, outliers=True):
    """Seeded normal data (with a few outlier channels), in ``dtype`` (numpy)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * scale
    if outliers:
        x[..., :: max(1, shape[-1] // 7)] *= 8.0
    return np.asarray(jnp.asarray(x).astype(jnp.dtype(dtype)))


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _tbits(t):
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _eq(j, t):
    assert str(np.asarray(j).dtype) == str(t.dtype).replace("torch.", ""), (np.asarray(j).dtype, t.dtype)
    np.testing.assert_array_equal(_bits(j), _tbits(t))


# ---------------------------------------------------------------------------
# quant/fp.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_fp8_fake_casts_bitwise(dtype):
    x = _rand((64, 256), dtype, seed=1)
    _eq(jfp.fake_cast_e5m2(jnp.asarray(x)), tfp.fake_cast_e5m2(_t(x)))
    _eq(jfp.fake_cast_e4m3(jnp.asarray(x)), tfp.fake_cast_e4m3(_t(x)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_fp4_bitwise(dtype):
    v = np.linspace(-1.2, 1.2, 4001, dtype=np.float32)  # every code and every midpoint's neighbourhood
    _eq(jfp.fp4_round_normalized(jnp.asarray(v)), tfp.fp4_round_normalized(_t(v)))
    x = _rand((32, 128), dtype, seed=2)
    _eq(jfp.fake_quantize_fp4(jnp.asarray(x), axis=-1), tfp.fake_quantize_fp4(_t(x), dim=-1))
    _eq(jfp.fake_quantize_fp4(jnp.asarray(x), axis=0), tfp.fake_quantize_fp4(_t(x), dim=0))


# ---------------------------------------------------------------------------
# quant/core.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits,sym,group,clip", [(4, True, 128, 0.9), (4, False, 0, 1.0), (8, True, 0, 1.0),
                                                 (8, False, 128, 0.85), (3, True, 64, 1.0)])
def test_fake_quantize_tensor_bitwise(dtype, bits, sym, group, clip):
    x = _rand((48, 256), dtype, seed=3)
    _eq(jc.fake_quantize_tensor(jnp.asarray(x), bits, group, sym, clip),
        tc.fake_quantize_tensor(_t(x), bits, group, sym, clip))
    q = jc.quantize_groups(jnp.asarray(x), bits, sym, clip)
    _eq(jc.dequantize_groups(q), tc.dequantize_groups(tc.quantize_groups(_t(x), bits, sym, clip)))


@pytest.mark.parametrize("sym", (True, False))
def test_fake_quantize_exponential_close(sym):
    x = _rand((64, 128), "float32", seed=4)
    want = np.asarray(jc._fake_quantize_exponential(jnp.asarray(x), 4, sym))
    got = tc._fake_quantize_exponential(_t(x), 4, sym).numpy()
    differ = want != got
    assert differ.mean() <= 1e-3, differ.mean()
    # a moved entry moves by one power-of-two step at most
    ratio = np.abs(got[differ] - np.asarray(x)[differ]) / np.maximum(np.abs(want[differ] - np.asarray(x)[differ]), 1e-30)
    assert np.all((ratio < 4.0) & (ratio > 0.25)), ratio


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("group,cg,quant_type", [(128, 2, "int"), (128, 1, "int"), (0, 2, "int"), (64, 4, "int"),
                                                 (128, 2, "fp")])
def test_quantize_weight_grouped_bitwise(dtype, group, cg, quant_type):
    w = _rand((64, 256), dtype, seed=5, scale=0.02)
    kw = dict(channel_group=cg, clip_ratio=0.85)
    _eq(jc.quantize_weight_grouped(jnp.asarray(w), 4, group, True, quant_type=jconf.QuantType(quant_type), **kw),
        tc.quantize_weight_grouped(_t(w), 4, group, True, quant_type=tconf.QuantType(quant_type), **kw))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("precision", (0, 1, 2, 3))
def test_quantize_keeper_bitwise(dtype, precision):
    x = _rand((40, 128), dtype, seed=6)
    _eq(jc.quantize_keeper(jnp.asarray(x), jconf.KeeperPrecision(precision)),
        tc.quantize_keeper(_t(x), tconf.KeeperPrecision(precision)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec", SPECS)
def test_quantize_weight_and_activation_bitwise(dtype, spec):
    js, ts = getattr(jconf, spec), getattr(tconf, spec)
    w = _rand((128, 384), dtype, seed=7, scale=0.02)
    _eq(jc.quantize_weight(jnp.asarray(w), js), tc.quantize_weight(_t(w), ts))
    x = _rand((2, 24, 384), dtype, seed=8)
    _eq(jc.quantize_activation(jnp.asarray(x), js), tc.quantize_activation(_t(x), ts))


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_kv_head_bitwise(dtype):
    x = _rand((2, 4, 16, 128), dtype, seed=9)
    spec_j, spec_t = jconf.ATOM_W4A4, tconf.ATOM_W4A4
    _eq(jc.quantize_kv_head(jnp.asarray(x), spec_j), tc.quantize_kv_head(_t(x), spec_t))
    jq, tq = jc.quantize_kv_head_real(jnp.asarray(x), spec_j), tc.quantize_kv_head_real(_t(x), spec_t)
    for a, b in zip(jq, tq):
        _eq(a, b)
    # off: the KV cache unquantized, or activations at 16 bits
    for f in (dict(kv_cache=False), dict(abits=16)):
        assert tc.quantize_kv_head(_t(x), spec_t.replace(**f)) is not None
        _eq(jc.quantize_kv_head(jnp.asarray(x), spec_j.replace(**f)), tc.quantize_kv_head(_t(x), spec_t.replace(**f)))


# ---------------------------------------------------------------------------
# ops/formats.py
# ---------------------------------------------------------------------------


def _gptq_scales():
    """A GPTQ-calibrated [in, out] weight and its exported scales, from JAX."""
    rng = np.random.default_rng(10)
    w = (rng.standard_normal((384, 256)) * 0.02).astype(np.float32)  # [in, out]
    x = rng.standard_normal((512, 384)).astype(np.float32)
    h = 2.0 * x.T @ x / 512
    wq, scales = jg.gptq_quantize_weight_spec(jnp.asarray(w.T), jnp.asarray(h), jconf.ATOM_W4A4, return_scales=True)
    return np.asarray(wq).T, np.asarray(scales)


def test_pack_gptq_output_bitwise_on_jax_scales():
    w_fake, scales = _gptq_scales()
    jpw = jf.pack_gptq_output(jnp.asarray(w_fake), jnp.asarray(scales), jconf.ATOM_W4A4)
    tpw = tf.pack_gptq_output(_t(w_fake), _t(scales), tconf.ATOM_W4A4)
    for a, b in zip(jpw, tpw):
        _eq(a, b)
    with pytest.raises(ValueError):
        tf.pack_gptq_output(_t(w_fake[:-64]), _t(scales), tconf.ATOM_W4A4)


def test_packed_weight_round_trips_bitwise():
    w1, w2 = _rand((384, 256), seed=11, scale=0.02), _rand((384, 128), seed=12, scale=0.02)
    jp = [jf.quantize_weight_packed(jnp.asarray(w), jconf.ATOM_W4A4) for w in (w1, w2)]
    tp = [tf.quantize_weight_packed(_t(w), tconf.ATOM_W4A4) for w in (w1, w2)]
    jcat, tcat = jf.concat_packed_out(jp), tf.concat_packed_out(tp)
    for a, b in zip(jcat, tcat):
        _eq(a, b)
    for dtype in (jnp.float32, jnp.bfloat16):
        _eq(jf.dequantize_weight(jcat, dtype), tf.dequantize_weight(tcat, getattr(torch, jnp.dtype(dtype).name)))
    # nibble planes and back: the port's merged scales split again
    back = tf.unpack_from_kernel(tf.pack_for_kernel(tcat))
    jback = jf.unpack_from_kernel(jf.pack_for_kernel(jcat))
    for a, b, c in zip(jback, back, tcat):
        _eq(a, b)
        assert torch.equal(b, c)
    # 2-per-byte storage form
    js, ts = jf.pack_weight_storage(jcat), tf.pack_weight_storage(tcat)
    for k in js:
        _eq(js[k], ts[k])
    for a, b in zip(jf.unpack_weight_storage(js), tf.unpack_weight_storage(ts)):
        _eq(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dequantize_activation_bitwise(dtype):
    x = _rand((24, 512), dtype, seed=13)
    jqa = jf.quantize_activation_packed(jnp.asarray(x), jconf.ATOM_W4A4)
    tqa = tf.quantize_activation_packed(_t(x), tconf.ATOM_W4A4)
    for out in ("float32", "bfloat16"):
        _eq(jf.dequantize_activation(jqa, jnp.dtype(out)), tf.dequantize_activation(tqa, getattr(torch, out)))


# ---------------------------------------------------------------------------
# models/nn.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_close(dtype):
    q, k, v = (_rand((2, 4, 40, 128), dtype, seed=s, scale=0.5, outliers=False) for s in (14, 15, 16))
    jmask, tmask = jnn.causal_mask(40, 40), tnn.causal_mask(40, 40)
    for jm_, tm_ in ((jmask, tmask), (None, None)):
        want = np.asarray(jnn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm_), np.float32)
        got = tnn.attention(_t(q), _t(k), _t(v), tm_).to(torch.float32).numpy()
        if dtype == "float32":  # ulps of f32 sums and exp; atol for entries near zero, 1e-6 of the largest
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
        else:  # an ulp of f32 order may move a bf16 rounding of a probability or of the output: one bf16 ulp
            np.testing.assert_allclose(got, want, rtol=2**-8, atol=2**-8 * np.abs(want).max())


def test_layernorm_close():
    x = _rand((8, 40, 256), seed=17)
    w, b = _rand((256,), seed=18), _rand((256,), seed=19)
    want = np.asarray(jnn.layernorm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5))
    got = tnn.layernorm(_t(x), _t(w), _t(b), 1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
