"""The port's quantization math, packed formats, numerics pins and the
embedding gather (K6), held against the JAX package on shared numpy inputs.

Integer codes and packed bytes must match bitwise and scales exactly; the
float statistics (rms rstd, rope tables) within rtol 1e-6, since PyTorch and
XLA may differ by an ulp in rsqrt, pow and cos/sin.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu.config import ATOM_W4A4
from atom_tpu.models import nn as jnn
from atom_tpu.numerics import rms_rstd as j_rms_rstd
from atom_tpu.ops import formats as jf
from atom_tpu.ops import reference as jr
from atom_tpu.ops.kv_layout import pack_channel_planes as j_pack_channel_planes
from atom_tpu.ops.kv_layout import pack_slot_planes as j_pack_slot_planes
from atom_tpu.ops.pallas_misc import embed_gather as j_embed_gather
from atom_tpu.quant import core as jc
from atom_tpu.quant import packing as jp
from atom_tpu_torch.config import ATOM_W4A4 as T_ATOM_W4A4
from atom_tpu_torch.models import nn as tnn
from atom_tpu_torch.numerics import rms_rstd as t_rms_rstd
from atom_tpu_torch.ops import formats as tf
from atom_tpu_torch.ops import reference as tr
from atom_tpu_torch.ops.kv_layout import pack_channel_planes as t_pack_channel_planes
from atom_tpu_torch.ops.kv_layout import pack_slot_planes as t_pack_slot_planes
from atom_tpu_torch.ops.misc import embed_gather as t_embed_gather
from atom_tpu_torch.quant import core as tc
from atom_tpu_torch.quant import packing as tp
from atom_tpu_torch.serving.convert import tensor_from_numpy
from test_torch_serving import cap_torch_threads

cap_torch_threads()


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _n(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _eq(j, t):
    np.testing.assert_array_equal(_bits(j), _n(t))


def test_port_spec_matches_jax_spec():
    import dataclasses

    import atom_tpu.config as jconf
    import atom_tpu_torch.config as tconf

    assert dataclasses.asdict(T_ATOM_W4A4) == dataclasses.asdict(ATOM_W4A4)
    for name in ("ATOM_W4A4_FP4", "ATOM_W8A8", "FP16_BASELINE"):
        assert dataclasses.asdict(getattr(tconf, name)) == dataclasses.asdict(getattr(jconf, name)), name


@pytest.mark.parametrize("signed", [True, False])
def test_pack_unpack_int4_bitwise(signed):
    rng = np.random.default_rng(0)
    lo, hi = (-8, 8) if signed else (0, 16)
    codes = rng.integers(lo, hi, (6, 64)).astype(np.int8)
    jpack, junpack = (jp.pack_int4, jp.unpack_int4) if signed else (jp.pack_uint4, jp.unpack_uint4)
    tpack, tunpack = (tp.pack_int4, tp.unpack_int4) if signed else (tp.pack_uint4, tp.unpack_uint4)
    jb, tb = jpack(jnp.asarray(codes)), tpack(_t(codes))
    np.testing.assert_array_equal(np.asarray(jb).view(np.uint8), tb.view(torch.uint8).numpy())
    np.testing.assert_array_equal(np.asarray(junpack(jb)), tunpack(tb).numpy())
    np.testing.assert_array_equal(tunpack(tb).numpy(), codes)


@pytest.mark.parametrize("sym,bits,clip", [(True, 4, 0.9), (True, 8, 1.0), (False, 4, 1.0), (False, 4, 0.85)])
def test_quantize_groups_bitwise(sym, bits, clip):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((16, 4, 128)) * rng.uniform(0.01, 3, (16, 4, 1))).astype(np.float32)
    jq = jc.quantize_groups(jnp.asarray(x), bits, sym, clip)
    tq = tc.quantize_groups(_t(x), bits, sym, clip)
    for a, b in zip(jq, tq):
        _eq(a, b)


def test_plane_packing_bitwise():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 16, (3, 2, 128, 32)).astype(np.int8)
    _eq(j_pack_channel_planes(jnp.asarray(codes)), t_pack_channel_planes(_t(codes)))
    _eq(j_pack_slot_planes(jnp.asarray(codes)), t_pack_slot_planes(_t(codes)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activation_packed_bitwise(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((32, 640)).astype(np.float32) * 2
    x[:, -128:] *= 20  # outlier keeper channels
    xj = jnp.asarray(x).astype(dtype)
    xt = tensor_from_numpy(np.asarray(xj), "cpu")
    jq = jf.quantize_activation_packed(xj, ATOM_W4A4)
    tq = tf.quantize_activation_packed(xt, T_ATOM_W4A4)
    # the port lays the keeper out as one more group after the body groups
    _eq(np.concatenate([jq.body, jq.keeper], 1), tq.codes)
    _eq(np.concatenate([jq.body_scale, jq.keeper_scale], 1), tq.scales)


def test_quantize_weight_packed_and_pack_for_kernel_bitwise():
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((512, 384)) / np.sqrt(512)).astype(np.float32)
    jpw = jf.quantize_weight_packed(jnp.asarray(w), ATOM_W4A4)
    tpw = tf.quantize_weight_packed(_t(w), T_ATOM_W4A4)
    for a, b in zip(jpw, tpw):
        _eq(a, b)
    jkw, tkw = jf.pack_for_kernel(jpw), tf.pack_for_kernel(tpw)
    _eq(jkw.body_packed, tkw.body_packed)
    _eq(jkw.keeper, tkw.keeper)
    _eq(np.concatenate([jkw.body_scale, jkw.keeper_scale[None]], 0), tkw.scales)


def test_quantize_kv_asym_bitwise():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((32, 4, 128)) * rng.uniform(0.1, 4, (32, 4, 1))).astype(np.float32)
    jq = jr.quantize_kv_asym(jnp.asarray(x))
    tq = tr.quantize_kv_asym(_t(x))
    _eq(jq.codes, tq.codes)
    _eq(jq.params, tq.params)


def test_rms_rstd_and_rope_tables_close():
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((32, 512)).astype(np.float32)).astype(jnp.bfloat16)
    xt = tensor_from_numpy(np.asarray(x), "cpu")
    np.testing.assert_allclose(t_rms_rstd(xt).numpy(), np.asarray(j_rms_rstd(x)), rtol=1e-6)
    pos = rng.integers(0, 2048, 32).astype(np.int32)
    jc_, js_ = jnn.rope_tables(jnp.asarray(pos), 128, 10000.0)
    tc_, ts_ = tnn.rope_tables(_t(pos), 128, 10000.0)
    np.testing.assert_allclose(tc_.numpy(), np.asarray(jc_), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js_), rtol=1e-6, atol=1e-6)
    w = jnp.asarray(rng.uniform(0.5, 1.5, 512).astype(np.float32)).astype(jnp.bfloat16)
    got = tnn.rmsnorm(xt, tensor_from_numpy(np.asarray(w), "cpu"), 1e-5)
    want = jnn.rmsnorm(x, w, 1e-5)
    np.testing.assert_allclose(
        got.to(torch.float32).numpy(), np.asarray(want, np.float32), rtol=2**-7, atol=0
    )


def test_embed_gather_matches_jax():
    """K6's plain version (the kernel's CPU twin) vs the Pallas gather.

    Bitwise but for the sign of zero: the TPU kernel sums a one-hot select in
    f32, turning -0.0 into +0.0; the port copies rows bitwise and keeps -0.0.
    """
    rng = np.random.default_rng(7)
    e = jnp.asarray(rng.standard_normal((64, 256)).astype(np.float32) * 0.02).astype(jnp.bfloat16)
    e = e.at[5, :7].set(-0.0)
    ids = np.array([5, 0, 63, 17, 5, 40, 8, 9], np.int32)
    want = np.asarray(j_embed_gather(e, jnp.asarray(ids), interpret=True))
    got = t_embed_gather(tensor_from_numpy(np.asarray(e), "cpu"), _t(ids))
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want.astype(np.float32))
    assert torch.signbit(got[0, :7]).all()  # -0.0 kept
    np.testing.assert_array_equal(_n(got)[1:4], _bits(want)[1:4])


def test_quant_gemm_and_dequantize_kv_match_jax():
    """The dual-path GEMM oracle (rtol 1e-5 on f32 output: group sums are
    exact integers, only the scale einsum's f32 order differs) and the KV
    dequantization (exact)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((16, 384)).astype(np.float32)
    w = (rng.standard_normal((384, 256)) / 20).astype(np.float32)
    jqa, jpw = jf.quantize_activation_packed(jnp.asarray(x), ATOM_W4A4), jf.quantize_weight_packed(jnp.asarray(w), ATOM_W4A4)
    tqa = tf.QuantizedActivation(
        _t(np.concatenate([jqa.body, jqa.keeper], 1)), _t(np.concatenate([jqa.body_scale, jqa.keeper_scale], 1))
    )
    tpw = tf.PackedWeight(*(_t(a) for a in jpw))
    want = np.asarray(jr.quant_gemm(jqa, jpw, out_dtype=jnp.float32))
    np.testing.assert_allclose(tr.quant_gemm(tqa, tpw, out_dtype=torch.float32).numpy(), want, rtol=1e-5, atol=1e-5)
    kv = jr.quantize_kv_asym(jnp.asarray(rng.standard_normal((8, 4, 128)).astype(np.float32)))
    np.testing.assert_array_equal(
        tr.dequantize_kv(_t(kv.codes), _t(kv.params)).numpy(), np.asarray(jr.dequantize_kv(kv.codes, kv.params))
    )


def test_apply_rope_matches_jax():
    """RoPE on bf16 heads with shared f32 tables: within 1 bf16 ulp."""
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.standard_normal((6, 4, 128)).astype(np.float32)).astype(jnp.bfloat16)
    cos, sin = jnn.rope_tables(jnp.arange(6), 128, 10000.0)
    want = np.asarray(jnn.apply_rope(x, cos[:, None], sin[:, None]), np.float32)
    got = tnn.apply_rope(tensor_from_numpy(np.asarray(x), "cpu"), _t(cos)[:, None], _t(sin)[:, None])
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, rtol=2**-7, atol=1e-6)
