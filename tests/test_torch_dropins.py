"""The port's remaining oracle drop-ins held against the JAX package:
``ops/reference.py``'s ``silu_mul_quant``, ``make_kv_pages``,
``append_kv_decode``, ``append_kv_prefill``, ``gather_kv`` and
``batch_decode``; ``ops/kv_layout.py``'s ``_unpack_planes``,
``kv_pages_from_reference`` and ``kv_codes_from_kernel``; and
``ops/gemm_packed.py``'s ``quant_gemm_o4_packed`` against
``pallas_gemm_packed.quant_gemm_o4_packed`` run with ``interpret=True``.

Tolerances: integer codes, page bytes and bf16 params bitwise everywhere;
``silu_mul_quant``'s scales within rtol 1e-6 (XLA's and PyTorch's float32
SiLU and absmax division differ in the last bit: 1.2e-7 measured), its codes
equal at these inputs;
``batch_decode``'s float32 output within 1e-5 of its largest entry (another
summation order of the same products).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu.config import ATOM_W4A4
from atom_tpu.ops import kv_layout as jkv
from atom_tpu.ops import reference as jr
from atom_tpu.ops.formats import pack_for_kernel as j_pack_for_kernel
from atom_tpu.ops.formats import quantize_activation_packed as j_qact
from atom_tpu.ops.formats import quantize_weight_packed as j_qweight
from atom_tpu.ops.pallas_gemm_packed import quant_gemm_o4_packed as j_o4_packed
from atom_tpu_torch import config as tconf
from atom_tpu_torch.ops import kv_layout as tkv
from atom_tpu_torch.ops import reference as tr
from atom_tpu_torch.ops.gemm_packed import quant_gemm_o4_packed
from atom_tpu_torch.ops.formats import QuantizedActivation
from atom_tpu_torch.quant.packing import pack_uint4
from atom_tpu_torch.serving.convert import _kpw, tensor_from_numpy
from test_torch_serving import cap_torch_threads

cap_torch_threads()

N_PAGES, H, S, D = 6, 2, 16, 128


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _kv(rng, t):
    """A ``KVQuant`` of ``t`` tokens as numpy: u4 codes and bf16-valued params."""
    codes = rng.integers(0, 16, (t, H, D)).astype(np.int8)
    scale = rng.uniform(0.01, 0.1, (t, H, 1)).astype(np.float32)
    zero = -rng.integers(0, 16, (t, H, 1)).astype(np.float32) * scale
    params = np.asarray(jnp.asarray(np.concatenate([scale, zero], -1)).astype(jnp.bfloat16).astype(jnp.float32))
    return codes, params


def _same(a, b):
    a, b = np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("abits", (4, 8))
def test_silu_mul_quant_matches_jax(abits):
    rng = np.random.default_rng(abits)
    gate = (rng.normal(size=(24, 512)) * 2).astype(np.float32)
    up = rng.normal(size=(24, 512)).astype(np.float32)
    spec_j = ATOM_W4A4.replace(abits=abits)
    want = jr.silu_mul_quant(jnp.asarray(gate).astype(jnp.bfloat16), jnp.asarray(up).astype(jnp.bfloat16), spec_j)
    got = tr.silu_mul_quant(_t(gate).bfloat16(), _t(up).bfloat16(), tconf.ATOM_W4A4.replace(abits=abits))
    codes = np.concatenate([want.body, want.keeper], axis=1)
    scales = np.concatenate([want.body_scale, want.keeper_scale], axis=1)
    assert got.codes.dtype == torch.int8 and got.codes.shape == codes.shape
    np.testing.assert_array_equal(got.codes.numpy(), codes)
    np.testing.assert_allclose(got.scales.numpy(), scales, rtol=1e-6)


def test_kv_page_appends_and_gather_match_jax():
    rng = np.random.default_rng(0)
    jp, jprm = jr.make_kv_pages(N_PAGES, H, S, D)
    tp, tprm = tr.make_kv_pages(N_PAGES, H, S, D, device="cpu")
    _same(jp, tp)
    _same(jprm, tprm)
    # a 37-token prefill from position 5 over pages (4, 1, 3), then one decode token for each of 3 sequences
    row = np.array([4, 1, 3, 0], np.int32)
    codes, params = _kv(rng, 37)
    jp, jprm = jr.append_kv_prefill(jp, jprm, jr.KVQuant(jnp.asarray(codes), jnp.asarray(params)), jnp.asarray(row),
                                    S, start_pos=5)
    tp2, tprm2 = tr.append_kv_prefill(tp, tprm, tr.KVQuant(_t(codes), _t(params)), _t(row), S, start_pos=5)
    assert not tp.any() and not tprm.any()  # the inputs untouched
    _same(jp, tp2)
    _same(jprm, tprm2)
    dcodes, dparams = _kv(rng, 3)
    page_idx, slot = np.array([2, 5, 4], np.int32), np.array([0, 15, 3], np.int32)
    jp, jprm = jr.append_kv_decode(jp, jprm, jr.KVQuant(jnp.asarray(dcodes), jnp.asarray(dparams)),
                                   jnp.asarray(page_idx), jnp.asarray(slot))
    tp3, tprm3 = tr.append_kv_decode(tp2, tprm2, tr.KVQuant(_t(dcodes), _t(dparams)), _t(page_idx), _t(slot))
    _same(jp, tp3)
    _same(jprm, tprm3)
    for r in (row, np.array([2, 5, 4, 1], np.int32)):
        jc, jpp = jr.gather_kv(jp, jprm, jnp.asarray(r))
        tc, tpp = tr.gather_kv(tp3, tprm3, _t(r))
        _same(jc, tc)
        _same(jpp, tpp)


@pytest.mark.parametrize("heads", (2, 4))
def test_batch_decode_matches_jax(heads):
    rng = np.random.default_rng(heads)
    k_pages = rng.integers(-128, 128, (N_PAGES, H, S, D // 2)).astype(np.int8)
    v_pages = rng.integers(-128, 128, (N_PAGES, H, S, D // 2)).astype(np.int8)
    _, k_params = _kv(rng, N_PAGES * S)
    _, v_params = _kv(rng, N_PAGES * S)
    k_params, v_params = (p.reshape(N_PAGES, S, H, 2).transpose(0, 2, 1, 3).copy() for p in (k_params, v_params))
    table = np.array([[1, 3, 0], [5, 2, 4]], np.int32)
    lens = np.array([20, 41], np.int32)
    q = rng.normal(size=(2, heads, D)).astype(np.float32)
    args = (q, k_pages, k_params, v_pages, v_params, table, lens)
    want = np.asarray(jr.batch_decode(*map(jnp.asarray, args), rope_theta=1e4, out_dtype=jnp.float32))
    got = tr.batch_decode(*map(_t, args), rope_theta=1e4, out_dtype=torch.float32).numpy()
    assert got.shape == want.shape == (2, heads, D)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_kv_layout_converters_match_jax():
    rng = np.random.default_rng(3)
    ref = [rng.integers(-128, 128, (N_PAGES, H, S, D // 2)).astype(np.int8),
           rng.normal(size=(N_PAGES, H, S, 2)).astype(np.float32),
           rng.integers(-128, 128, (N_PAGES, H, S, D // 2)).astype(np.int8),
           rng.normal(size=(N_PAGES, H, S, 2)).astype(np.float32)]
    want = jkv.kv_pages_from_reference(*map(jnp.asarray, ref))
    got = tkv.kv_pages_from_reference(*map(_t, ref))
    for f in jkv.KVPages._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f)
        _same(a.view(np.int16) if a.dtype.name == "bfloat16" else a,
              b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    for a, b in zip(jkv.kv_codes_from_kernel(want), tkv.kv_codes_from_kernel(got)):
        _same(a, b)
    planes = rng.integers(-128, 128, (3, 8, 5)).astype(np.int8)
    _same(jkv._unpack_planes(jnp.asarray(planes)), tkv._unpack_planes(_t(planes)))
    # the round trip: kernel layout -> reference layout codes -> kernel layout
    k_codes, k_prm, v_codes, v_prm = tkv.kv_codes_from_kernel(got)
    back = tkv.kv_pages_from_reference(pack_uint4(k_codes).view(torch.int8), k_prm, pack_uint4(v_codes).view(torch.int8),
                                       v_prm)
    assert all(torch.equal(a, b) for a, b in zip(back, got))


@pytest.mark.parametrize("m,k,n", ((8, 512, 256), (33, 1024, 512)))
def test_quant_gemm_o4_packed_matches_pallas(m, k, n):
    rng = np.random.default_rng(m)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * k**-0.5).astype(np.float32)
    qa = j_qact(jnp.asarray(x), ATOM_W4A4)
    kw = j_pack_for_kernel(j_qweight(jnp.asarray(w), ATOM_W4A4))
    want = j_o4_packed(qa, kw, head_dim=128, interpret=True)
    tkw = _kpw(type(kw)(*(np.asarray(a) for a in kw)), "cpu")
    tqa = QuantizedActivation(_t(np.concatenate([qa.body, qa.keeper], axis=1)),
                              _t(np.concatenate([qa.body_scale, qa.keeper_scale], axis=1)))
    got = quant_gemm_o4_packed(tqa, tkw, head_dim=128)
    _same(want.codes, got.codes)
    _same(want.params, got.params)
    assert got.codes.shape == (m, n // 128, 128)

