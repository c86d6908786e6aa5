"""The port's grouped-scale int8 GEMMs (kernel K14: ``grouped_int8_gemm`` and
``grouped_int8_gemm_o4``, through their plain versions), their ``quant_gemm``
/ ``quant_gemm_o4`` drop-ins and ``ops.reference.quant_gemm_o4``, held against
the JAX package on shared seeded inputs: the Pallas kernels in interpret mode
and the jnp oracle (``ops/reference.py``).

Above 112 body groups (the 70B MLP down depth) the TPU kernel still adds
every group in order, where K1 K-blocks: a numpy emulation of its float32
order, with the multiply-add XLA contracts, equals the interpreted kernel bit
for bit without K-blocks and differs from it with K1's; the same emulation
with each multiply and add rounded equals K14a's plain version bit for bit
without K-blocks and differs from it with K1's.

The CUDA kernels themselves are held against the same plain versions on the
card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu.config import ATOM_W4A4
from atom_tpu.ops import pallas_gemm as jg
from atom_tpu.ops import reference as jr
from atom_tpu.ops.formats import quantize_activation_packed, quantize_weight_packed
from atom_tpu_torch.ops import formats as tf
from atom_tpu_torch.ops import gemm as tg
from atom_tpu_torch.ops import gemm_packed as gp
from atom_tpu_torch.ops import reference as tr
from test_torch_serving import cap_torch_threads

cap_torch_threads()


def _t(a):
    return torch.from_numpy(np.array(a))


def _operands(seed, m, k, n):
    """JAX W4A4 operands from seeded float inputs, and the port's form of the
    same codes and scales (activation keeper as the last group)."""
    rng = np.random.default_rng(seed)
    qa = quantize_activation_packed(jnp.asarray(rng.standard_normal((m, k)).astype(np.float32)), ATOM_W4A4)
    pw = quantize_weight_packed(jnp.asarray((rng.standard_normal((k, n)) * 0.05).astype(np.float32)), ATOM_W4A4)
    tqa = tf.QuantizedActivation(_t(np.concatenate([qa.body, qa.keeper], axis=1)),
                                 _t(np.concatenate([qa.body_scale, qa.keeper_scale], axis=1)))
    tpw = tf.PackedWeight(*(_t(x) for x in pw))
    return qa, pw, tqa, tpw


# M not a multiple of the 32-row tile, N of 128 only at 256 (the JAX kernel pads both)
SHAPES = [(16, 512, 256), (5, 384, 384), (40, 1024, 128)]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_grouped_int8_gemm_matches_pallas(m, k, n):
    """K14a's plain version against the Pallas kernel in interpret mode: each
    group's int32 dot is exact in both and the float32 epilogue runs group by
    group in the same order, ``acc + float(dot_g) * sa * sw``, keeper last; but
    XLA's CPU compiler contracts the last multiply and the add into one fused
    multiply-add (emulating that reproduces every element of the interpreted
    kernel), so each term can round once less there: rtol 1e-5, as K1 against
    its Pallas kernel.  Against the jnp oracle (another float32 order): rtol
    1e-5, atol 1e-4, the JAX package's own bound for its kernel."""
    qa, pw, tqa, tpw = _operands(m + n, m, k, n)
    a, w, sa, sw = jg._assemble_operands(qa, pw)
    want = np.asarray(jg.grouped_int8_gemm(a, w, sa, sw, interpret=True))
    ta, tw_, tsa, tsw = tg._assemble_operands(tqa, tpw)
    for x, y in zip((ta, tw_, tsa, tsw), (a, w, sa, sw)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    before = tg.grouped_int8_gemm.launches
    got = tg.grouped_int8_gemm(ta, tw_, tsa, tsw)
    assert tg.grouped_int8_gemm.launches == before  # a CPU tensor takes the plain version
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    ref = np.asarray(jr.quant_gemm(qa, pw, out_dtype=jnp.float32))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)
    # the drop-in: the same product, rounded to its out_dtype
    assert torch.equal(tg.quant_gemm(tqa, tpw, out_dtype=torch.float32), got)
    bf = tg.quant_gemm(tqa, tpw)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf, got.to(torch.bfloat16))
    np.testing.assert_allclose(bf.float().numpy(), np.asarray(jg.quant_gemm_pallas(qa, pw, interpret=True), np.float32),
                               rtol=2**-7, atol=1e-6)  # one bf16 rounding apart where the f32 sums differ


@pytest.mark.parametrize("m,k,n", [(16, 512, 256), (5, 384, 384)])
def test_grouped_int8_gemm_o4_matches_pallas(m, k, n):
    """K14b's plain version against the Pallas kernel in interpret mode: codes
    and (scale, zero value) params bit for bit on these inputs (the product as
    K14a, within the fused multiply-add's rounding, then the quantizer of
    ``quantize_kv_asym``: IEEE division, bf16-rounded scale and zero value; no
    value lands on a rounding boundary here); the ``quant_gemm_o4`` drop-in
    returns them head-major."""
    qa, pw, tqa, tpw = _operands(7 * m + n, m, k, n)
    a, w, sa, sw = jg._assemble_operands(qa, pw)
    wc, wp = jg.grouped_int8_gemm_o4(a, w, sa, sw, interpret=True)
    before = tg.grouped_int8_gemm_o4.launches
    codes, params = tg.grouped_int8_gemm_o4(*tg._assemble_operands(tqa, tpw))
    assert tg.grouped_int8_gemm_o4.launches == before
    assert codes.dtype == torch.int8 and codes.shape == (m, n) and params.shape == (m, n // 128, 2)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(params.numpy(), np.asarray(wp))
    assert int(codes.min()) >= 0 and int(codes.max()) <= 15
    kq = tg.quant_gemm_o4(tqa, tpw)
    jq = jg.quant_gemm_o4_pallas(qa, pw, interpret=True)
    assert kq.codes.shape == (m, n // 128, 128)
    np.testing.assert_array_equal(kq.codes.numpy(), np.asarray(jq.codes))
    np.testing.assert_array_equal(kq.params.numpy(), np.asarray(jq.params))


@pytest.mark.parametrize("m,k,n", SHAPES[:2])
def test_reference_quant_gemm_o4_matches_jax(m, k, n):
    """``ops.reference.quant_gemm_o4`` (the oracle: ``quant_gemm``'s other
    float32 order, then the quantizer) against the JAX oracle: params within
    1e-5 (the JAX package's own bound for its kernel against the oracle), codes
    equal but where a product lands on a rounding boundary (at most 0.1%,
    measured 0), and the K14b plain version within the same bounds of it."""
    qa, pw, tqa, tpw = _operands(3 * m + k, m, k, n)
    want = jr.quant_gemm_o4(qa, pw, head_dim=128)
    got = tr.quant_gemm_o4(tqa, tpw)
    assert got.codes.shape == (m, n // 128, 128) and got.params.shape == (m, n // 128, 2)
    assert np.mean(got.codes.numpy() != np.asarray(want.codes)) <= 1e-3
    np.testing.assert_allclose(got.params.numpy(), np.asarray(want.params), atol=1e-5)
    kq = tg.quant_gemm_o4(tqa, tpw)
    assert np.mean(kq.codes.numpy() != got.codes.numpy()) <= 1e-3
    np.testing.assert_allclose(kq.params.numpy(), got.params.numpy(), atol=1e-5)


def test_k14_equals_k1_on_the_same_codes():
    """The grouped GEMM on int8-carrier codes and K1 on their nibble planes
    compute the same products in the same float32 order: equal bit for bit
    (what ``chip_smoke.py`` checks of the two kernels at Llama-2-7B width)."""
    qa, pw, tqa, tpw = _operands(11, 32, 512, 256)
    kw = tf.pack_for_kernel(tpw)
    k1 = gp.packed_w4_gemm_plain(tqa.codes, kw.body_packed, kw.keeper, tqa.scales, kw.scales)
    np.testing.assert_array_equal(tg.grouped_int8_gemm(*tg._assemble_operands(tqa, tpw)).numpy(), k1.numpy())
    kq = tg.quant_gemm_o4(tqa, tpw)
    want = tr.quantize_kv_asym(k1.reshape(32, 2, 128))
    assert torch.equal(kq.codes, want.codes) and torch.equal(kq.params, want.params)


def test_wrappers_refuse_other_devices_and_shapes():
    """A wrapper takes its plain version only for CPU tensors; a tensor on
    another device (``meta``) raises rather than falling back, and so does a
    head width the kernel does not quantize."""
    meta = [torch.empty((32, 256), dtype=torch.int8, device="meta"), torch.empty((256, 128), dtype=torch.int8),
            torch.empty((32, 2)), torch.empty((2, 128))]
    with pytest.raises(ValueError, match="on the CPU or all on CUDA"):
        tg.grouped_int8_gemm(*meta)
    with pytest.raises(ValueError, match="on the CPU or all on CUDA"):
        tg.grouped_int8_gemm_o4(*meta)
    # off the card a head width other than 128 still computes (the plain version quantizes any width)
    codes, params = tg.grouped_int8_gemm_o4(torch.zeros((2, 256), dtype=torch.int8), torch.zeros((256, 128),
                                            dtype=torch.int8), torch.ones((2, 2)), torch.ones((2, 128)), head_dim=64)
    assert codes.shape == (2, 128) and params.shape == (2, 2, 2)


def _fma32(x, y, z):
    """float32 ``x * y + z`` rounded once, as a fused multiply-add: ``x * y``
    is exact in float64; where the float64 sum lands on a float32 midpoint
    its own rounding error (TwoSum) decides the direction."""
    p = x.astype(np.float64) * y.astype(np.float64)
    z64 = z.astype(np.float64)
    s = p + z64
    bb = s - p
    err = (p - (s - bb)) + (z64 - bb)  # s + err == p + z exactly
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    other = np.where(s > r64, np.nextafter(r, np.float32(np.inf)), np.nextafter(r, np.float32(-np.inf)))
    midpoint = (s != r64) & (2 * np.abs(s - r64) == np.abs(other.astype(np.float64) - r64))
    return np.where(midpoint & (err != 0) & (np.sign(err) == np.sign(s - r64)), other, r)


def _mul_add32(x, y, z):
    """float32 ``x * y + z`` rounded twice: the multiply, then the add."""
    return x * y + z


def _emulate(a, w, sa, sw, kblk: bool, fma=_fma32):
    """A float32 order of K14: term ``float(dot_g) * sa``, then
    ``fma(term, sw, acc)``, group by group, keeper last; with ``kblk`` K1's
    K-blocked order in the same arithmetic (partial chains of ``KBLK_G``
    groups, each added to the output in turn, the keeper's term before the
    last block's partial).  ``fma`` is ``_fma32`` for the interpreted
    kernel (XLA's contraction) and ``_mul_add32`` for K14a's plain version
    (``acc + dot * sa * sw``, each operation rounded)."""
    m, k = a.shape
    ng = k // 128
    dots = np.matmul(a.reshape(m, ng, 128).transpose(1, 0, 2).astype(np.float64),
                     w.reshape(ng, 128, -1).astype(np.float64)).astype(np.float32)  # exact: |dot| < 2**24
    terms = [dots[g] * sa[:, g : g + 1] for g in range(ng)]
    acc = np.zeros(dots.shape[1:], np.float32)
    if not kblk:
        for g in range(ng):
            acc = fma(terms[g], sw[g : g + 1], acc)
        return acc
    body = ng - 1
    for g0 in range(0, body, gp.KBLK_G):
        part = np.zeros_like(acc)
        for g in range(g0, min(g0 + gp.KBLK_G, body)):
            part = fma(terms[g], sw[g : g + 1], part)
        if g0 + gp.KBLK_G >= body:
            acc = fma(terms[body], sw[body : body + 1], acc)
        acc = acc + part
    return acc


@pytest.mark.parametrize("k", [15488, 28672])
def test_deep_k_matches_pallas_unblocked(k):
    """Above ``KBLK_THRESHOLD`` body groups (120 and 223 + the keeper): the
    TPU kernel is never K-blocked.  Its interpreted output equals the numpy
    emulation of the unblocked order bit for bit and differs from K1's
    K-blocked order in the same arithmetic; K14a's plain version (the
    written order, no contraction) is within 1e-6 x max|out| of it (at this
    depth the fused multiply-add's roundings add up past the shallow cases'
    elementwise rtol 1e-5, atol 1e-6: measured 1.7e-7 and 1.9e-7 of
    max|out|), and K14b's codes and params equal the interpreted kernel's."""
    m, n = 16, 128
    qa, pw, tqa, tpw = _operands(k + 5, m, k, n)
    a, w, sa, sw = jg._assemble_operands(qa, pw)
    assert k // 128 - 1 > gp.KBLK_THRESHOLD
    want = np.asarray(jg.grouped_int8_gemm(a, w, sa, sw, interpret=True))
    an, wn, san, swn = (np.asarray(x) for x in (a, w, sa, sw))
    np.testing.assert_array_equal(_emulate(an, wn, san, swn, kblk=False), want)
    assert np.any(_emulate(an, wn, san, swn, kblk=True) != want)
    got = tg.grouped_int8_gemm(*tg._assemble_operands(tqa, tpw)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    wc, wprm = jg.grouped_int8_gemm_o4(a, w, sa, sw, interpret=True)
    codes, params = tg.grouped_int8_gemm_o4(*tg._assemble_operands(tqa, tpw))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(params.numpy(), np.asarray(wprm))


@pytest.mark.parametrize("k", [15488, 28672])
def test_deep_k_plain_version_is_unblocked(k):
    """K14a's plain version (the order the CUDA kernel is held to bit for bit
    on the card) at 120 and 223 body groups + the keeper equals the numpy
    emulation of the unblocked order with each multiply and add rounded, bit
    for bit, and differs from K1's K-blocked order in the same arithmetic:
    the order is pinned exactly, and the interpreted kernel's bound above
    covers only the fused multiply-add's roundings."""
    qa, pw, tqa, tpw = _operands(k + 5, 16, k, 128)
    a, w, sa, sw = tg._assemble_operands(tqa, tpw)
    got = tg.grouped_int8_gemm(a, w, sa, sw).numpy()
    an, wn, san, swn = (x.numpy() for x in (a, w, sa, sw))
    np.testing.assert_array_equal(_emulate(an, wn, san, swn, kblk=False, fma=_mul_add32), got)
    assert np.any(_emulate(an, wn, san, swn, kblk=True, fma=_mul_add32) != got)
