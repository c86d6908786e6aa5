"""The port's W8A16 lm_head (kernel K5 through its plain version, the
quantizer, the padding and slicing around it) held against the JAX package on
shared seeded inputs.  The JAX Pallas kernel runs in interpret mode.

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
from atom_tpu.serving import model as jm
from atom_tpu.serving.kvpool import KvPool as JKvPool
from atom_tpu.serving.kvpool import SeqKvCache as JSeqKvCache
from atom_tpu.serving.kvpool import batch_page_table as j_batch_page_table
from atom_tpu_torch.config import QuantSpec as TQuantSpec
from atom_tpu_torch.models.configs import Arch as TArch
from atom_tpu_torch.models.configs import ModelConfig as TModelConfig
from atom_tpu_torch.ops import gemm_w4a16 as tw
from atom_tpu_torch.serving import model as tm
from atom_tpu_torch.serving.convert import serving_params_from_numpy, tensor_from_numpy
from test_torch_serving import cap_torch_threads

cap_torch_threads()

TINY_KW = dict(vocab_size=199, hidden_size=256, intermediate_size=384, num_layers=2,
               num_heads=2, num_kv_heads=2, head_dim=128, max_position_embeddings=512)
JTINY, TTINY = ModelConfig(arch=Arch.LLAMA, **TINY_KW), TModelConfig(arch=TArch.LLAMA, **TINY_KW)
JSPEC, TSPEC = QuantSpec(weight_channel_group=1), TQuantSpec(weight_channel_group=1)
PAGE = 128


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _bf16(x):
    return np.array(jnp.asarray(np.asarray(x, np.float32)).astype(jnp.bfloat16))


@pytest.mark.parametrize("k,n", [(256, 199), (512, 384), (1024, 512)])
def test_quantize_w8a16_matches_jax_bitwise(k, n):
    """Per-column scales and int8 codes, bit for bit (one IEEE division for the
    scale, round-half-to-even for the codes); an all-zero column keeps the
    1e-8 floor."""
    rng = np.random.default_rng(k + n)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    w[:, 3] = 0.0
    want = jw.quantize_w8a16(jnp.asarray(w))
    got = tw.quantize_w8a16(_t(w))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.codes.dtype == torch.int8 and got.scale.shape == (1, n)
    np.testing.assert_array_equal(tw.dequantize_w8a16(got).numpy(), np.asarray(jw.dequantize_w8a16(want)))


@pytest.mark.parametrize("m,k,n", [(1, 512, 384), (32, 1024, 512), (40, 256, 640)])
def test_w8a16_gemm_matches_pallas(m, k, n):
    """K5's plain version against the Pallas kernel in interpret mode.  Every
    product (bf16 x int8 code) is exact in float32 and the scale multiplies
    once at the end in both, so they differ only by the order of the float32
    additions: within ``W8A16_RTOL`` (1e-4) of the largest output; a partial
    sum rounded to bf16 would cost 2e-3."""
    rng = np.random.default_rng(m * 7 + n)
    a = _bf16(rng.standard_normal((m, k)))
    wq = jw.quantize_w8a16(jnp.asarray((rng.standard_normal((k, n)) * 0.02).astype(np.float32)))
    want = np.asarray(jw.w8a16_gemm(jnp.asarray(a), wq, interpret=True))
    got = tw.w8a16_gemm(_t(a), tw.W8A16Weight(_t(wq.codes), _t(wq.scale)))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    err = np.abs(got.numpy() - want).max()
    assert err <= tw.W8A16_RTOL * np.abs(want).max(), f"max |diff| {err} vs max |out| {np.abs(want).max()}"
    # the float32 sum really is unrounded: equal to a float64 reference to 1e-5
    ref = (a.astype(np.float64) @ np.asarray(wq.codes, np.float64)) * np.asarray(wq.scale, np.float64)
    assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_w8a16_gemm_launch_count_untouched_on_cpu():
    """The count moves only where the kernel launches; a CPU tensor takes the
    plain version."""
    before = tw.w8a16_gemm.launches
    wq = tw.quantize_w8a16(torch.ones((16, 64)))
    out = tw.w8a16_gemm(torch.ones((2, 16), dtype=torch.bfloat16), wq)
    assert tw.w8a16_gemm.launches == before
    np.testing.assert_allclose(out.numpy(), 16.0, rtol=1e-6)


@pytest.fixture(scope="module")
def heads():
    jparams = jm.init_serving_params(jax.random.PRNGKey(2), JTINY, JSPEC)
    jq = jm.quantize_lm_head(jparams)
    tparams = serving_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jparams, jq, tparams, tm.quantize_lm_head(tparams)


def test_quantize_lm_head_padding_matches_jax(heads):
    """K padded to a multiple of 1024 and N to a multiple of 512 before
    quantization; codes and scales bitwise, pad rows and columns zero codes."""
    _, jq, _, tq = heads
    assert isinstance(tq.lm_head, tw.W8A16Weight)
    assert tuple(tq.lm_head.codes.shape) == (1024, 512)
    np.testing.assert_array_equal(tq.lm_head.codes.numpy(), np.asarray(jq.lm_head.codes))
    np.testing.assert_array_equal(tq.lm_head.scale.numpy(), np.asarray(jq.lm_head.scale))
    assert not tq.lm_head.codes[256:].any() and not tq.lm_head.codes[:, 199:].any()


def test_lm_head_logits_slicing_matches_jax(heads):
    """``_lm_head_logits`` with the W8A16 head: pad columns sliced off by
    ``vocab``, logits equal to the JAX head's within the float32 reordering
    tolerance, and close to the bf16 head's (the quantizer's error only)."""
    jparams, jq, tparams, tq = heads
    rng = np.random.default_rng(3)
    x = _bf16(rng.standard_normal((4, JTINY.hidden_size)))
    want = np.asarray(jm._lm_head_logits(jnp.asarray(x), jq.lm_head, JTINY.vocab_size))
    got = tm._lm_head_logits(_t(x), tq.lm_head, TTINY.vocab_size).numpy()
    assert got.shape == (4, 199)
    assert np.abs(got - want).max() <= tw.W8A16_RTOL * np.abs(want).max()
    assert tm._lm_head_logits(_t(x), tq.lm_head).shape == (4, 512)  # unsliced: the padded width
    ref = tm._lm_head_logits(_t(x), tparams.lm_head, TTINY.vocab_size).numpy()
    np.testing.assert_allclose(ref, np.asarray(jm._lm_head_logits(jnp.asarray(x), jparams.lm_head)), rtol=1e-5, atol=1e-6)
    err = np.abs(got - ref).mean() / (ref.std() + 1e-9)
    cos = float((ref * got).sum() / (np.linalg.norm(ref) * np.linalg.norm(got)))
    assert err < 0.02 and cos > 0.999, (err, cos)  # the JAX test's probe bounds W8A16 noise by 2%


def test_quantize_lm_head_int4_names_its_kernel(heads):
    """``bits=4`` no longer raises: it gives the W4A16 head that kernel K13
    (``w4a16_gemm``) runs, padded as the W8A16 head is (held against the JAX
    package in ``tests/test_torch_baselines.py``)."""
    _, _, tparams, _ = heads
    q4 = tm.quantize_lm_head(tparams, bits=4)
    assert isinstance(q4.lm_head, tw.W4A16Weight)
    assert tuple(q4.lm_head.packed.shape) == (512, 512) and tuple(q4.lm_head.scale.shape) == (8, 512)
    assert tm._lm_head_logits(torch.ones((2, 256)), q4.lm_head, 199).shape == (2, 199)


def test_convert_carries_w8a16_head_bitwise(heads):
    _, jq, _, tq = heads
    conv = serving_params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), "cpu")
    assert isinstance(conv.lm_head, tw.W8A16Weight)
    assert conv.lm_head.codes.dtype == torch.int8 and conv.lm_head.scale.dtype == torch.float32
    assert torch.equal(conv.lm_head.codes, tq.lm_head.codes) and torch.equal(conv.lm_head.scale, tq.lm_head.scale)


def test_quantized_lm_head_option(heads):
    """Counterpart of ``tests/test_serving.py::test_quantized_lm_head_option``:
    prefill and one decode step run end to end with the W8A16 head, and the
    port's tokens are the JAX package's on the same weights and prompt (near-tie
    argmax flips aside, both tokens are checked for range; the prefill token,
    computed from bitwise-equal quantized inputs, must agree)."""
    _, jq, _, tq = heads
    rng = np.random.Generator(np.random.PCG64(2))
    prompt = rng.integers(1, JTINY.vocab_size, 9).astype(np.int32)
    ids = np.zeros((32,), np.int32)
    ids[: len(prompt)] = prompt
    pool = JKvPool(JTINY.num_layers, 8, JTINY.num_kv_heads, PAGE, JTINY.head_dim)
    kv = JSeqKvCache(pool, len(prompt))
    tr = np.zeros((4,), np.int32)
    tr[: len(kv.page_ids)] = kv.page_ids

    jstate = jm.make_serving_state(JTINY.num_layers, 8, 1, JTINY.num_kv_heads, PAGE, JTINY.head_dim)
    jtok, jstate = jm.prefill_step(jq, jstate, jnp.asarray(ids), jnp.asarray(tr), jnp.int32(len(prompt)),
                                   jnp.int32(0), JTINY, JSPEC)
    tstate = tm.make_serving_state(TTINY.num_layers, 8, 1, TTINY.num_kv_heads, PAGE, TTINY.head_dim, device="cpu")
    ttok, tstate = tm.prefill_step(tq, tstate, _t(ids), _t(tr), len(prompt), 0, TTINY, TSPEC)
    assert ttok.dtype == torch.int32 and ttok.ndim == 0
    assert int(ttok) == int(jtok)

    kv.acquire_one()
    table, lens = j_batch_page_table([kv], 4)
    jtok2, _ = jm.decode_step(jq, jstate, jnp.asarray([int(jtok)], jnp.int32), jnp.asarray(table),
                              jnp.asarray(lens), JTINY, JSPEC)
    ttok2, _ = tm.decode_step(tq, tstate, torch.tensor([int(ttok)], dtype=torch.int32), _t(table), _t(lens),
                              TTINY, TSPEC)
    assert 0 <= int(ttok2[0]) < TTINY.vocab_size and 0 <= int(jtok2[0]) < JTINY.vocab_size
