"""The port's kernel prefill held against the JAX package's: the flash
attention kernel K12 (through its plain version) against the Pallas kernel in
interpret mode on the cases of ``tests/test_pallas_prefill.py``, the
``kernel=True`` branch of ``causal_code_attention``, and ``prefill_step`` with
``PREFILL_KERNEL_THRESHOLD`` at 0 against the default path.

The CUDA kernel is held against the same plain version on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu.config import ATOM_W4A4 as JSPEC
from atom_tpu.models.configs import Arch, ModelConfig
from atom_tpu.ops.pallas_prefill import flash_code_attention as j_flash
from atom_tpu.ops.reference import quantize_kv_asym as j_quantize_kv
from atom_tpu.serving import model as jm
from atom_tpu_torch.config import ATOM_W4A4 as TSPEC
from atom_tpu_torch.models.configs import Arch as TArch
from atom_tpu_torch.models.configs import ModelConfig as TModelConfig
from atom_tpu_torch.ops import reference as TR
from atom_tpu_torch.ops.prefill import flash_code_attention as t_flash
from atom_tpu_torch.ops.prefill import flash_code_attention_plain
from atom_tpu_torch.serving import model as tm
from atom_tpu_torch.serving.convert import serving_params_from_numpy, tensor_from_numpy
from test_torch_serving import cap_torch_threads

cap_torch_threads()

SM_SCALE = 128**-0.5


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _inputs(tq, tk, hq, hkv, seed):
    """q bf16 and real quantized K/V codes, the same arrays for both packages."""
    rng = np.random.default_rng(seed)
    q = np.array(jnp.asarray(rng.standard_normal((tq, hq, 128)).astype(np.float32)).astype(jnp.bfloat16))
    kq = j_quantize_kv(jnp.asarray(rng.standard_normal((tk, hkv, 128)).astype(np.float32)))
    vq = j_quantize_kv(jnp.asarray(rng.standard_normal((tk, hkv, 128)).astype(np.float32)))
    return q, kq, vq


# (Tq, Tk, HQ, Hkv, row offset, Pallas q block, Pallas key block): the cases of
# tests/test_pallas_prefill.py (MHA; GQA with lengths off the block; a query
# shard at an offset against the whole key range) and the sequence-parallel
# shape of a longer prompt's second half
CASES = {
    "mha_512": (512, 512, 4, 4, 0, 128, 256),
    "gqa_ragged_320": (320, 320, 4, 2, 0, 128, 128),
    "offset_256_tq128_tk512": (128, 512, 2, 2, 256, 128, 128),
    "gqa_offset_half": (192, 384, 4, 1, 192, 128, 128),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_code_attention_matches_pallas(case):
    """K12 against the Pallas kernel in interpret mode.  The same mathematics
    in another float32 order (one pass here, online over key blocks there), on
    the bf16 output grid: rtol 2e-2, atol 5e-3, the bound the JAX package holds
    its kernel to against its one-pass oracle."""
    tq, tk, hq, hkv, off, tq_blk, tk_blk = CASES[case]
    groups = hq // hkv
    q, kq, vq = _inputs(tq, tk, hq, hkv, seed=len(case))
    want = j_flash(jnp.asarray(q), kq.codes, kq.params, vq.codes, vq.params, groups, SM_SCALE,
                   row_offset=jnp.int32(off), offset_max=tk - tq, tq_blk=tq_blk, tk_blk=tk_blk, interpret=True)
    args = (_t(q), _t(kq.codes), _t(kq.params), _t(vq.codes), _t(vq.params), groups, SM_SCALE)
    got = t_flash(*args, row_offset=off, offset_max=tk - tq)
    assert got.dtype == torch.bfloat16 and got.shape == (tq, hq * 128)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2e-2, atol=5e-3)
    # on CPU tensors the wrapper is its plain version, and offset_max changes nothing
    assert torch.equal(got.view(torch.int16), flash_code_attention_plain(*args, row_offset=off).view(torch.int16))
    assert torch.equal(got.view(torch.int16), t_flash(*args, row_offset=off).view(torch.int16))


def test_flash_code_attention_masks_future_and_padded_keys():
    """Keys past a query's position carry no weight: replacing them (codes and
    params) leaves the rows before them unchanged bit for bit, at offset 0 and
    at an offset; the first row at offset 0 is V's dequantized first token."""
    tq, tk, hq, hkv = 40, 96, 4, 2
    q, kq, vq = _inputs(tq, tk, hq, hkv, seed=9)
    _, kq2, vq2 = _inputs(tq, tk, hq, hkv, seed=10)
    for off in (0, 30):
        cut = off + tq  # keys from here on are invisible to every query row
        mixed = [np.concatenate([np.asarray(a)[:cut], np.asarray(b)[cut:]]) for a, b in
                 ((kq.codes, kq2.codes), (kq.params, kq2.params), (vq.codes, vq2.codes), (vq.params, vq2.params))]
        a = t_flash(_t(q), _t(kq.codes), _t(kq.params), _t(vq.codes), _t(vq.params), 2, SM_SCALE, row_offset=off)
        b = t_flash(_t(q), *(_t(x) for x in mixed), 2, SM_SCALE, row_offset=off)
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    first = t_flash(_t(q), _t(kq.codes), _t(kq.params), _t(vq.codes), _t(vq.params), 2, SM_SCALE)[0].float().reshape(hq, 128)
    v0 = (np.asarray(vq.codes, np.float32)[0] * np.asarray(vq.params)[0, :, :1] + np.asarray(vq.params)[0, :, 1:])
    np.testing.assert_allclose(first.numpy(), np.repeat(v0, 2, axis=0), rtol=2**-7, atol=1e-6)


@pytest.mark.parametrize("shift", [-1, 1])
def test_chip_smoke_flash_gate_catches_offset_errors(shift):
    """``chip_smoke.py`` holds K12 to its plain version within ``ATTN_TOL`` on
    queries of scale 12, so that the softmax peaks on a few keys: a row offset
    wrong by one key (one key admitted or dropped at the causal edge) must then
    move the output past that tolerance, which queries of scale 1 over hundreds
    of keys would let through."""
    import chip_smoke

    tq, tk, hq, hkv, off = 64, 512, 4, 2, 400
    gen = torch.Generator().manual_seed(3)
    q = (torch.randn((tq, hq, 128), generator=gen) * 12.0).to(torch.bfloat16)
    kq, vq = (TR.quantize_kv_asym(torch.randn((tk, hkv, 128), generator=gen)) for _ in range(2))
    args = (q, kq.codes, kq.params, vq.codes, vq.params, 2, SM_SCALE)
    base = flash_code_attention_plain(*args, row_offset=off).float()
    with pytest.raises(AssertionError):
        torch.testing.assert_close(flash_code_attention_plain(*args, row_offset=off + shift).float(), base, **chip_smoke.ATTN_TOL)


def test_causal_code_attention_kernel_branch_matches_jax():
    """``causal_code_attention(kernel=True)`` in both packages (the Pallas
    kernel in interpret mode there, K12's plain version here), with and without
    ``row_pos``: rtol 2e-2, atol 5e-3 on the bf16 output.  At a head_dim other
    than 128 the JAX package keeps the default path without notice; the port
    raises, since the caller asked for a kernel that does not exist there
    (``prefill_hidden`` asks only at 128, so the threshold path is the same)."""
    tq, tk, hq, hkv, off = 128, 256, 4, 2, 128
    q, kq, vq = _inputs(tq, tk, hq, hkv, seed=4)
    tkq = TR.KVQuant(_t(kq.codes), _t(kq.params))
    tvq = TR.KVQuant(_t(vq.codes), _t(vq.params))
    want = jm.causal_code_attention(jnp.asarray(q), kq, vq, 2, SM_SCALE, row_pos=off + jnp.arange(tq), kernel=True)
    got = tm.causal_code_attention(_t(q), tkq, tvq, 2, SM_SCALE, row_pos=off + torch.arange(tq), kernel=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2e-2, atol=5e-3)
    # no row_pos: queries at 0..Tq-1 against the first Tq keys and the rest masked
    want0 = jm.causal_code_attention(jnp.asarray(q), kq, vq, 2, SM_SCALE, kernel=True)
    got0 = tm.causal_code_attention(_t(q), tkq, tvq, 2, SM_SCALE, kernel=True)
    np.testing.assert_allclose(got0.float().numpy(), np.asarray(want0, np.float32), rtol=2e-2, atol=5e-3)

    rng = np.random.default_rng(0)
    q64 = torch.from_numpy(rng.standard_normal((8, 2, 64)).astype(np.float32))
    kq64, vq64 = (TR.quantize_kv_asym(torch.from_numpy(rng.standard_normal((8, 2, 64)).astype(np.float32))) for _ in range(2))
    assert tm.causal_code_attention(q64, kq64, vq64, 1, 64**-0.5).shape == (8, 128)
    with pytest.raises(ValueError, match="head_dim 128"):
        tm.causal_code_attention(q64, kq64, vq64, 1, 64**-0.5, kernel=True)


CFG_KW = dict(vocab_size=256, hidden_size=512, intermediate_size=1024, num_layers=1, num_heads=4, num_kv_heads=2,
              head_dim=128, max_position_embeddings=512)


def test_prefill_step_with_kernel_threshold_matches_default_path(monkeypatch):
    """``prefill_step`` with ``PREFILL_KERNEL_THRESHOLD`` at 0 (every prompt
    through K12) against the default one-pass path, at the one-layer geometry
    of ``tests/test_pallas_prefill.py``'s integration test, and against the
    JAX package with its threshold at 0.

    The pages are written from the attention's inputs: bitwise equal between
    the two paths, and equal to the JAX eager layer stack's.  The hidden state
    sees attention outputs one bf16 ulp apart in a few elements; where such an
    element sits on a quantizer's rounding boundary a code flips downstream
    and moves its row.  By rows, between the port's paths and against the JAX
    kernel path: at most 10% of the 256 rows differ at all (measured over three
    prompts: 2-4.3%, the JAX package's own two paths 1.2-2%), no element by 1.0
    or more (measured: up to 0.53, a code step on a normed hidden of mean
    magnitude 0.8; the JAX package's own paths reach 0.53 too), and under 5% of
    the elements beyond flip noise (0.01 + 2%; measured up to 2.7%)."""
    jcfg, tcfg = ModelConfig(arch=Arch.LLAMA, **CFG_KW), TModelConfig(arch=TArch.LLAMA, **CFG_KW)
    jspec, tspec = JSPEC.replace(fused_serving=False), TSPEC.replace(fused_serving=False)
    jparams = jm.init_serving_params(jax.random.PRNGKey(0), jcfg, jspec)
    tparams = serving_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    t, page = 256, 128
    ids = np.random.default_rng(0).integers(0, 256, t).astype(np.int32)
    table_row = np.arange(1, 4, dtype=np.int32)

    def port(threshold):
        monkeypatch.setattr(tm, "PREFILL_KERNEL_THRESHOLD", threshold)
        calls = []
        real = tm.flash_code_attention
        monkeypatch.setattr(tm, "flash_code_attention", lambda *a, **k: calls.append(a[0].shape[0]) or real(*a, **k))
        state = tm.make_serving_state(1, 5, 2, tcfg.num_kv_heads, page, 128, device="cpu")
        x, pages = tm.prefill_hidden(tparams, state.pages, _t(ids), _t(table_row), tcfg, tspec)
        tok, new = tm.prefill_step(tparams, state, _t(ids), _t(table_row), t - 20, 1, tcfg, tspec)
        monkeypatch.setattr(tm, "flash_code_attention", real)
        return x.float().numpy(), pages, int(tok), new, calls

    x_def, pages_def, tok_def, _, calls_def = port(10**9)
    x_ker, pages_ker, tok_ker, new_ker, calls_ker = port(0)
    assert calls_def == [] and calls_ker == [t, t]  # one kernel call per layer and prefill
    assert new_ker.flushed.tolist() == [0, t - 20] and 0 <= tok_ker < 256
    for a, b in zip(pages_def[0], pages_ker[0]):
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b)

    def flip_close(got, want):
        diff = np.abs(got - want)
        rows = (diff > 0).any(axis=1).mean()
        assert rows <= 0.10, f"{rows:.2%} of the rows differ"
        assert diff.max() < 1.0, f"max diff {diff.max():.4f}"
        moved = np.mean(diff > (0.01 + 0.02 * np.abs(want)))
        assert moved < 0.05, f"{moved:.4%} elements moved beyond flip noise"

    flip_close(x_ker, x_def)

    monkeypatch.setattr(jm, "PREFILL_KERNEL_THRESHOLD", 0)
    jpages = jm.make_serving_state(1, 5, 2, jcfg.num_kv_heads, page, 128).pages
    xj, jpages = jm.prefill_hidden(jparams, jpages, jnp.asarray(ids), jnp.asarray(table_row), jcfg, jspec)
    flip_close(x_ker, np.asarray(xj, np.float32))
    for name in ("k_pages", "v_pages", "params"):
        jb = np.asarray(getattr(jpages[0], name))
        jb = jb.view(np.int16) if jb.dtype.name == "bfloat16" else jb
        tb = getattr(pages_ker[0], name)
        tb = tb.view(torch.int16).numpy() if tb.dtype == torch.bfloat16 else tb.numpy()
        np.testing.assert_array_equal(tb, jb, err_msg=name)
