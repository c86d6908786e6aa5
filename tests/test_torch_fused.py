"""The fused post-attention decode configuration of the port: the fused-in
o_proj GEMM K9 and the fused MLP K10 (through their plain versions) against
the Pallas kernels in interpret mode and against the port's own unfused chain,
the ``ATOM_TPU_FUSED_MLP`` gates, and ``decode_hidden`` with the flag on
against the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu.config import ATOM_W4A4 as JSPEC
from atom_tpu.models.configs import Arch, ModelConfig
from atom_tpu.numerics import rms_rstd as j_rms_rstd
from atom_tpu.ops.formats import pack_for_kernel as j_pack
from atom_tpu.ops.formats import quantize_weight_packed as j_quantize_weight
from atom_tpu.ops.pallas_gemm_packed import packed_w4_gemm_fused_in as j_fused_in
from atom_tpu.ops.pallas_mlp import fused_mlp_packed as j_fused_mlp
from atom_tpu.ops.pallas_mlp import fused_mlp_supported as j_supported
from atom_tpu.serving import model as jm
from atom_tpu_torch.config import ATOM_W4A4 as TSPEC
from atom_tpu_torch.models.configs import Arch as TArch
from atom_tpu_torch.models.configs import ModelConfig as TModelConfig
from atom_tpu_torch.ops import reference as TR
from atom_tpu_torch.ops.formats import KernelPackedWeight, quantize_activation_packed
from atom_tpu_torch.ops.gemm_packed import packed_w4_gemm_fused_in as t_fused_in
from atom_tpu_torch.ops.gemm_packed import quant_gemm_packed
from atom_tpu_torch.ops.mlp import fused_mlp_packed as t_fused_mlp
from atom_tpu_torch.ops.mlp import fused_mlp_packed_stages, fused_mlp_supported
from atom_tpu_torch.serving import model as tm
from atom_tpu_torch.serving.convert import serving_params_from_numpy, tensor_from_numpy
from test_torch_serving import cap_torch_threads

cap_torch_threads()

A_CLIP = JSPEC.a_clip_ratio


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _bf16(x):
    return np.array(jnp.asarray(np.asarray(x, np.float32)).astype(jnp.bfloat16))


def _weights(seed, in_f, out_f, scale=0.05):
    """One random weight in both packages' kernel layouts (same codes)."""
    w = np.random.default_rng(seed).standard_normal((in_f, out_f)).astype(np.float32) * scale
    jkw = j_pack(j_quantize_weight(jnp.asarray(w), JSPEC))
    scales = np.concatenate([np.asarray(jkw.body_scale), np.asarray(jkw.keeper_scale)[None]], 0)
    return jkw, KernelPackedWeight(_t(jkw.body_packed), _t(jkw.keeper), _t(scales))


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _flip_close(got, want, atol):
    """The JAX fused-kernel tests' bound: tight allclose plus a bound on the
    share of elements a flipped act code moved."""
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=atol)
    diff = np.abs(got - want)
    moved = diff > (0.1 * atol + 0.02 * np.abs(want))
    assert np.mean(moved) < 0.02, f"{np.mean(moved):.4%} elements moved beyond flip noise (max diff {diff.max():.4f})"


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------


def _rows_beyond_one_ulp(got, want):
    """Rows holding an element more than one bf16 ulp from ``want``."""
    return (np.abs(got - want) > np.abs(want) * 2**-7 + 1e-6).any(axis=1)


@pytest.mark.parametrize("norm", [False, True], ids=["no_norm", "norm"])
@pytest.mark.parametrize("resid", [False, True], ids=["no_resid", "resid"])
def test_fused_in_gemm_matches_pallas(norm, resid):
    """K9 against the Pallas kernel in interpret mode, with and without the
    norm, with and without the residual.  The integer dots are exact and the
    port follows the eager quantizer chain bitwise (next test); the compiled
    Pallas program sits 1 ulp off in about two thirds of its quantizer scales
    (see ``test_torch_kernels``), which breaks the exact rounding ties of bf16
    inputs the other way and flips about 0.03% of the activation codes.  One
    flipped code moves its whole output row by a code step times a weight.
    So, by rows: at least 65% of the rows within one bf16 ulp everywhere
    (measured: 75-91%, those rows bitwise), and every element within 0.2 (two
    code steps of ~0.6 times a weight of ~0.15; measured: 0.125)."""
    rng = np.random.default_rng(7 + 2 * norm + resid)
    m, k, n = 32, 640, 384
    jkw, tkw = _weights(1, k, n)
    y = _bf16(rng.standard_normal((m, k)) * 1.5)
    kwargs_j, kwargs_t = {}, {}
    if norm:
        norm_w = _bf16(rng.uniform(0.7, 1.3, (k,)))
        rstd = np.asarray(j_rms_rstd(jnp.asarray(y)))
        kwargs_j.update(norm_w=jnp.asarray(norm_w), rstd=jnp.asarray(rstd))
        kwargs_t.update(norm_w=_t(norm_w), rstd=_t(rstd))
    if resid:
        r = _bf16(rng.standard_normal((m, n)))
        kwargs_j.update(resid=jnp.asarray(r))
        kwargs_t.update(resid=_t(r))
    want = np.asarray(j_fused_in(jnp.asarray(y), jkw, abits=4, a_clip=A_CLIP, interpret=True, **kwargs_j), np.float32)
    got = t_fused_in(_t(y), tkw, abits=4, a_clip=A_CLIP, **kwargs_t)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    got = got.float().numpy()
    flip_rows = _rows_beyond_one_ulp(got, want)
    assert flip_rows.mean() <= 0.35, f"{flip_rows.mean():.2%} of rows beyond 1 bf16 ulp"
    np.testing.assert_allclose(got, want, rtol=0, atol=0.2)


def test_fused_in_gemm_equals_unfused_chain_bitwise():
    """K9 with the residual equals ``x + quant_gemm_packed(reorder_quant(..))``,
    the chain the decode step runs without the flag, bit for bit; with the norm
    it equals ``rmsnorm_reorder_quant`` in front of the same product; float32
    out is the bare product.  rstd computed by the wrapper when left out."""
    rng = np.random.default_rng(3)
    m, k, n = 32, 512, 256
    _, tkw = _weights(2, k, n)
    x = _t(_bf16(rng.standard_normal((m, k)) * 1.5))
    resid = _t(_bf16(rng.standard_normal((m, n))))
    perm = torch.from_numpy(rng.permutation(k).astype(np.int32))
    norm_w = _t(_bf16(rng.uniform(0.7, 1.3, (k,))))

    chain = resid + quant_gemm_packed(TR.reorder_quant(x, perm, TSPEC), tkw)
    fused = t_fused_in(torch.index_select(x, -1, perm), tkw, resid=resid, abits=4, a_clip=A_CLIP)
    assert torch.equal(_bits(fused), _bits(chain))

    chain_n = resid + quant_gemm_packed(TR.rmsnorm_reorder_quant(x, norm_w, perm, TSPEC), tkw)
    fused_n = t_fused_in(torch.index_select(x, -1, perm), tkw, norm_w=norm_w[perm.long()], resid=resid, abits=4, a_clip=A_CLIP)
    assert torch.equal(_bits(fused_n), _bits(chain_n))

    bare = t_fused_in(x, tkw, abits=4, a_clip=A_CLIP, out_dtype=torch.float32)
    assert bare.dtype == torch.float32
    assert torch.equal(bare, quant_gemm_packed(quantize_activation_packed(x, TSPEC), tkw, out_dtype=torch.float32))


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["norm_rstd", "no_norm_m8", "row_scale"])
def test_fused_mlp_matches_pallas(case):
    """K10 against the Pallas kernel in interpret mode: with the norm and rstd,
    without the norm at M = 8, and with ``row_scale``.

    Held by rows, as K9 above: an input code on an exact rounding tie flips
    between the compiled Pallas quantizer and the eager chain the port follows
    (SiLU may add a flipped act code on top), and the flip compounds through
    SiLU * up into its row's act scales.  At least 75% of the rows within one
    bf16 ulp everywhere (measured: 28 of 32 and 29 of 32 bitwise, 8 of 8
    without the norm); the whole output within the bound the JAX package holds
    its own two in-kernel-norm forms to (``tests/test_pallas_fused_in.py``:
    rtol 5e-2, atol 1.0, under 2% of the elements moved beyond flip noise;
    measured max 0.55)."""
    rng = np.random.default_rng({"norm_rstd": 0, "no_norm_m8": 1, "row_scale": 2}[case])
    d, inter = 512, 1024 if case != "no_norm_m8" else 1280
    m = 8 if case == "no_norm_m8" else 32
    jgu, tgu = _weights(10, d, 2 * inter)
    jdn, tdn = _weights(11, inter, d)
    y = _bf16(rng.standard_normal((m, d)))
    resid = _bf16(rng.standard_normal((m, d)))
    kj, kt = {}, {}
    if case != "no_norm_m8":
        norm_w = _bf16(rng.uniform(0.7, 1.3, (d,)))
        rstd = np.asarray(j_rms_rstd(jnp.asarray(y)))
        kj.update(norm_w=jnp.asarray(norm_w), rstd=jnp.asarray(rstd))
        kt.update(norm_w=_t(norm_w), rstd=_t(rstd))
    if case == "row_scale":
        rs = rng.uniform(0.1, 1.0, (m,)).astype(np.float32)
        kj.update(row_scale=jnp.asarray(rs))
        kt.update(row_scale=_t(rs))
    want = j_fused_mlp(jnp.asarray(y), jnp.asarray(resid), jgu, jdn, abits=4, a_clip=A_CLIP, interpret=True, **kj)
    want = np.asarray(want, np.float32)
    got = t_fused_mlp(_t(y), _t(resid), tgu, tdn, abits=4, a_clip=A_CLIP, **kt)
    assert got.dtype == torch.bfloat16 and got.shape == (m, d)
    got = got.float().numpy()
    flip_rows = _rows_beyond_one_ulp(got, want)
    assert flip_rows.mean() <= 0.25, f"{flip_rows.mean():.2%} of rows beyond 1 bf16 ulp"
    _flip_close(got, want, atol=1.0)


def test_fused_mlp_equals_unfused_mlp_bitwise():
    """K10 (with the norm inside, on the gathered hidden with the gathered
    weight) equals the port's unfused MLP block bit for bit, and its stages
    hand on the act codes the unfused chain quantizes."""
    rng = np.random.default_rng(5)
    m, d, inter = 32, 512, 768
    _, tgu = _weights(20, d, 2 * inter)
    _, tdn = _weights(21, inter, d)
    x = _t(_bf16(rng.standard_normal((m, d))))
    perm = torch.from_numpy(rng.permutation(d).astype(np.int32))
    ln = _t(_bf16(rng.uniform(0.7, 1.3, (d,))))

    m_in = TR.rmsnorm_reorder_quant(x, ln, perm, TSPEC)
    gu = quant_gemm_packed(m_in, tgu, out_dtype=torch.float32)
    d_in = quantize_activation_packed(torch.nn.functional.silu(gu[:, :inter]) * gu[:, inter:], TSPEC)
    chain = x + quant_gemm_packed(d_in, tdn)

    y = torch.index_select(x, -1, perm)
    out, act, act_scales = fused_mlp_packed_stages(y, x, tgu, tdn, norm_w=ln[perm.long()], rstd=tm._rms_rstd(x),
                                                   abits=4, a_clip=A_CLIP)
    assert torch.equal(act, d_in.codes) and torch.equal(act_scales, d_in.scales)
    assert torch.equal(_bits(out), _bits(chain))
    assert torch.equal(_bits(t_fused_mlp(y, x, tgu, tdn, norm_w=ln[perm.long()], abits=4, a_clip=A_CLIP)), _bits(chain))


@pytest.mark.parametrize("geom", [(4096, 11008, 128, 128), (5120, 13824, 128, 128), (4096, 11008, 64, 128),
                                  (768, 2048, 128, 128), (8192, 28672, 128, 128), (512, 768, 128, 128)])
def test_fused_mlp_support_gate_matches_jax(geom):
    assert fused_mlp_supported(*geom) == j_supported(*geom)


# ---------------------------------------------------------------------------
# a float32 residual (fault C4): the output takes the residual's type, and the
# epilogue adds the product unrounded, as the TPU kernels' ``_rp`` does at 32 bits
# ---------------------------------------------------------------------------


def _rows_within_f32(got, want):
    """Share of rows whose every element lies within 1e-5 relative + 1e-5."""
    return (np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-5).all(axis=1).mean()


def test_fused_in_gemm_f32_resid_matches_pallas():
    """K9 with a float32 residual against the Pallas kernel in interpret mode,
    on the inputs of ``test_fused_in_gemm_matches_pallas[resid-no_norm]`` with
    the residual left in float32: float32 out, at least 75% of the rows within
    1e-5 relative + 1e-5 (a flipped input code moves its row, as there), every
    element within 0.2.  One bf16 rounding of the product before the add (the
    fault) moves products of order 1 by up to 2^-9 and puts rows outside."""
    rng = np.random.default_rng(8)
    m, k, n = 32, 640, 384
    jkw, tkw = _weights(1, k, n)
    y = _bf16(rng.standard_normal((m, k)) * 1.5)
    r = rng.standard_normal((m, n)).astype(np.float32)
    want = np.asarray(j_fused_in(jnp.asarray(y), jkw, resid=jnp.asarray(r), abits=4, a_clip=A_CLIP, interpret=True))
    got = t_fused_in(_t(y), tkw, resid=_t(r), abits=4, a_clip=A_CLIP)
    assert want.dtype == np.float32 and got.dtype == torch.float32 and got.shape == (m, n)
    got = got.numpy()
    assert _rows_within_f32(got, want) >= 0.75, f"{_rows_within_f32(got, want):.2%} of rows within 1e-5"
    np.testing.assert_allclose(got, want, rtol=0, atol=0.2)


@pytest.mark.parametrize("row_scale", [False, True], ids=["resid", "row_scale"])
def test_fused_mlp_f32_resid_matches_pallas(row_scale):
    """K10 with a float32 residual, without and with ``row_scale``, against
    the Pallas kernel in interpret mode on the inputs of
    ``test_fused_mlp_matches_pallas`` (its ``norm_rstd`` and ``row_scale``
    cases: d 512, inter 1024, M 32, norm and rstd) with the residual left in
    float32: float32 out, at least 75% of the rows within 1e-5 relative +
    1e-5, the whole output within ``_flip_close``'s bound.  Rounding the
    product to bf16 before the add (the fault) put 0 of the 32 rows within it
    without ``row_scale``.  The rows that move are those of the bf16 test: an
    input code flipped by the compiled quantizer, whatever the residual's type."""
    rng = np.random.default_rng(2 if row_scale else 0)
    m, d, inter = 32, 512, 1024
    jgu, tgu = _weights(10, d, 2 * inter)
    jdn, tdn = _weights(11, inter, d)
    y = _bf16(rng.standard_normal((m, d)))
    resid = rng.standard_normal((m, d)).astype(np.float32)
    norm_w = _bf16(rng.uniform(0.7, 1.3, (d,)))
    rstd = np.asarray(j_rms_rstd(jnp.asarray(y)))
    kj, kt = dict(norm_w=jnp.asarray(norm_w), rstd=jnp.asarray(rstd)), dict(norm_w=_t(norm_w), rstd=_t(rstd))
    if row_scale:
        rs = rng.uniform(0.1, 1.0, (m,)).astype(np.float32)
        kj.update(row_scale=jnp.asarray(rs))
        kt.update(row_scale=_t(rs))
    want = np.asarray(j_fused_mlp(jnp.asarray(y), jnp.asarray(resid), jgu, jdn, abits=4, a_clip=A_CLIP, interpret=True,
                                  **kj))
    got = t_fused_mlp(_t(y), _t(resid), tgu, tdn, abits=4, a_clip=A_CLIP, **kt)
    assert want.dtype == np.float32 and got.dtype == torch.float32 and got.shape == (m, d)
    got = got.numpy()
    assert _rows_within_f32(got, want) >= 0.75, f"{_rows_within_f32(got, want):.2%} of rows within 1e-5"
    _flip_close(got, want, atol=1.0)


def test_fused_mlp_expert_chain_on_f32_accumulator_matches_pallas():
    """MoE's fused branch (``atom_tpu/serving/moe.py``): the experts' K10 calls
    chained on a float32 accumulator, ``acc = fused_mlp_packed(h, acc, gu_e,
    dn_e, row_scale=w_e)``, two experts, in both packages (the Pallas kernel in
    interpret mode).  Bounds as the single call's."""
    rng = np.random.default_rng(21)
    m, d, inter = 32, 512, 1024
    experts = [(_weights(30 + e, d, 2 * inter), _weights(40 + e, inter, d)) for e in range(2)]
    h = _bf16(rng.standard_normal((m, d)))
    w = rng.uniform(0.0, 1.0, (2, m)).astype(np.float32)
    x = _bf16(rng.standard_normal((m, d))).astype(np.float32)
    acc_j, acc_t = jnp.asarray(x), _t(x)
    for e, ((jgu, tgu), (jdn, tdn)) in enumerate(experts):
        acc_j = j_fused_mlp(jnp.asarray(h), acc_j, jgu, jdn, row_scale=jnp.asarray(w[e]), abits=4, a_clip=A_CLIP,
                            interpret=True)
        acc_t = t_fused_mlp(_t(h), acc_t, tgu, tdn, row_scale=_t(w[e]), abits=4, a_clip=A_CLIP)
    want = np.asarray(acc_j)
    assert want.dtype == np.float32 and acc_t.dtype == torch.float32
    got = acc_t.numpy()
    assert _rows_within_f32(got, want) >= 0.75, f"{_rows_within_f32(got, want):.2%} of rows within 1e-5"
    _flip_close(got, want, atol=1.0)


# ---------------------------------------------------------------------------
# the gates and the decode step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value,on", [("1", True), ("true", True), ("yes", True), ("0", False), ("", False),
                                      ("false", False), ("False", False), ("off", False), (None, False)])
def test_fused_flag_is_parsed(monkeypatch, value, on):
    """``ATOM_TPU_FUSED_MLP`` is parsed: ``0``, empty and ``false`` are off (the
    JAX package reads any set value, ``0`` included, as on);
    ``ATOM_TPU_NO_FUSED_MLP=1`` forces off."""
    monkeypatch.delenv("ATOM_TPU_NO_FUSED_MLP", raising=False)
    if value is None:
        monkeypatch.delenv("ATOM_TPU_FUSED_MLP", raising=False)
    else:
        monkeypatch.setenv("ATOM_TPU_FUSED_MLP", value)
    assert tm._fused_mlp_enabled() is on
    monkeypatch.setenv("ATOM_TPU_NO_FUSED_MLP", "1")
    assert tm._fused_mlp_enabled() is False
    monkeypatch.setenv("ATOM_TPU_NO_FUSED_MLP", "0")
    assert tm._fused_mlp_enabled() is on


GQA_KW = dict(vocab_size=199, hidden_size=512, intermediate_size=768, num_layers=2, num_heads=8, num_kv_heads=4,
              head_dim=128, max_position_embeddings=512)
J_GQA, T_GQA = ModelConfig(arch=Arch.LLAMA, **GQA_KW), TModelConfig(arch=TArch.LLAMA, **GQA_KW)


@pytest.fixture(scope="module")
def gqa_params():
    jparams = jm.init_serving_params(jax.random.PRNGKey(5), J_GQA, JSPEC)
    return jparams, serving_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _count_calls(monkeypatch, name):
    calls = []
    real = getattr(tm, name)

    def counted(*a, **k):
        calls.append(a[0].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(tm, name, counted)
    return calls


def test_fused_gates_follow_rows_geometry_and_flag(monkeypatch, gqa_params):
    """The K9/K10 branch is taken for at most 32 rows with the flag on, and
    left for 288 rows (a mixed step), for the flag at ``0`` and for a spec off
    the prologue's scheme.  On a geometry ``fused_mlp_supported`` refuses
    (intermediate 640 is no multiple of 256) the o_proj is fused and the MLP is
    not; both forms equal the unfused ``_post_attn`` bit for bit."""
    _, tparams = gqa_params
    lp = tparams.layers[0]  # hidden 512, intermediate 768: K9 and K10 both take it
    narrow = tm.init_serving_params(T_GQA.replace(intermediate_size=640, num_layers=1), TSPEC, seed=2, device="cpu").layers[0]
    rng = np.random.default_rng(1)
    monkeypatch.delenv("ATOM_TPU_NO_FUSED_MLP", raising=False)
    x = _t(_bf16(rng.standard_normal((32, 512))))
    attn = _t(_bf16(rng.standard_normal((32, 1024))))
    x288, attn288 = x.repeat(9, 1), attn.repeat(9, 1)

    monkeypatch.setenv("ATOM_TPU_FUSED_MLP", "1")
    assert tm._fused_oproj_ok((32, 512), lp, TSPEC) and not tm._fused_oproj_ok((288, 512), lp, TSPEC)
    assert not tm._fused_oproj_ok((32, 512), lp, TSPEC.replace(fused_serving=False))
    assert tm._fused_mlp_ok((32, 512), lp, TSPEC) and not tm._fused_mlp_ok((288, 512), lp, TSPEC)
    assert tm._fused_oproj_ok((32, 512), narrow, TSPEC) and not tm._fused_mlp_ok((32, 512), narrow, TSPEC)
    k9 = _count_calls(monkeypatch, "packed_w4_gemm_fused_in")
    k10 = _count_calls(monkeypatch, "fused_mlp_packed")
    both = tm._post_attn(x, attn, lp, TSPEC)
    assert k9 == [32] and k10 == [32]
    rows288 = tm._post_attn(x288, attn288, lp, TSPEC)  # a mixed step's row count stays unfused
    assert k9 == [32] and k10 == [32]
    oproj_only = tm._post_attn(x, attn, narrow, TSPEC)
    assert k9 == [32, 32] and k10 == [32]

    monkeypatch.setenv("ATOM_TPU_FUSED_MLP", "0")
    assert not tm._fused_oproj_ok((32, 512), lp, TSPEC) and not tm._fused_mlp_ok((32, 512), lp, TSPEC)
    assert torch.equal(_bits(both), _bits(tm._post_attn(x, attn, lp, TSPEC)))
    assert torch.equal(_bits(oproj_only), _bits(tm._post_attn(x, attn, narrow, TSPEC)))
    assert torch.equal(_bits(rows288), _bits(tm._post_attn(x288, attn288, lp, TSPEC)))
    assert torch.equal(_bits(rows288[:32]), _bits(both))  # rows are independent
    assert k9 == [32, 32] and k10 == [32]


def test_converted_params_carry_what_the_fused_path_reads(gqa_params):
    """``serving/convert.py`` needs nothing new for the fused branch: the
    pre-gathered norm weight ``ln_mlp_g`` arrives and equals ``ln_mlp`` gathered
    by ``mlp_reorder``, and ``wo`` / ``wgateup`` / ``wdown`` are the layouts K9
    and K10 take."""
    _, tparams = gqa_params
    for lp in tparams.layers:
        assert torch.equal(_bits(lp.ln_mlp_g), _bits(lp.ln_mlp[lp.mlp_reorder.long()]))
        for kw, k in ((lp.wo, 1024), (lp.wgateup, 512), (lp.wdown, 768)):
            assert kw.body_packed.shape[0] == (k - 128) // 2 and kw.scales.shape[0] == k // 128
            assert kw.keeper.shape[0] == 128 and kw.scales.dtype == torch.float32


def test_fused_decode_hidden_matches_jax(monkeypatch, gqa_params):
    """One decode step with ``ATOM_TPU_FUSED_MLP=1`` at the GQA geometry of
    ``tests/test_serving.py::test_fused_decode_hidden_matches_unfused`` (batch
    32, fresh state, every sequence at length 1) in both packages.

    Bound as that test bounds the JAX package's own two paths (structural:
    under 25% of elements moved by more than 0.05, max under 1.5): the jitted
    Pallas quantizers sit 1 ulp off the eager chain the port follows, and a
    flipped code moves its row through the dynamic act scales.  Within the
    port the flag changes nothing: fused and unfused hidden states are bitwise
    equal (K9 and K10 equal the unfused chains)."""
    jparams, tparams = gqa_params
    monkeypatch.delenv("ATOM_TPU_NO_FUSED_MLP", raising=False)
    monkeypatch.setenv("ATOM_TPU_FUSED_MLP", "1")
    b, n_pages, page = 32, 12, 128
    rng = np.random.Generator(np.random.PCG64(6))
    ids = rng.integers(1, J_GQA.vocab_size, b).astype(np.int32)
    table, lens = np.zeros((b, 2), np.int32), np.ones((b,), np.int32)

    jstate = jm.make_serving_state(J_GQA.num_layers, n_pages, b, J_GQA.num_kv_heads, page, J_GQA.head_dim)
    xj, _ = jm.decode_hidden(jparams, jstate, jnp.asarray(ids), jnp.asarray(table), jnp.asarray(lens), J_GQA, JSPEC)

    def port():
        state = tm.make_serving_state(T_GQA.num_layers, n_pages, b, T_GQA.num_kv_heads, page, T_GQA.head_dim, device="cpu")
        x, _ = tm.decode_hidden(tparams, state, _t(ids), _t(table), _t(lens), T_GQA, TSPEC)
        return x

    k9 = _count_calls(monkeypatch, "packed_w4_gemm_fused_in")
    xt = port()
    assert k9 == [32, 32]  # the fused o_proj ran in both layers
    diff = np.abs(xt.float().numpy() - np.asarray(xj, np.float32))
    assert np.mean(diff > 0.05) < 0.25, f"{np.mean(diff > 0.05):.2%} elements moved > 0.05"
    assert diff.max() < 1.5, f"max divergence {diff.max():.3f}"
    monkeypatch.setenv("ATOM_TPU_FUSED_MLP", "0")
    assert torch.equal(_bits(port()), _bits(xt)) and k9 == [32, 32]
