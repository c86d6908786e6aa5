"""The port's calibration (``calib/outlier.py``, ``calib/gptq.py``,
``calib/pipeline.py``) and accuracy model (``models/llama.py``) held against
the JAX package on shared numpy-seeded inputs and weights carried across by
``params_from_numpy``.

Tolerances, and why:
  * saliency statistics and Hessians within rtol 1e-6: float32 sums in
    another order (the model's saliency within 1e-5: layer 1's inputs carry
    layer 0's float order); the reorder indices equal where no two
    saliencies lie within 1e-6 relative (checked), and stable on exact ties;
  * the taps: float32 within 1e-5 of the largest entry, bf16 equal, each
    but for under 5% of the entries (an activation code flipped by an ulp
    upstream moves its row; bf16 matmuls round float32 sums of another order);
  * GPTQ in two layers.  Given JAX's own ``hinv`` (the block loop alone):
    every code equal, scales and values within rtol 2e-6 (XLA's CPU code
    contracts ``w - e d`` into a fused multiply-add, so the compensated
    weights sit a few ulps off).  On its own factorisation (PyTorch's
    Cholesky and solve, an ulp off XLA's): at most 0.1% of the codes differ
    and the scales stay within rtol 1e-5;
  * ``forward``: float32 within 1e-5 of the largest logit of
    ``llama.forward.__wrapped__``; bfloat16 against the JAX package's own
    op-by-op chain (``forward_collect_taps``' logits), because its jitted
    forward keeps bf16 intermediates in float32 (XLA's excess precision) and
    so is not that chain: argmax agreement >= 0.95 and mean |delta| under 1%
    of mean |logit| (a flipped activation code moves a row), and against the
    jitted forward the served-logits bounds (correlation > 0.97);
  * ``calibrate``: RTN bitwise on float32 weights; GPTQ against the JAX
    pipeline run op by op (its ``layer_fwd`` unjitted, for the reason
    above): layer 0, whose inputs are equal, at most 0.1% of the body codes
    and 2% of the keeper codes differ; GPTQ's error feedback turns the
    Hessian's deviation in later layers (1e-3 relative flips ~10% of codes)
    into more, so all layers together at most 15% of the body codes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atom_tpu.calib.pipeline as jpl
import atom_tpu.config as jconf
from atom_tpu.calib import gptq as jg
from atom_tpu.calib import outlier as jo
from atom_tpu.config import KeeperPrecision, QuantSpec, QuantType
from atom_tpu.models import llama as jl
from atom_tpu.models.configs import Arch, ModelConfig
from atom_tpu.ops import formats as jf
from atom_tpu.quant.core import quantize_keeper as j_quantize_keeper
from atom_tpu_torch import config as tconf
from atom_tpu_torch.calib import gptq as tg
from atom_tpu_torch.calib import outlier as to
from atom_tpu_torch.calib import pipeline as tpl
from atom_tpu_torch.models import llama as tl
from atom_tpu_torch.models.configs import Arch as TArch
from atom_tpu_torch.models.configs import ModelConfig as TModelConfig
from atom_tpu_torch.ops import formats as tf
from test_torch_serving import cap_torch_threads

cap_torch_threads()

_GEOM = dict(vocab_size=199, hidden_size=256, intermediate_size=384, num_layers=2, num_heads=2, num_kv_heads=2,
             head_dim=128, max_position_embeddings=512)
JCFG, TCFG = ModelConfig(arch=Arch.LLAMA, **_GEOM), TModelConfig(arch=TArch.LLAMA, **_GEOM)
WEIGHTS = ("wq", "wk", "wv", "wo", "wgate", "wup", "wdown")


def _t(a):
    return torch.from_numpy(np.array(a))


def _params(dtype):
    jp = jl.init_params(jax.random.PRNGKey(0), JCFG, dtype=dtype)
    return jp, tl.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _batches(n=2, t=64, seed=7):
    rng = np.random.Generator(np.random.PCG64(seed))
    return [rng.integers(1, JCFG.vocab_size, (1, t)).astype(np.int32) for _ in range(n)]


def _f32(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# Saliency and reorder indices
# ---------------------------------------------------------------------------


def test_saliency_updates_close():
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(2, 7, 96)).astype(np.float32) for _ in range(4)]
    for jfn, tfn in ((jo.hessian_diag_update, to.hessian_diag_update), (jo.abs_mean_update, to.abs_mean_update)):
        js = ts = None
        for x in xs:
            js, ts = jfn(js, jnp.asarray(x), 4), tfn(ts, _t(x), 4)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


@pytest.mark.parametrize("ties", (False, True))
def test_reorder_indices_equal(ties):
    rng = np.random.default_rng(1)
    sal = (rng.permutation(512) + 1 + 0.5 * rng.random(512)).astype(np.float32)
    if ties:  # exact ties: both sorts are stable
        sal = np.round(sal / 64).astype(np.float32)
    else:
        s = np.sort(sal)
        assert np.min(np.diff(s) / s[1:]) > 1e-6  # no two within 1e-6 relative
    np.testing.assert_array_equal(to.reorder_index_ascending(_t(sal)).numpy(),
                                  np.asarray(jo.reorder_index_ascending(jnp.asarray(sal))))
    np.testing.assert_array_equal(to.reorder_index_per_head(_t(sal), 128).numpy(),
                                  np.asarray(jo.reorder_index_per_head(jnp.asarray(sal), 128)))
    perm = to.reorder_index_ascending(_t(sal))
    np.testing.assert_array_equal(to.invert_permutation(perm).numpy(),
                                  np.asarray(jo.invert_permutation(jnp.asarray(perm.numpy()))))
    assert to.reorder_index_ascending(_t(sal)).dtype == torch.int32


def test_collect_saliency_and_indices_match_jax():
    jp, tp = _params(jnp.float32)
    batches = _batches()
    js = jpl.collect_saliency(jp, JCFG, [jnp.asarray(b) for b in batches])
    ts = tpl.collect_saliency(tp, TCFG, [_t(b) for b in batches])
    assert set(js) == set(ts)
    for k in js:  # layer 1's inputs carry layer 0's float order: a few ulps
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-5, err_msg=k)
    ji = jpl.compute_reorder_indices(js, JCFG.head_dim)
    ti = tpl.compute_reorder_indices(ts, TCFG.head_dim)
    for k in ji:
        np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]), err_msg=k)


# ---------------------------------------------------------------------------
# GPTQ
# ---------------------------------------------------------------------------


def test_hessian_accumulation_close():
    rng = np.random.default_rng(10)
    js, ts = jg.gptq_init(48), tg.gptq_init(48)
    for i in range(3):
        x = rng.normal(size=(1, 5 + i, 48)).astype(np.float32)
        js, ts = jg.gptq_add_batch(js, jnp.asarray(x)), tg.gptq_add_batch(ts, _t(x))
    np.testing.assert_allclose(ts.hessian.numpy(), np.asarray(js.hessian), rtol=1e-6, atol=1e-6)
    assert ts.nsamples == int(js.nsamples) == 3


def _problem(rows, cols, seed, dead=()):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(rows, cols)) * 0.02).astype(np.float32)
    x = rng.normal(size=(256, cols)).astype(np.float32)
    x[:, ::37] *= 6.0
    h = (2.0 * x.T @ x / 256).astype(np.float32)
    for c in dead:
        h[c, :] = h[:, c] = 0.0
    return w, h


# (rows, cols, bits, group_size, channel_group, keeper, keeper precision, quant type)
GPTQ_CASES = {
    "atom_w4": (64, 512, 4, 128, 2, 128, KeeperPrecision.INT8, QuantType.INT),
    "ungrouped": (32, 256, 4, 0, 1, 0, KeeperPrecision.FLOAT, QuantType.INT),
    "remainder_block": (32, 320, 4, 128, 2, 32, KeeperPrecision.INT8, QuantType.INT),
    "fp4": (32, 256, 4, 32, 1, 64, KeeperPrecision.FP8_E4M3, QuantType.FP),
    "w8_cg4": (32, 256, 8, 64, 4, 64, KeeperPrecision.INT8, QuantType.INT),
}


def _jax_hinv(h, percdamp):
    """``hinv`` as ``atom_tpu/calib/gptq.py`` computes it, and the dead-column mask."""
    h = jnp.asarray(h)
    dead = jnp.diag(h) == 0
    h = h + jnp.diag(jnp.where(dead, 1.0, 0.0))
    h = h + percdamp * jnp.mean(jnp.diag(h)) * jnp.eye(h.shape[0], dtype=h.dtype)
    chol = jnp.linalg.cholesky(h)
    full = jax.scipy.linalg.cho_solve((chol, True), jnp.eye(h.shape[0], dtype=h.dtype))
    return jnp.linalg.cholesky((full + full.T) / 2).T, dead


def _jax_blocks(w32, hinv, bits, group, cg, keeper, kp, qt):
    """The JAX package's block loop (``_process_block`` per block, then the keeper)."""
    n_nonout = w32.shape[1] - keeper
    grouped = group > 0
    block = min(group if grouped else 128, n_nonout)
    kw = dict(bits=bits, sym=True, channel_group=cg, clip_ratio=0.85, quant_type=qt)
    s0 = z0 = None
    if not grouped:
        s0, z0 = jg._find_params(w32[:, :n_nonout], bits, True, cg, 0.85, qt)
    scales = []
    for i1 in range(0, n_nonout, block):
        w32, s = jg._process_block(w32, hinv, jnp.asarray(i1, jnp.int32), min(block, n_nonout - i1), grouped, s0, z0,
                                   **kw)
        scales.append(np.asarray(s[:, 0]))
    if keeper:
        w32 = w32.at[:, n_nonout:].set(j_quantize_keeper(w32[:, n_nonout:], kp))
    return np.asarray(w32), np.stack(scales)


def _codes(wq, scales, group, cg, keeper, fp=False):
    """Codes of a symmetric GPTQ output on its block scales: integers, or
    for FP4 the codebook values x 16 (integers too)."""
    n = wq.shape[1] - keeper
    blk = min(group if group else 128, n)
    s_cols = np.repeat(np.repeat(scales, cg, axis=1).T, blk, axis=1)[:, :n]  # [rows, n]
    r = wq[:, :n] / s_cols
    return np.round(r * 16) if fp else np.round(r)


@pytest.mark.parametrize("case", sorted(GPTQ_CASES))
def test_gptq_block_loop_on_jax_hinv(case):
    rows, cols, bits, group, cg, keeper, kp, qt = GPTQ_CASES[case]
    w, h = _problem(rows, cols, seed=len(case), dead=(5,))
    hinv, dead = _jax_hinv(h, 0.01)
    w32 = np.where(np.asarray(dead)[None, :], 0.0, w).astype(np.float32)
    jw, js = _jax_blocks(jnp.asarray(w32), hinv, bits, group, cg, keeper, kp, qt)
    tw, ts = tg.gptq_blocks(_t(w32), _t(hinv), bits=bits, group_size=group, channel_group=cg, keeper=keeper,
                            keeper_precision=tconf.KeeperPrecision(int(kp)), quant_type=tconf.QuantType(qt.value),
                            clip_ratio=0.85)
    tw, ts = tw.numpy(), ts.numpy()
    np.testing.assert_allclose(ts, js, rtol=2e-6)
    np.testing.assert_allclose(tw, jw, rtol=2e-6, atol=2e-6 * np.abs(jw).max())
    fp = qt == QuantType.FP
    np.testing.assert_array_equal(_codes(tw, ts, group, cg, keeper, fp), _codes(jw, js, group, cg, keeper, fp))
    assert np.all(tw[:, 5] == 0.0)  # the dead column


@pytest.mark.parametrize("case", ("atom_w4", "remainder_block", "w8_cg4"))
def test_gptq_own_factorisation_close(case):
    rows, cols, bits, group, cg, keeper, kp, _ = GPTQ_CASES[case]
    w, h = _problem(rows, cols, seed=100 + len(case))
    kw = dict(bits=bits, group_size=group, channel_group=cg, keeper=keeper, clip_ratio=0.85, return_scales=True)
    jw, js = jg.gptq_quantize_weight(jnp.asarray(w), jnp.asarray(h), keeper_precision=kp, **kw)
    tw, ts = tg.gptq_quantize_weight(_t(w), _t(h), keeper_precision=tconf.KeeperPrecision(int(kp)), **kw)
    jw, js, tw, ts = np.asarray(jw), np.asarray(js), tw.numpy(), ts.numpy()
    differ = np.mean(_codes(tw, ts, group, cg, keeper) != _codes(jw, js, group, cg, keeper))
    assert differ <= 1e-3, differ
    np.testing.assert_allclose(ts, js, rtol=1e-5)


def _tq(w, h, **kw):
    return tg.gptq_quantize_weight(_t(w), _t(h), **kw).numpy()


def test_gptq_identity_hessian_is_rtn():
    w = np.random.default_rng(1).normal(size=(8, 64)).astype(np.float32)
    q = _tq(w, np.eye(64, dtype=np.float32), bits=4, group_size=0, channel_group=1, keeper=0, percdamp=0.0)
    scale, zero = tg._find_params(_t(w), 4, True, 1, 1.0, tconf.QuantType.INT)
    codes = torch.clamp(torch.round(_t(w) / scale) + zero, 0, 15)
    np.testing.assert_array_equal(q, (scale * (codes - zero)).numpy())


def test_gptq_keeper_int8_compensated():
    rng = np.random.default_rng(3)
    x, w = rng.normal(size=(256, 128)).astype(np.float32), rng.normal(size=(16, 128)).astype(np.float32)
    q = _tq(w, 2.0 * x.T @ x, bits=4, group_size=32, channel_group=1, keeper=32,
            keeper_precision=tconf.KeeperPrecision.INT8)
    keep = q[:, -32:]
    codes = keep / (np.abs(keep).max(1, keepdims=True) / 127.0)
    np.testing.assert_allclose(codes, np.round(codes), atol=1e-2)
    assert not np.allclose(keep, w[:, -32:], atol=1e-3)


def test_gptq_channel_group_shares_grid():
    rng = np.random.default_rng(4)
    w = np.zeros((4, 64), np.float32)
    w[0], w[1], w[2:] = rng.normal(size=64) * 10, rng.normal(size=64) * 0.01, rng.normal(size=(2, 64))
    q = _tq(w, np.eye(64, dtype=np.float32), bits=4, group_size=0, channel_group=2, keeper=0, percdamp=0.0)
    np.testing.assert_allclose(q[1], 0.0, atol=1e-6)


def test_gptq_fp4_on_codebook():
    w = np.random.default_rng(5).normal(size=(8, 64)).astype(np.float32)
    q, s = tg.gptq_quantize_weight(_t(w), torch.eye(64), bits=4, group_size=32, channel_group=1, keeper=0,
                                   quant_type=tconf.QuantType.FP, percdamp=0.0, return_scales=True)
    grid = q.numpy().reshape(8, 2, 32) / s.numpy().T[:, :, None] / 12.0  # code values in [-1, 1]
    mags = np.array([0.0, 0.0625, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0], np.float32) / 12.0
    assert np.all(np.min(np.abs(np.abs(grid)[..., None] - mags), axis=-1) < 1e-5)


def test_gptq_dead_columns_zeroed():
    w = np.random.default_rng(6).normal(size=(4, 32)).astype(np.float32)
    h = np.eye(32, dtype=np.float32)
    h[5, 5] = 0.0
    np.testing.assert_array_equal(_tq(w, h, bits=4, group_size=0, channel_group=1, keeper=0)[:, 5], 0.0)


# ---------------------------------------------------------------------------
# The accuracy model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ("FP16_BASELINE", "ATOM_W4A4"))
def test_forward_float32_close(spec):
    jp, tp = _params(jnp.float32)
    ids = _batches(1, 64, seed=3)[0]
    want = np.asarray(jl.forward.__wrapped__(jp, jnp.asarray(ids), JCFG, getattr(jconf, spec)))
    got = tl.forward(tp, _t(ids), TCFG, getattr(tconf, spec)).numpy()
    assert got.shape == want.shape == (1, 64, JCFG.vocab_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("seed", (3, 8))
def test_forward_bfloat16_against_the_op_by_op_chain(seed):
    jp, tp = _params(jnp.bfloat16)
    ids = _batches(1, 64, seed=seed)[0]
    chain, _ = jl.forward_collect_taps(jp, jnp.asarray(ids), JCFG, QuantSpec())
    chain = np.asarray(chain)
    got = tl.forward(tp, _t(ids), TCFG, tconf.ATOM_W4A4).numpy()
    assert np.mean(got.argmax(-1) == chain.argmax(-1)) >= 0.95
    assert np.abs(got - chain).mean() < 0.01 * np.abs(chain).mean()
    jitted = np.asarray(jl.forward(jp, jnp.asarray(ids), JCFG, QuantSpec()))
    assert np.corrcoef(got.ravel(), jitted.ravel())[0, 1] > 0.97


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_forward_collect_taps_close(dtype):
    jp, tp = _params(jnp.dtype(dtype))
    ids = _batches(1, 64, seed=4)[0]
    jlog, jt = jl.forward_collect_taps(jp, jnp.asarray(ids), JCFG, QuantSpec())
    tlog, tt = tl.forward_collect_taps(tp, _t(ids), TCFG, tconf.ATOM_W4A4)
    assert set(jt) == set(tt) and len(tt) == 14 * JCFG.num_layers
    for k in jt:
        a, b = _f32(jt[k]), _f32(tt[k])
        assert a.shape == b.shape and str(np.asarray(jt[k]).dtype) == str(tt[k].dtype).split(".")[-1], k
        if dtype == "float32":  # ulps, and now and then a flipped activation code, which moves its row
            assert np.mean(np.abs(b - a) > 1e-5 * np.abs(a).max()) < 0.05, k
        else:  # bf16 matmuls round f32 sums of another order: a few entries one bf16 ulp (or a flipped code) apart
            assert np.mean(a != b) < 0.05, (k, np.mean(a != b))


def test_reorder_and_rtn_helpers_match_jax():
    jp, tp = _params(jnp.bfloat16)
    rng = np.random.default_rng(5)
    idx = {}
    for i in range(JCFG.num_layers):
        for mod, n in (("self_attn.q_proj", 256), ("self_attn.k_proj", 256), ("self_attn.v_proj", 256),
                       ("self_attn.o_proj", 256), ("mlp.gate_proj", 256), ("mlp.up_proj", 256),
                       ("mlp.down_proj", 384)):
            idx[f"layers.{i}.{mod}.input"] = rng.permutation(n).astype(np.int32)
    jr = jl.quantize_weights_rtn(jl.apply_reorder(jp, JCFG, {k: jnp.asarray(v) for k, v in idx.items()}), JCFG,
                                 QuantSpec())
    tr = tl.quantize_weights_rtn(tl.apply_reorder(tp, TCFG, {k: _t(v) for k, v in idx.items()}), TCFG,
                                 tconf.ATOM_W4A4)
    for k, v in jr["layers"].items():
        a = np.asarray(v)
        b = tr["layers"][k]
        np.testing.assert_array_equal(b.view(torch.int16).numpy() if b.dtype == torch.bfloat16 else b.numpy(),
                                      a.view(np.int16) if a.dtype.name == "bfloat16" else a, err_msg=k)
    assert tl.hessian_tap_specs(TCFG) == jl.hessian_tap_specs(JCFG)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


def test_calibrate_rtn_bitwise():
    jp, tp = _params(jnp.float32)
    batches = _batches()
    spec_j, spec_t = QuantSpec(use_gptq=False), tconf.QuantSpec(use_gptq=False)
    jc, ji = jpl.calibrate(jp, JCFG, spec_j, [jnp.asarray(b) for b in batches])
    tc, ti = tpl.calibrate(tp, TCFG, spec_t, [_t(b) for b in batches])
    for k in ji:
        np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]), err_msg=k)
    for k, v in jc["layers"].items():
        np.testing.assert_array_equal(tc["layers"][k].numpy(), np.asarray(v), err_msg=k)
    assert all(torch.equal(tp["layers"][k], tl.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")["layers"][k])
               for k in tp["layers"])  # the input params untouched


def test_calibrate_gptq_codes_close(monkeypatch):
    jp, tp = _params(jnp.float32)
    batches = _batches()
    monkeypatch.setattr(jpl.jax, "jit", lambda f, **kw: f)  # the JAX pipeline's layer_fwd op by op
    jsc, tsc = {}, {}
    jc, _ = jpl.calibrate(jp, JCFG, QuantSpec(), [jnp.asarray(b) for b in batches], scales_out=jsc)
    monkeypatch.undo()
    tc, _ = tpl.calibrate(tp, TCFG, tconf.ATOM_W4A4, [_t(b) for b in batches], scales_out=tsc)
    assert set(jsc) == set(tsc) == {f"{i}.{w}" for i in range(JCFG.num_layers) for w in WEIGHTS}
    body = {0: [], 1: []}
    keeper = {0: [], 1: []}
    for i in range(JCFG.num_layers):
        for w in WEIGHTS:
            a = jf.pack_gptq_output(jc["layers"][w][i], jsc[f"{i}.{w}"], QuantSpec())
            b = tf.pack_gptq_output(tc["layers"][w][i], tsc[f"{i}.{w}"], tconf.ATOM_W4A4)
            body[i].append(np.asarray(a.body) != b.body.numpy())
            keeper[i].append(np.asarray(a.keeper) != b.keeper.numpy())
            if i == 0:
                np.testing.assert_allclose(tsc[f"{i}.{w}"].numpy(), np.asarray(jsc[f"{i}.{w}"]), rtol=1e-5)
    share = {i: np.mean(np.concatenate([d.ravel() for d in body[i]])) for i in body}
    k_share0 = np.mean(np.concatenate([d.ravel() for d in keeper[0]]))
    assert share[0] <= 1e-3 and k_share0 <= 0.02, (share, k_share0)
    assert (share[0] + share[1]) / 2 <= 0.15, share
