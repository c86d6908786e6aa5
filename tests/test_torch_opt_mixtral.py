"""The port's OPT and Mixtral accuracy models (``models/opt.py``,
``models/mixtral.py``, the OPT and Mixtral halves of ``models/hf_loader.py``
and ``calib/pipeline.py``) held against the JAX package on ``TINY_OPT`` and
``TINY_MIXTRAL`` (GPTQ on OPT at a width with INT4 body groups: ``TINY_OPT``'s
128 channels are all keeper), weights carried across by ``params_from_numpy``
and inputs from numpy seeds.

Tolerances, and why:
  * ``forward`` in float32 against the JAX module's unjitted forward: within
    1e-5 of the largest logit, argmax equal; under W4A4 a flipped activation
    code (an ulp upstream puts a value on the other side of a rounding edge)
    moves its token's row, and in Mixtral may route it to another expert, so
    there all but at most 2 of 64 rows;
  * bfloat16 against the JAX package's op-by-op chain (``forward_collect_taps``'
    logits; its jitted forward keeps bf16 intermediates in float32): argmax
    agreement >= 0.95 and mean |delta| under 1% of mean |logit|;
  * the taps: the same keys and dtypes, each tap's entries equal (float32:
    within 1e-5 of its largest) but for under 5% of them;
  * routing within 4 float32 ulp (XLA's and PyTorch's ``exp`` differ in the
    last bits) with the same experts chosen, ties to the lower expert;
  * ``moe_block`` against an explicit loop over each token's routed experts:
    within 1e-6 of the largest output (other summation orders);
  * the reorder helpers and RTN calibration bitwise; the reordered model's
    float32 logits within 1e-5 of the unreordered's;
  * GPTQ calibration against the JAX pipeline run op by op: layer 0 at most
    0.1% of the body codes differ, both layers together at most 15%
    (GPTQ's error feedback, ``tests/test_torch_calib.py``);
  * the HF loaders bitwise with the JAX package's, and the float32 forward
    within 2e-2 of the ``transformers`` model's logits (``tests/test_hf_loader.py``'s
    bound).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atom_tpu.calib.pipeline as jpl
import atom_tpu.config as jconf
from atom_tpu.config import QuantSpec
from atom_tpu.models import hf_loader as jhf
from atom_tpu.models import mixtral as jmx
from atom_tpu.models import opt as jopt
from atom_tpu.models.configs import TINY_MIXTRAL, TINY_OPT, Arch, ModelConfig
from atom_tpu.ops import formats as jf
from atom_tpu_torch import config as tconf
from atom_tpu_torch.calib import pipeline as tpl
from atom_tpu_torch.models import configs as tcfgs
from atom_tpu_torch.models import hf_loader as thf
from atom_tpu_torch.models import mixtral as tmx
from atom_tpu_torch.models import opt as topt
from atom_tpu_torch.ops import formats as tf
from test_torch_serving import cap_torch_threads

cap_torch_threads()

_OPT_WIDE = dict(vocab_size=199, hidden_size=256, intermediate_size=384, num_layers=2, num_heads=2, num_kv_heads=2,
                 head_dim=128, max_position_embeddings=512, tie_word_embeddings=True)
MODELS = {
    "mixtral": (jmx, tmx, TINY_MIXTRAL, tcfgs.TINY_MIXTRAL),
    "opt": (jopt, topt, TINY_OPT, tcfgs.TINY_OPT),
    "opt_wide": (jopt, topt, ModelConfig(arch=Arch.OPT, **_OPT_WIDE),
                 tcfgs.ModelConfig(arch=tcfgs.Arch.OPT, **_OPT_WIDE)),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


@functools.lru_cache(maxsize=None)
def _params(model, dtype):
    jm, tm, jc, _ = MODELS[model]
    jp = jm.init_params(jax.random.PRNGKey(0), jc, dtype=jnp.dtype(dtype))
    return jp, tm.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _ids(model, seed=3, n=1, t=64):
    rng = np.random.Generator(np.random.PCG64(seed))
    return [rng.integers(1, MODELS[model][2].vocab_size, (1, t)).astype(np.int32) for _ in range(n)]


@functools.lru_cache(maxsize=None)
def _jax_chain(model, dtype, spec):
    """The JAX package's op-by-op chain: (logits, taps) as numpy."""
    jm, _, jc, _ = MODELS[model]
    logits, taps = jm.forward_collect_taps(_params(model, dtype)[0], jnp.asarray(_ids(model)[0]), jc,
                                           getattr(jconf, spec))
    return np.asarray(logits), {k: np.asarray(v) for k, v in taps.items()}


# ---------------------------------------------------------------------------
# Forward and taps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ("mixtral", "opt"))
@pytest.mark.parametrize("spec", ("FP16_BASELINE", "ATOM_W4A4"))
def test_forward_float32_close(model, spec):
    jm, tm, jc, tc = MODELS[model]
    jp, tp = _params(model, "float32")
    ids = _ids(model)[0]
    want = np.asarray(jm.forward.__wrapped__(jp, jnp.asarray(ids), jc, getattr(jconf, spec)))
    got = tm.forward(tp, _t(ids), tc, getattr(tconf, spec)).numpy()
    assert got.shape == want.shape == (1, 64, jc.vocab_size) and got.dtype == np.float32
    close = np.all(np.abs(got - want) <= 1e-5 * np.abs(want).max(), axis=-1)[0]
    if (model, spec) == ("mixtral", "ATOM_W4A4"):
        assert np.mean(close) >= 0.9, np.flatnonzero(~close)
        assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.95
        assert np.abs(got - want).mean() < 0.01 * np.abs(want).mean()
    else:
        assert close.all(), np.flatnonzero(~close)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("model", ("mixtral", "opt"))
def test_forward_bfloat16_against_the_op_by_op_chain(model):
    _, tm, _, tc = MODELS[model]
    chain, _ = _jax_chain(model, "bfloat16", "ATOM_W4A4")
    got = tm.forward(_params(model, "bfloat16")[1], _t(_ids(model)[0]), tc, tconf.ATOM_W4A4).numpy()
    assert np.mean(got.argmax(-1) == chain.argmax(-1)) >= 0.95
    assert np.abs(got - chain).mean() < 0.01 * np.abs(chain).mean()


@pytest.mark.parametrize("model", ("mixtral", "opt"))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_forward_collect_taps_close(model, dtype):
    _, tm, jc, tc = MODELS[model]
    jlog, jt = _jax_chain(model, dtype, "ATOM_W4A4")
    tlog, tt = tm.forward_collect_taps(_params(model, dtype)[1], _t(_ids(model)[0]), tc, tconf.ATOM_W4A4)
    per_layer = 10 + 6 * jc.num_experts if model == "mixtral" else 12
    assert set(jt) == set(tt) and len(tt) == per_layer * jc.num_layers
    for k in jt:
        a, b = _f32(jt[k]), _f32(tt[k])
        assert a.shape == b.shape and str(jt[k].dtype) == str(tt[k].dtype).split(".")[-1], k
        tol = 1e-5 * np.abs(a).max() if dtype == "float32" else 0.0
        assert np.mean(np.abs(b - a) > tol) < 0.05, (k, np.mean(np.abs(b - a) > tol))


# ---------------------------------------------------------------------------
# The MoE block
# ---------------------------------------------------------------------------


def test_route_top_k_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(96, 8)).astype(np.float32)
    logits[:8, 2] = logits[:8, 5] = logits[:8].max(-1) + 1  # exact ties between two experts
    logits[8:12] = 0.25  # all eight tied
    cfg_j, cfg_t = TINY_MIXTRAL.replace(num_experts=8), tcfgs.TINY_MIXTRAL.replace(num_experts=8)
    want = np.asarray(jmx.route_top_k(jnp.asarray(logits), cfg_j))
    got = tmx.route_top_k(_t(logits), cfg_t).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    assert np.all((got > 0).sum(-1) == 2)
    np.testing.assert_array_equal(np.flatnonzero(got[8] > 0), [0, 1])
    np.testing.assert_array_equal(np.flatnonzero(got[0] > 0), [2, 5])
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= 4 * ulp)
    # the router product in the model's dtype, as XLA's bf16 dot rounds it
    h = rng.normal(size=(64, 256)).astype(np.float32)
    r = (rng.normal(size=(256, 4)) * 0.02).astype(np.float32)
    jl = np.asarray((jnp.asarray(h, jnp.bfloat16) @ jnp.asarray(r, jnp.bfloat16)).astype(jnp.float32))
    tl = tmx.router_logits(_t(h).bfloat16(), _t(r).bfloat16())
    assert tl.dtype == torch.bfloat16
    np.testing.assert_array_equal(tl.float().numpy(), jl)


@pytest.mark.parametrize("spec", ("FP16_BASELINE", "ATOM_W4A4"))
def test_moe_block_matches_per_expert_loop(spec):
    """Dense dispatch (every expert over every token, unrouted pairs weighted
    0) against the routed form: each token through its top-k experts only."""
    cfg, qspec = tcfgs.TINY_MIXTRAL, getattr(tconf, spec)
    lp = {k: v[0] for k, v in _params("mixtral", "float32")[1]["layers"].items()}
    hid = torch.from_numpy(np.random.default_rng(4).normal(size=(48, cfg.hidden_size)).astype(np.float32))

    def tap(name, val):
        pass

    tap.collecting = False
    got = tmx.moe_block(lp, hid, cfg, qspec, tap)
    weights = tmx.route_top_k(tmx.router_logits(hid, lp["router"]), cfg)
    hq = tmx.quantize_activation(hid, qspec)
    want = torch.zeros_like(hid)
    for t in range(hid.shape[0]):
        for e in torch.nonzero(weights[t] > 0).flatten().tolist():
            act = tmx.quantize_activation((torch.nn.functional.silu(hq[t : t + 1] @ lp["w1"][e])
                                           * (hq[t : t + 1] @ lp["w3"][e])), qspec)
            want[t] += weights[t, e] * (act @ lp["w2"][e])[0]
    assert got.shape == want.shape and got.dtype == torch.float32
    err = (got - want).abs().amax(-1) / want.abs().max()
    # a row's activation codes may flip where the per-token product rounds differently (one code step)
    assert (err > 1e-6).sum() <= (2 if spec == "ATOM_W4A4" else 0) and err.max() < 1e-2, err


# ---------------------------------------------------------------------------
# Calibration wiring
# ---------------------------------------------------------------------------


def _random_indices(model, seed=5):
    """Random reorder indices of the shape calibration gives: q/k/v share
    one input order (one saliency), as do the experts (expert 0's)."""
    jm, _, jc, _ = MODELS[model]
    rng = np.random.default_rng(seed)
    h, inter, qh = jc.hidden_size, jc.intermediate_size, jc.num_heads * jc.head_dim
    if model == "mixtral":
        mods = {"self_attn.o_proj": qh, "block_sparse_moe.experts.0.w1": h, "block_sparse_moe.experts.0.w2": inter}
    else:
        mods = {"self_attn.out_proj": h, "fc1": h, "fc2": inter}
    idx = {}
    for i in range(jc.num_layers):
        qkv = rng.permutation(h).astype(np.int32)
        idx.update({f"layers.{i}.self_attn.{p}.input": qkv for p in ("q_proj", "k_proj", "v_proj")})
        idx.update({f"layers.{i}.{m}.input": rng.permutation(n).astype(np.int32) for m, n in mods.items()})
    return idx


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) and a.dtype != torch.bfloat16 else a
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("model", ("mixtral", "opt"))
def test_reorder_rtn_helpers_and_tap_specs_match_jax(model):
    jm, tm, jc, tc = MODELS[model]
    jp, tp = _params(model, "bfloat16")
    idx = _random_indices(model)
    jr = jm.quantize_weights_rtn(jm.apply_reorder(jp, jc, {k: jnp.asarray(v) for k, v in idx.items()}), jc,
                                 QuantSpec())
    tr = tm.quantize_weights_rtn(tm.apply_reorder(tp, tc, {k: _t(v) for k, v in idx.items()}), tc, tconf.ATOM_W4A4)
    assert set(jr["layers"]) == set(tr["layers"])
    for k, v in jr["layers"].items():
        np.testing.assert_array_equal(_bits(tr["layers"][k]), _bits(v), err_msg=k)
    assert tm.hessian_tap_specs(tc) == jm.hessian_tap_specs(jc)


@pytest.mark.parametrize("model", ("mixtral", "opt"))
def test_reorder_leaves_the_float_model_alone(model):
    _, tm, _, tc = MODELS[model]
    tp = _params(model, "float32")[1]
    ids = _t(_ids(model)[0])
    want = tm.forward(tp, ids, tc, tconf.FP16_BASELINE).numpy()
    reordered = tm.apply_reorder(tp, tc, {k: _t(v) for k, v in _random_indices(model, seed=6).items()})
    got = tm.forward(reordered, ids, tc, tconf.FP16_BASELINE).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("model", ("mixtral", "opt"))
def test_calibrate_rtn_bitwise(model):
    jm, tm, jc, tc = MODELS[model]
    jp, tp = _params(model, "float32")
    batches = _ids(model, seed=7, n=2)
    jcal, ji = jpl.calibrate(jp, jc, QuantSpec(use_gptq=False), [jnp.asarray(b) for b in batches])
    tcal, ti = tpl.calibrate(tp, tc, tconf.QuantSpec(use_gptq=False), [_t(b) for b in batches])
    assert set(ji) == set(ti)
    for k in ji:
        np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]), err_msg=k)
    for k, v in jcal["layers"].items():
        np.testing.assert_array_equal(tcal["layers"][k].numpy(), np.asarray(v), err_msg=k)


def _weight_of(params, key):
    """A GPTQ scale key ("{layer}.{w}" or "{layer}.{w}.{e}") -> its weight [in, out]."""
    layer, name, *expert = key.split(".")
    w = params["layers"][name][int(layer)]
    return w[int(expert[0])] if expert else w


@pytest.mark.parametrize("model", ("mixtral", "opt_wide"))
def test_calibrate_gptq_codes_close(model, monkeypatch):
    jm, tm, jc, tc = MODELS[model]
    jp, tp = _params(model, "float32")
    batches = _ids(model, seed=7, n=2)
    monkeypatch.setattr(jpl.jax, "jit", lambda f, **kw: f)  # the JAX pipeline's layer_fwd op by op
    jsc, tsc = {}, {}
    jcal, _ = jpl.calibrate(jp, jc, QuantSpec(), [jnp.asarray(b) for b in batches], scales_out=jsc)
    monkeypatch.undo()
    tcal, _ = tpl.calibrate(tp, tc, tconf.ATOM_W4A4, [_t(b) for b in batches], scales_out=tsc)
    assert set(jsc) == set(tsc)
    if model == "mixtral":
        assert {k for k in tsc if k.startswith("0.")} == (
            {f"0.{w}" for w in ("wq", "wk", "wv", "wo")}
            | {f"0.{w}.{e}" for w in ("w1", "w3", "w2") for e in range(jc.num_experts)})
    body = {i: [] for i in range(jc.num_layers)}
    for key in jsc:
        a = jf.pack_gptq_output(_weight_of(jcal, key), jsc[key], QuantSpec())
        b = tf.pack_gptq_output(_weight_of(tcal, key), tsc[key], tconf.ATOM_W4A4)
        body[int(key.split(".")[0])].append((np.asarray(a.body) != b.body.numpy()).ravel())
    share = {i: float(np.mean(np.concatenate(d))) for i, d in body.items()}
    assert share[0] <= 1e-3 and sum(share.values()) / len(share) <= 0.15, share


# ---------------------------------------------------------------------------
# HF checkpoints
# ---------------------------------------------------------------------------


def _hf_model(model, tmp_path):
    if model == "opt":
        from transformers import OPTConfig, OPTForCausalLM

        hf_cfg = OPTConfig(vocab_size=128, hidden_size=64, ffn_dim=112, num_hidden_layers=2, num_attention_heads=2,
                           max_position_embeddings=64, do_layer_norm_before=True, word_embed_proj_dim=64)
        torch.manual_seed(1)
        hf = OPTForCausalLM(hf_cfg).eval()
    else:
        from transformers import MixtralConfig, MixtralForCausalLM

        hf_cfg = MixtralConfig(vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=2,
                               num_attention_heads=2, num_key_value_heads=1, num_local_experts=4,
                               num_experts_per_tok=2, max_position_embeddings=64, rms_norm_eps=1e-5)
        torch.manual_seed(2)
        hf = MixtralForCausalLM(hf_cfg).eval()
    path = str(tmp_path / model)
    hf.save_pretrained(path)
    return hf, path


@pytest.mark.parametrize("model", ("mixtral", "opt"))
def test_hf_parity(model, tmp_path):
    hf, path = _hf_model(model, tmp_path)
    cfg = thf.config_from_hf(path)
    jcfg = jhf.config_from_hf(path)
    assert {k: (v.value if hasattr(v, "value") else v) for k, v in vars(cfg).items()} == {
        k: (v.value if hasattr(v, "value") else v) for k, v in vars(jcfg).items()}
    _, tm = MODELS[model][:2]
    jload = jhf.load_mixtral_params if model == "mixtral" else jhf.load_opt_params
    want = tm.params_from_numpy(jax.tree.map(np.asarray, jload(path, jcfg, dtype=jnp.bfloat16)), "cpu")
    got = tm.load_hf_params(path, cfg, device="cpu")
    assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
    for k in want:
        for a, b in ((got[k], want[k]),) if k != "layers" else ((got[k][n], want[k][n]) for n in want[k]):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(_bits(a), _bits(b)), k
    ids = np.array([[1, 5, 9, 2, 77, 3]], np.int32)
    with torch.no_grad():
        ref = hf(torch.tensor(ids, dtype=torch.long)).logits.numpy()
    out = tm.forward(tm.load_hf_params(path, cfg, dtype=torch.float32, device="cpu"), _t(ids), cfg,
                     tconf.FP16_BASELINE).numpy()
    np.testing.assert_allclose(out, ref, rtol=2e-2, atol=2e-2)
