"""The port's Mixtral export (``models/hf_loader.py::pack_calibrated_params_moe``,
the MoE branch of ``utils/checkpoint.py``'s ``save_serving`` / ``load_serving``,
``main.py --export_serving``) and the accuracy CLI on ``tiny-opt`` and
``tiny-mixtral``, held against the JAX package.

Tolerances, and why:
  * ``pack_calibrated_params_moe`` on JAX-calibrated params (GPTQ with its
    scales; RTN from the reordered originals and from the fake values) and
    both packages' export directories: bitwise (integer codes, scales, bf16
    bits);
  * the served logits (the MoE serving model's prefill, its kernels' plain
    versions on the CPU) against the port's accuracy forward on the same
    calibrated params: ``tests/test_calibrated_serving.py``'s structural
    bounds (correlation > 0.97, mean |delta| < 0.25 x mean |logit|, argmax
    agreement >= 0.6);
  * the CLI's ``targetResult`` within rtol 5e-3 of the JAX CLI's on one bf16
    checkpoint (``tests/test_torch_accuracy_cli.py``'s bound: in bf16 the two
    packages' matmuls round float32 sums in another order, which moves
    near-tied saliencies and GPTQ's Hessians, and the JAX pipeline runs its
    layers and its evaluation jitted).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atom_tpu.calib.pipeline as jpl
from atom_tpu.config import QuantSpec
from atom_tpu.models import hf_loader as jhf
from atom_tpu.models import mixtral as jmx
from atom_tpu.models import opt as jopt
from atom_tpu.models.configs import TINY_MIXTRAL, TINY_OPT
from atom_tpu.utils import checkpoint as jck
from atom_tpu_torch import config as tconf
from atom_tpu_torch.calib import pipeline as tpl
from atom_tpu_torch.models import configs as tcfgs
from atom_tpu_torch.models import hf_loader as thf
from atom_tpu_torch.models import mixtral as tmx
from atom_tpu_torch.serving.convert import moe_serving_params_from_numpy, tensor_from_numpy
from atom_tpu_torch.serving.moe import MoEServingParams
from atom_tpu_torch.utils import checkpoint as tck
from test_torch_serving import cap_torch_threads

cap_torch_threads()

JCFG, TCFG = TINY_MIXTRAL, tcfgs.TINY_MIXTRAL


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(n=2, seed=11):
    rng = np.random.Generator(np.random.PCG64(seed))
    return [rng.integers(1, JCFG.vocab_size, (1, 64)).astype(np.int32) for _ in range(n)]


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            yield from _leaves(item)


def _same(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                           y.view(torch.int16) if y.dtype == torch.bfloat16 else y)


@pytest.fixture(scope="module")
def jax_gptq():
    """JAX's GPTQ calibration of the float32 TINY_MIXTRAL and its exported scales."""
    params = jmx.init_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    scales = {}
    calib, _ = jpl.calibrate(params, JCFG, QuantSpec(), [jnp.asarray(b) for b in _batches()], scales_out=scales)
    return calib, scales


def test_pack_calibrated_params_moe_gptq_bitwise(jax_gptq):
    calib, scales = jax_gptq
    assert {f"1.w2.{e}" for e in range(JCFG.num_experts)} <= set(scales)
    want = moe_serving_params_from_numpy(
        _np_tree(jhf.pack_calibrated_params_moe(calib, JCFG, QuantSpec(), gptq_scales=scales)), "cpu")
    got = thf.pack_calibrated_params_moe(tmx.params_from_numpy(_np_tree(calib), "cpu"), TCFG, tconf.ATOM_W4A4,
                                         gptq_scales={k: tensor_from_numpy(np.asarray(v), "cpu")
                                                      for k, v in scales.items()})
    assert isinstance(got, MoEServingParams) and got.layers[0].wgateup.body_packed.shape[0] == JCFG.num_experts
    _same(got, want)


@pytest.fixture(scope="module")
def jax_rtn():
    """JAX's RTN calibration of the bf16 TINY_MIXTRAL, with its originals and reorder indices."""
    params = jmx.init_params(jax.random.PRNGKey(1), JCFG, dtype=jnp.bfloat16)
    calib, idx = jpl.calibrate(params, JCFG, QuantSpec(use_gptq=False), [jnp.asarray(b) for b in _batches()])
    return params, calib, idx


@pytest.mark.parametrize("orig", (True, False))
def test_pack_calibrated_params_moe_rtn_bitwise(orig, jax_rtn):
    params, calib, idx = jax_rtn
    spec = QuantSpec(use_gptq=False)
    orig_r = jpl.reorder_model(params, JCFG, idx) if orig else None
    want = moe_serving_params_from_numpy(
        _np_tree(jhf.pack_calibrated_params_moe(calib, JCFG, spec, orig_params=orig_r)), "cpu")
    t_orig = tmx.params_from_numpy(_np_tree(orig_r), "cpu") if orig else None
    got = thf.pack_calibrated_params_moe(tmx.params_from_numpy(_np_tree(calib), "cpu"), TCFG,
                                         tconf.QuantSpec(use_gptq=False), orig_params=t_orig)
    _same(got, want)


def test_moe_serving_export_crosses_both_ways(jax_gptq, tmp_path):
    calib, scales = jax_gptq
    jsp = jhf.pack_calibrated_params_moe(calib, JCFG, QuantSpec(), gptq_scales=scales)
    jck.save_serving(str(tmp_path / "jax"), jsp, JCFG, QuantSpec())
    tsp, cfg, spec = tck.load_serving(str(tmp_path / "jax"), device="cpu")
    assert cfg == TCFG and spec == tconf.ATOM_W4A4 and isinstance(tsp, MoEServingParams)
    _same(tsp, moe_serving_params_from_numpy(_np_tree(jsp), "cpu"))
    tck.save_serving(str(tmp_path / "port"), tsp, cfg, spec)
    back, jcfg, jspec = jck.load_serving(str(tmp_path / "port"))
    assert jcfg == JCFG and jspec == QuantSpec()
    _same(moe_serving_params_from_numpy(_np_tree(back), "cpu"), tsp)
    again, _, _ = tck.load_serving(str(tmp_path / "port"), device="cpu")
    _same(again, tsp)
    with pytest.raises(ValueError):  # the served architectures only
        tck.save_serving(str(tmp_path / "opt"), tsp, tcfgs.TINY_OPT, spec)


def test_served_logits_match_accuracy_pipeline():
    """The port's GPTQ calibration of TINY_MIXTRAL, exported and served
    through the MoE serving model's prefill (plain versions of its kernels on
    the CPU), against the port's accuracy forward."""
    from atom_tpu_torch.serving.model import _lm_head_logits, make_serving_state
    from atom_tpu_torch.serving.moe import prefill_hidden_moe

    params = tmx.init_params(TCFG, seed=0, dtype=torch.float32, device="cpu")
    scales = {}
    calib, _ = tpl.calibrate(params, TCFG, tconf.ATOM_W4A4, [torch.from_numpy(b) for b in _batches()],
                             scales_out=scales)
    sp = thf.pack_calibrated_params_moe(calib, TCFG, tconf.ATOM_W4A4, gptq_scales=scales)
    t = 48
    ids = torch.from_numpy(np.random.Generator(np.random.PCG64(3)).integers(1, TCFG.vocab_size, t).astype(np.int32))
    want = tmx.forward(calib, ids[None], TCFG, tconf.ATOM_W4A4)[0].numpy()
    state = make_serving_state(TCFG.num_layers, 4, 1, TCFG.num_kv_heads, 128, TCFG.head_dim, device="cpu")
    x, _ = prefill_hidden_moe(sp, state.pages, ids, torch.arange(1, 2, dtype=torch.int32), TCFG, tconf.ATOM_W4A4)
    got = _lm_head_logits(x, sp.lm_head, TCFG.vocab_size).numpy()
    assert got.shape == want.shape == (t, TCFG.vocab_size)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.97
    assert np.abs(got - want).mean() < 0.25 * np.abs(want).mean()
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.6


def _target(text):
    m = re.findall(r"^targetResult,synthetic,([0-9.]+)$", text, re.M)
    assert len(m) == 1, text
    return float(m[0])


@pytest.mark.parametrize("model", ("tiny-mixtral", "tiny-opt"))
def test_cli_target_result_matches_jax(model, tmp_path, capsys):
    from atom_tpu import main as jmain
    from atom_tpu_torch import main as tmain

    jm, cfg = (jmx, TINY_MIXTRAL) if model == "tiny-mixtral" else (jopt, TINY_OPT)
    ckpt = str(tmp_path / "tiny.npz")
    jck.save_pytree(ckpt, jm.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16))
    # TINY_OPT's 128 channels are all keeper, which GPTQ refuses in both packages: its weights take RTN
    gptq = ["--use_gptq"] if model == "tiny-mixtral" else []
    args = [model, "synthetic", *gptq, "--reorder", "--eval_ppl", "--calib_samples", "4", "--ckpt", ckpt]
    export = ["--export_serving", str(tmp_path / "srv")] if model == "tiny-mixtral" else []
    tmain.main([*args, *export, "--device", "cpu"])
    got = _target(capsys.readouterr().out)
    jmain.main(args)
    want = _target(capsys.readouterr().out)
    assert got == pytest.approx(want, rel=5e-3)
    if export:  # the CLI's MoE export loads in both packages
        tsp, tcfg, _ = tck.load_serving(str(tmp_path / "srv"), device="cpu")
        assert isinstance(tsp, MoEServingParams) and tcfg == TCFG
        jsp, jcfg, _ = jck.load_serving(str(tmp_path / "srv"))
        _same(moe_serving_params_from_numpy(_np_tree(jsp), "cpu"), tsp)
    else:  # OPT is not served: the export refuses it before anything runs
        with pytest.raises(SystemExit, match="served architectures"):
            tmain.main([*args, "--export_serving", str(tmp_path / "srv"), "--device", "cpu"])
        assert not (tmp_path / "srv").exists() and "calibration in" not in capsys.readouterr().out
