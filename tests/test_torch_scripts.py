"""The port's generate and served-PPL scripts (``scripts/torch_generate.py``,
``scripts/torch_serve_byte_lm.py``) against the JAX package's
(``scripts/generate.py``, ``scripts/serve_byte_lm.py``), on the CPU.

  * generate: on TINY Llama and Mixtral exports written by the JAX
    package's ``save_serving``, the port's script runs its engine for real
    (the kernels' plain versions) and builds the same ``TextGenConfig``,
    pool and requests as the JAX script (whose engine is replaced by a
    recorder: nothing is computed there), and produces every byte;
  * served PPL: a 1-layer BYTE_LM checkpoint written here, seqlen 128, 2
    windows.  The port's script runs for real; the JAX script runs on the
    port's calibrated weights and GPTQ scales (its ``calibrate`` replaced)
    and evaluates op by op (``jax.disable_jit``), so both score the same
    weights through the same chain of bf16 roundings: the accuracy-pipeline
    PPL within rtol 1e-4 (measured 2e-7 with one torch thread, 7e-5 with
    eight), the served PPL within rtol 1e-3 (measured 7e-5 and 4.7e-4: W4A4's
    activation codes flip on a few rounding ties of the two serving paths).
    Jitted, the JAX package's bf16 evaluation keeps intermediates in float32
    and lands 2e-3 to 8e-3 away on these random weights.  Two independent
    calibrations are not compared: GPTQ's error feedback turns ulp-level
    differences into ~10% of the codes (``ROADMAP.md`` §C), and here the
    two scripts' own accuracy PPLs differ by 1.8%.  The calibration is held
    by ``tests/test_torch_calib.py``, the export bitwise by
    ``test_torch_accuracy_cli.py::test_pack_calibrated_params_bitwise``.
"""
import dataclasses
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atom_tpu.calib.pipeline as jpl
import atom_tpu.serving as jserving
import atom_tpu.utils.eval as jev
import atom_tpu_torch.calib.pipeline as tpl
import atom_tpu_torch.serving as tserving
from atom_tpu.config import ATOM_W4A4
from atom_tpu.models.configs import TINY_LLAMA, TINY_MIXTRAL
from atom_tpu.serving.model import init_serving_params
from atom_tpu.serving.moe import init_moe_serving_params
from atom_tpu.utils.checkpoint import save_serving
from test_torch_serving import cap_torch_threads

cap_torch_threads()

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

import generate as jgen  # noqa: E402
import serve_byte_lm as jserve  # noqa: E402
import torch_generate as tgen  # noqa: E402
import torch_serve_byte_lm as tserve  # noqa: E402

PROMPTS = ["The captain stood on the deck and ", "Call me"]
TOKENS = 24


def _engine_recorder(base, seen: dict, run_real: bool):
    """``TextGenEngine`` that records its configuration, pool and requests;
    ``run_real=False`` returns a result of the right length and computes nothing."""

    class Recorder(base):
        def __init__(self, cfg, pool, prefill_fn, decode_fn, state, *args, **kw):
            seen.update(cfg=dataclasses.asdict(cfg), pool=(pool.n_pages, pool.page_size), args=args, kw=kw)
            if run_real:
                super().__init__(cfg, pool, prefill_fn, decode_fn, state, *args, **kw)

        def run(self, rs, **kw):
            seen.update(prompt_lens=rs.prompt_lens.tolist(), output_lens=rs.output_lens.tolist(),
                        prompts=[p.tolist() for p in rs.prompts], run_kw=kw)
            if run_real:
                return super().run(rs, **kw)
            return dict(throughput_tok_s=1.0, output_tokens=int(rs.output_lens.sum()),
                        tokens=[[65] * int(n) for n in rs.output_lens])

    return Recorder


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """TINY Llama and Mixtral serving exports written by the JAX package, at
    the byte vocabulary the scripts decode."""
    root = tmp_path_factory.mktemp("exports")
    llama, mixtral = TINY_LLAMA.replace(vocab_size=256), TINY_MIXTRAL.replace(vocab_size=256)
    save_serving(str(root / "llama"), init_serving_params(jax.random.PRNGKey(0), llama, ATOM_W4A4), llama, ATOM_W4A4)
    save_serving(str(root / "mixtral"), init_moe_serving_params(jax.random.PRNGKey(0), mixtral, ATOM_W4A4), mixtral,
                 ATOM_W4A4)
    return root


@pytest.mark.parametrize("model", ["llama", "mixtral"])
def test_generate_matches_jax_script(exports, model, monkeypatch, capsys):
    argv = ["--serving_dir", str(exports / model), "--tokens", str(TOKENS), "--batch", "2"]
    for p in PROMPTS:
        argv += ["--prompt", p]
    want, got = {}, {}
    monkeypatch.setattr(jserving, "TextGenEngine", _engine_recorder(jserving.TextGenEngine, want, run_real=False))
    monkeypatch.setattr(sys, "argv", ["generate.py", *argv])
    jgen.main()
    monkeypatch.setattr(tserving, "TextGenEngine", _engine_recorder(tserving.TextGenEngine, got, run_real=True))
    res = tgen.main([*argv, "--device", "cpu"])
    assert got == want
    assert want["cfg"]["prefill_buckets"] == (128, 256, 512, 1024)
    assert res["output_tokens"] == len(PROMPTS) * TOKENS
    toks = [res["tokens"][i] for i in range(len(PROMPTS))]
    assert [len(t) for t in toks] == [TOKENS] * len(PROMPTS)
    assert all(0 <= b < 256 for t in toks for b in t)
    out = capsys.readouterr().out
    assert f"({len(PROMPTS) * TOKENS} bytes generated)" in out
    assert all(f"--- prompt {i}: {p!r}" in out for i, p in enumerate(PROMPTS))


def test_scripts_refuse_without_a_card(exports):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the scripts run on it by default")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.main(["--serving_dir", str(exports / "llama")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--ckpt", "missing.npz"])


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(tree.numpy())


def _targets(text: str) -> dict:
    return {k: float(v) for k, v in re.findall(r"^targetResult,(corpus_\w+),([0-9.]+)$", text, re.M)}


def test_serve_byte_lm_matches_jax_script(tmp_path, monkeypatch, capsys):
    from atom_tpu_torch.models import llama
    from atom_tpu_torch.models.configs import BYTE_LM
    from atom_tpu_torch.utils.checkpoint import save_pytree
    from torch_train_corpus_model import bf16_rounded

    ckpt = str(tmp_path / "byte_lm_1layer.npz")
    save_pytree(ckpt, bf16_rounded(llama.init_params(BYTE_LM.replace(num_layers=1), seed=0, dtype=torch.float32,
                                                     device="cpu")))
    argv = ["--ckpt", ckpt, "--corpus_dir", str(REPO / "data" / "corpus"), "--layers", "1", "--seqlen", "128",
            "--windows", "2", "--calib_samples", "4"]
    calibrated = {}
    real_calibrate = tpl.calibrate

    def keep(params, cfg, spec, batches, scales_out=None):
        calib, indices = real_calibrate(params, cfg, spec, batches, scales_out=scales_out)
        calibrated.update(calib=calib, scales=dict(scales_out))
        return calib, indices

    monkeypatch.setattr(tpl, "calibrate", keep)
    res = tserve.main([*argv, "--device", "cpu"])
    got = _targets(capsys.readouterr().out)
    assert set(got) == {"corpus_accuracy_pipeline", "corpus_served_kernels"}
    assert got["corpus_accuracy_pipeline"] == pytest.approx(res["ppl_accuracy"], abs=1e-5)
    assert all(np.isfinite(v) and 1.0 < v < 1e4 for v in got.values())

    def same_weights(params, cfg, spec, batches, scales_out=None):
        scales_out.update({k: jnp.asarray(v.numpy()) for k, v in calibrated["scales"].items()})
        return _jax_tree(calibrated["calib"]), {}

    monkeypatch.setattr(jpl, "calibrate", same_weights)
    real_ppl = jev.perplexity

    def op_by_op(*a, **kw):
        with jax.disable_jit():
            return real_ppl(*a, **kw)

    monkeypatch.setattr(jev, "perplexity", op_by_op)
    monkeypatch.setattr(sys, "argv", ["serve_byte_lm.py", *argv])
    jserve.main()
    want = _targets(capsys.readouterr().out)
    assert got["corpus_accuracy_pipeline"] == pytest.approx(want["corpus_accuracy_pipeline"], rel=1e-4)
    assert got["corpus_served_kernels"] == pytest.approx(want["corpus_served_kernels"], rel=1e-3)
