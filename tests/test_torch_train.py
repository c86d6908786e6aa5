"""The port's fixture trainer (``utils/train.py``, ``scripts/torch_train_corpus_model.py``)
held against the JAX package's (``atom_tpu/utils/train.py``, optax) on
float32 ``TINY_LLAMA`` from a JAX seed, windows from numpy seeds.

Tolerances, and why:
  * the loss within rtol 1e-6 and every gradient leaf within 5e-6 of its
    largest entry of ``jax.value_and_grad``'s (float32 sums in another
    order; the backward recomputes each layer in both);
  * the learning-rate schedule equal to optax's in float32 at all but 0.5%
    of the steps, and there within two float32 ulp: XLA's float32 cosine is
    not correctly rounded (one ulp, doubled by the products after it), the
    port's is (float64 rounded once);
  * three updates of ``train`` (the first at learning rate 0) within 1e-2 x
    lr of optax's on all but 0.01% of each leaf's entries, and every entry
    within 0.1 x lr: Adam divides each gradient by its own root mean square,
    so a gradient entry near eps (a token seen once) whose float32 value
    differs in its last bits moves its parameter by a few percent of a
    learning-rate step;
  * ``sample_windows`` bitwise (the same numpy stream); ``eval_loss`` within
    rtol 1e-5;
  * the checkpoint bitwise through both packages' ``restore_model_params``.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from atom_tpu.models import llama as jl
from atom_tpu.models.configs import TINY_LLAMA as JCFG
from atom_tpu.utils import checkpoint as jck
from atom_tpu.utils import train as jt
from atom_tpu_torch.models import configs as tcfgs
from atom_tpu_torch.models import llama as tl
from atom_tpu_torch.utils import checkpoint as tck
from atom_tpu_torch.utils import train as tt
from test_torch_serving import cap_torch_threads

cap_torch_threads()

REPO = Path(__file__).resolve().parents[1]
TCFG = tcfgs.TINY_LLAMA
TOKENS = np.random.default_rng(1).integers(0, JCFG.vocab_size, 20_000).astype(np.int32)


def _params():
    jp = jl.init_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    return jp, tl.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _named(tree, prefix=""):
    """(dotted name, leaf) pairs of a nested dict, sorted by key."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}.")
        elif v is not None:
            yield prefix + k, v


def test_loss_and_gradients_match_jax():
    jp, tp = _params()
    ids = tt.sample_windows(np.random.default_rng(2), TOKENS, 1, 2, 64)[0]
    jf, js = jt.split_trainable(jp)
    jloss, jgrad = jax.value_and_grad(lambda f: jt._loss(jt.merge_trainable(f, js), jnp.asarray(ids), JCFG))(jf)
    fl, st = tt.split_trainable(tp)
    assert {n for n, _ in _named(st)} == {"layers.attn_ln_idx", "layers.mlp_ln_idx", "layers.attn_out_idx"}
    names, leaves = zip(*_named(fl))
    for p in leaves:
        p.requires_grad_(True)
    loss = tt._loss(tt.merge_trainable(fl, st), torch.from_numpy(ids), TCFG)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    assert loss.item() == pytest.approx(float(jloss), rel=1e-6)
    want = dict(_named(jax.tree.map(lambda a: None if a is None else np.asarray(a), jgrad,
                                    is_leaf=lambda a: a is None)))
    assert set(want) == set(grads)
    for n, g in want.items():
        np.testing.assert_allclose(grads[n].numpy(), g, rtol=0, atol=5e-6 * np.abs(g).max(), err_msg=n)


@pytest.mark.parametrize("lr,warmup,steps", ((3e-4, 100, 2400), (3e-4, 8, 24), (1e-3, 1, 3)))
def test_schedule_matches_optax(lr, warmup, steps):
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1), end_value=lr * 0.1)
    ours = tt.lr_schedule(lr, warmup, steps)
    counts = np.arange(steps + 3)
    a = np.asarray(jax.vmap(want)(jnp.asarray(counts, jnp.int32)), np.float32)
    b = np.asarray([ours(int(c)) for c in counts], np.float32)
    assert a[0] == b[0] == 0.0  # optax's count starts at 0: the first update at lr 0
    assert np.mean(a != b) <= 5e-3
    np.testing.assert_array_less(np.abs(a - b), np.spacing(a) * 2.01)


def test_three_updates_match_optax():
    jp, tp = _params()
    kw = dict(steps=3, batch=2, seqlen=64, lr=1e-3, warmup=1, chunk=2, seed=0, log=lambda s: None)
    jout, jloss = jt.train(jp, JCFG, TOKENS, **kw)
    tout, tloss = tt.train(tp, TCFG, TOKENS, **kw)
    assert tloss == pytest.approx(jloss, rel=1e-5)
    moved = 0.0
    for n, a in _named(jax.tree.map(np.asarray, jout)):
        b, a0 = dict(_named(tout))[n].numpy(), np.asarray(dict(_named(jp))[n])
        assert a.dtype == b.dtype, n
        np.testing.assert_allclose(b, a, rtol=0, atol=0.1 * kw["lr"], err_msg=n)
        assert np.mean(np.abs(b - a) > 1e-2 * kw["lr"]) <= 1e-4, n
        moved = max(moved, float(np.abs(a - a0).max()))
    assert moved > 0.5 * kw["lr"]  # the updates after the first did move the weights
    assert not any(p.requires_grad for _, p in _named(tout))


def test_sample_windows_bitwise_and_eval_loss_close():
    a = jt.sample_windows(np.random.default_rng(5), TOKENS, 3, 2, 33)
    b = tt.sample_windows(np.random.default_rng(5), TOKENS, 3, 2, 33)
    assert a.dtype == b.dtype == np.int32 and a.shape == (3, 2, 34)
    np.testing.assert_array_equal(a, b)
    jp, tp = _params()
    want = jt.eval_loss(jp, JCFG, TOKENS[:4000], 64, batch=4, max_windows=10)
    got = tt.eval_loss(tp, TCFG, TOKENS[:4000], 64, batch=4, max_windows=10)
    assert got == pytest.approx(want, rel=1e-5)


def test_script_checkpoint_round_trip(tmp_path, monkeypatch, capsys):
    """``scripts/torch_train_corpus_model.py`` (on a tiny model with the byte
    vocabulary) writes bf16-rounded float32 carriers that ``main.py byte-lm
    --ckpt`` reads back, and the JAX package's ``restore_model_params`` too."""
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    import torch_train_corpus_model as script

    from atom_tpu_torch import main as cli

    tiny = TCFG.replace(vocab_size=256)
    monkeypatch.setattr(tcfgs, "BYTE_LM", tiny)
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for name, n in (("train.txt", 60_000), ("eval.txt", 3_000)):
        (corpus / name).write_bytes((REPO / "data" / "corpus" / name).read_bytes()[:n])
    out = str(tmp_path / "ckpt.npz")
    script.main(["--steps", "3", "--batch", "2", "--seqlen", "32", "--chunk", "3", "--corpus", str(corpus),
                 "--out", out, "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "saved checkpoint" in printed and "eval:" in printed

    params = tck.restore_model_params(out, tl, tiny, 0, "cpu")
    raw = np.load(out)
    for n, leaf in _named(params):
        arr = raw[n.replace(".", "/")]
        if leaf.dtype == torch.bfloat16:  # float32 carriers of bf16 values: exact
            assert arr.dtype == np.float32
            np.testing.assert_array_equal(leaf.float().numpy(), arr, err_msg=n)
    jparams = jck.restore_model_params(out, jl, JCFG.replace(vocab_size=256), 0)
    for n, a in _named(jax.tree.map(np.asarray, jparams)):
        b = dict(_named(params))[n]
        np.testing.assert_array_equal(b.float().numpy() if b.is_floating_point() else b.numpy(),
                                      a.astype(np.float32) if a.dtype.name == "bfloat16" else a, err_msg=n)
    cli.main(["byte-lm", "corpus", "--ckpt", out, "--wbits", "16", "--abits", "16", "--eval_ppl", "--seqlen", "32",
              "--calib_samples", "1", "--corpus_dir", str(corpus), "--device", "cpu"])
    line = [x for x in capsys.readouterr().out.splitlines() if x.startswith("targetResult,corpus,")]
    assert len(line) == 1 and 1.0 < float(line[0].split(",")[2]) < 256.0
