"""Sequence-parallel prefill in the port (``atom_tpu_torch/serving/sp.py``)
held bitwise against the port's single-device ``prefill_step``, and against
the JAX package's ``make_sp_prefill_fn`` on its virtual CPU mesh.

The JAX tests' cases (``tests/test_serving_sp.py``): sp 4 over a 57-token
prompt in the 128 bucket (hidden 256, 2 / 1 heads), by the default attention
and by the flash kernel's path (``PREFILL_KERNEL_THRESHOLD`` 0: its plain
version here); sp 2 x tp 2 over a 41-token prompt in the 64 bucket (hidden
512, 4 / 2 heads), then a decode step on the TP step over the same tp axis.
4 gloo ranks on the CPU, spawned once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu.config import QuantSpec
from atom_tpu.models.configs import Arch, ModelConfig
from atom_tpu.serving import model as jm
from atom_tpu.serving.sp import make_sp_prefill_fn
from atom_tpu_torch.config import QuantSpec as TQuantSpec
from atom_tpu_torch.models.configs import Arch as TArch
from atom_tpu_torch.models.configs import ModelConfig as TModelConfig
from atom_tpu_torch.parallel.launch import run_ranks
from atom_tpu_torch.serving import model as tm
from atom_tpu_torch.serving.convert import serving_params_from_numpy
from test_torch_serving import cap_torch_threads
from test_torch_serving_tp import _bits, _tbits
from torch_rank_bodies import _prefill_once, join_heads, sp_body, state_tensors

cap_torch_threads()

SPEC = QuantSpec(weight_channel_group=1, fused_serving=False)
T_SPEC = TQuantSpec(weight_channel_group=1, fused_serving=False)
PAGE, N_PAGES, TABLE_ROW = 128, 8, [1, 2, 0, 0]
SP_KW = dict(vocab_size=211, hidden_size=256, intermediate_size=384, num_layers=2, num_heads=2, num_kv_heads=1,
             head_dim=128)
SP_TP_KW = dict(vocab_size=212, hidden_size=512, intermediate_size=1024, num_layers=2, num_heads=4, num_kv_heads=2,
                head_dim=128)


def _model(kw, key):
    jcfg, tcfg = ModelConfig(arch=Arch.LLAMA, **kw), TModelConfig(arch=TArch.LLAMA, **kw)
    jparams = jm.init_serving_params(jax.random.PRNGKey(key), jcfg, SPEC)
    return jcfg, tcfg, jparams, serving_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _single_prefill(tparams, tcfg, prompt, bucket, kernel=False):
    old = tm.PREFILL_KERNEL_THRESHOLD
    tm.PREFILL_KERNEL_THRESHOLD = 0 if kernel else old
    try:
        state = tm.make_serving_state(2, N_PAGES, 1, tcfg.num_kv_heads, PAGE, 128, device="cpu")
        tok, state = _prefill_once(tm.make_step_fns(tparams, tcfg, T_SPEC)[0], state, prompt, bucket, TABLE_ROW)
    finally:
        tm.PREFILL_KERNEL_THRESHOLD = old
    return int(tok), state


@pytest.fixture(scope="module")
def runs():
    sp_model, sp_tp_model = _model(SP_KW, 3), _model(SP_TP_KW, 7)
    prompt = np.random.Generator(np.random.PCG64(5)).integers(1, 211, 57).astype(np.int32)
    prompt2 = np.random.Generator(np.random.PCG64(8)).integers(1, 212, 41).astype(np.int32)
    _, tcfg, _, tparams = sp_model
    sp_case = {name: (tparams, tcfg, T_SPEC, prompt, 128, TABLE_ROW, N_PAGES, PAGE, kernel)
               for name, kernel in (("default", False), ("kernel", True))}
    _, tcfg2, _, tparams2 = sp_tp_model
    sp_tp_case = (tparams2, tcfg2, T_SPEC, prompt2, 64, TABLE_ROW, N_PAGES, PAGE)
    ranks = run_ranks(sp_body, 4, timeout_s=240, args=(sp_case, sp_tp_case))
    out = dict(sp_model=sp_model, sp_tp_model=sp_tp_model, prompt=prompt, prompt2=prompt2, ranks=ranks)
    for name, kernel in (("default", False), ("kernel", True)):
        tok, state = _single_prefill(tparams, tcfg, prompt, 128, kernel)
        out[name] = (tok, state_tensors(state))
    tok, state = _single_prefill(tparams2, tcfg2, prompt2, 64)
    table = torch.as_tensor([TABLE_ROW], dtype=torch.int32)
    nxt, _ = tm.decode_step(tparams2, state, torch.tensor([tok], dtype=torch.int32), table,
                            torch.tensor([42], dtype=torch.int32), tcfg2, T_SPEC)
    out["sp_tp"] = (tok, state_tensors(state), int(nxt[0]))
    return out


@pytest.mark.parametrize("name", ["default", "kernel"])
def test_sp_prefill_matches_single_device_bitwise(runs, name):
    """sp 4: every rank's first token and whole pages equal the single
    device's prefill, bit for bit (the flash kernel's plain version is
    row-independent too)."""
    tok, single = runs[name]
    for r in runs["ranks"]:
        assert r[name][0] == tok
        for key, want in single.items():
            assert torch.equal(r[name][1][key], want), f"{name}: {key} differs"


def test_sp_tp_prefill_matches_single_device_bitwise(runs):
    """sp 2 x tp 2: the first token, pages gathered over the tp ranks' kv
    heads (in each sp row of the mesh) bitwise the single device's; the TP
    decode step continuing from them gives the single device's next token."""
    tok, single, nxt = runs["sp_tp"]
    ranks = runs["ranks"]
    assert all(r["sp_tp"][0] == tok and r["sp_tp"][2] == nxt for r in ranks)
    for row in (ranks[0:2], ranks[2:4]):  # mesh (sp, tp): ranks 2i, 2i + 1 share an sp index
        joined = join_heads([r["sp_tp"][1] for r in row])
        for key, want in single.items():
            assert torch.equal(joined[key], want), f"sp x tp: {key} differs"


def test_sp_prefill_matches_jax_sp(runs):
    """Against the JAX package's ``make_sp_prefill_fn`` (jitted on 4 CPU
    devices): layer 0's pages within 0.2% of their bytes of the port's sp
    prefill (as ``test_torch_serving_tp.py::test_tp_matches_jax_tp`` holds
    the TP prefill; deeper layers carry a jitted program's quantizer flips
    through attention)."""
    from jax.sharding import Mesh

    jcfg, _, jparams, _ = runs["sp_model"]
    mesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
    ids = np.zeros((128,), np.int32)
    ids[:57] = runs["prompt"]
    state = jm.make_serving_state(2, N_PAGES, 1, 1, PAGE, 128)
    _, state = make_sp_prefill_fn(jparams, jcfg, SPEC, mesh)(state, jnp.asarray(ids), jnp.asarray(TABLE_ROW, jnp.int32),
                                                              jnp.int32(57), jnp.int32(0))
    port = runs["ranks"][0]["default"][1]
    assert int(np.asarray(state.flushed)[0]) == int(port["flushed"][0]) == 57
    for f in ("k_pages", "v_pages", "params"):
        a, t = _bits(getattr(state.pages[0], f)), _tbits(port[f"pages0.{f}"])
        assert np.mean(a != t) <= 2e-3, f"layer 0 {f}: {np.mean(a != t):.4%} of bytes differ"
