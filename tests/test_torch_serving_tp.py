"""Tensor-parallel serving in the port (``atom_tpu_torch/serving/parallel.py``)
held bitwise against the port's single-device steps, and against the JAX
package's ``make_tp_step_fns`` on its virtual CPU mesh.

The JAX tests' geometries (``tests/test_serving_tp.py``): MHA (hidden 1024,
8 heads) and GQA (hidden 512, 8 query / 4 kv heads), 2 layers, pages of 128,
batch 2, ``fused_serving=False``; tp 4 (GQA: one kv head a rank).  A prompt
prefilled, then 38 decode steps (one ring flush at step 32).  The port's
ranks are 4 gloo processes on the CPU, spawned once for the module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu.config import QuantSpec
from atom_tpu.models.configs import Arch, ModelConfig
from atom_tpu.ops.kv_hot import HOT_W
from atom_tpu.serving import model as jm
from atom_tpu.serving.parallel import make_state_sharded, make_tp_step_fns, shard_serving_params
from atom_tpu_torch.config import QuantSpec as TQuantSpec
from atom_tpu_torch.models.configs import Arch as TArch
from atom_tpu_torch.models.configs import ModelConfig as TModelConfig
from atom_tpu_torch.parallel.launch import run_ranks
from atom_tpu_torch.serving import model as tm
from atom_tpu_torch.serving.convert import serving_params_from_numpy, serving_state_from_numpy
from test_torch_serving import B, W, _inputs, _state, cap_torch_threads
from torch_rank_bodies import drive, join_heads, state_tensors, tp_body

cap_torch_threads()

TP = 4
PAGE, N_PAGES, STEPS = 128, 8, HOT_W + 6
GEOMS = {"mha": dict(hidden_size=1024, intermediate_size=2048, num_heads=8, num_kv_heads=8),
         "gqa": dict(hidden_size=512, intermediate_size=1024, num_heads=8, num_kv_heads=4)}
PROMPTS = {"mha": (1, 30), "gqa": (7, 20)}  # (numpy seed, prompt length), as the JAX tests


def _cfgs(name):
    kw = dict(vocab_size=256, num_layers=2, head_dim=128, **GEOMS[name])
    return ModelConfig(arch=Arch.LLAMA, **kw), TModelConfig(arch=TArch.LLAMA, **kw)


SPEC = QuantSpec(weight_channel_group=1, fused_serving=False)
T_SPEC = TQuantSpec(weight_channel_group=1, fused_serving=False)


@pytest.fixture(scope="module")
def runs():
    """Per geometry: the JAX params, the port's single-device run and the
    port's TP ranks' runs; and one decode step from a seeded state (GQA,
    batch 32, ring at row 9: ``tests/test_torch_serving.py``'s state), on
    one device and on the ranks (one spawn for all)."""
    cases, out = {}, {}
    for name in GEOMS:
        jcfg, tcfg = _cfgs(name)
        jparams = jm.init_serving_params(jax.random.PRNGKey(0), jcfg, SPEC)
        tparams = serving_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
        seed, n = PROMPTS[name]
        prompt = np.random.Generator(np.random.PCG64(seed)).integers(1, 256, n).astype(np.int32)
        cases[name] = (tparams, tcfg, T_SPEC, prompt, 32, [1, 2], STEPS, N_PAGES, PAGE)
        state = tm.make_serving_state(2, N_PAGES, 2, tcfg.num_kv_heads, PAGE, 128, device="cpu")
        toks, state = drive(*tm.make_step_fns(tparams, tcfg, T_SPEC), state, prompt, 32, [1, 2], STEPS)
        pre = tm.make_serving_state(2, N_PAGES, 2, tcfg.num_kv_heads, PAGE, 128, device="cpu")
        _, pre = drive(*tm.make_step_fns(tparams, tcfg, T_SPEC), pre, prompt, 32, [1, 2], 0)
        out[name] = dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams, prompt=prompt,
                         single=(toks, state_tensors(state)), single_prefill=state_tensors(pre))
    rng = np.random.default_rng(10)
    table, ids = _inputs(rng, 256)
    flushed = rng.integers(0, 400, B)
    lens = (flushed + rng.integers(1, W + 1, B)).astype(np.int32)
    seeded = _state(rng, GEOMS["gqa"]["num_kv_heads"], flushed, row=9)
    g = out["gqa"]
    step_in = (torch.from_numpy(ids), torch.from_numpy(table), torch.from_numpy(lens))
    _, decode_fn = tm.make_step_fns(g["tparams"], g["tcfg"], T_SPEC)
    nxt, st = decode_fn(serving_state_from_numpy(seeded, "cpu"), *step_in)
    out["step"] = dict(seeded=seeded, ids=ids, table=table, lens=lens, single=(nxt, state_tensors(st)))
    step_case = (g["tparams"], g["tcfg"], T_SPEC, serving_state_from_numpy(seeded, "cpu"), *step_in)
    ranks = run_ranks(tp_body, TP, timeout_s=240, args=(cases, step_case))
    for name in list(GEOMS) + ["step"]:
        out[name]["tp_tokens"] = [r[name][0] for r in ranks]
        out[name]["tp"] = join_heads([r[name][1] for r in ranks])
    return out


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_tp_matches_single_device_bitwise(runs, name):
    """Every rank's tokens equal the single device's, through the ring flush;
    pages, ring and flushed counts, gathered over the ranks' kv heads, are
    bitwise the single device's."""
    r = runs[name]
    toks, single = r["single"]
    assert all(t == toks for t in r["tp_tokens"])
    assert int(single["flushed"][0]) >= HOT_W
    for key, want in single.items():
        assert torch.equal(r["tp"][key], want), f"{name}: {key} differs"


def test_tp_step_from_seeded_state_bitwise(runs):
    """One decode step of 32 sequences from a seeded state: next ids on
    every rank, ring and pages bitwise the single device's."""
    r = runs["step"]
    nxt, single = r["single"]
    assert all(torch.equal(t, nxt) for t in r["tp_tokens"])
    for key, want in single.items():
        assert torch.equal(r["tp"][key], want), f"step: {key} differs"


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _tbits(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def test_tp_matches_jax_tp(runs):
    """Against the JAX package's TP steps (jitted on the 8-device CPU mesh,
    GQA, tp 4), under the bounds ``tests/test_torch_serving.py`` holds the
    single-device steps to.  The prefill: layer 0's pages (written before
    any attention) with at most 0.2% of their bytes differing (a jitted JAX
    program's quantizer scales sit an ulp off its op-by-op chain, so a code
    on a rounding boundary may flip; past layer 0 such a flip spreads
    through attention to every later token, and may move the first token
    where two logits are close).  The seeded decode step: next ids agree on
    the majority of the 32 rows, the pages untouched, the ring bitwise but
    for the written column."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    g, r = runs["gqa"], runs["step"]
    jcfg = g["jcfg"]
    mesh = Mesh(np.array(jax.devices()[:TP]), ("tp",))
    prefill, decode = make_tp_step_fns(shard_serving_params(g["jparams"], jcfg, mesh), jcfg, SPEC, mesh)

    prompt = g["prompt"]
    ids = np.zeros((32,), np.int32)
    ids[: len(prompt)] = prompt
    state = make_state_sharded(2, N_PAGES, 2, jcfg.num_kv_heads, PAGE, 128, mesh)
    _, state = prefill(state, jnp.asarray(ids), jnp.asarray([1, 2], jnp.int32), jnp.int32(len(prompt)),
                         jnp.int32(0))
    state = jax.device_get(state)
    port = g["single_prefill"]
    for f in ("k_pages", "v_pages", "params"):
        a, t = _bits(getattr(state.pages[0], f)), _tbits(port[f"pages0.{f}"])
        assert np.mean(a != t) <= 2e-3, f"layer 0 {f}: {np.mean(a != t):.4%} of bytes differ"

    def put(tree, spec):
        return jax.device_put(jnp.asarray(np.array(tree)), NamedSharding(mesh, spec))

    st = r["seeded"]
    jstate = st._replace(
        pages=[type(pg)(put(pg.k_pages, P(None, "tp")), put(pg.v_pages, P(None, "tp")),
                        put(pg.params, P(None, None, "tp"))) for pg in st.pages],
        hot=[type(h)(put(h.k_codes, P(None, "tp")), put(h.prm, P(None, None, "tp")), put(h.v_codes, P(None, "tp")))
             for h in st.hot],
        row=put(st.row, P()), flushed=put(st.flushed, P()))
    jids, jst = decode(jstate, jnp.asarray(r["ids"]), jnp.asarray(r["table"]), jnp.asarray(r["lens"]))
    tids, tp = r["tp_tokens"][0], r["tp"]
    assert np.mean(np.asarray(jids) == tids.numpy()) > 0.5
    row = int(st.row)
    for l in range(2):
        for f in ("k_pages", "v_pages", "params"):
            np.testing.assert_array_equal(_bits(getattr(jst.pages[l], f)), _tbits(tp[f"pages{l}.{f}"]))
        for f, axis in (("k_codes", 3), ("prm", 3), ("v_codes", 2)):
            np.testing.assert_array_equal(np.delete(_bits(getattr(jst.hot[l], f)), row, axis),
                                          np.delete(_tbits(tp[f"hot{l}.{f}"]), row, axis))
