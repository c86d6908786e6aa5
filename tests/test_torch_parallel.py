"""The port's accuracy models on DTensor shardings
(``atom_tpu_torch/parallel/shardings.py``) against the JAX package's models,
as ``tests/test_parallel.py`` holds the JAX package's sharded forwards, and
the rank launcher's failure paths (``atom_tpu_torch/parallel/launch.py``).

The JAX tests' cases: TINY_LLAMA in float32 unquantized (atol 2e-4) and
under a 64-group W4A4 spec (atol 2e-3), TINY_MIXTRAL unquantized (3e-4), and
TINY_OPT unquantized (2e-4, the Llama bound; the JAX tests shard no OPT).
The port's params are the JAX params carried across; its forwards run on a
(dp 2, tp 2) mesh of 4 gloo ranks, spawned once, with the ids sharded on
dp; the references are the JAX forwards on one device.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu.config import ATOM_W4A4, FP16_BASELINE
from atom_tpu.models import TINY_LLAMA, TINY_MIXTRAL, TINY_OPT, llama, mixtral, opt
from atom_tpu_torch.config import ATOM_W4A4 as T_W4A4
from atom_tpu_torch.config import FP16_BASELINE as T_FP16
from atom_tpu_torch.models import configs as tconfigs
from atom_tpu_torch.models.base import params_from_numpy
from atom_tpu_torch.parallel.launch import run_ranks
from test_torch_serving import cap_torch_threads
from torch_rank_bodies import dtensor_body, failing_body, hanging_body

cap_torch_threads()

TINY_SPEC = ATOM_W4A4.replace(weight_group_size=64, act_group_size=64, keeper=64)
T_TINY_SPEC = T_W4A4.replace(weight_group_size=64, act_group_size=64, keeper=64)
# name: (family, JAX module, JAX cfg, port cfg, key, JAX spec, port spec, batch, atol)
CASES = {
    "llama_fp": ("llama", llama, TINY_LLAMA, tconfigs.TINY_LLAMA, 0, FP16_BASELINE, T_FP16, 4, 2e-4),
    "llama_w4a4": ("llama", llama, TINY_LLAMA, tconfigs.TINY_LLAMA, 1, TINY_SPEC, T_TINY_SPEC, 2, 2e-3),
    "mixtral_fp": ("mixtral", mixtral, TINY_MIXTRAL, tconfigs.TINY_MIXTRAL, 0, FP16_BASELINE, T_FP16, 2, 3e-4),
    "opt_fp": ("opt", opt, TINY_OPT, tconfigs.TINY_OPT, 0, FP16_BASELINE, T_FP16, 2, 2e-4),
}


@pytest.fixture(scope="module")
def runs():
    cases, want = {}, {}
    for name, (family, jmod, jcfg, tcfg, key, jspec, tspec, batch, _) in CASES.items():
        jparams = jmod.init_params(jax.random.PRNGKey(key), jcfg, jnp.float32)
        ids = np.tile(np.arange(16)[None], (batch, 1)) % jcfg.vocab_size
        want[name] = np.asarray(jmod.forward(jparams, jnp.asarray(ids), jcfg, jspec))
        tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
        cases[name] = (family, tparams, tcfg, tspec, torch.from_numpy(ids))
    got = run_ranks(dtensor_body, 4, timeout_s=240, args=(cases,))
    return want, got


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_forward_matches_jax(runs, name):
    """Every rank's whole logits within the JAX test's bound of the JAX
    forward on one device."""
    want, got = runs
    for r in got:
        np.testing.assert_allclose(r[name].numpy(), want[name], atol=CASES[name][-1])


def test_run_ranks_raises_when_a_rank_fails():
    """A rank that raises fails the run within seconds, with its traceback,
    and the rank waiting on it is stopped."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(failing_body, 2, timeout_s=120)
    assert time.monotonic() - t0 < 60


def test_run_ranks_times_out_on_a_hang():
    """A rank that never returns fails the run at ``timeout_s``, not at the
    test run's cut, and is killed."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running after"):
        run_ranks(hanging_body, 2, timeout_s=6)
    assert time.monotonic() - t0 < 40
