"""Engine-level data parallelism in the port (``atom_tpu_torch/serving/dp.py``)
against the JAX package's ``serving/dp.py``, and dp groups held token for
token against single-group runs of their partitions.

The JAX test's model and requests (``tests/test_serving_dp.py``: hidden
512, 4 heads, 2 layers, batch 2, page 128, bucket 32, 5 requests): dp 2
groups of tp 2 on 4 gloo ranks (spawned once), and dp 2 groups of tp 1 as
threads in this process.
"""
import jax
import numpy as np
import pytest
import torch

from atom_tpu.config import QuantSpec
from atom_tpu.models.configs import Arch, ModelConfig
from atom_tpu.serving import dp as jdp
from atom_tpu.serving import model as jm
from atom_tpu.serving.workload import RequestSet as JRequestSet
from atom_tpu_torch.config import QuantSpec as TQuantSpec
from atom_tpu_torch.models.configs import Arch as TArch
from atom_tpu_torch.models.configs import ModelConfig as TModelConfig
from atom_tpu_torch.parallel.launch import run_ranks
from atom_tpu_torch.serving import KvPool, RequestSet, TextGenConfig, TextGenEngine
from atom_tpu_torch.serving import dp as tdp
from atom_tpu_torch.serving import model as tm
from atom_tpu_torch.serving.convert import serving_params_from_numpy
from test_torch_serving import cap_torch_threads
from torch_rank_bodies import dp_body

cap_torch_threads()

KW = dict(vocab_size=256, hidden_size=512, intermediate_size=1024, num_layers=2, num_heads=4, num_kv_heads=4,
          head_dim=128)
SPEC = QuantSpec(weight_channel_group=1, fused_serving=False)
T_SPEC = TQuantSpec(weight_channel_group=1, fused_serving=False)
TG = TextGenConfig(batch_size=2, page_size=128, max_seq_len=256, prefill_buckets=(32,))


def _requests(n, cls, seed=11):
    rng = np.random.Generator(np.random.PCG64(seed))
    prompt_lens = rng.integers(3, 28, n).astype(np.int32)
    output_lens = rng.integers(2, 12, n).astype(np.int32)
    return cls(prompt_lens, output_lens, [rng.integers(1, 256, p).astype(np.int32) for p in prompt_lens])


def test_split_requests_matches_jax():
    """The same round-robin partition as the JAX package, arrival order kept."""
    for n, dp in ((7, 3), (5, 2), (2, 4)):
        jparts = jdp.split_requests(_requests(n, JRequestSet), dp)
        tparts = tdp.split_requests(_requests(n, RequestSet), dp)
        assert [len(p) for p in tparts] == [len(p) for p in jparts]
        for jp, tp in zip(jparts, tparts):
            np.testing.assert_array_equal(tp.prompt_lens, jp.prompt_lens)
            np.testing.assert_array_equal(tp.output_lens, jp.output_lens)
            for a, b in zip(tp.prompts, jp.prompts):
                np.testing.assert_array_equal(a, b)
    rs = _requests(7, RequestSet)
    assert sum(p.total_tokens for p in tdp.split_requests(rs, 3)) == rs.total_tokens


class _Stub:
    """An engine that returns fixed statistics for its partition."""

    def __init__(self, i):
        self.i = i

    def run(self, rs, progress=False, record=False):
        n = len(rs)
        return dict(elapsed_s=1.0 + self.i, total_tokens=int(rs.total_tokens), output_tokens=int(rs.output_lens.sum()),
                    requests=n, ttft_avg_s=0.1 * (self.i + 1), decode_ms_per_token_avg=2.0 + self.i)


def test_run_data_parallel_aggregates_as_jax():
    """The aggregate of the groups' results: every key and value of the JAX
    package's ``run_data_parallel`` over the same (stub) groups."""
    want = jdp.run_data_parallel([_Stub(0), _Stub(1)], _requests(5, JRequestSet))
    got = tdp.run_data_parallel([_Stub(0), _Stub(1)], _requests(5, RequestSet))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k]) if k != "per_group" else got[k] == want[k]


@pytest.fixture(scope="module")
def model():
    jparams = jm.init_serving_params(jax.random.PRNGKey(0), ModelConfig(arch=Arch.LLAMA, **KW), SPEC)
    return TModelConfig(arch=TArch.LLAMA, **KW), serving_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                                                           "cpu")


def _single_group(params, cfg, part):
    n_pool = TG.batch_size * TG.max_seq_len // TG.page_size + 16
    state = tm.make_serving_state(cfg.num_layers, n_pool, TG.batch_size, cfg.num_kv_heads, TG.page_size,
                                  cfg.head_dim, device="cpu")
    pool = KvPool(cfg.num_layers, n_pool, cfg.num_kv_heads, TG.page_size, cfg.head_dim)
    return TextGenEngine(TG, pool, *tm.make_step_fns(params, cfg, T_SPEC), state).run(part, record=True)


def _check_groups(res, params, cfg, rs):
    assert res["dp"] == 2 and res["requests"] == len(rs)
    assert res["output_tokens"] == int(rs.output_lens.sum()) and res["throughput_tok_s"] > 0
    for i, part in enumerate(tdp.split_requests(rs, 2)):
        ref = _single_group(params, cfg, part)
        got = res["per_group"][i]["tokens"]
        for r in range(len(part)):
            assert got[r] == ref["tokens"][r], f"group {i} request {r}: dp tokens diverge from the single-group run"


def test_dp_over_tp_ranks_matches_single_groups(model):
    """dp 2 groups of tp 2 ranks complete the workload, every rank returns
    the whole result, each group's pool is fully recycled, and each group's
    transcripts equal a single-device engine's run of its partition token
    for token (TP is bitwise the single device; groups never talk)."""
    cfg, params = model
    rs = _requests(5, RequestSet)
    ranks = run_ranks(dp_body, 4, timeout_s=240, args=(params, cfg, T_SPEC, TG, rs))
    res = ranks[0][0]
    for r, (other, (free, n_pages)) in enumerate(ranks):
        assert [g["tokens"] for g in other["per_group"]] == [g["tokens"] for g in res["per_group"]]
        assert free == n_pages - 1, f"rank {r}: {n_pages - 1 - free} pages not returned"
    _check_groups(res, params, cfg, rs)


def test_dp_threads_match_single_groups(model):
    """dp 2 groups of tp 1 as threads in one process (the JAX package's
    form, here both on the CPU): the same per-group parity."""
    cfg, params = model
    rs = _requests(5, RequestSet)
    engines = tdp.make_dp_tp_engines(params, cfg, T_SPEC, TG, [torch.device("cpu")] * 2, dp=2, tp=1)
    res = tdp.run_data_parallel(engines, rs, record=True)
    for eng in engines:
        assert eng.pool.num_free_pages == eng.pool.n_pages - 1
    _check_groups(res, params, cfg, rs)
