"""The port's benchmark modules (``atom_tpu_torch/utils/timing.py``,
``atom_tpu_torch/benchmarks/{bench_kernels,bench_textgen}.py``) against the
JAX package's, on the CPU.

  * ``_slope_tok_s`` under a scripted clock: JAX's trip counts; the median
    of the positive samples where JAX takes the minimum (which can be
    negative); a raise when no sample is positive;
  * ``bench_op`` on a CPU op: finite and positive;
  * ``model_cfg`` field for field;
  * the bursts and ``engine_run``'s stacks, structurally: the step and init
    functions replaced by recorders in both packages (nothing is computed),
    every call's arguments equal: seeds, configs, window counts, page
    tables, initial lengths, pool pages, ``max_t``, ``TextGenConfig`` and
    the requests;
  * the same functions for real at TINY_LLAMA and TINY_MIXTRAL width cut to
    one layer (the kernels' plain versions): positive rates, and
    ``engine_run``'s result keys equal to the JAX engine's;
  * ``bench_kernels.main(["--quick"])`` with ``bench_op`` and the weight
    builders stubbed in both packages: the same rows (names, byte and op
    counts).
"""
import dataclasses
import enum
import inspect
import math
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atom_tpu.benchmarks.bench_kernels as jbk
import atom_tpu.benchmarks.bench_textgen as jbt
import atom_tpu.serving as jserving
import atom_tpu.serving.baselines as jbl
import atom_tpu.serving.lora as jlora
import atom_tpu.serving.model as jm
import atom_tpu.serving.moe as jmoe
import atom_tpu_torch.benchmarks.bench_kernels as tbk
import atom_tpu_torch.benchmarks.bench_textgen as tbt
import atom_tpu_torch.serving as tserving
import atom_tpu_torch.serving.baselines as tbl
import atom_tpu_torch.serving.lora as tlora
import atom_tpu_torch.serving.model as tm
import atom_tpu_torch.serving.moe as tmoe
from atom_tpu_torch.models.configs import TINY_LLAMA, TINY_MIXTRAL
from atom_tpu_torch.utils.timing import bench_op, card_line, dispatch_latency
from test_torch_serving import cap_torch_threads

cap_torch_threads()

TINY1 = TINY_LLAMA.replace(num_layers=1)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def _scripted(durations):
    """A ``time`` stand-in whose ``perf_counter`` makes each timed call of
    ``_slope_tok_s`` last the next of ``durations``."""
    marks = [0.0]
    for d in durations:
        marks += [marks[-1] + 10.0, marks[-1] + 10.0 + d]
    ticks = iter(marks[1:])
    return types.SimpleNamespace(perf_counter=lambda: next(ticks))


@pytest.mark.parametrize("n_hi", [4, 32])
def test_slope_tok_s_median_of_positive_samples(n_hi, monkeypatch):
    # rounds of (t_lo, t_hi): slopes 2 / (n_hi - 2), negative, 3 / (n_hi - 2)
    durations = [1.0, 3.0, 5.0, 1.0, 1.0, 4.0]
    trips = {}
    for name, mod in (("jax", jbt), ("port", tbt)):
        monkeypatch.setattr(mod, "time", _scripted(durations))
        trips[name] = []
        trips[name + "_out"] = mod._slope_tok_s(lambda n, t=trips[name]: t.append(n) or 0.0, 32, n_hi)
    assert trips["port"] == trips["jax"] == [2] + [2, n_hi] * 3
    tok_s, per = trips["port_out"]
    assert per == pytest.approx(2.5 / (n_hi - 2)) and tok_s == pytest.approx(32 / per)
    assert trips["jax_out"][0] < 0  # JAX's min takes the negative sample


def test_slope_tok_s_raises_without_a_positive_sample(monkeypatch):
    monkeypatch.setattr(tbt, "time", _scripted([2.0, 1.0] * 3))
    with pytest.raises(RuntimeError, match="no positive slope sample"):
        tbt._slope_tok_s(lambda n: 0.0, 32, 4)


def test_bench_op_on_the_cpu():
    gen = torch.Generator().manual_seed(0)
    a, b = torch.randn((64, 64), generator=gen), torch.randn((64, 64), generator=gen)
    dt = bench_op(torch.mm, [a, b], iters=5)
    assert math.isfinite(dt) and dt > 0
    qa = types.SimpleNamespace()  # no tensor anywhere: the device is unknown
    with pytest.raises(ValueError, match="no tensor"):
        bench_op(lambda x: x, [qa])
    assert dispatch_latency(2, device="cpu") > 0
    assert card_line("cpu") == "device: cpu"


def test_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it by default")
    for call in (lambda: dispatch_latency(), lambda: tbk.main(["--quick"]), lambda: tbt.main(["--layers", "1"]),
                 lambda: tbt.burst_throughput_w4a4(TINY1, 2, 64), lambda: tbt.engine_run(TINY1, 2, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("name", ["7b", "13b", "70b"])
def test_model_cfg_matches_jax(name):
    assert _plain(tbt.model_cfg(name, 3)) == _plain(jbt.model_cfg(name, 3))


# ---------------------------------------------------------------------------
# the bursts and engine cells, structurally
# ---------------------------------------------------------------------------


def _plain(x):
    """Arguments of either package as plain Python for comparison."""
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, _FakeState):
        return "state"
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, torch.dtype):
        return str(x).removeprefix("torch.")
    if isinstance(x, np.dtype) or (isinstance(x, type) and issubclass(x, np.generic)):
        return np.dtype(x).name
    if isinstance(x, type) and hasattr(x, "dtype"):  # jnp.bfloat16, jnp.int8
        return np.dtype(x.dtype).name
    if isinstance(x, torch.Tensor):
        return x.tolist()
    if isinstance(x, (jax.Array, np.ndarray, np.generic)):
        return np.asarray(x).tolist()
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


OPAQUE = {"params", "lw", "state", "kvs", "device"}
RENAME = {"n_windows": "n_steps"}  # JAX's decode_burst* name their window count n_steps


class _FakeState:
    def __init__(self, calls):
        self.calls = calls

    def _replace(self, **kw):
        self.calls.append(("state._replace", _plain(kw)))
        return self


def _recorder(calls, name, real, ret):
    sig = inspect.signature(real)

    def fn(*a, **kw):
        bound = sig.bind(*a, **kw).arguments
        rec = {RENAME.get(k, k): _plain(v) for k, v in bound.items() if k not in OPAQUE | {"key"}}
        if "key" in bound:  # PRNGKey(s) -> s, the port's seed
            rec["seed"] = int(np.asarray(bound["key"])[-1])
        calls.append((name, rec))
        return ret(*a, **kw)

    return fn


def _record_package(monkeypatch, mods, calls):
    """Replace each package's param builders, states and bursts by recorders."""
    model, moe, lora, base, serving, bench = mods
    identity = lambda p, *a, **k: p  # noqa: E731
    burst_ret = lambda params, state, ids, table, lens, *a, **k: (ids, state, lens)  # noqa: E731
    lora_ret = lambda params, lw, state, ids, table, lens, *a, **k: (ids, state, lens)  # noqa: E731
    base_ret = lambda params, kvs, ids, lens, *a, **k: (ids, kvs, lens)  # noqa: E731
    table = {
        model: dict(init_serving_params=lambda *a, **k: "params", quantize_lm_head=identity,
                    make_serving_state=lambda *a, **k: _FakeState(calls), decode_burst=burst_ret,
                    make_mixed_step_fns=lambda *a, **k: ("prefill", "decode", "chunk")),
        moe: dict(init_moe_serving_params=lambda *a, **k: "params", decode_burst_moe=burst_ret),
        lora: dict(init_llama_lora=lambda *a, **k: "lora", lora_decode_burst=lora_ret,
                   make_lora_step_fns=lambda *a, **k: ("prefill", "decode")),
        base: dict(init_bf16_params=lambda *a, **k: "params", init_w8_params=lambda *a, **k: "params",
                   init_w4a16_params=lambda *a, **k: "params", make_dense_kv=lambda *a, **k: "dense_kv",
                   bf16_decode_burst=base_ret, w8a8_decode_burst=base_ret, w4a16_decode_burst=base_ret,
                   make_baseline_step_fns=lambda *a, **k: ("prefill", "decode")),
    }
    for mod, fns in table.items():
        for name, ret in fns.items():
            monkeypatch.setattr(mod, name, _recorder(calls, name, getattr(mod, name), ret))

    class Engine:
        def __init__(self, tg, pool, prefill_fn, decode_fn, state, chunk_fn=None, lora=False):
            calls.append(("TextGenEngine", dict(tg=_plain(tg), pool=[pool.n_pages, pool.page_size, pool.num_free_pages],
                                                steps=[prefill_fn, decode_fn], state=_plain(state),
                                                chunk_fn=chunk_fn, lora=lora)))

        def run(self, rs, **kw):
            calls.append(("run", dict(prompt_lens=_plain(rs.prompt_lens), output_lens=_plain(rs.output_lens),
                                      prompts=_plain(rs.prompts), adapter_ids=_plain(rs.adapter_ids), kw=kw)))
            return {}

    monkeypatch.setattr(serving, "TextGenEngine", Engine)

    def slope(run, batch, n_hi):
        calls.append(("_slope_tok_s", dict(batch=batch, n_hi=n_hi, runs=[run(2), run(n_hi)])))
        return 1.0, 1.0

    monkeypatch.setattr(bench, "_slope_tok_s", slope)


CELLS = {
    "w4a4_bf16_head": lambda b, cfg, kw: b.burst_throughput_w4a4(cfg, 32, 512, head="bf16", **kw),
    "w4a4_w8a16_head": lambda b, cfg, kw: b.burst_throughput_w4a4(cfg, 32, 512, head="w8a16", **kw),
    "w4a4_w4a16_head_64_steps": lambda b, cfg, kw: b.burst_throughput_w4a4(cfg, 16, 1000, n_steps=64, head="w4a16",
                                                                           **kw),
    "moe": lambda b, cfg, kw: b.burst_throughput_moe(32, 512, **kw),
    "lora": lambda b, cfg, kw: b.burst_throughput_lora(cfg, 32, 512, **kw),
    "lora_rank_64_bf16_head": lambda b, cfg, kw: b.burst_throughput_lora(cfg, 8, 300, rank=64, head="bf16", **kw),
    "bf16": lambda b, cfg, kw: b.burst_throughput_baseline(cfg, 32, 512, "bf16", **kw),
    "w8a8": lambda b, cfg, kw: b.burst_throughput_baseline(cfg, 32, 512, "w8a8", **kw),
    "w4a16_48_steps": lambda b, cfg, kw: b.burst_throughput_baseline(cfg, 16, 700, "w4a16", n_steps=48, **kw),
    "engine_w4a4_mixed": lambda b, cfg, kw: b.engine_run(cfg, 32, 64, "w4a4", **kw),
    "engine_w4a4_serial": lambda b, cfg, kw: b.engine_run(cfg, 32, 64, "w4a4", sched="serial", **kw),
    "engine_lora": lambda b, cfg, kw: b.engine_run(cfg, 16, 40, "lora", **kw),
    "engine_bf16": lambda b, cfg, kw: b.engine_run(cfg, 32, 64, "bf16", sched="serial", **kw),
    "engine_w8a8": lambda b, cfg, kw: b.engine_run(cfg, 32, 64, "w8a8", sched="serial", **kw),
    "engine_w4a16": lambda b, cfg, kw: b.engine_run(cfg, 8, 12, "w4a16", **kw),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cells_make_the_jax_calls(cell, monkeypatch):
    calls = {"jax": [], "port": []}
    _record_package(monkeypatch, (jm, jmoe, jlora, jbl, jserving, jbt), calls["jax"])
    _record_package(monkeypatch, (tm, tmoe, tlora, tbl, tserving, tbt), calls["port"])
    out = {"jax": CELLS[cell](jbt, jbt.model_cfg("7b", 4), {}),
           "port": CELLS[cell](tbt, tbt.model_cfg("7b", 4), {"device": "cpu"})}
    assert calls["port"] == calls["jax"]
    assert _plain(out["port"]) == _plain(out["jax"])
    names = [name for name, _ in calls["port"]]
    assert names and ("TextGenEngine" in names) == cell.startswith("engine")


def test_engine_run_has_no_moe_stack():
    for mod, kw in ((jbt, {}), (tbt, {"device": "cpu"})):
        with pytest.raises(ValueError, match="no moe stack"):
            mod.engine_run(mod.model_cfg("7b", 1), 4, 1, "moe", **kw)


# ---------------------------------------------------------------------------
# for real, at TINY width
# ---------------------------------------------------------------------------


def _jax_engine_keys():
    """The result keys of the JAX package's ``TextGenEngine.run`` (step
    functions that compute nothing)."""
    from atom_tpu.serving import KvPool, TextGenConfig, TextGenEngine, synth_requests

    tg = TextGenConfig(batch_size=2, max_seq_len=256, page_size=64, prefill_buckets=(64, 128))

    def prefill_fn(state, ids, table_row, true_len, slot):
        return jnp.int32(1), state

    def decode_fn(state, ids, page_table, seq_lens):
        return jnp.ones_like(ids), state

    engine = TextGenEngine(tg, KvPool(1, 16, 1, 64, 64), prefill_fn, decode_fn, jnp.zeros((1,)))
    return set(engine.run(synth_requests(3, 64, maxlen=100)))


def test_bursts_and_engine_for_real(monkeypatch):
    rates = {
        "w4a4": tbt.burst_throughput_w4a4(TINY1, 2, 64, head="w8a16", device="cpu"),
        "lora": tbt.burst_throughput_lora(TINY1, 2, 64, device="cpu"),
        **{k: tbt.burst_throughput_baseline(TINY1, 2, 64, k, device="cpu") for k in ("bf16", "w8a8", "w4a16")},
    }
    monkeypatch.setattr(tbt, "ModelConfig", lambda **kw: TINY_MIXTRAL.replace(num_layers=kw["num_layers"]))
    rates["moe"] = tbt.burst_throughput_moe(2, 64, layers=1, device="cpu")
    for stack, (tok_s, per_step) in rates.items():
        assert math.isfinite(tok_s) and tok_s > 0 and per_step > 0, stack
    keys = _jax_engine_keys()
    for stack, sched in (("w4a4", "mixed"), ("w4a4", "serial"), ("lora", "serial"), ("w8a8", "serial")):
        res = tbt.engine_run(TINY1, 2, 3, stack, sched=sched, device="cpu")
        assert set(res) == keys, stack
        want = tserving.synth_requests(3, TINY1.vocab_size, maxlen=900)
        assert res["requests"] == 3 and res["output_tokens"] == want.total_output_tokens
        assert res["throughput_tok_s"] > 0 and (res["mixed_steps"] > 0) == (sched == "mixed"), (stack, sched)


# ---------------------------------------------------------------------------
# bench_kernels
# ---------------------------------------------------------------------------


def _rows(text: str) -> list:
    return [line for line in text.splitlines() if re.search(r" us(  |$)", line)]


def test_bench_kernels_rows_match_jax(monkeypatch, capsys):
    seen = {"jax": 0, "port": 0}

    def stub(name):
        def bench(op, args, *, iters=100, **kw):
            seen[name] += 1
            return 1e-4 * (1 + iters / 100)
        return bench

    # operands that no stubbed bench_op reads: 7B-width weights, KV pages and adapter stores
    monkeypatch.setattr(jbk, "bench_op", stub("jax"))
    monkeypatch.setattr(jbk, "quantize_weight_packed", lambda w, spec: w[:1, :1])
    monkeypatch.setattr(jbk, "pack_for_kernel", lambda w: w)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    real_j_pages, real_t_pages = jbk.make_kv_pages_kernel, tbk.make_kv_pages_kernel
    monkeypatch.setattr(jbk, "make_kv_pages_kernel", lambda n, h, s, d: real_j_pages(1, 1, 2, 2))
    monkeypatch.setattr(jlora, "init_llama_lora", lambda *a, **k: types.SimpleNamespace(q=None))
    jbk.main(["--quick"])
    want = _rows(capsys.readouterr().out)
    monkeypatch.setattr(tbk, "bench_op", stub("port"))
    monkeypatch.setattr(tbk, "_packed_weight", lambda gen, k, n, dev: None)
    monkeypatch.setattr(tbk, "make_kv_pages_kernel", lambda n, h, s, d, dev: real_t_pages(1, 1, 2, 2, dev))
    monkeypatch.setattr(tbk, "init_llama_lora", lambda *a, **k: types.SimpleNamespace(q=None))
    tbk.main(["--quick", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "device: cpu"
    got = _rows(out)
    assert got == want and len(got) == 4 * 3 + 6 + 1 + 1 == seen["port"] == seen["jax"]
    for only, n in (("gemm", 12), ("epilogue", 6), ("decode", 1), ("lora", 1)):
        tbk.main(["--quick", "--only", only, "--device", "cpu"])
        assert len(_rows(capsys.readouterr().out)) == n
