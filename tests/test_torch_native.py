"""The port's native C++ scheduler (``atom_tpu_torch/native``) held against
Python bookkeeping, as ``tests/test_native_scheduler.py`` holds the JAX
package's: the same page tables and lengths step for step as the JAX
package's ``KvPool`` (the oracle, computed once per module) and the port's,
overflow and unservable requests rejected, and ``TextGenEngine(native=True)``
serving the same tokens and tables as ``native=False`` in serial and mixed
scheduling.  The library is built with ``g++`` at first use into
``atom_tpu_torch/build/``; it never loads the JAX package's copy.
"""
import numpy as np
import pytest

from atom_tpu.serving import kvpool as jpool
from atom_tpu_torch import native
from atom_tpu_torch.config import QuantSpec as TQuantSpec
from atom_tpu_torch.models.configs import Arch as TArch
from atom_tpu_torch.models.configs import ModelConfig as TModelConfig
from atom_tpu_torch.native import NativeScheduler
from atom_tpu_torch.serving import KvPool, RequestSet, SeqKvCache, TextGenConfig, TextGenEngine
from atom_tpu_torch.serving import model as tm
from atom_tpu_torch.serving.kvpool import batch_page_table
from test_torch_serving import cap_torch_threads

cap_torch_threads()

B, PAGES, S, MP = 4, 40, 128, 8
KW = dict(vocab_size=199, hidden_size=256, intermediate_size=384, num_layers=2, num_heads=2, num_kv_heads=2,
          head_dim=128)
TCFG = TModelConfig(arch=TArch.LLAMA, **KW)
TSPEC = TQuantSpec(weight_channel_group=1)
N_POOL = 24


def _requests():
    rng = np.random.Generator(np.random.PCG64(0))
    return [(i, int(rng.integers(10, 300)), int(rng.integers(3, 20))) for i in range(B)]


def _python_trace(kvpool, seq_cache, page_table):
    """Admit the requests into a Python pool, then step until all retire ->
    (each admission's table row, [(table, lens, finished ids, free pages)]
    per step)."""
    pool = kvpool.KvPool(2, PAGES, 2, S, 128) if kvpool is not None else KvPool(2, PAGES, 2, S, 128)
    cache = seq_cache if seq_cache is not None else SeqKvCache
    seqs, rows = {}, []
    for slot, (rid, p, o) in enumerate(_requests()):
        seqs[slot] = [cache(pool, p), o, rid]
        row = np.zeros((MP,), np.int32)
        row[: len(seqs[slot][0].page_ids)] = seqs[slot][0].page_ids
        rows.append(row)
    steps = []
    while seqs:
        for entry in seqs.values():
            entry[0].acquire_one()
        table, lens = page_table([seqs[s][0] if s in seqs else None for s in range(B)], MP)
        done = []
        for slot, entry in list(seqs.items()):
            entry[1] -= 1
            if entry[1] <= 0:
                done.append(entry[2])
                entry[0].release()
                del seqs[slot]
        steps.append((np.asarray(table), np.asarray(lens), done, pool.num_free_pages))
    return rows, steps


@pytest.fixture(scope="module")
def jax_trace():
    """The JAX package's ``KvPool`` bookkeeping of the scripted requests."""
    return _python_trace(jpool, jpool.SeqKvCache, jpool.batch_page_table)


def test_native_matches_python_bookkeeping(jax_trace):
    """Admission rows, then every step's table, lengths, retired requests and
    free pages: the native scheduler == the port's ``KvPool`` == the JAX
    package's, and every page comes back."""
    rows, steps = jax_trace
    assert len(steps) > 3
    for got_rows, got_steps in (_python_trace(None, None, batch_page_table), _native_trace()):
        assert len(got_steps) == len(steps)
        for a, b in zip(got_rows, rows):
            np.testing.assert_array_equal(a, b)
        for (ta, la, da, fa), (tb, lb, db, fb) in zip(got_steps, steps):
            np.testing.assert_array_equal(ta, tb)
            np.testing.assert_array_equal(la, lb)
            assert sorted(da) == sorted(db) and fa == fb
    assert steps[-1][3] == PAGES - 1


def _native_trace():
    nat = NativeScheduler(B, PAGES, S, MP)
    rows = []
    for rid, p, o in _requests():
        slot = nat.admit(rid, p, o)
        assert slot == rid and nat.seqlen(slot) == p
        rows.append(nat.table_row(slot).copy())
    steps = []
    while nat.num_active:
        table, lens, done = nat.decode_step()
        steps.append((table.copy(), lens.copy(), done, nat.num_free_pages))
    return rows, steps


def test_native_rejects_overflow():
    """-2 when the pool cannot hold a prompt, -1 when no slot is free."""
    nat = NativeScheduler(2, 6, 128, 8)  # 5 usable pages
    assert nat.admit(0, 300, 5) >= 0  # takes 3 pages
    assert nat.admit(1, 300, 5) == -2  # needs 3, only 2 free
    assert nat.admit(1, 50, 5) >= 0  # 1 page fits
    assert nat.admit(2, 50, 5) == -1  # no slot left
    assert nat.num_free_pages == 1
    for bad in (-1, 2):  # the C++ side indexes slots unchecked: the facade refuses
        with pytest.raises(IndexError):
            nat.table_row(bad)


def test_native_rejects_unservable_request():
    """A prompt + output needing more than ``max_pages`` pages -> -3 whatever
    the pool holds; through the engine, a ``ValueError`` naming it.  A
    prompt that the empty pool cannot hold: ``RuntimeError`` in both
    schedulers."""
    nat = NativeScheduler(2, 40, 128, 4)  # at most 4 * 128 = 512 tokens a sequence
    assert nat.admit(0, 500, 100) == -3
    assert nat.admit(1, 400, 100) >= 0
    assert nat.admit(2, 513, 1) == -3
    eng, _ = _engine(native=True, mixed=False)
    prompt = np.ones((300,), np.int32)
    with pytest.raises(ValueError, match="unservable"):
        eng.run(RequestSet(np.asarray([300], np.int32), np.asarray([300], np.int32), [prompt]))
    # a prompt the empty pool cannot hold raises as the Python pool does, where waiting would never end
    for native in (True, False):
        eng, _ = _engine(native=native, mixed=False, n_pool=2)
        with pytest.raises(RuntimeError, match="KV pool exhausted"):
            eng.run(RequestSet(np.asarray([300], np.int32), np.asarray([5], np.int32), [prompt]))


def _engine(native, mixed, params=None, n_pool=N_POOL):
    params = params if params is not None else tm.init_serving_params(TCFG, TSPEC, seed=1, device="cpu")
    tg = TextGenConfig(batch_size=2, page_size=S, max_seq_len=512, prefill_buckets=(128, 256, 512))
    pool = KvPool(TCFG.num_layers, n_pool, TCFG.num_kv_heads, S, TCFG.head_dim)
    state = tm.make_serving_state(TCFG.num_layers, n_pool, tg.batch_size, TCFG.num_kv_heads, S, TCFG.head_dim,
                                  device="cpu")
    if mixed:
        pre, dec, chunk = tm.make_mixed_step_fns(params, TCFG, TSPEC)
        return TextGenEngine(tg, pool, pre, dec, state, chunk_fn=chunk, native=native), pool
    return TextGenEngine(tg, pool, *tm.make_step_fns(params, TCFG, TSPEC), state, native=native), pool


def _recording(fn, log, kind):
    """``fn`` that first logs its tensor arguments (copied) and ints."""

    def call(state, *args):
        log.append((kind,) + tuple(a.numpy().copy() if hasattr(a, "numpy") else a for a in args))
        return fn(state, *args)

    return call


@pytest.mark.parametrize("mixed", [False, True], ids=["serial", "mixed"])
def test_engine_native_parity(mixed):
    """``TextGenEngine(native=True)`` == ``native=False``: the same arguments
    at every step (prefill table rows, page tables and lengths, chunks) and
    the same tokens, for outputs of 5, 8, 36 and 1 tokens (a single-token
    request, a ring flush); the native scheduler ends with every page free
    and no sequence active."""
    params = tm.init_serving_params(TCFG, TSPEC, seed=1, device="cpu")
    rng = np.random.Generator(np.random.PCG64(9))
    prompts = [rng.integers(1, TCFG.vocab_size, int(rng.integers(40, 300))).astype(np.int32) for _ in range(4)]
    rs = RequestSet(prompt_lens=np.asarray([len(p) for p in prompts]), output_lens=np.asarray([5, 8, 36, 1]),
                    prompts=prompts)
    runs = {}
    for nat in (False, True):
        eng, pool = _engine(nat, mixed, params)
        log = []
        eng.prefill_fn = _recording(eng.prefill_fn, log, "prefill")
        eng.decode_fn = _recording(eng.decode_fn, log, "decode")
        if mixed:
            eng.chunk_fn = _recording(eng.chunk_fn, log, "chunk")
        res = eng.run(rs, record=True)
        assert res["scheduler"] == ("native" if nat else "python") and pool.num_free_pages == N_POOL - 1
        if nat:
            assert eng.nat.num_free_pages == N_POOL - 1 and eng.nat.num_active == 0
        runs[nat] = (res["tokens"], log, res["decode_steps"], res["mixed_steps"])
    (tok_py, log_py, steps_py, mixed_py), (tok_nat, log_nat, steps_nat, mixed_nat) = runs[False], runs[True]
    assert tok_nat == tok_py and (steps_nat, mixed_nat) == (steps_py, mixed_py) and steps_py > 32
    assert (mixed_py > 0) == mixed and len(log_nat) == len(log_py)
    assert {e[0] for e in log_py} == ({"chunk", "decode"} if mixed else {"prefill", "decode"})
    for got, want in zip(log_nat, log_py):
        assert got[0] == want[0] and len(got) == len(want)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, b)


def test_native_builds_into_the_port_build_dir():
    """The library is the port's own build of its own source, under
    ``atom_tpu_torch/build/``, rebuilt under a new name when the source
    changes."""
    path = native._build()
    assert path.parent == native.BUILD and path.name.startswith("libatomserve-") and path.exists()
    assert native.SRC.parent.name == "native" and native.SRC.parent.parent.name == "atom_tpu_torch"
    assert native.load_native() is native.load_native()
