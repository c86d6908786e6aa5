"""The port's KV pool, workload generator and continuous-batching engine held
against the JAX package's: host-side bookkeeping equal step for step, the
counterparts of the JAX serving tests, and the slice as a whole
(``TextGenEngine.run`` on the same converted weights in both packages).

Geometry: the JAX serving tests' TINY model (vocab 199, hidden 256, 2 layers,
2 heads of 128: the unfused qkv path) and a GQA model on the fused path (K7),
page 128, W 32.  The JAX side runs its Pallas kernels in interpret mode, the
port its plain versions.
"""
import jax
import numpy as np
import pytest
import torch

from atom_tpu.config import QuantSpec
from atom_tpu.models.configs import Arch, ModelConfig
from atom_tpu.serving import engine as jeng
from atom_tpu.serving import kvpool as jpool
from atom_tpu.serving import model as jm
from atom_tpu.serving import workload as jwl
from atom_tpu_torch import native as native_mod
from atom_tpu_torch.config import QuantSpec as TQuantSpec
from atom_tpu_torch.models.configs import Arch as TArch
from atom_tpu_torch.models.configs import ModelConfig as TModelConfig
from atom_tpu_torch.serving import KvPool, RequestSet, SeqKvCache, TextGenConfig, TextGenEngine, synth_requests
from atom_tpu_torch.serving import model as tm
from atom_tpu_torch.serving.convert import serving_params_from_numpy
from atom_tpu_torch.serving.kvpool import batch_page_table
from test_torch_serving import cap_torch_threads

cap_torch_threads()

TINY_KW = dict(vocab_size=199, hidden_size=256, intermediate_size=384, num_layers=2,
               num_heads=2, num_kv_heads=2, head_dim=128, max_position_embeddings=512)
GQA_KW = dict(vocab_size=199, hidden_size=512, intermediate_size=768, num_layers=2,
              num_heads=8, num_kv_heads=4, head_dim=128, max_position_embeddings=512)
JTINY, TTINY = ModelConfig(arch=Arch.LLAMA, **TINY_KW), TModelConfig(arch=TArch.LLAMA, **TINY_KW)
JSPEC, TSPEC = QuantSpec(weight_channel_group=1), TQuantSpec(weight_channel_group=1)
PAGE = 128


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def tiny_params():
    jparams = jm.init_serving_params(jax.random.PRNGKey(0), JTINY, JSPEC)
    return jparams, serving_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")


# ---------------------------------------------------------------------------
# host-side bookkeeping
# ---------------------------------------------------------------------------


def test_kvpool_matches_jax_step_for_step():
    """The same scripted admissions, extensions and releases give the same page
    ids, tables and lengths in both packages (same allocation order)."""
    pools = (jpool.KvPool(2, 20, 2, 16, 128), KvPool(2, 20, 2, 16, 128))
    seqs = ([], [])
    rng = np.random.default_rng(0)
    for step in range(60):
        op = rng.integers(0, 4)
        arg = int(rng.integers(1, 40))
        for (pool, live, mod) in zip(pools, seqs, (jpool, None)):
            cache_cls = jpool.SeqKvCache if mod else SeqKvCache
            if op == 0 and pool.num_free_pages >= pool.pages_for(arg) and len(live) < 6:
                live.append(cache_cls(pool, arg))
            elif op == 1 and live:
                live.pop(arg % len(live)).release()
            elif live:
                s = live[arg % len(live)]
                if pool.num_free_pages:
                    s.acquire_one() if op == 2 else s.append_slot()
        assert pools[0].num_free_pages == pools[1].num_free_pages
        assert [s.page_ids for s in seqs[0]] == [s.page_ids for s in seqs[1]]
        rows = ([*seqs[0], None], [*seqs[1], None])
        (jt, jl), (tt, tl) = jpool.batch_page_table(rows[0], 8), batch_page_table(rows[1], 8)
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tl, jl)
        assert tt.dtype == np.int32 and tl.dtype == np.int32
    with pytest.raises(RuntimeError, match="KV pool exhausted"):
        pools[1].alloc(pools[1].num_free_pages + 1)
    assert 0 not in [p for s in seqs[1] for p in s.page_ids]  # page 0 is the sink


@pytest.mark.parametrize("kw", [dict(num_requests=64, vocab_size=32000, maxlen=2048),
                                dict(num_requests=12, vocab_size=199, maxlen=300, seed=5)])
def test_synth_requests_match_jax(kw):
    want, got = jwl.synth_requests(**kw), synth_requests(**kw)
    np.testing.assert_array_equal(got.prompt_lens, want.prompt_lens)
    np.testing.assert_array_equal(got.output_lens, want.output_lens)
    assert len(got) == len(want) == kw["num_requests"]
    for a, b in zip(got.prompts, want.prompts):
        np.testing.assert_array_equal(a, b)
    assert got.total_tokens == want.total_tokens and got.total_output_tokens == want.total_output_tokens


# ---------------------------------------------------------------------------
# counterparts of tests/test_serving.py
# ---------------------------------------------------------------------------


def _make_engine(tparams, batch_size=4, n_pages=24):
    pool = KvPool(TTINY.num_layers, n_pages, TTINY.num_kv_heads, PAGE, TTINY.head_dim)
    state = tm.make_serving_state(TTINY.num_layers, n_pages, batch_size, TTINY.num_kv_heads, PAGE, TTINY.head_dim,
                                  device="cpu")
    cfg = TextGenConfig(batch_size=batch_size, page_size=PAGE, max_seq_len=512, prefill_buckets=(64, 128))
    return TextGenEngine(cfg, pool, *tm.make_step_fns(tparams, TTINY, TSPEC), state), pool


def _workload(seed, n_req, vocab):
    rng = np.random.Generator(np.random.PCG64(seed))
    prompt_lens = rng.integers(3, 40, n_req).astype(np.int32)
    output_lens = rng.integers(2, 50, n_req).astype(np.int32)
    prompts = [rng.integers(1, vocab, p).astype(np.int32) for p in prompt_lens]
    return prompt_lens, output_lens, prompts


def test_engine_completes_workload(tiny_params):
    engine, pool = _make_engine(tiny_params[1])
    prompt_lens, output_lens, prompts = _workload(3, 6, TTINY.vocab_size)
    free_before = pool.num_free_pages
    result = engine.run(RequestSet(prompt_lens, output_lens, prompts))
    assert result["requests"] == 6
    assert result["output_tokens"] == int(output_lens.sum())
    assert result["throughput_tok_s"] > 0 and result["scheduler"] == "python"
    assert pool.num_free_pages == free_before  # all pages returned to the pool
    assert [b for b, _ in engine.last_prefill_s] == [64] * 6 and engine.device.type == "cpu"


def _decode_prefill_consistency(cfg, spec, params, n_gen=40):
    """Prefill a prompt and decode ``n_gen`` tokens step by step (crossing the
    W=32 flush at lengths 32 and 64), then prefill prompt + generated[:k] afresh
    and compare its next-token prediction with generated[k]."""
    n_pages = 12
    pool = KvPool(cfg.num_layers, n_pages, cfg.num_kv_heads, PAGE, cfg.head_dim)
    state = tm.make_serving_state(cfg.num_layers, n_pages, 1, cfg.num_kv_heads, PAGE, cfg.head_dim, device="cpu")
    rng = np.random.Generator(np.random.PCG64(9))
    prompt = rng.integers(1, cfg.vocab_size, 27).astype(np.int32)

    def prefill(seq, bucket, state):
        kv = SeqKvCache(pool, len(seq))
        ids = np.zeros((bucket,), np.int32)
        ids[: len(seq)] = seq
        tr = np.zeros((4,), np.int32)
        tr[: len(kv.page_ids)] = kv.page_ids
        tok, state = tm.prefill_step(params, state, _t(ids), _t(tr), len(seq), 0, cfg, spec)
        return int(tok), state, kv

    tok, state, kv = prefill(prompt, 32, state)
    generated = [tok]
    for i in range(n_gen - 1):
        kv.acquire_one()
        table, lens = batch_page_table([kv], 4)
        tok, state = tm.decode_step(params, state, torch.tensor([generated[-1]], dtype=torch.int32), _t(table),
                                    _t(lens), cfg, spec, flush=((i + 1) % 32 == 0))
        generated.append(int(tok[0]))

    mismatches = 0
    checks = (1, 4, 5, 6, 37, 38, n_gen - 1)
    for k in checks:
        seq = np.concatenate([prompt, np.asarray(generated[:k], np.int32)])
        tok2, state, kv2 = prefill(seq, 128, state)
        mismatches += tok2 != generated[k]
        kv2.release()
    return mismatches, len(checks)


@pytest.mark.parametrize("geom", ["mha_unfused", "gqa_fused"])
def test_decode_matches_prefill_continuation(geom):
    """Step-by-step decode (hot ring, bulk flushes, paged attention) reproduces
    the tokens a longer prefill predicts, by the JAX test's majority: at most 2
    of 7 checks may diverge (prefill and decode sum in other orders, and a KV
    code on a rounding boundary can flip a near-tie argmax).  The GQA geometry
    takes the fused qkv epilogue (K7) at prefill and, at batch 1, the fallback
    branch (K7 + ``write_hot``) at decode."""
    kw = TINY_KW if geom == "mha_unfused" else GQA_KW
    cfg = TModelConfig(arch=TArch.LLAMA, **kw)
    spec = TSPEC if geom == "mha_unfused" else TSPEC.replace(fused_serving=False)
    params = tm.init_serving_params(cfg, spec, seed=1, device="cpu")
    mismatches, n = _decode_prefill_consistency(cfg, spec, params)
    assert mismatches <= 2, f"{mismatches}/{n} prefill-continuation checks diverged"


def test_engine_error_paths(tiny_params, monkeypatch):
    """Prompt over the largest bucket -> ValueError; KV pool exhaustion ->
    RuntimeError; ``lora=True`` beside a ``chunk_fn`` -> ValueError (LoRA
    prefills serially); ``native=True`` when the C++ scheduler cannot be
    built -> that error, where ``"auto"`` takes the Python pool; ``chunk_fn``
    alone selects mixed scheduling."""
    engine, pool = _make_engine(tiny_params[1], batch_size=2, n_pages=24)
    rng = np.random.Generator(np.random.PCG64(4))
    long_prompt = rng.integers(1, TTINY.vocab_size, 300).astype(np.int32)
    rs = RequestSet(np.asarray([300], np.int32), np.asarray([4], np.int32), [long_prompt])
    with pytest.raises(ValueError, match="exceeds largest prefill bucket"):
        engine.run(rs)

    small_pool = KvPool(TTINY.num_layers, 2, TTINY.num_kv_heads, PAGE, TTINY.head_dim)
    with pytest.raises(RuntimeError, match="exhausted"):
        small_pool.alloc(5)
    engine2, _ = _make_engine(tiny_params[1], batch_size=2, n_pages=2)
    prompt_lens, output_lens, prompts = _workload(3, 2, TTINY.vocab_size)
    with pytest.raises(RuntimeError, match="KV pool exhausted"):
        engine2.run(RequestSet(prompt_lens, output_lens, prompts))

    pre, dec, chunk = tm.make_mixed_step_fns(tiny_params[1], TTINY, TSPEC)
    with pytest.raises(ValueError, match="serially"):
        TextGenEngine(engine.cfg, pool, pre, dec, engine.state, chunk_fn=chunk, lora=True)

    def no_compiler():
        raise OSError("no C++ compiler")

    monkeypatch.setattr(native_mod, "load_native", no_compiler)
    fns = tm.make_step_fns(tiny_params[1], TTINY, TSPEC)
    with pytest.raises(OSError, match="compiler"):
        TextGenEngine(engine.cfg, pool, *fns, engine.state, native=True)
    assert TextGenEngine(engine.cfg, pool, *fns, engine.state, native="auto").nat is None
    monkeypatch.undo()

    # the chunk_fn entry: the engine takes it and serves the requests through it
    calls = []

    def counting_chunk(*args):
        calls.append(args[6:])  # (pos0, chunk_len, chunk_slot)
        return chunk(*args)

    engine3, pool3 = _make_engine(tiny_params[1], batch_size=2, n_pages=24)
    mixed = TextGenEngine(engine3.cfg, pool3, pre, dec, engine3.state, chunk_fn=counting_chunk)
    res = mixed.run(RequestSet(prompt_lens, output_lens, prompts))
    assert res["requests"] == 2 and res["output_tokens"] == int(output_lens.sum())
    assert [c[0] for c in calls] == [0, 0] and [c[2] for c in calls] == [0, 1] and mixed.last_prefill_s == []
    assert res["mixed_steps"] == 1 and pool3.num_free_pages == 23


def _serve_recording_tables(tparams, **kwargs):
    """Serve the tiny workload; return the tokens, the prefills' table rows and
    the decode steps' tables and lengths, and the pool's free pages after."""
    pool = KvPool(TTINY.num_layers, 24, TTINY.num_kv_heads, PAGE, TTINY.head_dim)
    state = tm.make_serving_state(TTINY.num_layers, 24, 2, TTINY.num_kv_heads, PAGE, TTINY.head_dim, device="cpu")
    cfg = TextGenConfig(batch_size=2, page_size=PAGE, max_seq_len=512, prefill_buckets=(64, 128))
    prefill, decode = tm.make_step_fns(tparams, TTINY, TSPEC)
    tables = []

    def rec_prefill(state, ids, table_row, true_len, slot):
        tables.append(("prefill", slot, table_row.numpy().copy()))
        return prefill(state, ids, table_row, true_len, slot)

    def rec_decode(state, ids, page_table, seq_lens):
        tables.append(("decode", page_table.numpy().copy(), seq_lens.numpy().copy()))
        return decode(state, ids, page_table, seq_lens)

    engine = TextGenEngine(cfg, pool, rec_prefill, rec_decode, state, **kwargs)
    res = engine.run(RequestSet(*_workload(3, 4, TTINY.vocab_size)), record=True)
    free = engine.nat.num_free_pages if engine.nat is not None else pool.num_free_pages
    return res["tokens"], tables, free, res["scheduler"]


@pytest.mark.parametrize("native", ["auto", None, 0], ids=["auto", "None", "0"])
def test_engine_native_auto_or_off_serves_through_python_pool(tiny_params, native):
    """``native="auto"`` means "use the C++ scheduler if it builds": it builds
    here, so it serves through the port's native scheduler, and it never
    raises (fault C1; ``test_engine_error_paths`` takes away the compiler).
    ``None`` and ``0`` are false, as the JAX engine tests them, and serve
    through the Python pool.  Every way gives ``native=False``'s tokens and
    page tables and lengths at every step, and every page comes back."""
    want_tokens, want_tables, want_free, want_sched = _serve_recording_tables(tiny_params[1], native=False)
    got_tokens, got_tables, got_free, got_sched = _serve_recording_tables(tiny_params[1], native=native)
    assert want_sched == "python" and got_sched == ("native" if native == "auto" else "python")
    assert got_tokens == want_tokens and got_free == want_free == 23
    assert len(got_tables) == len(want_tables) and any(t[0] == "decode" for t in got_tables)
    for got, want in zip(got_tables, want_tables):
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, b)


def test_late_joining_sequence_flush_correctness(tiny_params):
    """A request admitted mid-window (ring row 13 at its prefill) decodes
    correctly across the synchronized flush: its pending block spans only part
    of the ring, and columns written before it joined must stay masked.  Both
    sequences reproduce fresh-prefill continuations (at most 1 of 4 diverging,
    the JAX test's bound)."""
    params = tm.init_serving_params(TTINY, TSPEC, seed=6, device="cpu")
    n_pages = 16
    pool = KvPool(TTINY.num_layers, n_pages, TTINY.num_kv_heads, PAGE, TTINY.head_dim)
    state = tm.make_serving_state(TTINY.num_layers, n_pages, 2, TTINY.num_kv_heads, PAGE, TTINY.head_dim, device="cpu")
    rng = np.random.Generator(np.random.PCG64(12))
    prompt_a = rng.integers(1, TTINY.vocab_size, 19).astype(np.int32)
    prompt_b = rng.integers(1, TTINY.vocab_size, 11).astype(np.int32)

    def prefill(slot, seq, kv, bucket, state):
        ids = np.zeros((bucket,), np.int32)
        ids[: len(seq)] = seq
        tr = np.zeros((4,), np.int32)
        tr[: len(kv.page_ids)] = kv.page_ids
        tok, st = tm.prefill_step(params, state, _t(ids), _t(tr), len(seq), slot, TTINY, TSPEC)
        return int(tok), st

    kv_a = SeqKvCache(pool, len(prompt_a))
    tok_a, state = prefill(0, prompt_a, kv_a, 32, state)
    gen_a, gen_b, kv_b = [tok_a], [], None
    ids = np.zeros((2,), np.int32)
    for i in range(45):  # crosses the flush at step 32
        if i == 13:
            kv_b = SeqKvCache(pool, len(prompt_b))
            tok_b, state = prefill(1, prompt_b, kv_b, 32, state)
            assert state.row == 13 and state.flushed.tolist()[1] == len(prompt_b)
            gen_b.append(tok_b)
        kv_a.acquire_one()
        ids[0] = gen_a[-1]
        if kv_b is not None:
            kv_b.acquire_one()
            ids[1] = gen_b[-1]
        table, lens = batch_page_table([kv_a, kv_b], 4)
        tok, state = tm.decode_step(params, state, _t(ids.copy()), _t(table), _t(lens), TTINY, TSPEC,
                                    flush=((i + 1) % 32 == 0))
        gen_a.append(int(tok[0]))
        if kv_b is not None:
            gen_b.append(int(tok[1]))

    mismatches = checks = 0
    for prompt, gen in ((prompt_a, gen_a), (prompt_b, gen_b)):
        for k in (len(gen) - 6, len(gen) - 1):
            seq = np.concatenate([prompt, np.asarray(gen[:k], np.int32)])
            kv2 = SeqKvCache(pool, len(seq))
            tok2, state = prefill(0, seq, kv2, 128, state)
            checks += 1
            mismatches += tok2 != gen[k]
            kv2.release()
    assert mismatches <= 1, f"{mismatches}/{checks} continuations diverged"


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------


def _jax_engine_run(jparams, step_fns, requests, n_pages, bsz):
    jp = jpool.KvPool(JTINY.num_layers, n_pages, JTINY.num_kv_heads, PAGE, JTINY.head_dim)
    jstate = jm.make_serving_state(JTINY.num_layers, n_pages, bsz, JTINY.num_kv_heads, PAGE, JTINY.head_dim)
    jcfg = jeng.TextGenConfig(batch_size=bsz, page_size=PAGE, max_seq_len=512, prefill_buckets=(64, 128))
    res = jeng.TextGenEngine(jcfg, jp, *step_fns, jstate).run(jwl.RequestSet(*requests), record=True)
    return res, jp.num_free_pages


def _op_by_op_step_fns(jparams):
    """``make_step_fns`` over the JAX step functions without their outer
    ``jax.jit``: every op dispatched on its own, each Pallas kernel in interpret
    mode: the chain of roundings the port follows op by op."""
    from atom_tpu.ops.kv_hot import HOT_W

    prefill, decode = jm.prefill_step.__wrapped__, jm.decode_step.__wrapped__
    counter = {"n": 0}

    def prefill_fn(state, ids, table_row, true_len, slot):
        return prefill(jparams, state, ids, table_row, true_len, slot, JTINY, JSPEC)

    def decode_fn(state, ids, page_table, seq_lens):
        counter["n"] += 1
        return decode(jparams, state, ids, page_table, seq_lens, JTINY, JSPEC, flush=counter["n"] % HOT_W == 0)

    return prefill_fn, decode_fn


def test_engine_run_matches_jax(tiny_params):
    """``TextGenEngine.run(record=True)`` in both packages on the same weights
    and requests (batch 4, 8 requests of 3-39 prompt and 2-49 output tokens, so
    slots are refilled mid-window and the ring flushes).

    Against the JAX engine as its tests run it (jitted steps): the same result
    dictionary and schedule: decode-step count, tokens per request, pool drained
    back.  Its tokens are not compared: a jitted step is one XLA program whose
    quantizers sit 1 ulp off the op-by-op chain, and on these weights the JAX
    package's own two forms agree on the first token of only 4 of 8 requests
    (measured).

    Tokens are held to the JAX engine driving the same step functions op by
    op.  The first token of every request depends on its prompt alone and
    agrees in at least 7 of 8 requests (measured 8; the JAX tests accept 5 of 7
    for prefill against decode).  Later tokens are compared up to each
    request's first divergence, since from there the two continue different
    texts: at least 70% of all generated positions lie before it (measured
    108 of 126)."""
    jparams, tparams = tiny_params
    requests = _workload(3, 8, JTINY.vocab_size)
    output_lens = requests[1]
    n_pages, bsz = 24, 4
    jres, jfree = _jax_engine_run(jparams, jm.make_step_fns(jparams, JTINY, JSPEC), requests, n_pages, bsz)
    eres, efree = _jax_engine_run(jparams, _op_by_op_step_fns(jparams), requests, n_pages, bsz)
    engine, pool = _make_engine(tparams, bsz, n_pages)
    tres = engine.run(RequestSet(*requests), record=True)

    assert set(jres) == set(tres)
    for key in ("requests", "decode_steps", "mixed_steps", "total_tokens", "output_tokens", "scheduler", "prompt_lens"):
        assert tres[key] == jres[key] == eres[key], key
    assert pool.num_free_pages == jfree == efree == n_pages - 1
    first = before = total = 0
    for r in range(8):
        et, tt = eres["tokens"][r], tres["tokens"][r]
        assert len(tt) == len(et) == len(jres["tokens"][r]) == output_lens[r]
        assert all(0 <= t < TTINY.vocab_size for t in tt)
        first += tt[0] == et[0]
        same = np.asarray(tt) == np.asarray(et)
        before += len(same) if same.all() else int(np.argmin(same))
        total += len(same)
    assert first >= 7, f"first tokens agree in {first}/8 requests"
    assert before / total >= 0.7, f"{before}/{total} generated positions before the first divergence"
