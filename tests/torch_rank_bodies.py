"""Rank bodies of the port's parallel tests (``tests/test_torch_serving_tp.py``,
``test_torch_moe_ep.py``, ``test_torch_serving_sp.py``,
``test_torch_serving_dp.py``, ``test_torch_parallel.py``).

``parallel.launch.run_ranks`` spawns fresh interpreters that import this
module by name, so it imports only ``torch``, numpy and the port, never
JAX or a test module.  Each body builds its mesh, runs every case of its
test file and returns plain tensors and numbers; the test files compare
them with the port's single-device steps (``drive``, run in the test
process) and with the JAX package.
"""
from __future__ import annotations

import torch

from atom_tpu_torch.serving import model as tm


def _threads():
    torch.set_num_threads(1)


def drive(prefill_fn, decode_fn, state, prompt, bucket: int, table_row, n_steps: int, other_id: int = 0):
    """The JAX parallel tests' protocol: ``prompt`` prefilled into slot 0 of
    a batch of 2 (bucket-padded, pages ``table_row``), then ``n_steps``
    decode steps with slot 0 live and slot 1 idle (``other_id`` its id) ->
    (tokens of slot 0, the state after the prefill's and every step's
    tokens, final state)."""
    ids = torch.zeros(bucket, dtype=torch.int32)
    ids[: len(prompt)] = torch.as_tensor(prompt, dtype=torch.int32)
    table_row = torch.as_tensor(table_row, dtype=torch.int32)
    tok, state = prefill_fn(state, ids, table_row, len(prompt), 0)
    toks = [int(tok)]
    table = torch.stack([table_row, torch.zeros_like(table_row)])
    lens = len(prompt)
    for _ in range(n_steps):
        lens += 1
        nxt, state = decode_fn(state, torch.tensor([toks[-1], other_id], dtype=torch.int32), table,
                               torch.tensor([lens, 0], dtype=torch.int32))
        toks.append(int(nxt[0]))
    return toks, state


def state_tensors(state) -> dict:
    """Pages and ring of a serving state, by layer and field, on the CPU."""
    out = {}
    for l, (pg, hot) in enumerate(zip(state.pages, state.hot)):
        for f in pg._fields:
            out[f"pages{l}.{f}"] = getattr(pg, f).cpu()
        for f in hot._fields:
            out[f"hot{l}.{f}"] = getattr(hot, f).cpu()
    out["flushed"] = state.flushed.cpu()
    return out


# heads lie on dim 1 of pages (k_pages, v_pages), dim 2 of params and of the ring's prm, dim 1 of the ring's codes
HEAD_DIM = {"k_pages": 1, "v_pages": 1, "params": 2, "k_codes": 1, "prm": 2, "v_codes": 1}


def join_heads(shards: list) -> dict:
    """The whole state from per-rank state tensors split by kv head."""
    out = {}
    for key in shards[0]:
        field = key.split(".")[-1]
        out[key] = shards[0][key] if key == "flushed" else torch.cat([s[key] for s in shards], dim=HEAD_DIM[field])
    return out


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------


def heads_of(state, i: int, n: int):
    """Rank ``i`` of ``n``'s kv heads of a whole serving state (copies)."""
    def cut(t, dim):
        h = t.shape[dim] // n
        return t.narrow(dim, i * h, h).clone()

    pages = [type(pg)(*(cut(getattr(pg, f), HEAD_DIM[f]) for f in pg._fields)) for pg in state.pages]
    hot = [type(h)(*(cut(getattr(h, f), HEAD_DIM[f]) for f in h._fields)) for h in state.hot]
    return tm.ServingState(pages=pages, hot=hot, row=state.row, flushed=state.flushed.clone())


def _serve_cases(mesh, axis, shard, step_fns, cases, step_case) -> dict:
    """The protocol cases and the seeded step of ``tp_body`` / ``ep_body`` on
    ``mesh``'s ``axis``: ``shard(params, cfg, mesh, axis)`` and
    ``step_fns(sparams, cfg, spec, mesh, axis)``."""
    from atom_tpu_torch.parallel.mesh import axis_index, axis_size
    from atom_tpu_torch.serving.parallel import make_state_sharded

    out = {}
    for name, (params, cfg, spec, prompt, bucket, table_row, n_steps, n_pages, page) in cases.items():
        state = make_state_sharded(cfg.num_layers, n_pages, 2, cfg.num_kv_heads, page, cfg.head_dim, mesh, axis,
                                   device="cpu")
        fns = step_fns(shard(params, cfg, mesh, axis), cfg, spec, mesh, axis)
        toks, state = drive(*fns, state, prompt, bucket, table_row, n_steps)
        out[name] = (toks, state_tensors(state))
    if step_case is not None:
        params, cfg, spec, state, ids, table, lens = step_case
        _, decode_fn = step_fns(shard(params, cfg, mesh, axis), cfg, spec, mesh, axis)
        nxt, state = decode_fn(heads_of(state, axis_index(mesh, axis), axis_size(mesh, axis)), ids, table, lens)
        out["step"] = (nxt, state_tensors(state))
    return out


def tp_body(rank, world, dev, cases, step_case):
    """At tp = world: every protocol case of ``cases`` ({name: (params, cfg,
    spec, prompt, bucket, table_row, n_steps, n_pages, page)}) -> {name:
    (tokens, this rank's state tensors)}; and ``step_case`` (params, cfg,
    spec, whole state, ids, table, lens): one decode step (no flush) from
    this rank's heads of the state -> ("step", (next ids, state tensors))."""
    from atom_tpu_torch.parallel.mesh import make_mesh
    from atom_tpu_torch.serving.parallel import make_tp_step_fns, shard_serving_params

    _threads()
    return _serve_cases(make_mesh((world,), ("tp",)), "tp", shard_serving_params, make_tp_step_fns, cases, step_case)


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------


def ep_body(rank, world, dev, cases_by_ep, step_case, step_ep):
    """Expert parallelism: ``cases_by_ep`` {ep: cases} as ``tp_body``'s, each
    on a (world / ep, ep) mesh ("dp", "ep"); ``step_case`` at ``step_ep`` ->
    {ep: {name: (tokens, this rank's state tensors)}, "step": ...}."""
    from atom_tpu_torch.parallel.mesh import make_mesh
    from atom_tpu_torch.serving.moe import make_moe_ep_step_fns, shard_moe_serving_params

    _threads()
    out = {}
    for ep, cases in cases_by_ep.items():
        mesh = make_mesh((world // ep, ep), ("dp", "ep"))
        out[ep] = _serve_cases(mesh, "ep", shard_moe_serving_params, make_moe_ep_step_fns, cases,
                               step_case if ep == step_ep else None)
    out["step"] = out[step_ep].pop("step")
    return out


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------


def _prefill_once(prefill_fn, state, prompt, bucket, table_row):
    ids = torch.zeros(bucket, dtype=torch.int32)
    ids[: len(prompt)] = torch.as_tensor(prompt, dtype=torch.int32)
    return prefill_fn(state, ids, torch.as_tensor(table_row, dtype=torch.int32), len(prompt), 0)


def sp_body(rank, world, dev, sp_case, sp_tp_case):
    """``sp_case`` (params, cfg, spec, prompt, bucket, table_row, n_pages,
    page, kernel): prefill at sp = world, the attention through the flash
    kernel's plain version when ``kernel``; ``sp_tp_case`` the same at sp 2
    x tp 2, then one decode step on ``make_tp_step_fns`` over the tp axis ->
    {"sp": (token, state tensors), "sp_tp": (token, this rank's state
    tensors, the decode step's next id)}."""
    import atom_tpu_torch.serving.model as model
    from atom_tpu_torch.parallel.mesh import make_mesh
    from atom_tpu_torch.serving.parallel import make_state_sharded, make_tp_step_fns, shard_serving_params
    from atom_tpu_torch.serving.sp import make_sp_prefill_fn, make_sp_tp_prefill_fn

    _threads()
    out = {}
    mesh = make_mesh((world,), ("sp",))
    for name, (params, cfg, spec, prompt, bucket, table_row, n_pages, page, kernel) in sp_case.items():
        model.PREFILL_KERNEL_THRESHOLD = 0 if kernel else 10**9
        state = model.make_serving_state(cfg.num_layers, n_pages, 1, cfg.num_kv_heads, page, cfg.head_dim, "cpu")
        tok, state = _prefill_once(make_sp_prefill_fn(params, cfg, spec, mesh), state, prompt, bucket, table_row)
        out[name] = (int(tok), state_tensors(state))
    model.PREFILL_KERNEL_THRESHOLD = 10**9

    params, cfg, spec, prompt, bucket, table_row, n_pages, page = sp_tp_case
    mesh = make_mesh((2, world // 2), ("sp", "tp"))
    sparams = shard_serving_params(params, cfg, mesh)
    state = make_state_sharded(cfg.num_layers, n_pages, 1, cfg.num_kv_heads, page, cfg.head_dim, mesh, device="cpu")
    tok, state = _prefill_once(make_sp_tp_prefill_fn(sparams, cfg, spec, mesh), state, prompt, bucket, table_row)
    prefilled = state_tensors(state)
    _, decode_fn = make_tp_step_fns(sparams, cfg, spec, mesh)
    nxt, _ = decode_fn(state, tok.reshape(1), torch.as_tensor([table_row], dtype=torch.int32),
                       torch.tensor([len(prompt) + 1], dtype=torch.int32))
    out["sp_tp"] = (int(tok), prefilled, int(nxt[0]))
    return out


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------


def dp_body(rank, world, dev, params, cfg, spec, tg, rs):
    """dp 2 groups of tp world / 2 over the mesh ("dp", "tp") ->
    ``run_data_parallel``'s result (with transcripts) and this rank's
    group's pool (free pages, pages)."""
    from atom_tpu_torch.parallel.mesh import make_mesh
    from atom_tpu_torch.serving.dp import make_dp_tp_engines, run_data_parallel

    _threads()
    mesh = make_mesh((2, world // 2), ("dp", "tp"))
    engines = make_dp_tp_engines(params, cfg, spec, tg, mesh, dp=2, tp=world // 2)
    res = run_data_parallel(engines, rs, record=True, mesh=mesh)
    return res, (engines[0].pool.num_free_pages, engines[0].pool.n_pages)


# ---------------------------------------------------------------------------
# the accuracy models on DTensor, and the launcher's failure paths
# ---------------------------------------------------------------------------


def dtensor_body(rank, world, dev, cases):
    """``cases`` {name: (family, params, cfg, spec, ids)} through the family's
    ``forward`` on params sharded by its spec over a (2, world / 2) ("dp",
    "tp") mesh and ids sharded on dp -> {name: whole logits}."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from atom_tpu_torch.models import llama, mixtral, opt
    from atom_tpu_torch.parallel import shardings
    from atom_tpu_torch.parallel.mesh import make_mesh

    _threads()
    mesh = make_mesh((2, world // 2), ("dp", "tp"))
    families = {"llama": (llama, shardings.llama_param_specs()), "mixtral": (mixtral, shardings.mixtral_param_specs()),
                "opt": (opt, shardings.opt_param_specs())}
    out = {}
    for name, (family, params, cfg, spec, ids) in cases.items():
        mod, specs = families[family]
        sharded = shardings.shard_params(params, specs, mesh)
        with implicit_replication():
            logits = mod.forward(sharded, distribute_tensor(ids, mesh, shardings.data_sharding()), cfg, spec)
        out[name] = logits.full_tensor()
    return out


def failing_body(rank, world, dev):
    """Rank 1 raises; the others wait in a collective it never joins."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()


def hanging_body(rank, world, dev):
    """Rank 0 never returns."""
    import time

    if rank == 0:
        time.sleep(3600)
    return rank
