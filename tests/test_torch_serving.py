"""The port's decode slice held against the JAX package's serving model, plus
the port's isolation from JAX and its device policy.

Shared geometry: the smallest that takes the fused decode path (vocab 256,
hidden 512, inter 768, 2 layers, heads of 128, batch 32, page 256, W 32), MHA
and GQA.  The JAX side runs its Pallas kernels in interpret mode; the port
its plain versions.  Inputs and state come from seeded numpy arrays.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu.config import ATOM_W4A4
from atom_tpu.models.configs import Arch, ModelConfig
from atom_tpu.ops.kv_hot import HotKV as JHot
from atom_tpu.ops.kv_layout import KVPages as JPages
from atom_tpu.serving import model as jm
from atom_tpu_torch.config import ATOM_W4A4 as T_SPEC
from atom_tpu_torch.models.configs import Arch as TArch
from atom_tpu_torch.models.configs import ModelConfig as TModelConfig
from atom_tpu_torch.serving import model as tm
from atom_tpu_torch.serving.convert import serving_params_from_numpy, serving_state_from_numpy


def cap_torch_threads():
    """Give each pytest-xdist worker its share of the cores for torch's
    intra-op threads.  By default every worker's torch opens one thread per
    core, so N workers run N times as many threads as there are cores and
    the port's tests spend most of their time waiting on each other.
    Without xdist the worker count is unset and nothing changes.  Every
    ``tests/test_torch_*.py`` calls this at import, so the cap holds whichever
    file a worker collects first.  A process a test starts (a CLI run) keeps
    its thread a core but waits passively (``OMP_WAIT_POLICY``): spinning
    OpenMP threads beside busy workers took one ~2 s calibration past 120 s.
    The wait policy moves no result; a thread count does (a process-wide
    ``OMP_NUM_THREADS=1`` moved one perplexity test's figure by 7e-4)."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))
        os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")


cap_torch_threads()

REPO = Path(__file__).resolve().parents[1]
B, PAGE, W, MAX_PAGES = 32, 256, 32, 2
GEOMS = {"mha": (4, 4), "gqa": (8, 4)}


def _cfgs(heads, kv_heads):
    kw = dict(vocab_size=256, hidden_size=512, intermediate_size=768, num_layers=2,
              num_heads=heads, num_kv_heads=kv_heads, head_dim=128, max_position_embeddings=1024)
    return ModelConfig(arch=Arch.LLAMA, **kw), TModelConfig(arch=TArch.LLAMA, **kw)


def _bf16(x):
    return np.array(jnp.asarray(np.asarray(x, np.float32)).astype(jnp.bfloat16))


def _prm(rng, shape):
    """bf16 affine planes [.., 4, ..] like real codes': scale, zero = -7.5 scale."""
    s = rng.uniform(0.01, 0.06, (shape[0], 2) + shape[2:]).astype(np.float32)
    return _bf16(np.stack([s[:, 0], -7.5 * s[:, 0], s[:, 1], -7.5 * s[:, 1]], axis=1))


def _state(rng, kv_heads, flushed, row):
    n_pages = 1 + B * MAX_PAGES
    pages = [JPages(rng.integers(-128, 128, (n_pages, kv_heads, 64, PAGE)).astype(np.int8),
                    rng.integers(-128, 128, (n_pages, kv_heads, PAGE // 2, 128)).astype(np.int8),
                    _prm(rng, (n_pages, 4, kv_heads, PAGE))) for _ in range(2)]
    hot = [JHot(rng.integers(-128, 128, (B, kv_heads, 64, W)).astype(np.int8),
                _prm(rng, (B, 4, kv_heads, W)),
                rng.integers(0, 16, (B, kv_heads, W, 128)).astype(np.int8)) for _ in range(2)]
    return jm.ServingState(pages=pages, hot=hot, row=np.int32(row), flushed=flushed.astype(np.int32))


def _to_jax(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)), tree)


@pytest.fixture(scope="module", params=sorted(GEOMS))
def model(request):
    jcfg, tcfg = _cfgs(*GEOMS[request.param])
    jparams = jm.init_serving_params(jax.random.PRNGKey(0), jcfg, ATOM_W4A4)
    tparams = serving_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return request.param, jcfg, tcfg, jparams, tparams


def _inputs(rng, vocab):
    table = (1 + np.arange(B * MAX_PAGES).reshape(B, MAX_PAGES)).astype(np.int32)
    ids = rng.integers(0, vocab, B).astype(np.int32)
    return table, ids


def test_params_convert_bitwise(model):
    """Every array bitwise; a weight's body and keeper scales arrive merged,
    keeper scale last, as the port's GEMMs read them."""
    _, _, _, jparams, tparams = model

    def eq(t, a):
        a = np.asarray(a)
        a = a.view(np.int16) if a.dtype.name == "bfloat16" else a
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        np.testing.assert_array_equal(t.numpy(), a)

    for f in ("embed", "final_norm", "lm_head"):
        eq(getattr(tparams, f), getattr(jparams, f))
    assert len(tparams.layers) == len(jparams.layers)
    for jl, tl in zip(jparams.layers, tparams.layers):
        for f in tl._fields:
            jv, tv = getattr(jl, f), getattr(tl, f)
            if f.startswith("w"):
                eq(tv.body_packed, jv.body_packed)
                eq(tv.keeper, jv.keeper)
                eq(tv.scales, np.concatenate([np.asarray(jv.body_scale), np.asarray(jv.keeper_scale)[None]], 0))
            else:
                eq(tv, jv)


def test_decode_hidden_matches_jax(model):
    """One decode step's hidden states from a seeded state (no flush), bound
    as ``tests/test_serving.py::test_fused_decode_hidden_matches_unfused``
    bounds the JAX package's own two paths: quantization-boundary flips
    propagate through the dynamic activation scales, so only the share of
    elements moved by more than 0.05 and the largest move are bounded; a
    wiring error moves nearly every element.

    Against JAX's unfused decode path (eager quantization chain) the port is
    bitwise in most rows (measured: at most 5% of elements moved, max 0.97):
    share under 25%, max under 1.5.  Against JAX's fused path (the Pallas
    qkv kernel jitted on the CPU, whose quantizer scales are 1 ulp off, see
    ``test_torch_kernels``) the JAX package's own two paths differ by up to
    1.58 on these states (measured), so there the max bound is 2.0."""
    name, jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(10)
    table, ids = _inputs(rng, jcfg.vocab_size)
    flushed = rng.integers(0, 400, B)
    lens = (flushed + rng.integers(1, W + 1, B)).astype(np.int32)
    st = _state(rng, jcfg.num_kv_heads, flushed, row=9)
    xt, new = tm.decode_hidden(tparams, serving_state_from_numpy(st, "cpu"), torch.from_numpy(ids),
                               torch.from_numpy(table), torch.from_numpy(lens), tcfg, T_SPEC)
    assert new.row == 10
    xt = xt.to(torch.float32).numpy()
    for spec, max_bound in ((ATOM_W4A4.replace(fused_serving=False), 1.5), (ATOM_W4A4, 2.0)):
        xj, _ = jm.decode_hidden(jparams, _to_jax(st), jnp.asarray(ids), jnp.asarray(table), jnp.asarray(lens), jcfg, spec)
        diff = np.abs(xt - np.asarray(xj, np.float32))
        tag = f"{name}, fused_serving={spec.fused_serving}"
        assert np.mean(diff > 0.05) < 0.25, f"{tag}: {np.mean(diff > 0.05):.2%} of elements moved > 0.05"
        assert diff.max() < max_bound, f"{tag}: max divergence {diff.max():.3f}"


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _tbits(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("flush", [False, True])
def test_decode_step_matches_jax(model, flush):
    """``decode_step`` from a state whose ring holds W-1 tokens (row W-1), so
    the flushing step writes every active sequence's W-token block into its
    pages (blocks inside a page, crossing a page boundary, inactive slots).

    Next ids agree by majority.  Pages and ring are bitwise except where this
    step's token landed (ring column W-1; the token's page lane), whose codes
    carry the quantizer flips of the K2 comparison."""
    name, jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(20 + flush)
    table, ids = _inputs(rng, jcfg.vocab_size)
    flushed = rng.integers(0, 2 * PAGE - W, B)
    flushed[:4] = [0, 230, 250, PAGE - W]  # from empty; crossing slot 256; ending at it
    lens = (flushed + W).astype(np.int32)
    flushed[5], lens[5] = 0, 0  # inactive slot
    st = _state(rng, jcfg.num_kv_heads, flushed, row=W - 1)
    jids, jst = jm.decode_step(jparams, _to_jax(st), jnp.asarray(ids), jnp.asarray(table), jnp.asarray(lens),
                               jcfg, ATOM_W4A4, flush=flush)
    tids, tst = tm.decode_step(tparams, serving_state_from_numpy(st, "cpu"), torch.from_numpy(ids),
                               torch.from_numpy(table), torch.from_numpy(lens), tcfg, T_SPEC, flush=flush)
    agree = np.mean(tids.numpy() == np.asarray(jids))
    assert agree > 0.5, f"{name}: next ids agree on {agree:.0%}"
    np.testing.assert_array_equal(tst.flushed.numpy(), np.asarray(jst.flushed))
    assert tst.row == int(jst.row) == 0

    active = lens > flushed
    new_slot = lens - 1
    page_of = table[np.arange(B), np.clip(new_slot // PAGE, 0, MAX_PAGES - 1)]
    for layer in range(2):
        jr, tr = jst.hot[layer], tst.hot[layer]
        for a, t, axis in ((jr.k_codes, tr.k_codes, 3), (jr.prm, tr.prm, 3), (jr.v_codes, tr.v_codes, 2)):
            np.testing.assert_array_equal(np.delete(_tbits(t), W - 1, axis), np.delete(_bits(a), W - 1, axis))
        for field, lane_axis, in_plane in (("k_pages", 3, False), ("params", 3, False), ("v_pages", 2, True)):
            a, t = _bits(getattr(jst.pages[layer], field)), _tbits(getattr(tst.pages[layer], field))
            allowed = np.zeros(a.shape, bool)
            if flush:
                for b in np.nonzero(active)[0]:
                    lane = new_slot[b] % PAGE
                    idx = [page_of[b]] + [slice(None)] * (a.ndim - 1)
                    idx[lane_axis] = lane % (PAGE // 2) if in_plane else lane
                    allowed[tuple(idx)] = True
            outside = (a != t) & ~allowed
            assert not outside.any(), f"{name} layer {layer} {field}: {outside.sum()} entries differ off the new token"
            assert np.mean(a != t) <= 2e-3


def test_off_fused_path_raises():
    """Off the ring-fused decode path nothing raises any more: a batch that
    is not a multiple of 32 decodes through ``_attn_block_common`` +
    ``write_hot``, a spec with ``fused_serving=False`` through the int-input
    ring kernel, and ``causal_code_attention(kernel=True)`` through the flash
    kernel K12 (its plain version here), and ``quantize_lm_head(bits=4)``
    gives the W4A16 head (K13)."""
    _, tcfg = _cfgs(4, 4)
    small = tcfg.replace(num_layers=1)
    params = tm.init_serving_params(small, T_SPEC, device="cpu")
    st = tm.make_serving_state(1, 3, 16, 4, PAGE, 128, device="cpu")  # batch 16: not a multiple of 32
    ones = torch.ones(16, dtype=torch.int32)
    nxt, st = tm.decode_step(params, st, ones, torch.ones((16, 1), dtype=torch.int32), ones, small, T_SPEC)
    assert nxt.shape == (16,) and st.row == 1 and bool(st.hot[0].v_codes[:, :, 0].any())
    assert tm.quantize_lm_head(params, bits=4).lm_head.packed.dtype == torch.int8  # the W4A16 head (K13)
    from atom_tpu_torch.ops.reference import quantize_kv_asym

    gen = torch.Generator().manual_seed(0)
    q = torch.randn((6, 4, 128), generator=gen).to(torch.bfloat16)
    kq, vq = (quantize_kv_asym(torch.randn((6, 4, 128), generator=gen)) for _ in range(2))
    want = tm.causal_code_attention(q, kq, vq, 1, 128**-0.5)
    got = tm.causal_code_attention(q, kq, vq, 1, 128**-0.5, kernel=True)
    assert got.shape == (6, 512) and got.dtype == torch.bfloat16
    # the same sums in another order, then one bf16 rounding
    torch.testing.assert_close(got.float(), want.float(), atol=2e-3, rtol=2**-7)


@pytest.mark.parametrize("branch", ["batch_8_fallback", "int_input_ring_kernel"])
def test_decode_step_off_fused_branches_match_jax(branch):
    """The two decode branches beside the ring-fused kernel, against the JAX
    decode step on the same state (ring holding W-1 tokens, a flushing step):
    a batch of 8 (K7 + ``write_hot``), and batch 32 with ``fused_serving=False``
    (the int-input ring kernel K8).  Both run the eager quantization chain in
    JAX too, so the step's ring column and flushed pages are near bitwise:
    flushed counts and ``row`` equal, every ring column but the written one
    untouched and bitwise, at most 0.2% of all page and ring bytes differing
    (the new token's codes, which sit behind a jitted JAX program's 1-ulp
    quantizer fuzz), next ids agreeing by majority."""
    jcfg, tcfg = _cfgs(4, 4)
    jparams = jm.init_serving_params(jax.random.PRNGKey(1), jcfg, ATOM_W4A4)
    tparams = serving_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    b = 8 if branch == "batch_8_fallback" else B
    jspec = ATOM_W4A4 if b == 8 else ATOM_W4A4.replace(fused_serving=False)
    tspec = T_SPEC if b == 8 else T_SPEC.replace(fused_serving=False)
    rng = np.random.default_rng(30 + b)
    table, ids = _inputs(rng, jcfg.vocab_size)
    flushed = rng.integers(0, 2 * PAGE - W, B)
    flushed[:3] = [0, 240, PAGE - W]
    lens = (flushed + W).astype(np.int32)
    flushed[5], lens[5] = 0, 0  # idle slot
    st = _state(rng, jcfg.num_kv_heads, flushed, row=W - 1)
    cut = lambda tree: jax.tree_util.tree_map(lambda a: a[:b] if a.shape[:1] == (B,) else a, tree)  # noqa: E731
    st = st._replace(hot=cut(st.hot), flushed=st.flushed[:b])
    table, ids, lens = table[:b], ids[:b], lens[:b]

    jids, jst = jm.decode_step(jparams, _to_jax(st), jnp.asarray(ids), jnp.asarray(table), jnp.asarray(lens),
                               jcfg, jspec, flush=True)
    tids, tst = tm.decode_step(tparams, serving_state_from_numpy(st, "cpu"), torch.from_numpy(ids),
                               torch.from_numpy(table), torch.from_numpy(lens), tcfg, tspec, flush=True)
    assert np.mean(tids.numpy() == np.asarray(jids)) > 0.5
    np.testing.assert_array_equal(tst.flushed.numpy(), np.asarray(jst.flushed))
    assert tst.row == int(jst.row) == 0
    total = differing = 0
    for layer in range(2):
        jr, tr = jst.hot[layer], tst.hot[layer]
        for a, t, axis in ((jr.k_codes, tr.k_codes, 3), (jr.prm, tr.prm, 3), (jr.v_codes, tr.v_codes, 2)):
            np.testing.assert_array_equal(np.delete(_tbits(t), W - 1, axis), np.delete(_bits(a), W - 1, axis))
            total, differing = total + t.numel(), differing + int((_tbits(t) != _bits(a)).sum())
        for f in ("k_pages", "v_pages", "params"):
            a, t = _bits(getattr(jst.pages[layer], f)), _tbits(getattr(tst.pages[layer], f))
            total, differing = total + a.size, differing + int((a != t).sum())
    assert differing / total <= 2e-3, f"{differing / total:.4%} of ring and page bytes differ"


def test_no_device_means_the_card(monkeypatch):
    """Entry points default to CUDA and raise without it; they never drop to
    the CPU unless asked."""
    _, tcfg = _cfgs(4, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_serving_params(tcfg, T_SPEC)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.make_serving_state(2, 3, 32, 4, PAGE, 128)


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for CPU tensors; a tensor on any
    other device (here ``meta``) raises instead of falling back."""
    from atom_tpu_torch.ops.gemm_packed import packed_w4_gemm
    from atom_tpu_torch.ops.misc import embed_gather

    meta = dict(device="meta")
    with pytest.raises(ValueError, match="on the CPU or all on CUDA"):
        embed_gather(torch.empty((64, 256), dtype=torch.bfloat16, **meta), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="on the CPU or all on CUDA"):
        packed_w4_gemm(*(torch.empty(2, 2, **meta) for _ in range(5)))


def _port_sources():
    return (sorted((REPO / "atom_tpu_torch").rglob("*.py")) + sorted((REPO / "scripts").glob("torch_*.py"))
            + [REPO / "chip_smoke.py"])


def test_port_imports_neither_jax_nor_atom_tpu():
    bad = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            bad += [f"{path.relative_to(REPO)}: {n}" for n in names if n.split(".")[0] in ("jax", "jaxlib", "atom_tpu")]
    assert not bad, bad
    names = {str(p.relative_to(REPO)) for p in _port_sources()}
    assert len(names) > 25
    for new in ("ops/gemm_w4a16.py", "serving/kvpool.py", "serving/workload.py", "serving/engine.py", "ops/mlp.py",
                "ops/prefill.py", "ops/gemm.py", "serving/baselines.py", "serving/moe.py", "serving/lora.py",
                "native/__init__.py", "calib/gptq.py", "calib/pipeline.py", "models/llama.py", "utils/checkpoint.py",
                "main.py", "models/opt.py", "models/mixtral.py", "utils/train.py", "parallel/mesh.py",
                "parallel/launch.py", "parallel/shardings.py", "serving/parallel.py", "serving/sp.py", "serving/dp.py"):
        assert f"atom_tpu_torch/{new}" in names
    assert "chip_smoke.py" in names and "scripts/torch_train_corpus_model.py" in names


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'atom_tpu'): sys.modules[m] = None\n"
        "import importlib, pathlib\n"
        "mods = sorted(str(p.with_suffix('')).replace('/', '.') for p in pathlib.Path('atom_tpu_torch').rglob('*.py'))\n"
        "mods = [m[:-9] if m.endswith('.__init__') else m for m in mods]\n"
        "for m in mods + ['chip_smoke']: importlib.import_module(m)\n"
        "assert len(mods) > 25, mods\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib', 'atom_tpu.')) for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
