"""K12's tile walk (``csrc/prefill.cu::flash_tile_kernel``), its plan and its
order of arithmetic on the CPU.

On the card a block owns one query tile (64 rows, 16 a warp) of one query
head and walks the 64-slot key tiles that ``ops/prefill.py::flash_plan``
gives it, up to the last one its last row can see.  Per key tile: q.K on bf16
tensor-core fragments (exact products, float32 sums), the affine correction
and ``sm_scale`` in the written order, the causal and Tk masks on a warp's
diagonal and last tiles only (a warp none of whose rows sees the tile skips
it), the online softmax, and p.V with p * v_scale as a bf16 term and its
bf16 remainder, each tile's p.V from zero joined to the running output by
one multiply-add with the rescale.  That walk is emulated here in plain
PyTorch and held against the plain version and against the JAX package's
Pallas kernel in interpret mode; the plan is checked for coverage.  The CUDA
kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu.ops.pallas_prefill import flash_code_attention as j_flash
from atom_tpu.ops.reference import quantize_kv_asym as j_quantize_kv
from atom_tpu_torch.ops import prefill as pf
from atom_tpu_torch.serving.convert import tensor_from_numpy
from test_torch_serving import cap_torch_threads

cap_torch_threads()

NEG = -1e30
SM_SCALE = 128**-0.5


def _walked(plan, tq, tk):
    """(row, key) pairs each plan entry's block walks, as a [tq, tk] count."""
    seen = np.zeros((tq, tk), np.int64)
    for t, n in zip(plan.q_tiles, plan.key_tiles):
        rows = slice(t * pf.TILE_Q, min((t + 1) * pf.TILE_Q, tq))
        seen[rows, : min(n * pf.TILE_K, tk)] += 1
    return seen


@pytest.mark.parametrize(
    "tq,tk,offset",
    [(1024, 1024, 0), (512, 1024, 512), (512, 1024, 200), (300, 300, 0), (100, 300, 200), (300, 1000, 700),
     (40, 96, 0), (200, 100, 0)],
    ids=["t1024", "offset_512", "offset_200", "t300", "tq100_tk300_offset200", "tq300_offset700", "one_tile",
         "keys_fewer_than_rows"],
)
def test_flash_plan_covers_every_visible_pair_once(tq, tk, offset):
    """Every query tile is listed once, so every visible (row, key) pair is
    walked exactly once; no tile walks a key tile past the last one its last
    row sees (its last key tile holds a key visible to that row); the entries
    run heaviest first."""
    plan = pf.flash_plan(tq, tk, offset)
    tile_q = pf.TILE_Q
    assert sorted(plan.q_tiles) == list(range(-(-tq // tile_q)))
    seen = _walked(plan, tq, tk)
    visible = np.arange(tk)[None, :] <= offset + np.arange(tq)[:, None]
    assert (seen[visible] == 1).all()
    for t, n in zip(plan.q_tiles, plan.key_tiles):
        last_row = min((t + 1) * tile_q, tq) - 1
        first_of_last = (n - 1) * pf.TILE_K
        assert n >= 1 and first_of_last < tk and first_of_last <= offset + last_row
    assert list(plan.key_tiles) == sorted(plan.key_tiles, reverse=True)
    assert plan.args() == [len(plan.q_tiles), *plan.q_tiles, *plan.key_tiles]


def test_flash_plan_blocks_put_sibling_heads_side_by_side():
    """A launch has one block per (plan entry, query head), entry-major: the
    query heads of one kv head (GQA 64/8: 8 of them) are neighbours in launch
    order, so their blocks read the same K/V tiles from L2; the block count is
    entries x HQ.  Shapes the plan cannot take are refused."""
    hq, hkv = 64, 8
    groups = hq // hkv
    plan = pf.flash_plan(1024, 1024, 0)
    blocks = [(b // hq, b % hq) for b in range(len(plan.q_tiles) * hq)]
    kv_runs = [hq_ // groups for _, hq_ in blocks]
    assert all(kv_runs[i:i + groups] == [kv_runs[i]] * groups for i in range(0, len(kv_runs), groups))
    assert len(blocks) == 16 * hq and plan.key_tiles[0] == 16 and plan.key_tiles[-1] == 1
    for bad in ((0, 64, 0), (64, 0, 0), (64, 64, -1), (256 * 64 + 1, 64, 0)):
        with pytest.raises(ValueError):
            pf.flash_plan(*bad)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def flash_emulation(q, kc, kp, vc, vp, groups, sm_scale, row_offset=0, terms=2):
    """K12's walk in plain PyTorch -> (bf16 [Tq, HQ * D], float32 [HQ, Tq, D]).

    Per plan entry, all query heads at once: warps of 16 rows; per key tile
    the scores as float32 sums of exact products, the affine correction in the
    kernel's order, masks on a warp's diagonal and last tiles only, a warp
    whose rows see none of the tile left as it is, the online softmax, p *
    v_scale as ``terms`` bf16 terms (the kernel: 2), each the rounding of what
    the ones before leave, and the tile's p.V from zero joined to the output
    with the rescale."""
    tq, hq, d = q.shape
    tk = kc.shape[0]
    plan = pf.flash_plan(tq, tk, row_offset)
    tile_q, tile_k = pf.TILE_Q, pf.TILE_K
    qf = q.float().transpose(0, 1)  # [HQ, Tq, D]
    kcf = kc.float().repeat_interleave(groups, 1).transpose(0, 1)  # [HQ, Tk, D]
    vcf = vc.float().repeat_interleave(groups, 1).transpose(0, 1)
    kpf = kp.float().repeat_interleave(groups, 1).transpose(0, 1)  # [HQ, Tk, 2]
    vpf = vp.float().repeat_interleave(groups, 1).transpose(0, 1)
    out = torch.zeros(hq, tq, d)
    for t, n_kt in zip(plan.q_tiles, plan.key_tiles):
        r0, r1 = t * tile_q, min((t + 1) * tile_q, tq)
        rows = torch.arange(r0, r1)
        pos = row_offset + rows
        warp_pos0 = row_offset + r0 + 16 * ((rows - r0) // 16)  # each row's warp's first position
        qt = qf[:, r0:r1]
        qsum = qt.sum(-1, keepdim=True)  # [HQ, R, 1]
        m = torch.full((hq, r1 - r0, 1), NEG)
        l = torch.zeros(hq, r1 - r0, 1)
        z = torch.zeros(hq, r1 - r0, 1)
        o = torch.zeros(hq, r1 - r0, d)
        for j in range(n_kt):
            k0 = j * tile_k
            slots = torch.arange(k0, min(k0 + tile_k, tk))
            active = (k0 <= warp_pos0 + 15)[None, :, None]  # the warp walks the tile
            edge = ((k0 + tile_k - 1 > warp_pos0) | (k0 + tile_k > tk))[:, None]
            raw = qt @ kcf[:, slots].transpose(1, 2)  # [HQ, R, S]
            ks, kz = kpf[:, slots, 0][:, None, :], kpf[:, slots, 1][:, None, :]
            x = ((raw * ks) + (qsum * kz)) * sm_scale
            visible = ~edge | ((slots[None, :] <= pos[:, None]) & (slots[None, :] < tk))  # [R, S]
            x = torch.where(visible[None], x, NEG)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.where(visible[None], torch.exp(x - m_new), 0.0)
            vs, vz = vpf[:, slots, 0][:, None, :], vpf[:, slots, 1][:, None, :]
            rest, pv = p * vs, torch.zeros_like(o)
            for _ in range(terms):
                part = _bf16(rest)
                pv = pv + part @ vcf[:, slots]
                rest = rest - part
            m = torch.where(active, m_new, m)
            l = torch.where(active, l * alpha + p.sum(-1, keepdim=True), l)
            z = torch.where(active, z * alpha + (p * vz).sum(-1, keepdim=True), z)
            o = torch.where(active, o * alpha + pv, o)
        out[:, r0:r1] = (o + z) / torch.clamp_min(l, 1e-20)
    return out.to(torch.bfloat16).transpose(0, 1).reshape(tq, hq * d), out


def _inputs(tq, tk, hq, hkv, seed, q_scale=1.0):
    """q bf16 and real quantized K/V codes (the JAX package's quantizer), numpy."""
    rng = np.random.default_rng(seed)
    q = np.array(jnp.asarray(rng.standard_normal((tq, hq, 128)).astype(np.float32) * q_scale).astype(jnp.bfloat16))
    kq = j_quantize_kv(jnp.asarray(rng.standard_normal((tk, hkv, 128)).astype(np.float32)))
    vq = j_quantize_kv(jnp.asarray(rng.standard_normal((tk, hkv, 128)).astype(np.float32)))
    return q, kq, vq


def _exact(q, kc, kp, vc, vp, groups, row_offset):
    """The attention in float64, one pass: [HQ, Tq, D]."""
    qd = torch.from_numpy(np.asarray(q, np.float32)).double().transpose(0, 1)
    kd = (kc.double() * kp[..., :1].double() + kp[..., 1:].double()).repeat_interleave(groups, 1).transpose(0, 1)
    vd = (vc.double() * vp[..., :1].double() + vp[..., 1:].double()).repeat_interleave(groups, 1).transpose(0, 1)
    s = qd @ kd.transpose(1, 2) * SM_SCALE
    tq, tk = qd.shape[1], kd.shape[1]
    vis = torch.arange(tk)[None, :] <= row_offset + torch.arange(tq)[:, None]
    s = torch.where(vis[None], s, -torch.inf)
    return torch.softmax(s, -1) @ vd


# (Tq, Tk, HQ, Hkv, row offset): MHA from row 0, GQA at an offset, a Tq and Tk
# that are no multiples of the tiles, from row 0 and at an offset
CASES = {
    "mha_192": (192, 192, 2, 2, 0),
    "gqa_offset_128": (128, 256, 4, 2, 128),
    "ragged_tq100_tk300_offset200": (100, 300, 2, 1, 200),
    "ragged_tq200_tk264_offset64": (200, 264, 2, 2, 64),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_emulation_matches_plain_and_exact(case):
    """The walk against the plain version: bf16 outputs within one bf16
    rounding of each other (atol 1e-5, rtol 2^-7: float32 sums in another
    order before the one rounding), at least 90% of them bitwise equal; its
    float32 output within 3e-5 of the plain version's float32 result and of
    the float64 attention (the plain version itself: within 1e-5 of it;
    measured: the walk 1.1e-5 to 1.4e-5), with q of scale 12 (a peaked softmax,
    as the card's check builds it)."""
    tq, tk, hq, hkv, off = CASES[case]
    q, kq, vq = _inputs(tq, tk, hq, hkv, seed=len(case), q_scale=12.0)
    args = [tensor_from_numpy(np.asarray(a), "cpu") for a in (q, kq.codes, kq.params, vq.codes, vq.params)]
    got, got32 = flash_emulation(*args, hq // hkv, SM_SCALE, off)
    want = pf.flash_code_attention_plain(*args, hq // hkv, SM_SCALE, off)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-5, rtol=2**-7)
    assert got.view(torch.int16).eq(want.view(torch.int16)).float().mean() >= 0.9
    exact = _exact(q, *args[1:], hq // hkv, off)
    plain32 = pf.flash_code_attention_f32(*args, hq // hkv, SM_SCALE, off)
    assert float((got32 - plain32).abs().max()) < 3e-5
    assert float((got32.double() - exact).abs().max()) < 3e-5
    assert float(exact.abs().mean()) > 0.1  # outputs of order 1: the bounds have teeth


@pytest.mark.parametrize("case", ["gqa_offset_128", "ragged_tq100_tk300_offset200"])
def test_flash_emulation_matches_pallas(case):
    """The walk against the Pallas kernel in interpret mode (its own blocks of
    128 query rows and 128 keys, offset_max = Tk - Tq): within rtol 2e-2, atol
    5e-3 on the bf16 output, the bound ``tests/test_torch_flash_prefill.py``
    holds the plain version to."""
    tq, tk, hq, hkv, off = CASES[case]
    q, kq, vq = _inputs(tq, tk, hq, hkv, seed=len(case))
    want = j_flash(jnp.asarray(q), kq.codes, kq.params, vq.codes, vq.params, hq // hkv, SM_SCALE,
                   row_offset=jnp.int32(off), offset_max=tk - tq, tq_blk=128, tk_blk=128, interpret=True)
    args = [tensor_from_numpy(np.asarray(a), "cpu") for a in (q, kq.codes, kq.params, vq.codes, vq.params)]
    got, _ = flash_emulation(*args, hq // hkv, SM_SCALE, off)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2e-2, atol=5e-3)


@pytest.mark.parametrize("terms,within", [(1, None), (2, 3e-5)], ids=["one", "two"])
def test_flash_emulation_terms_of_p_times_v_scale(terms, within):
    """Why p.V takes p * v_scale as two bf16 terms: as one, the float32 output
    strays past 1e-3 of the float64 attention on queries of scale 12 (measured
    6e-3 to 8e-3), where the kernel's one bf16 rounding at the end allows
    2e-3 (``chip_smoke.py``'s ``ATTN_TOL``); with the remainder it stays
    within 3e-5."""
    tq, tk, hq, hkv, off = 128, 256, 2, 2, 128
    q, kq, vq = _inputs(tq, tk, hq, hkv, seed=5, q_scale=12.0)
    args = [tensor_from_numpy(np.asarray(a), "cpu") for a in (q, kq.codes, kq.params, vq.codes, vq.params)]
    _, got32 = flash_emulation(*args, 1, SM_SCALE, off, terms=terms)
    err = float((got32.double() - _exact(q, *args[1:], 1, off)).abs().max())
    assert err > 1e-3 if within is None else err < within


def test_keys_past_the_last_visible_change_nothing_in_the_walk():
    """Masked slots give p = 0 exactly: replacing every key and value past the
    last one any row sees leaves the walk's output bitwise unchanged, at a Tk
    that is no multiple of the key tile."""
    tq, tk, hq, hkv, off = 70, 300, 2, 1, 100
    q, kq, vq = _inputs(tq, tk, hq, hkv, seed=11, q_scale=12.0)
    _, kq2, vq2 = _inputs(tq, tk, hq, hkv, seed=12)
    cut = off + tq
    a = [tensor_from_numpy(np.asarray(x), "cpu") for x in (q, kq.codes, kq.params, vq.codes, vq.params)]
    b = [a[0]] + [tensor_from_numpy(np.concatenate([np.asarray(x)[:cut], np.asarray(y)[cut:]]), "cpu")
                  for x, y in ((kq.codes, kq2.codes), (kq.params, kq2.params), (vq.codes, vq2.codes), (vq.params, vq2.params))]
    ga, _ = flash_emulation(*a, 2, SM_SCALE, off)
    gb, _ = flash_emulation(*b, 2, SM_SCALE, off)
    assert torch.equal(ga.view(torch.int16), gb.view(torch.int16))
