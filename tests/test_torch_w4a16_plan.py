"""K13's launch plan (``ops/gemm_w4a16.py::w4a16_plan``): which of the CUDA
kernel's two paths a shape takes, its block rows, its split of K over a thread
block cluster and its grid, at every shape the W4A16 stack, the W4A16 head and
``chip_smoke.py`` give the kernel.  The kernel takes the plan's group ranges
and grid as they are, so these are the values it launches with.

The plan is pure Python, so it is checked here; the kernel it launches is held
against its plain version on the card by ``chip_smoke.py``.  The last test
holds the split's order of float32 additions (per-rank running sums of scaled
group partials, then the ranks in rank order) against the Pallas kernel in
interpret mode, within the tolerance the card check uses.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu.ops import pallas_gemm_w4a16 as jw
from atom_tpu_torch.ops import gemm_w4a16 as tw
from atom_tpu_torch.ops.gemm_packed import unpack_nibble_planes
from test_torch_serving import cap_torch_threads

cap_torch_threads()

HID, INTER_P, HEAD_N = 4096, 11264, 32256  # Llama-2-7B width, the W4A16 stack's padded MLP, the padded head
SMS, MAX_CLUSTER = 132, 8
# (m, k, n): the W4A16 stack's decode GEMMs (batch 32) and prefill buckets, the
# head at 32 rows and 1, and chip_smoke.py's K13 cases
SHAPES = [
    *[(32, k, n) for k, n in ((HID, HID), (HID, INTER_P), (INTER_P, HID))],
    *[(m, k, n) for m in (128, 256, 512) for k, n in ((HID, HID), (HID, INTER_P), (INTER_P, HID))],
    (32, HID, HEAD_N), (1, HID, HEAD_N),
    (1024, HID, INTER_P), (100, 384, 224), (1, HID, HID), (64, HID, HID), (64, HID, INTER_P), (65, HID, HID),
    (48, 640, 160), (32, 1024, 4128),
]
SKINNY_ROWS = (8, 16, 32, 64)  # the row counts the CUDA entry point instantiates for the skinny path
COLS = 128  # weight columns of a block, on both paths


def _ids(shapes):
    return [f"m{m}_k{k}_n{n}" for m, k, n in shapes]


@pytest.mark.parametrize("m,k,n", SHAPES, ids=_ids(SHAPES))
def test_plan_covers_every_group_once_in_order(m, k, n):
    """Each rank of the split sums a non-empty run of groups; the runs follow
    each other and cover all K/128 groups once, and the kernel is handed them
    as the rank's first group plus the end.  No cluster exceeds 8 blocks, and
    the grid is the column tiles times the split by the row tiles."""
    plan = tw.w4a16_plan(m, k, n)
    ng = k // tw.GROUP
    assert 1 <= plan.split <= MAX_CLUSTER and len(plan.groups) == plan.split
    assert plan.groups[0][0] == 0 and plan.groups[-1][1] == ng
    for (a0, a1), (b0, _) in zip(plan.groups, plan.groups[1:]):
        assert a1 == b0
    assert all(g1 > g0 for g0, g1 in plan.groups)
    assert list(tw._group_starts(plan.groups)) == [g0 for g0, _ in plan.groups] + [ng]
    assert plan.grid == (-(-n // COLS) * plan.split, -(-m // plan.tile_m))
    if plan.path == "skinny":
        assert plan.grid[1] == 1
        assert plan.tile_m == min(r for r in SKINNY_ROWS if r >= m)
    else:
        assert (plan.tile_m, plan.split) == (128, 1)


@pytest.mark.parametrize("m,k,n", SHAPES, ids=_ids(SHAPES))
def test_skinny_plan_fills_the_card(m, k, n):
    """The skinny path's grid covers the 132 SMs wherever N and K allow it
    (column tiles x up to 8 blocks, one group each at least), with the
    smallest such split; where they do not, the split is the largest.  Up to
    32 rows, A's bytes read per 128-column tile stay at or below the tile's
    weight bytes."""
    plan = tw.w4a16_plan(m, k, n)
    if m > tw.SKINNY_MAX_M:
        assert plan.path == "tile"
        return
    assert plan.path == "skinny"
    ng, tiles = k // tw.GROUP, -(-n // COLS)
    if tiles * min(MAX_CLUSTER, ng) >= SMS:
        assert plan.grid[0] >= SMS and (plan.split == 1 or tiles * (plan.split - 1) < SMS)
    else:
        assert plan.split == min(MAX_CLUSTER, ng)
    if m <= 32:
        assert plan.tile_m * tw.GROUP * 2 <= tw.HALF * COLS


def test_the_switch_between_paths_is_at_64_rows():
    assert tw.SKINNY_MAX_M == 64
    assert tw.w4a16_plan(64, HID, HID).path == "skinny" and tw.w4a16_plan(65, HID, HID).path == "tile"
    assert [tw.w4a16_plan(m, HID, HID).path for m in (1, 32, 64, 65, 128, 1024)] == ["skinny"] * 3 + ["tile"] * 3
    # the decode step and the head: clusters of 5 per 128 columns at N 4096, 2 at 11264, none at the head
    assert [tw.w4a16_plan(32, k, n).split for k, n in ((HID, HID), (HID, INTER_P), (INTER_P, HID), (HID, HEAD_N))] == [5, 2, 5, 1]
    assert [tw.w4a16_plan(m, HID, HEAD_N).tile_m for m in (1, 8, 9, 16, 17, 32, 33, 64)] == [8, 8, 16, 16, 32, 32, 64, 64]


@pytest.mark.parametrize("m,k,n,what", [(32, HID, 4100, "N=4100"), (32, HID, 224 + 16, "N=240"),
                                        (100, 4000, HID, "K=4000"), (1, 64, 128, "K=64"), (32, 0, 128, "K=0"),
                                        (32, HID, 0, "N=0")])
def test_plan_raises_on_shapes_the_kernel_does_not_take(m, k, n, what):
    with pytest.raises(ValueError, match=what.split("=")[0] + "="):
        tw.w4a16_plan(m, k, n)


def _split_order(a: torch.Tensor, wq, plan) -> torch.Tensor:
    """K13's float32 order under ``plan``: per rank, the group's partial times
    its scale added into a block sum, which goes into the rank's sum at every
    multiple of ``KBLK`` groups and at the rank's end; then the ranks added in
    rank order."""
    codes = unpack_nibble_planes(wq.packed).to(torch.float32)  # [ng, 128, N]
    ag = a.to(torch.float32).reshape(a.shape[0], -1, tw.GROUP).transpose(0, 1)
    part = torch.bmm(ag, codes)  # [ng, M, N]: exact products, float32 sums
    ranks = []
    for g0, g1 in plan.groups:
        acc, blk = torch.zeros_like(part[0]), torch.zeros_like(part[0])
        for g in range(g0, g1):
            blk = blk + part[g] * wq.scale[g]
            if (g + 1) % tw.KBLK == 0 or g + 1 == g1:
                acc, blk = acc + blk, torch.zeros_like(blk)
        ranks.append(acc)
    out = ranks[0]
    for r in ranks[1:]:
        out = out + r
    return out


@pytest.mark.parametrize("m,k", [(1, 640), (32, 640), (64, 640), (65, 640), (65, 2560)])
def test_split_order_within_tolerance_of_pallas(m, k):
    """The kernel's order of additions under each plan (at 5 groups a skinny
    plan splits 5 ways) stays within ``W4A16_RTOL`` of the largest output of
    the Pallas kernel, and the wrapper's plain version on the CPU too; the tile
    path (one rank) adds in the plain version's order, bit for bit on the same
    group partials (20 groups: blocks of 8, 8 and 4)."""
    n = 160
    rng = np.random.default_rng(m)
    a = np.array(jnp.asarray(rng.standard_normal((m, k)).astype(np.float32)).astype(jnp.bfloat16).astype(jnp.float32))
    wq = jw.quantize_w4a16(jnp.asarray((rng.standard_normal((k, n)) * 0.05).astype(np.float32)))
    want = np.asarray(jw.w4a16_gemm(jnp.asarray(a), wq, out_dtype=jnp.float32, interpret=True))
    twq = tw.W4A16Weight(torch.from_numpy(np.array(wq.packed)), torch.from_numpy(np.array(wq.scale)))
    plan = tw.w4a16_plan(m, k, n)
    assert plan.path == ("skinny" if m <= 64 else "tile") and plan.split == (5 if m <= 64 else 1)  # one group per rank
    assert len(plan.groups) == 1 or k == 640
    top = np.abs(want).max()
    got = _split_order(torch.from_numpy(a), twq, plan).numpy()
    assert np.abs(got - want).max() <= tw.W4A16_RTOL * top
    plain = tw.w4a16_gemm(torch.from_numpy(a), twq, out_dtype=torch.float32).numpy()
    assert np.abs(plain - want).max() <= tw.W4A16_RTOL * top
    if plan.split == 1:
        np.testing.assert_array_equal(got, plain)
