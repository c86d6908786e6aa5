"""K14's launch plans (``ops/gemm.py::grouped_int8_plan``): the kernel, the
tiles, the ring depth, the unblocked order and the shared memory of every
launch that ``chip_smoke.py`` makes and of every layout that
``scripts/torch_int8_carrier_compare.py --stages`` times; and the wrappers'
refusals on the kernel path.  CPU only: the plans are Python, the kernels run
on the card (``chip_smoke.py``)."""
import pytest
import torch

from atom_tpu_torch.ops import gemm as tg
from atom_tpu_torch.ops import gemm_packed as gp
from test_torch_serving import cap_torch_threads

cap_torch_threads()

SMEM_BLOCK = 232448
HID, INTER = 4096, 11008
# (M, K, N) of every K14 launch in chip_smoke.py: K14a at the decode and prefill row counts at N 4,096 and
# 11,008, the 70B down depth, M 100 / N 128, the int8-carrier layer's projections; K = 128 (no body group)
SMOKE_SHAPES = sorted({(m, HID, n) for m in (1, 32, 64, 65, 288, 1024) for n in (HID, INTER)}
                      | {(32, 28672, 1024), (288, 28672, 1024), (100, HID, 128), (32, HID, 128), (32, INTER, HID),
                         (1, 128, 128), (200, 128, 256)})
# the compare script's ring depths at its block layouts: (M, K, N, stages)
STAGE_SWEEP = [(1, HID, HID), (32, HID, HID), (64, HID, HID), (32, INTER, HID), (32, HID, INTER), (64, HID, INTER),
               (32, 28672, 1024), (65, HID, HID), (288, HID, HID), (288, HID, INTER), (288, 28672, 1024),
               (1024, HID, HID), (1024, HID, INTER)]
RING_DEPTHS = [(m, k, n, st) for m, k, n in STAGE_SWEEP
               for st in ((4, 6, 8) if tg.grouped_int8_plan(m, k, n).path == "core" else (3, 4, 6))]


def _check_layout(plan, m, k, n):
    """What the kernels' int8-weight form takes (never K-blocked: the form
    has no K-blocked instance): tiles of its kernel, shared memory as its
    layout (``core_smem`` with 128-row weight slots) within a block."""
    ng = k // 128 - 1
    assert plan.cluster == 1 and plan.stages >= 3
    assert plan.smem == gp.core_smem(plan.tile_m, plan.tile_n, plan.stages, ng, False, wrows=128) <= SMEM_BLOCK
    if plan.path == "core":
        assert plan.tile_m in (16, 32, 64) and plan.tile_n in (32, 64, 128) and n % plan.tile_n == 0
        assert plan.grid == (n // plan.tile_n, -(-m // plan.tile_m))
    else:
        assert plan.tile_m in (64, 128) and plan.tile_n in (64, 128)
        assert plan.grid == (-(-m // plan.tile_m), -(-n // plan.tile_n))


@pytest.mark.parametrize("m,k,n", SMOKE_SHAPES)
def test_plan_of_every_smoke_launch(m, k, n):
    """The decode core up to 64 rows with a body group, the prefill GEMM
    above and at K = 128 (as K1); tiles the kernels take, whole column tiles
    on the core; a group a 128-row slot, never K-blocked; the plan's shared
    memory is the kernels' layout and fits a block; a ring of at least 3
    stages."""
    plan = tg.grouped_int8_plan(m, k, n)
    ng = k // 128 - 1
    assert plan.path == ("core" if m <= gp.CORE_MAX_M and ng > 0 else "prefill")
    _check_layout(plan, m, k, n)


@pytest.mark.parametrize("m,k,n", SMOKE_SHAPES)
def test_default_stages_by_block_rows(m, k, n):
    """K1's tiles wherever K1 takes the unblocked order (K1 K-blocks above
    ``KBLK_THRESHOLD`` body groups, and then keeps to 64-row prefill
    blocks); on the core a ring of 8 slots in 16-row blocks and 4 in taller
    ones (128-row slots: K1's bytes in flight), on the prefill GEMM the most
    of 6 that shared memory holds (3 at the least)."""
    plan = tg.grouped_int8_plan(m, k, n)
    ng = k // 128 - 1
    k1 = gp.packed_w4_plan(m, k, n)
    if ng <= gp.KBLK_THRESHOLD or plan.path == "core":
        assert (k1.path, k1.tile_m, k1.tile_n, k1.grid) == (plan.path, plan.tile_m, plan.tile_n, plan.grid)
    if plan.path == "core":
        assert plan.stages == min(ng + 2, 8 if plan.tile_m == 16 else 4)
    else:
        deeper = gp.core_smem(plan.tile_m, plan.tile_n, plan.stages + 1, ng, False, wrows=128)
        assert plan.stages == max(3, min(ng + 2, 6)) or (plan.stages < 6 and deeper > SMEM_BLOCK)


@pytest.mark.parametrize("m,k,n,stages", RING_DEPTHS)
def test_plan_under_every_ring_depth(m, k, n, stages):
    """Each ring depth the compare script times is a launch the kernels
    take, on the default plan's kernel and tiles."""
    plan = tg.grouped_int8_plan(m, k, n, stages=stages)
    default = tg.grouped_int8_plan(m, k, n)
    assert plan.stages == stages
    assert (plan.path, plan.tile_m, plan.tile_n, plan.grid) == (default.path, default.tile_m, default.tile_n,
                                                                 default.grid)
    _check_layout(plan, m, k, n)


def test_plans_pinned():
    """The launches the tables of ``PERF.md`` time: 16 x 64 core blocks at 32
    rows (N 4,096) with 8 stages, 32 x 64 at N 11,008 with 4; 128 x 128
    prefill blocks at 1,024 rows with 6; the 70B depth at 32 rows in 32
    blocks of 16 x 64 and at 288 rows in 64 x 64 prefill blocks; K = 128 on
    the prefill GEMM too.  A 128-row slot is twice K1's weight slot."""
    p = tg.grouped_int8_plan(32, HID, HID)
    assert (p.path, p.tile_m, p.tile_n, p.stages, p.grid) == ("core", 16, 64, 8, (64, 2))
    assert p.smem == 1024 + 8 * (16 * 128 + 64 * 128 + 64 * 4 + 16) + 32 * 16 * 4
    assert gp.packed_w4_plan(32, HID, HID).smem == p.smem - 8 * 64 * 64
    p = tg.grouped_int8_plan(32, HID, INTER)
    assert (p.path, p.tile_m, p.tile_n, p.stages, p.grid) == ("core", 32, 64, 4, (172, 1))
    p = tg.grouped_int8_plan(1024, HID, INTER)
    assert (p.path, p.tile_m, p.tile_n, p.stages, p.grid) == ("prefill", 128, 128, 6, (8, 86))
    p = tg.grouped_int8_plan(32, 28672, 1024)
    assert (p.path, p.tile_m, p.tile_n, p.stages, p.grid) == ("core", 16, 64, 8, (16, 2))
    p = tg.grouped_int8_plan(288, 28672, 1024)
    assert (p.path, p.tile_m, p.tile_n) == ("prefill", 64, 64)
    p = tg.grouped_int8_plan(1, 128, 128)
    assert (p.path, p.stages) == ("prefill", 3)


def test_deep_k_is_never_k_blocked():
    """At 223 body groups K1 K-blocks and keeps to 64-row prefill blocks; K14
    takes the unblocked order there, so 128-row blocks too, with the staged
    activation scales (224 x 128 floats, 115 KB) beside a ring of 3
    stages."""
    assert 28672 // 128 - 1 > gp.KBLK_THRESHOLD
    assert gp.packed_w4_plan(1024, 28672, 4096).tile_m == 64
    with pytest.raises(ValueError, match="not a prefill layout"):
        gp.packed_w4_plan(1024, 28672, 4096, tile_m=128)
    p = tg.grouped_int8_plan(1024, 28672, 4096, tile_m=128, tile_n=128)
    assert p.tile_m == 128 and p.stages == 3 and p.smem == gp.core_smem(128, 128, 3, 223, False, wrows=128)
    assert p.smem <= SMEM_BLOCK
    assert 224 * 128 * 4 == 114688 < p.smem


def test_plan_refuses_what_shared_memory_cannot_hold():
    """Deeper than the staged scales and a ring of 3 stages fit (400 groups
    at 128 rows: 205 KB of scales), the plan raises; so does a head or
    paired launch on int8 weights (the int8-weight form has neither
    epilogue)."""
    with pytest.raises(ValueError, match="no room"):
        tg.grouped_int8_plan(1024, 128 * 400, 4096, tile_m=128)
    with pytest.raises(ValueError, match="int8 weights"):
        gp.packed_w4_plan(32, HID, 3 * HID, head=True, int8=True)
    with pytest.raises(ValueError, match="int8 weights"):
        gp.packed_w4_plan(32, HID, 2 * INTER, paired=True, int8=True)
    with pytest.raises(ValueError, match="must be a positive multiple"):
        tg.grouped_int8_plan(32, HID + 64, HID)


def test_kernel_path_refuses_other_head_widths_and_shapes(monkeypatch):
    """On the kernel path (inputs taken as CUDA tensors) K14b refuses a head
    width other than 128 and K14 an N off its tiles, before any launch: the
    plain version alone quantizes other widths."""
    monkeypatch.setattr(tg, "on_cpu", lambda *t: False)
    a, w = torch.zeros((2, 256), dtype=torch.int8), torch.zeros((256, 128), dtype=torch.int8)
    sa, sw = torch.ones((2, 2)), torch.ones((2, 128))
    with pytest.raises(ValueError, match="heads of 128"):
        tg.grouped_int8_gemm_o4(a, w, sa, sw, head_dim=64)
    w96, sw96 = torch.zeros((256, 96), dtype=torch.int8), torch.ones((2, 96))
    with pytest.raises(ValueError, match="N=96"):
        tg.grouped_int8_gemm_o4(a, w96, sa, sw96)
    w80, sw80 = torch.zeros((256, 80), dtype=torch.int8), torch.ones((2, 80))
    with pytest.raises(ValueError, match="N=80"):
        tg.grouped_int8_gemm(a, w80, sa, sw80)
