"""K1's launch plans and the arithmetic of its two GEMM kernels, on the CPU.

``ops/gemm_packed.py::packed_w4_plan`` picks the CUDA launch of the K1
family (the decode core up to 64 rows, the prefill GEMM above); the kernels
take it as it is, so the plans checked here are the launches.  The kernels
run only on the card, where ``chip_smoke.py`` holds them bit for bit against
the plain version; here numpy emulations of their index math (the weight
loads, the byte permutes, the nibble masks, the ldmatrix addresses and the
mma fragment layout of the core; the wgmma register fragments, the
shared-memory descriptor's reads of the swizzled activation tile and the
accumulator layout of the prefill GEMM) and of their order of float32
additions are held against ``unpack_nibble_planes`` and
``packed_w4_gemm_plain``.
"""
import numpy as np
import pytest
import torch

from atom_tpu_torch.ops import gemm_packed as gp
from test_torch_serving import cap_torch_threads

cap_torch_threads()

HID, INTER = 4096, 11008  # Llama-2-7B
# (m, k, n): the decode GEMMs at batch 32 (o_proj, gate/up, down, qkv), the
# 70B down projection's depth, the mixed step's and prefill's rows, small batches
SHAPES = [
    (32, HID, HID), (32, HID, 2 * INTER), (32, INTER, HID), (32, HID, 3 * HID), (32, 28672, 1024),
    (1, HID, HID), (8, HID, 2 * INTER), (16, 640, 256), (17, 1152, 640), (33, HID, HID), (64, HID, 2 * INTER),
    (64, INTER, HID), (65, HID, HID), (100, 384, 224), (288, HID, HID), (1024, HID, 2 * INTER), (32, 128, 64),
]
HEAD_SHAPES = [(32, HID, 3 * HID), (8, HID, 3 * HID), (64, HID, 3 * HID), (100, 640, 768), (4, 256, 512)]
SMEM_BLOCK = 232448


def _ids(shapes):
    return [f"m{m}_k{k}_n{n}" for m, k, n in shapes]


def _prefill_layouts(k):
    """The prefill GEMM's (tile_m, tile_n) at K: 64 rows only when K-blocked."""
    kblk = k // gp.GROUP - 1 > gp.KBLK_THRESHOLD
    return [(r, c) for r in (64, 128) for c in (64, 128) if not (kblk and r == 128)]


def _prefill_cost(m, n, layout):
    """Waves of blocks x a block's measured time per group (packed_w4_plan's estimate)."""
    rows, cols = (layout.tile_m, layout.tile_n) if hasattr(layout, "tile_m") else layout
    blocks = -(-m // rows) * -(-n // cols)
    per_sm = gp._PREFILL_BLOCKS_PER_SM[(rows, cols)]
    return -(-blocks // (132 * per_sm)) * gp._PREFILL_GROUP_US[(rows, cols)]


def _covered_once(plan, m, n):
    """Every output element of [m, n] lies in exactly one block and in
    exactly one consumer warp's 16 columns (over all the block's rows: the
    core's warps and the prefill GEMM's, whose warpgroup of 4 takes 64).  The
    core's grid is (column tiles, row tiles), the prefill GEMM's (row tiles,
    column tiles); its last column tile may pass N (zeros in, nothing out)."""
    tm, tn = plan.tile_m, plan.tile_n
    rows, cols = -(-m // tm), -(-n // tn)
    count = np.zeros((rows * tm, cols * tn), np.int64)
    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            r, c = (by, bx) if plan.path == "core" else (bx, by)
            for c0 in range(c * tn, (c + 1) * tn, 16):
                count[r * tm : (r + 1) * tm, c0 : c0 + 16] += 1
    grid = (cols, rows) if plan.path == "core" else (rows, cols)
    return (count[:m, :n] == 1).all() and (count <= 1).all() and plan.grid == grid


@pytest.mark.parametrize("m,k,n", SHAPES, ids=_ids(SHAPES))
def test_plan_covers_every_column_tile_once(m, k, n):
    """The grid's column tiles cover N once and its row tiles M; inside a
    block the consumer warps (at most 8) cover the tile once."""
    plan = gp.packed_w4_plan(m, k, n)
    assert _covered_once(plan, m, n)
    if plan.path == "core":
        assert plan.tile_n in (32, 64, 128) and plan.tile_n // 16 <= 8
    else:
        assert plan.tile_n in (64, 128) and plan.tile_m in (64, 128)


@pytest.mark.parametrize("m,k,n", SHAPES, ids=_ids(SHAPES))
def test_plan_switches_at_64_rows(m, k, n):
    """Up to 64 rows (with a body group) the core, in the fewest of 16, 32
    or 64 rows that hold M unless that leaves SMs without a block; above 64
    rows the prefill GEMM, in the layout of least estimated time."""
    plan = gp.packed_w4_plan(m, k, n)
    if m > gp.CORE_MAX_M or k == gp.GROUP:
        assert plan.path == "prefill" and plan.args() == [0, plan.tile_m, plan.tile_n, plan.stages]
        assert _prefill_cost(m, n, plan) == min(_prefill_cost(m, n, lay) for lay in _prefill_layouts(k))
        return
    fewest = min(r for r in (16, 32, 64) if r >= m)
    assert plan.path == "core" and plan.args()[0] == 1 and plan.tile_m <= fewest
    if plan.tile_m < fewest:  # row tiles only where the column tiles leave SMs idle
        assert plan.grid[0] * -(-m // (2 * plan.tile_m)) < 132


@pytest.mark.parametrize("m,k,n", SHAPES + HEAD_SHAPES, ids=_ids(SHAPES + HEAD_SHAPES))
def test_plan_ring_fits_shared_memory(m, k, n):
    """The column tile divides N; the ring has 3 to ng + 2 slots and the
    block's shared memory is core_smem's, within what a block may take."""
    for head in (False, True) if n % 128 == 0 else (False,):
        plan = gp.packed_w4_plan(m, k, n, head=head)
        ng = k // 128 - 1
        if plan.path == "prefill":
            assert not head and 3 <= plan.stages <= max(3, ng + 2)
            assert plan.smem == gp.core_smem(plan.tile_m, plan.tile_n, plan.stages, ng, False) <= SMEM_BLOCK
            continue
        assert plan.tile_n in (32, 64, 128) and n % plan.tile_n == 0
        assert 3 <= plan.stages <= ng + 2
        assert plan.smem == gp.core_smem(plan.tile_m, plan.tile_n, plan.stages, ng, head) <= SMEM_BLOCK
        if head:  # a block owns one 128-column head, at most 32 rows
            assert plan.tile_n == 128 and plan.tile_m <= 32
            assert plan.grid == (n // 128, -(-m // plan.tile_m))


@pytest.mark.parametrize("m", [65, 96, 128, 288])
def test_core_above_64_rows_takes_16_row_blocks(m):
    """Above 64 rows the core (the ring epilogue at a decode batch over 64,
    or K1 asked for the core) still takes 16-row blocks when asked, and
    plans as it does up to 64 rows: 32-row head blocks, 64-row blocks for K1
    (fault C3, which made 32- and 64-row blocks over more than 64 rows differ
    from the plain version now and then, is closed: a proxy fence before a
    slot's release)."""
    for head, n in ((True, 3 * HID), (False, 3 * HID)):
        plan = gp.packed_w4_plan(m, HID, n, head=head, path="core")
        assert plan.path == "core" and plan.tile_m == (32 if head else 64) and _covered_once(plan, m, n)
        assert plan.grid == (n // plan.tile_n, -(-m // plan.tile_m))
        for tile_m in (16, 32) if head else (16, 32, 64):
            asked = gp.packed_w4_plan(m, HID, n, head=head, path="core", tile_m=tile_m)
            assert asked.tile_m == tile_m and _covered_once(asked, m, n)
        if head:
            with pytest.raises(ValueError):
                gp.packed_w4_plan(m, HID, n, head=True, path="core", tile_m=64)
    assert gp.packed_w4_plan(64, HID, 3 * HID, head=True).tile_m == 32


@pytest.mark.parametrize("m,n,tile_m,tile_n", [(96, 3 * HID, 32, 128), (128, 3 * HID, 32, 64), (256, 3 * HID, 64, 64),
                                               (128, HID, 32, 128)])
def test_core_plans_the_layouts_fault_c3_had_refused(m, n, tile_m, tile_n):
    """The layouts fault C3 was found in, which ``scripts/torch_gemm_stress.py``
    now launches as planned cases (0 of 100 differ on the card), plan again:
    K2's 32-row head blocks at a decode batch of 96 and 128, K1's core in 32-
    and 64-row blocks over more than 64 rows, with their rows covered once."""
    head = tile_n == 128 and n == 3 * HID and m == 96
    plan = gp.packed_w4_plan(m, HID, n, head=head, path="core", tile_m=tile_m, tile_n=None if head else tile_n)
    assert (plan.path, plan.tile_m, plan.tile_n) == ("core", tile_m, tile_n) and _covered_once(plan, m, n)
    assert plan.smem == gp.core_smem(tile_m, tile_n, plan.stages, HID // 128 - 1, head) <= SMEM_BLOCK


def test_plan_takes_overrides_and_refuses_bad_layouts():
    """Other layouts (for measuring) plan as asked; a tile that does not
    divide N, a width the kernel has no swizzle for, 64-row head blocks or
    a ring too deep for shared memory raise."""
    plan = gp.packed_w4_plan(32, HID, HID, tile_n=128, tile_m=32, stages=6)
    assert (plan.tile_n, plan.tile_m, plan.stages, plan.grid) == (128, 32, 6, (32, 1))
    assert plan.smem == gp.core_smem(32, 128, 6, 31, False) and _covered_once(plan, 32, HID)
    with pytest.raises(ValueError):
        gp.packed_w4_plan(32, HID, 96, tile_n=64)  # 1.5 tiles
    with pytest.raises(ValueError):
        gp.packed_w4_plan(32, HID, HID, tile_n=256)
    with pytest.raises(ValueError):
        gp.packed_w4_plan(64, HID, 3 * HID, head=True, tile_m=64)
    with pytest.raises(ValueError):
        gp.packed_w4_plan(32, HID, HID, tile_n=128, tile_m=64, stages=30)  # 406 KB


@pytest.mark.parametrize("m,k,n,head", [(32, HID, 4100, False), (32, HID, 48, True), (32, 4000, HID, False),
                                        (32, 64, HID, False), (300, 200, 64, False)])
def test_plan_raises_on_shapes_the_kernels_do_not_take(m, k, n, head):
    """N not whole 32-column tiles (128 with the ring epilogue), K not whole
    128-row groups: ValueError, before anything launches."""
    with pytest.raises(ValueError):
        gp.packed_w4_plan(m, k, n, head=head)


# ---------------------------------------------------------------------------
# Emulation of the core's int32 group dot
# ---------------------------------------------------------------------------


def _byte_perm(x, y, sel):
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(sel >> (4 * j)) & 7] << (8 * j) for j in range(4))


def _bytes_s8(word):
    return [((word >> (8 * i)) & 0xFF) - (256 if (word >> (8 * i)) & 0x80 else 0) for i in range(4)]


def _selectors(tig):
    sel0 = sel1 = 0
    for jj in range(4):
        k = (jj - tig) & 3
        sel0 |= (2 * k) << (4 * jj)
        sel1 |= (2 * k + 1) << (4 * jj)
    return sel0, sel1


def _w_offset(row, col, tile_n, paired=False):
    """gemm_packed.cu::w_offset: rows tile_n bytes apart, TMA's 32/64/128-byte
    swizzle; the paired slot (one 3D box [64][gate, up][tile_n / 2]) under the
    swizzle of its half's width, 32- or 64-byte."""
    off = row * tile_n + col
    mask = {64: 1, 128: 3}[tile_n] if paired else {32: 0, 64: 3, 128: 7}[tile_n]
    return off ^ (((off >> 7) & mask) << 4)


def _slot(w, tile_n, paired=False):
    """A weight slot [64 rows, tile_n bytes] as the TMA lays it out in shared
    memory (paired: w's columns are the gate half, then the up half)."""
    flat = np.zeros(64 * tile_n, np.uint8)
    for r in range(64):
        for c in range(tile_n):
            flat[_w_offset(r, c, tile_n, paired)] = w[r, c]
    return flat


def _load_cols(slot, tile_n, c0, q, tig, banks, paired=False):
    """load_cols at the 4-row step q: columns c0, c0 + 1 of rows 16q + 4tig
    + ((i + tig) & 3); the loads' word addresses go to `banks`."""
    sel0, sel1 = _selectors(tig)
    u = []
    for i in range(4):
        off = _w_offset(16 * q + 4 * tig + ((i + tig) & 3), c0, tile_n, paired)
        banks[i].append(off // 4)
        u.append(int(slot[off]) | int(slot[off + 1]) << 8)
    x, y = _byte_perm(u[0], u[1], 0x5410), _byte_perm(u[2], u[3], 0x5410)
    return _byte_perm(x, y, sel0), _byte_perm(x, y, sel1)


def _swizzled(act):
    """The activation tile [rows, 128] as TMA's 128-byte swizzle lays it out."""
    flat = np.zeros(act.size, np.uint8)
    for r in range(act.shape[0]):
        for c in range(8):
            flat[r * 128 + ((c ^ (r & 7)) << 4) : r * 128 + ((c ^ (r & 7)) << 4) + 16] = act[r, c * 16 : c * 16 + 16]
    return flat


def _ldsm_x4(flat, rbase, chunk):
    """ldmatrix x4 as the kernel addresses it: lane l gives row rbase + (l & 7)
    + 8 (l >> 4), chunk chunk + ((l >> 3) & 1), swizzled; lane (gid, tig)
    receives bytes 4tig.. of the row that lane 8 mi + gid addressed."""
    addr = []
    for lane in range(32):
        r = rbase + (lane & 7) + ((lane >> 4) << 3)
        addr.append(r * 128 + (((chunk + ((lane >> 3) & 1)) ^ (r & 7)) << 4))
    out = np.zeros((32, 4), np.int64)
    for lane in range(32):
        gid, tig = lane >> 2, lane & 3
        for mi in range(4):
            w = flat[addr[8 * mi + gid] + 4 * tig : addr[8 * mi + gid] + 4 * tig + 4]
            out[lane, mi] = int(w[0]) | int(w[1]) << 8 | int(w[2]) << 16 | int(w[3]) << 24
    return out


def _mma(d, a_regs, b0, b1, gid_of, tig_of):
    """m16n8k32 s8: A [16, 32] from lanes' a0..a3, B [32, 8] from b0, b1; D
    accumulated into d[lane] = (D[gid][2tig], D[gid][2tig+1], D[gid+8][2tig], D[gid+8][2tig+1])."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = gid_of[lane], tig_of[lane]
        A[g, 4 * t : 4 * t + 4] = _bytes_s8(a_regs[lane][0])
        A[g + 8, 4 * t : 4 * t + 4] = _bytes_s8(a_regs[lane][1])
        A[g, 16 + 4 * t : 16 + 4 * t + 4] = _bytes_s8(a_regs[lane][2])
        A[g + 8, 16 + 4 * t : 16 + 4 * t + 4] = _bytes_s8(a_regs[lane][3])
        B[4 * t : 4 * t + 4, g] = _bytes_s8(b0[lane])
        B[16 + 4 * t : 16 + 4 * t + 4, g] = _bytes_s8(b1[lane])
    D = A @ B
    for lane in range(32):
        g, t = gid_of[lane], tig_of[lane]
        d[lane] += [D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1]]


def _core_group_dot(act, w, keeper, rows, tile_n, wc, paired=False):
    """Consumer warp wc's int32 dots of one group for its 16 columns and the
    block's `rows` activation rows, as gemm_core_kernel computes them ->
    [rows, 16] (16 x the dot for a nibble group, the dot for the keeper),
    and the word addresses of its weight loads.  w: the group's weight bytes
    [64, tile_n] (the keeper: [128, tile_n], two slots); act: the group's
    activation codes [rows, 128].  ``paired``: the SiLU-quant epilogue's
    slot (w's columns: tile_n / 2 gate columns, then as many up columns)."""
    lanes = range(32)
    gid_of, tig_of = [ln >> 2 for ln in lanes], [ln & 3 for ln in lanes]
    flat = _swizzled(act.astype(np.uint8))
    w = w.astype(np.uint8)
    slots = [_slot(w[h * 64 : h * 64 + 64], tile_n, paired) for h in range(w.shape[0] // 64)]
    d = np.zeros((rows // 8, 32, 4), np.int64)
    banks = []
    # (slot, first 4-row step, plane, activation chunk) of each k-step
    steps = [(st // 2, 2 * (st & 1), None, 2 * st) for st in range(4)] if keeper else [
        (0, 2 * sh, plane, plane * 4 + sh * 2) for sh in range(2) for plane in range(2)]
    for slot, q, plane, chunk in steps:
        regs = []
        for lane in lanes:
            bank_lists = [[] for _ in range(4)]
            c0 = wc * 16 + 2 * gid_of[lane]
            t0, t1 = _load_cols(slots[slot], tile_n, c0, q, tig_of[lane], bank_lists, paired)
            t2, t3 = _load_cols(slots[slot], tile_n, c0, q + 1, tig_of[lane], bank_lists, paired)
            banks.append(bank_lists)
            t = [t0, t1, t2, t3]
            if plane == 0:
                t = [((x << 4) & 0xFFFFFFFF) & 0xF0F0F0F0 for x in t]
            elif plane == 1:
                t = [x & 0xF0F0F0F0 for x in t]
            regs.append(t)
        for np_ in range(rows // 16):
            b = _ldsm_x4(flat, np_ * 16, chunk)
            _mma(d[2 * np_], regs, b[:, 0], b[:, 1], gid_of, tig_of)
            _mma(d[2 * np_ + 1], regs, b[:, 2], b[:, 3], gid_of, tig_of)
    out = np.zeros((rows, 16), np.int64)
    for nt in range(rows // 8):
        for lane in lanes:
            for e in range(4):
                out[nt * 8 + 2 * tig_of[lane] + (e & 1), 2 * gid_of[lane] + (e >> 1)] = d[nt, lane, e]
    return out, banks


@pytest.mark.parametrize("rows,tile_n", [(16, 32), (32, 64), (16, 128)])
def test_core_group_dot_equals_unpacked_codes(rows, tile_n):
    """The core's weight loads (swizzled slot), permutes, nibble masks,
    swizzled ldmatrix reads and mma fragments give 16 x (a . w) for a nibble
    group and a . w for the int8 keeper, against ``unpack_nibble_planes``'
    codes, for every consumer warp of the block; the 4 lanes of a column
    read 4 different banks in every load."""
    rng = np.random.default_rng(rows + tile_n)
    wp = rng.integers(-128, 128, (64, tile_n)).astype(np.int8)
    a = rng.integers(-8, 8, (rows, 128)).astype(np.int8)
    codes = gp.unpack_nibble_planes(torch.from_numpy(wp)).numpy()[0].astype(np.int64)  # [128, tile_n]
    wk = rng.integers(-127, 128, (128, tile_n)).astype(np.int8)
    ak = rng.integers(-127, 128, (rows, 128)).astype(np.int8)
    for wc in range(tile_n // 16):
        cols = slice(wc * 16, wc * 16 + 16)
        got, banks = _core_group_dot(a, wp.view(np.uint8), False, rows, tile_n, wc)
        np.testing.assert_array_equal(got, 16 * (a.astype(np.int64) @ codes[:, cols]))
        got, _ = _core_group_dot(ak, wk.view(np.uint8), True, rows, tile_n, wc)
        np.testing.assert_array_equal(got, ak.astype(np.int64) @ wk.astype(np.int64)[:, cols])
        # each load instruction of the warp: lanes 2k and 2k+1 share a word, no two words share a bank
        for step in range(0, len(banks), 32):
            for i in range(4):
                for call in range(2):
                    words = {lists[i][call] for lists in banks[step : step + 32]}
                    assert len(words) == 16 and len({w % 32 for w in words}) == 16


@pytest.mark.parametrize("rows,tile_n", [(32, 64), (16, 128), (64, 128)])
def test_paired_slot_group_dot_reads_gate_and_up_columns(rows, tile_n):
    """K10's SiLU-quant gate/up launch: block x's slot is one 3D box, each
    row the gate columns t x .. of the gate/up weight (t = tile_n / 2), then
    the up columns inter + t x .., under the swizzle of t bytes (32- or
    64-byte); every consumer warp's dots, through the core's loads, permutes
    and mma fragments, are those of its gate or up columns, and the 4 lanes
    of a column still read 4 different banks."""
    rng = np.random.default_rng(rows + tile_n + 1)
    t, inter = tile_n // 2, 256
    wp = rng.integers(-128, 128, (64, 2 * inter)).astype(np.int8)
    codes = gp.unpack_nibble_planes(torch.from_numpy(wp)).numpy()[0].astype(np.int64)  # [128, 2 * inter]
    wk = rng.integers(-127, 128, (128, 2 * inter)).astype(np.int8)
    a = rng.integers(-8, 8, (rows, 128)).astype(np.int8)
    ak = rng.integers(-127, 128, (rows, 128)).astype(np.int8)
    x = 1  # the block's column tile
    cols_of_tile = np.r_[x * t : x * t + t, inter + x * t : inter + x * t + t]
    for wc in range(tile_n // 16):
        cols = cols_of_tile[wc * 16 : wc * 16 + 16]
        got, banks = _core_group_dot(a, wp[:, cols_of_tile].view(np.uint8), False, rows, tile_n, wc, paired=True)
        np.testing.assert_array_equal(got, 16 * (a.astype(np.int64) @ codes[:, cols]))
        got, _ = _core_group_dot(ak, wk[:, cols_of_tile].view(np.uint8), True, rows, tile_n, wc, paired=True)
        np.testing.assert_array_equal(got, ak.astype(np.int64) @ wk.astype(np.int64)[:, cols])
        for step in range(0, len(banks), 32):
            for i in range(4):
                for call in range(2):
                    words = {lists[i][call] for lists in banks[step : step + 32]}
                    assert len(words) == 16 and len({w % 32 for w in words}) == 16


@pytest.mark.parametrize("m", [1, 8, 17, 32, 64])
@pytest.mark.parametrize("tile_n", [None, 64, 128])
def test_paired_plan_clusters_cover_the_groups(m, tile_n):
    """The SiLU-quant gate/up launch (7B: K 4096, N = 2 x 11008): the core, 64
    (t = 32, the default) or 128 weight columns a block, the grid of the
    unpaired plan at that width; its clusters of 256 / tile_n blocks along
    the columns cover each 128-channel group of the intermediate exactly
    (block x: gate columns t x .. t x + t - 1, rank x mod cluster); the
    shared memory is core_smem's, with the ranks' partial maxima."""
    inter = 11008
    plan = gp.packed_w4_plan(m, HID, 2 * inter, paired=True, tile_n=tile_n)
    t = plan.tile_n // 2
    assert plan.path == "core" and plan.tile_n == (tile_n or 64) and plan.cluster == 128 // t
    assert plan.grid == gp.packed_w4_plan(m, HID, 2 * inter, tile_n=plan.tile_n).grid == (inter // t, plan.grid[1])
    assert plan.grid[0] % plan.cluster == 0
    groups = [{(x * t) // 128 for x in range(c * plan.cluster, (c + 1) * plan.cluster)}
              for c in range(plan.grid[0] // plan.cluster)]
    assert groups == [{g} for g in range(inter // 128)]
    assert plan.smem == gp.core_smem(plan.tile_m, plan.tile_n, plan.stages, HID // 128 - 1, False, True) <= SMEM_BLOCK
    assert gp.packed_w4_plan(m, HID, 2 * inter).cluster == 1


def test_paired_plan_refuses_what_the_epilogue_cannot_take():
    """No paired launch in 32-column blocks (a group would span 8 blocks), on
    an intermediate that is not whole 128-channel groups, with the ring
    epilogue or on the prefill GEMM; the shallowest ring plans (the epilogue's
    tile, which reuses the ring, fits it at the largest block)."""
    assert gp.packed_w4_plan(64, HID, 2 * 11008, paired=True, tile_m=64, tile_n=128, stages=3).stages == 3
    for kwargs, n in ((dict(tile_n=32), 2 * 11008), (dict(), 2 * 1088), (dict(head=True), 2 * 11008),
                      (dict(path="prefill"), 2 * 11008)):
        with pytest.raises(ValueError):
            gp.packed_w4_plan(32, HID, n, paired=True, **kwargs)


# ---------------------------------------------------------------------------
# Emulation of the core's order of float32 additions
# ---------------------------------------------------------------------------


def _core_order(a, wp, wk, sa, sw):
    """out = the Chain of gemm_core_kernel in numpy float32: body terms
    (16 x dot) * (sa / 16) * sw, serial at <= 112 body groups, K-blocked by 16
    above; the keeper's term last (before the last block's partial)."""
    m, ktot = a.shape
    ng = ktot // 128 - 1
    codes = gp.unpack_nibble_planes(torch.from_numpy(wp)).numpy().astype(np.int64)
    a64 = a.astype(np.int64)
    f = np.float32
    out = np.zeros((m, wp.shape[1]), f)
    part = np.zeros_like(out)
    kblk = ng > gp.KBLK_THRESHOLD
    for g in range(ng):
        dot16 = (16 * (a64[:, g * 128 : (g + 1) * 128] @ codes[g])).astype(f)
        term = (dot16 * (sa[:, g : g + 1] * f(0.0625))) * sw[g : g + 1, :]
        if kblk:
            part = part + term
            if (g + 1) % gp.KBLK_G == 0 and g + 1 < ng:
                out, part = out + part, np.zeros_like(out)
        else:
            out = out + term
    keeper = ((a64[:, ng * 128 :] @ wk.astype(np.int64)).astype(f) * sa[:, ng : ng + 1]) * sw[ng : ng + 1, :]
    out = out + keeper
    return out + part if kblk else out


@pytest.mark.parametrize("ktot", [HID, 15488])
def test_core_float_order_equals_plain_bitwise(ktot):
    """31 body groups (serial) and 120 (K-blocked, the 30B / 70B MLP's order):
    the core's chain, with the 1/16 folded into the activation scales, equals
    ``packed_w4_gemm_plain`` bit for bit."""
    rng = np.random.default_rng(ktot)
    m, n, ng = 32, 64, ktot // 128 - 1
    a = np.concatenate([rng.integers(-8, 8, (m, ng * 128)), rng.integers(-127, 128, (m, 128))], 1).astype(np.int8)
    wp = rng.integers(-128, 128, (ng * 64, n)).astype(np.int8)
    wk = rng.integers(-127, 128, (128, n)).astype(np.int8)
    sa = rng.uniform(0.01, 0.2, (m, ng + 1)).astype(np.float32)
    sw = rng.uniform(0.001, 0.02, (ng + 1, n)).astype(np.float32)
    want = gp.packed_w4_gemm_plain(*(torch.from_numpy(x) for x in (a, wp, wk, sa, sw))).numpy()
    np.testing.assert_array_equal(_core_order(a, wp, wk, sa, sw).view(np.int32), want.view(np.int32))


# ---------------------------------------------------------------------------
# The prefill GEMM: plans, and an emulation of its fragments, wgmma operands
# and order of float32 additions
# ---------------------------------------------------------------------------

# (m, k, n): the engine's prefill buckets and the mixed step at Llama-2-7B's
# o_proj, gate/up, down and qkv, the 70B down depth, and K7's decode fallback
PREFILL_SHAPES = [
    (128, HID, HID), (128, HID, 2 * INTER), (128, INTER, HID), (128, HID, 3 * HID), (256, HID, HID),
    (256, INTER, HID), (512, HID, 2 * INTER), (288, HID, 3 * HID), (288, 28672, 1024), (1024, INTER, HID),
    (1024, HID, 3 * HID), (8, HID, 3 * HID), (65, HID, HID),
]


@pytest.mark.parametrize("m,k,n", PREFILL_SHAPES, ids=_ids(PREFILL_SHAPES))
def test_prefill_plan_takes_the_fastest_layout_within_shared_memory(m, k, n):
    """The prefill plan (K7's at any M, K1's above 64 rows) covers every
    output once, fits a block's shared memory with a ring of 3 to 6 slots,
    and takes the layout of least estimated time (the largest block among
    equals); 128-row blocks only where the sum is not K-blocked."""
    plan = gp.packed_w4_plan(m, k, n, path="prefill")
    ng = k // gp.GROUP - 1
    assert plan.path == "prefill" and _covered_once(plan, m, n)
    assert 3 <= plan.stages <= 6 and plan.smem == gp.core_smem(plan.tile_m, plan.tile_n, plan.stages, ng, False)
    assert plan.smem <= SMEM_BLOCK
    if ng > gp.KBLK_THRESHOLD:
        assert plan.tile_m == 64
    costs = {lay: _prefill_cost(m, n, lay) for lay in _prefill_layouts(k)}
    assert costs[(plan.tile_m, plan.tile_n)] == min(costs.values())
    assert all(lay[0] * lay[1] <= plan.tile_m * plan.tile_n for lay, c in costs.items() if c == min(costs.values()))
    if m > gp.CORE_MAX_M:
        assert gp.packed_w4_plan(m, k, n) == plan


def test_prefill_plan_takes_overrides_and_refuses_bad_layouts():
    """Other tiles plan as asked (for measuring), and the core can be asked
    for above 64 rows, in 16-, 32- or 64-row blocks; 128-row blocks of a K-blocked sum,
    widths the kernel has no warpgroups for, the ring epilogue on the
    prefill GEMM and the core without a body group raise."""
    plan = gp.packed_w4_plan(1024, HID, HID, path="prefill", tile_m=64, tile_n=128, stages=4)
    assert (plan.tile_m, plan.tile_n, plan.stages, plan.grid) == (64, 128, 4, (16, 32))
    plan = gp.packed_w4_plan(1024, HID, HID, tile_n=64)  # the other dimension still chosen
    assert plan.tile_n == 64 and plan.tile_m in (64, 128)
    core = gp.packed_w4_plan(128, HID, HID, path="core")
    assert core.path == "core" and core.tile_m == 32 and _covered_once(core, 128, HID)  # halved: 64 x 2 blocks < 132
    for tile_m in (16, 32, 64):
        assert gp.packed_w4_plan(128, HID, HID, path="core", tile_m=tile_m).tile_m == tile_m
    with pytest.raises(ValueError):
        gp.packed_w4_plan(288, 28672, 1024, tile_m=128)
    with pytest.raises(ValueError):
        gp.packed_w4_plan(128, HID, HID, path="prefill", tile_n=32)
    with pytest.raises(ValueError):
        gp.packed_w4_plan(128, HID, HID, path="prefill", tile_m=256)
    with pytest.raises(ValueError):
        gp.packed_w4_plan(128, HID, 3 * HID, head=True, path="prefill")
    with pytest.raises(ValueError):
        gp.packed_w4_plan(128, 128, HID, path="core")
    with pytest.raises(ValueError):
        gp.packed_w4_plan(128, HID, HID, path="tile")


def _byte_perm_v(x, y, sel):
    """__byte_perm on arrays (per-element selectors)."""
    b = np.stack([(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)], -1)
    sel = np.broadcast_to(sel, x.shape)
    out = np.zeros(x.shape, np.int64)
    for j in range(4):
        out |= np.take_along_axis(b, ((sel >> (4 * j)) & 7)[..., None], -1)[..., 0] << (8 * j)
    return out


def _s8(word):
    """The 4 signed bytes of each int32 word -> [..., 4]."""
    b = np.stack([(word >> (8 * i)) & 0xFF for i in range(4)], -1)
    return b - 256 * (b >= 128)


def _prefill_frags(slots, keeper, tile_n):
    """gemm_prefill_kernel's build() for every consumer thread of a block:
    A registers [k-step j, register q, warp, lane] from a group's weight
    slot (the keeper's two), each [64 rows, tile_n] as TMA lays it out."""
    warp = np.arange(tile_n // 16)[:, None]
    lane = np.arange(32)[None, :]
    gid, tig = lane >> 2, lane & 3
    c0 = warp * 16 + 2 * gid
    sels = [_selectors(t) for t in range(4)]
    sel0, sel1 = np.array([s[0] for s in sels])[tig], np.array([s[1] for s in sels])[tig]
    mask = {64: 3, 128: 7}[tile_n]

    def load_cols(slot, q):
        u = []
        for i in range(4):
            off = (16 * q + 4 * tig + ((i + tig) & 3)) * tile_n + c0
            off = off ^ (((off >> 7) & mask) << 4)
            u.append(slot[off].astype(np.int64) | slot[off + 1].astype(np.int64) << 8)
        x, y = _byte_perm_v(u[0], u[1], 0x5410), _byte_perm_v(u[2], u[3], 0x5410)
        return _byte_perm_v(x, y, sel0), _byte_perm_v(x, y, sel1)

    a = np.zeros((4, 4) + c0.shape, np.int64)
    for st in range(4):
        if keeper:  # k-step st: keeper rows 32 st.., slot st // 2
            a[st, 0], a[st, 1] = load_cols(slots[st // 2], 2 * (st & 1))
            a[st, 2], a[st, 3] = load_cols(slots[st // 2], 2 * (st & 1) + 1)
        elif st < 2:  # k-steps sh (low nibbles) and 2 + sh (high) from rows 32 sh..
            t = load_cols(slots[0], 2 * st) + load_cols(slots[0], 2 * st + 1)
            for q in range(4):
                a[st, q] = (t[q] << 4) & 0xF0F0F0F0
                a[2 + st, q] = t[q] & 0xF0F0F0F0
    return a


def _wgmma_unit(a, flat, h, wg):
    """The 4 k-steps of wgmma m64n64k32 s8 for warpgroup wg on rows 64h.. of
    the activation tile `flat` (swizzled, 128-byte rows): A from the
    registers of warps 4wg..4wg + 3 (lane (gid, tig) of warp w gives A rows
    16w + gid and + 8, k bytes 4tig.. and 16 + 4tig..), B read through the
    shared-memory descriptor (start 8192 h + 32 j, 8-row atoms 1024 bytes
    apart, 128-byte rows, the 128-byte swizzle on the address) -> the
    accumulator D [64, 64] as int64."""
    lane = np.arange(32)
    gid, tig = lane >> 2, lane & 3
    n = np.arange(64)
    d = np.zeros((64, 64), np.int64)
    for j in range(4):
        A = np.zeros((64, 32), np.int64)
        for w in range(4):
            regs = _s8(a[j, :, 4 * wg + w, :])  # [4 regs, 32 lanes, 4 bytes]
            for q in range(4):
                rows = 16 * w + gid + 8 * (q & 1)
                for b in range(4):
                    A[rows, 16 * (q >> 1) + 4 * tig + b] = regs[q, :, b]
        addr = 8192 * h + 32 * j + (n // 8)[None, :] * 1024 + (n % 8)[None, :] * 128 + np.arange(32)[:, None]
        addr = addr ^ (((addr >> 7) & 7) << 4)
        B = flat[addr].astype(np.int64)
        d += A @ (B - 256 * (B >= 128))
    return d


def _prefill_emulated(a, wp, wk, sa, sw, tile_m, tile_n):
    """gemm_prefill_kernel in numpy, block by block: the ring's slots as TMA
    fills them (zeros past M and N), the staged activation scales (body
    groups times 1/16), the fragments, the wgmma units, the accumulator
    layout (thread (w, gid, tig)'s element e of a unit: activation row
    8 (e >> 2) + 2 tig + (e & 1), weight column 16 w + 2 gid + ((e >> 1) & 1)),
    and each element's chain in group order (K-blocked above 112 groups),
    stored where row < M and column < N."""
    f = np.float32
    m, ktot = a.shape
    n = wp.shape[1]
    ng = ktot // 128 - 1
    kblk = ng > gp.KBLK_THRESHOLD
    mp, np_ = -(-m // tile_m) * tile_m, -(-n // tile_n) * tile_n
    ap = np.zeros((mp, ktot), np.int8)
    ap[:m] = a
    wpp, wkp = np.zeros((ng * 64, np_), np.int8), np.zeros((128, np_), np.int8)
    wpp[:, :n], wkp[:, :n] = wp, wk
    swp = np.zeros((ng + 1, np_), f)
    swp[:, :n] = sw
    sa_s = np.zeros((ng + 1, mp), f)
    sa_s[:, :m] = sa.T
    sa_s[:ng] *= f(0.0625)
    out = np.zeros((m, n), f)
    lane = np.arange(32)
    gid, tig = lane >> 2, lane & 3
    e = np.arange(32)
    for c in range(np_ // tile_n):
        cols = slice(c * tile_n, (c + 1) * tile_n)
        frags = [_prefill_frags([_slot(wpp[g * 64 : g * 64 + 64, cols].view(np.uint8), tile_n)], False, tile_n)
                 for g in range(ng)]
        frags.append(_prefill_frags([_slot(wkp[h * 64 : h * 64 + 64, cols].view(np.uint8), tile_n) for h in range(2)],
                                    True, tile_n))
        for r in range(mp // tile_m):
            rows = slice(r * tile_m, (r + 1) * tile_m)
            acc = np.zeros((tile_m, tile_n), f)
            part = np.zeros_like(acc)
            for g in range(ng + 1):
                flat = _swizzled(ap[rows, g * 128 : (g + 1) * 128].view(np.uint8))
                dot = np.zeros((tile_m, tile_n), np.int64)
                for wg in range(tile_n // 64):
                    for h in range(tile_m // 64):
                        d = _wgmma_unit(frags[g], flat, h, wg)
                        for w in range(4):  # thread (w, lane)'s 32 elements, as the kernel's fold indexes them
                            drow = 16 * w + gid[:, None] + 8 * ((e[None, :] >> 1) & 1)
                            dcol = 8 * (e[None, :] >> 2) + 2 * tig[:, None] + (e[None, :] & 1)
                            arow = 64 * h + dcol
                            wcol = 64 * wg + 16 * w + 2 * gid[:, None] + ((e[None, :] >> 1) & 1)
                            dot[arow, wcol] = d[drow, dcol]
                term = (dot.astype(f) * sa_s[g, rows][:, None]) * swp[g, cols][None, :]
                if g == ng:
                    acc = acc + term
                    if kblk:
                        acc = acc + part
                elif kblk:
                    part = part + term
                    if (g + 1) % gp.KBLK_G == 0 and g + 1 < ng:
                        acc, part = acc + part, np.zeros_like(part)
                else:
                    acc = acc + term
            r0, c0 = r * tile_m, c * tile_n
            out[r0 : min(m, r0 + tile_m), c0 : min(n, c0 + tile_n)] = acc[: m - r0, : n - c0]
    return out


@pytest.mark.parametrize("m,ktot,n,tile_m,tile_n", [
    (100, 640, 192, 64, 64), (100, 640, 192, 64, 128), (100, 640, 192, 128, 64), (100, 640, 192, 128, 128),
    (160, 1152, 256, 128, 128), (65, 15488, 128, 64, 128), (70, 128, 64, 128, 64),
], ids=["m100_t64x64", "m100_t64x128", "m100_t128x64", "m100_t128x128", "m160_t128x128", "m65_kblk_t64x128",
        "m70_keeper_only"])
def test_prefill_emulation_equals_plain_bitwise(m, ktot, n, tile_m, tile_n):
    """The prefill GEMM's fragments (the decode core's loads and permutes,
    one warpgroup per 64 columns), wgmma operands (register A, descriptor B
    on the swizzled tile, 64-row units) and accumulator layout give each
    group's exact int32 dot, and its chain (1/16 folded into the staged
    scales, the keeper last, K-blocked above 112 groups) equals
    ``packed_w4_gemm_plain`` bit for bit: M not a multiple of the row tile,
    the last column tile past N, 120 body groups, no body group at all."""
    rng = np.random.default_rng(m + ktot + n + tile_m + tile_n)
    ng = ktot // 128 - 1
    a = np.concatenate([rng.integers(-8, 8, (m, ng * 128)), rng.integers(-127, 128, (m, 128))], 1).astype(np.int8)
    wp = rng.integers(-128, 128, (ng * 64, n)).astype(np.int8)
    wk = rng.integers(-127, 128, (128, n)).astype(np.int8)
    sa = rng.uniform(0.01, 0.2, (m, ng + 1)).astype(np.float32)
    sw = rng.uniform(0.001, 0.02, (ng + 1, n)).astype(np.float32)
    want = gp.packed_w4_gemm_plain(*(torch.from_numpy(x) for x in (a, wp, wk, sa, sw))).numpy()
    got = _prefill_emulated(a, wp, wk, sa, sw, tile_m, tile_n)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
