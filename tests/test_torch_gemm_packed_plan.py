"""K1's launch plan and the decode core's arithmetic, on the CPU.

``ops/gemm_packed.py::packed_w4_plan`` picks the CUDA launch of the K1
family (the decode core up to 64 rows, the 32 x 32 tile kernel above); the
kernel takes it as it is, so the plans checked here are the launches.  The
core itself runs only on the card, where ``chip_smoke.py`` holds it bit for
bit against the plain version; here numpy emulations of its index math (the
weight loads, the byte permutes, the nibble masks, the ldmatrix addresses on
the swizzled activation tile and the mma fragment layout) and of its order of
float32 additions are held against ``unpack_nibble_planes`` and
``packed_w4_gemm_plain``.
"""
import numpy as np
import pytest
import torch

from atom_tpu_torch.ops import gemm_packed as gp

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


def _covered_once(plan, m, n):
    """Every output element of [m, n] lies in exactly one block and, in a
    core block, in exactly one consumer warp's 16 columns (over all the
    block's rows)."""
    count = np.zeros((plan.grid[1] * max(plan.tile_m, 32), n), np.int64)
    tm, tn, warp_cols = (32, 32, 32) if plan.path == "tile" else (plan.tile_m, plan.tile_n, 16)
    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            for c0 in range(bx * tn, (bx + 1) * tn, warp_cols):
                count[by * tm : (by + 1) * tm, c0 : c0 + warp_cols] += 1
    return (count[:m] == 1).all() and (count[m:] <= 1).all() and plan.grid == (n // tn, -(-m // tm))


@pytest.mark.parametrize("m,k,n", SHAPES, ids=_ids(SHAPES))
def test_plan_covers_every_column_tile_once(m, k, n):
    """The grid's column tiles cover N once and its row tiles M; inside a
    core block the consumer warps (at most 8) cover the tile once."""
    plan = gp.packed_w4_plan(m, k, n)
    assert _covered_once(plan, m, n)
    if plan.path == "core":
        assert plan.tile_n in (32, 64, 128) and plan.tile_n // 16 <= 8


@pytest.mark.parametrize("m,k,n", SHAPES, ids=_ids(SHAPES))
def test_plan_switches_at_64_rows(m, k, n):
    """Up to 64 rows (with a body group) the core, in the fewest of 16, 32
    or 64 rows that hold M unless that leaves SMs without a block; above 64
    rows the tile kernel."""
    plan = gp.packed_w4_plan(m, k, n)
    if m > gp.CORE_MAX_M or k == gp.GROUP:
        assert plan.path == "tile" and plan.args() == [0, 0, 0, 0]
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
        if plan.path == "tile":
            continue
        ng = k // 128 - 1
        assert plan.tile_n in (32, 64, 128) and n % plan.tile_n == 0
        assert 3 <= plan.stages <= ng + 2
        assert plan.smem == gp.core_smem(plan.tile_m, plan.tile_n, plan.stages, ng, head) <= SMEM_BLOCK
        if head:  # a block owns one 128-column head, at most 32 rows
            assert plan.tile_n == 128 and plan.tile_m <= 32
            assert plan.grid == (n // 128, -(-m // plan.tile_m))


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


def _w_offset(row, col, tile_n):
    """gemm_packed.cu::w_offset: rows tile_n bytes apart, TMA's 32/64/128-byte swizzle."""
    off = row * tile_n + col
    mask = {32: 0, 64: 3, 128: 7}[tile_n]
    return off ^ (((off >> 7) & mask) << 4)


def _slot(w, tile_n):
    """A weight slot [64 rows, tile_n bytes] as the TMA lays it out in shared memory."""
    flat = np.zeros(64 * tile_n, np.uint8)
    for r in range(64):
        for c in range(tile_n):
            flat[_w_offset(r, c, tile_n)] = w[r, c]
    return flat


def _load_cols(slot, tile_n, c0, q, tig, banks):
    """load_cols at the 4-row step q: columns c0, c0 + 1 of rows 16q + 4tig
    + ((i + tig) & 3); the loads' word addresses go to `banks`."""
    sel0, sel1 = _selectors(tig)
    u = []
    for i in range(4):
        off = _w_offset(16 * q + 4 * tig + ((i + tig) & 3), c0, tile_n)
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


def _core_group_dot(act, w, keeper, rows, tile_n, wc):
    """Consumer warp wc's int32 dots of one group for its 16 columns and the
    block's `rows` activation rows, as gemm_core_kernel computes them ->
    [rows, 16] (16 x the dot for a nibble group, the dot for the keeper),
    and the word addresses of its weight loads.  w: the group's weight bytes
    [64, tile_n] (the keeper: [128, tile_n], two slots); act: the group's
    activation codes [rows, 128]."""
    lanes = range(32)
    gid_of, tig_of = [ln >> 2 for ln in lanes], [ln & 3 for ln in lanes]
    flat = _swizzled(act.astype(np.uint8))
    w = w.astype(np.uint8)
    slots = [_slot(w[h * 64 : h * 64 + 64], tile_n) for h in range(w.shape[0] // 64)]
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
            t0, t1 = _load_cols(slots[slot], tile_n, c0, q, tig_of[lane], bank_lists)
            t2, t3 = _load_cols(slots[slot], tile_n, c0, q + 1, tig_of[lane], bank_lists)
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
