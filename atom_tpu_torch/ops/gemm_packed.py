"""4-bit-weight dual-path GEMMs (``atom_tpu/ops/pallas_gemm_packed.py``).

Kernel K1, ``packed_w4_gemm``: ``out f32 [M, N] = sum_g (A_g . W_g)_i32 *
sa[:, g] * sw[g, :] + (A_k . W_k)_i32 * sa[:, ng] * sw[ng, :]`` over
nibble-plane INT4 body groups and the INT8 keeper, in that f32 order.

Kernel K2, ``packed_w4_gemm_qkv_ring_fused``: RMSNorm (rstd passed in) ->
dual-path activation quantization -> the K1 product -> RoPE on q and k ->
per-head asymmetric u4 quantization of post-RoPE K and of V -> stores into
the hot ring at column ``row``, in place.  Returns q.

Kernel K7, ``packed_w4_gemm_qkv``: the K1 product on an already quantized
activation -> RoPE on q and k -> the same per-head K/V quantization, returned
as one byte per code with float32 params (prefill appends whole pages from
them; decode off the ring-fused geometry hands them to ``write_hot``).

Kernel K8, ``packed_w4_gemm_qkv_ring``: K2 without its prologue, for specs
whose activation quantization the prologue does not implement.

Kernel K9, ``packed_w4_gemm_fused_in``: the K1 product with the dynamic
activation quantization (and, given a norm weight, the RMSNorm) in front and
the residual add behind: ``bf16(resid + bf16(acc))``, the roundings of the
unfused chain ``x + quant_gemm_packed(reorder_quant(..))``, which it equals
bit for bit.  Given the layer's ``reorder`` index it takes the ungathered
activation and its prologue reads the gather in place.

All launch ``csrc/gemm_packed.cu`` on CUDA tensors and run their plain
versions (``*_plain``) on CPU tensors.  The plain versions compute each
group's integer dot as a float32 matmul, exact because every partial sum is
an integer below 2**24 (|sum| <= 128 * 127 * 127); on the card that needs
``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default.

The order of the float32 sum is the TPU kernel's: up to ``KBLK_THRESHOLD``
body groups one chain per output element over the groups, the keeper last;
above it partial sums of ``KBLK_G`` groups, each added to the output in turn,
the keeper's term before the last partial.  :func:`packed_w4_plan` picks
the CUDA launch for a shape: up to ``CORE_MAX_M`` rows the pipelined decode
core (column tiles, a ring of TMA copies a block, a warp per 16 columns
keeping its float chains in registers), above it the prefill GEMM (blocks of
64 or 128 rows x 64 or 128 columns on the same ring, a warpgroup per 64
columns on the int8 ``wgmma``, the fold of one 64-row unit overlapping the
next unit's products).  K7 always runs the prefill GEMM.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from atom_tpu_torch.numerics import rms_rstd, rp_bf16
from atom_tpu_torch.ops import _build
from atom_tpu_torch.ops.formats import KernelPackedWeight, QuantizedActivation, quantize_dual_path
from atom_tpu_torch.ops.kv_layout import pack_channel_planes
from atom_tpu_torch.ops.reference import quantize_kv_asym
from atom_tpu_torch.ops.runtime import check_kernel_input, on_cpu

GROUP = 128
HALF = GROUP // 2
_TN = 32  # N is whole 32-column tiles
KBLK_THRESHOLD = 112  # body groups above which the sum is K-blocked (pallas_gemm_packed.py:174)
KBLK_G = 16  # groups of a K-blocked partial sum
CORE_MAX_M = 64  # rows up to which the decode core runs; the prefill GEMM above
HEAD = 128  # columns of a head: the ring epilogue's block owns one
_CORE_ROWS = (16, 32, 64)  # block rows of the core (tile_m)
_CORE_COLS = (32, 64, 128)  # block columns of the core (tile_n): a consumer warp per 16
_STAGES = 8  # ring slots of the core (3 to 35 measured within a few per cent on the H100; 8 the best or equal)
# K14's core ring (128-row int8 slots, twice K1's bytes a slot) in blocks taller than 16 rows: 4 slots, K1's
# bytes in flight, faster there than 8; 16-row blocks keep 8, faster there than 4 (NVIDIA H100 80GB HBM3,
# scripts/torch_int8_carrier_compare.py --stages; PERF.md section 6)
_INT8_TALL_STAGES = 4
_PAIRED_COLS = (64, 128)  # the SiLU-quant gate/up core's block columns: t = 32 or 64 gate + as many up columns
_PAIRED_TILE_N = 64  # its default: 4-block clusters (PERF.md section 6 holds both layouts' times)
_PREFILL_ROWS = (64, 128)  # block rows of the prefill GEMM: one or two 64-row wgmma units a group
_PREFILL_COLS = (64, 128)  # block columns of the prefill GEMM: a consumer warpgroup per 64
_PREFILL_STAGES = 6  # ring slots of the prefill GEMM, fewer where shared memory holds fewer
# A prefill block's time per group (us) by (tile_m, tile_n), and its blocks per SM: NVIDIA H100 80GB
# HBM3, 700 W, scripts/torch_prefill_gemm.py --crossover (one wave of blocks, 32-1,024 rows)
_PREFILL_GROUP_US = {(64, 64): 0.66, (64, 128): 0.84, (128, 64): 0.90, (128, 128): 1.2}
_PREFILL_BLOCKS_PER_SM = {(64, 64): 2, (64, 128): 1, (128, 64): 1, (128, 128): 1}
_SMS = 132  # the H100's SMs
_SMEM_BLOCK = 232448  # the most shared memory one block may take

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PLAN = ctypes.POINTER(ctypes.c_int)


class PackedW4Plan(NamedTuple):
    """The launch of a K1-family GEMM, as the CUDA entry points take it.

    ``path`` "core": blocks of ``tile_m`` rows x ``tile_n`` columns, one
    producer warp and a consumer warp per 16 columns (over all the block's
    rows), a ring of ``stages`` group slots, ``smem`` bytes of dynamic shared
    memory, grid ``(N / tile_n, ceil(M / tile_m))``.  ``path`` "prefill":
    blocks of ``tile_m`` rows x ``tile_n`` columns, a consumer warpgroup per
    64 columns and a producer warp, the same ring and shared memory, grid
    ``(ceil(M / tile_m), ceil(N / tile_n))`` (row tiles first, so that the
    blocks in flight share their column tiles' weights in L2).  ``cluster``:
    blocks a thread-block cluster along the grid's columns (K10's SiLU-quant
    gate/up launch, whose block takes ``tile_n / 2`` gate and as many up
    columns: the 128-channel groups' blocks; 1 for every other launch)."""

    path: str
    tile_m: int
    tile_n: int
    stages: int
    smem: int
    grid: tuple
    cluster: int = 1

    def args(self) -> list:
        """The plan as the C entry points' four ints."""
        return [int(self.path == "core"), self.tile_m, self.tile_n, self.stages]


_MAX_RANKS = 4  # the SiLU-quant epilogue's largest cluster (t = 32)


def core_smem(tile_m: int, tile_n: int, stages: int, ng: int, head: bool, paired: bool = False,
              wrows: int = HALF) -> int:
    """Dynamic shared memory of a core or prefill block
    (``gemm_packed.cu::core_smem``): per ring stage the activation tile, the
    weight slot (``wrows`` byte rows: 64, or K14's 128-row int8 slot), the
    scale row and two barriers; the activation scales of all groups; the
    head epilogue's f32 tile and its rows' cos and sin; the SiLU-quant
    epilogue's partial maxima of up to 4 cluster ranks (``paired``); 1 KB to
    align the ring."""
    stage = tile_m * GROUP + tile_n * wrows + tile_n * 4 + 16
    return (1024 + stages * stage + (ng + 1) * tile_m * 4 + (tile_m * (3 * HEAD + 4) * 4 if head else 0)
            + (_MAX_RANKS * tile_m * 4 if paired else 0))


@functools.lru_cache(maxsize=512)
def packed_w4_plan(m: int, k: int, n: int, head: bool = False, tile_n: int | None = None,
                   tile_m: int | None = None, stages: int | None = None, path: str | None = None,
                   paired: bool = False, int8: bool = False) -> PackedW4Plan:
    """The launch for an [m, k] x [k, n] product (k = body groups * 128 +
    the 128 keeper rows); raises on a shape the kernels do not take (N not
    whole 32-column tiles, K not whole groups).  ``head``: the ring epilogue,
    whose block owns a 128-column head (at most 32 rows a block, any M).
    ``path`` ("core" or "prefill"), ``tile_n``, ``tile_m`` and ``stages``
    override the defaults (for measuring other layouts).  ``paired``: K10's
    gate/up launch with the SiLU-quant epilogue (n = 2 * inter, inter whole
    128-channel groups; the core only): a block of ``tile_n`` weight columns
    holds ``tile_n / 2`` gate columns and the matching up columns, 64 (the
    default) or 128 of them, in clusters of ``256 / tile_n`` blocks.
    ``int8``: K14's launch on int8 weights (k rows, the keeper's last), a
    group a 128-row ring slot, never K-blocked, so the prefill GEMM may take
    128-row blocks at any depth (``ops/gemm.py::grouped_int8_plan``).

    Core (M <= 64 with a body group, or ``head``): 64 columns a block where
    N allows (rows of 64 bytes a weight copy), else 32; the fewest of 16, 32
    or 64 rows that hold M, halved down to 16 while the grid has fewer blocks
    than SMs (at M <= 64 there is no split of K to fill the card with: the
    column tiles, and row tiles that read the same weights, are the
    parallelism; not for ``head``, whose 96 blocks of 32 rows measured
    faster than 192 of 16); a ring of 8 group slots (``int8`` in blocks
    taller than 16 rows: ``_INT8_TALL_STAGES``).  Above 64 rows (``head``
    at a decode batch over 64, or the core asked for) the same rule (fault
    C3, which made 32- and 64-row blocks there differ now and then, is
    closed: ``ROADMAP.md`` section C).  Prefill (above 64 rows, or no body
    group): see :func:`_prefill_plan`."""
    if n <= 0 or n % _TN:
        raise ValueError(f"packed_w4_gemm: N={n} must be a positive multiple of {_TN}")
    if k < GROUP or k % GROUP:
        raise ValueError(f"packed_w4_gemm: K={k} must be a positive multiple of {GROUP}")
    ng = k // GROUP - 1
    if int8 and (head or paired):
        raise ValueError("packed_w4_gemm: no head or paired launch for int8 weights")
    if paired:
        if head or n % (2 * GROUP) or (tile_n or _PAIRED_TILE_N) not in _PAIRED_COLS or path == "prefill":
            raise ValueError(f"packed_w4_gemm: no paired SiLU-quant launch for N={n} in {tile_n} columns")
        tile_n = tile_n or _PAIRED_TILE_N
        path = "core"
    if path is None:
        path = "core" if head or (m <= CORE_MAX_M and ng > 0) else "prefill"
    if path == "prefill" and not head:
        return _prefill_plan(m, ng, n, tile_m, tile_n, stages, int8)
    if path != "core" or ng == 0:
        raise ValueError(f"packed_w4_gemm: no {path} launch for K={k}{' with the ring epilogue' if head else ''}")
    if head and n % HEAD:
        raise ValueError(f"packed_w4_gemm: N={n} must be whole {HEAD}-column heads")
    tn = HEAD if head else (tile_n or (2 * _TN if n % (2 * _TN) == 0 else _TN))
    rows = tile_m
    if rows is None:
        rows = next(r for r in _CORE_ROWS if r >= min(m, 32 if head else CORE_MAX_M))
        while not head and rows > _CORE_ROWS[0] and n // tn * -(-m // rows) < _SMS:
            rows //= 2
    if rows not in _CORE_ROWS or (head and rows > 32) or tn not in _CORE_COLS or n % tn:
        raise ValueError(f"packed_w4_gemm: N={n} in {rows} x {tn} blocks is not a core layout")
    stages = stages or min(ng + 2, _INT8_TALL_STAGES if int8 and rows > _CORE_ROWS[0] else _STAGES)
    smem = core_smem(rows, tn, stages, ng, head, paired, GROUP if int8 else HALF)
    if stages < 3 or smem > _SMEM_BLOCK:
        raise ValueError(f"packed_w4_gemm: K={k} at {rows} x {tn} leaves no room for a ring of {stages} stages")
    return PackedW4Plan("core", rows, tn, stages, smem, (n // tn, -(-m // rows)), 2 * GROUP // tn if paired else 1)


def _prefill_plan(m: int, ng: int, n: int, tile_m: int | None = None, tile_n: int | None = None,
                  stages: int | None = None, int8: bool = False) -> PackedW4Plan:
    """The prefill GEMM's launch for M rows, ``ng`` body groups and N
    columns: of the blocks of 64 or 128 rows x 64 or 128 columns (a last
    tile past M or N reads zeros and stores nothing), the one whose waves
    of blocks (``_PREFILL_BLOCKS_PER_SM`` a SM) take the least time at the
    measured time per group of a block (``_PREFILL_GROUP_US``): bigger
    blocks read the weights and activations fewer times but take longer a
    group, so small grids take small blocks; 64 rows above
    ``KBLK_THRESHOLD`` groups (the K-blocked order's partial chains would
    not fit a thread's registers at 128); a ring of ``_PREFILL_STAGES``
    group slots, or as many as shared memory holds (at least 3).
    ``int8``: K14's 128-row int8 weight slots (never K-blocked)."""
    kblk = ng > KBLK_THRESHOLD and not int8
    wrows = GROUP if int8 else HALF

    def cost(layout):
        rows, cols = layout
        blocks = -(-m // rows) * -(-n // cols)
        return -(-blocks // (_SMS * _PREFILL_BLOCKS_PER_SM[layout])) * _PREFILL_GROUP_US[layout]

    layouts = [(r, c) for r in _PREFILL_ROWS for c in _PREFILL_COLS
               if r == (tile_m or r) and c == (tile_n or c) and not (kblk and r > _PREFILL_ROWS[0])]
    if not layouts:
        raise ValueError(f"packed_w4_gemm: {tile_m} x {tile_n} blocks at {ng} groups is not a prefill layout")
    tm, tn = min(layouts, key=lambda lay: (cost(lay), -lay[0] * lay[1]))
    if stages is None:
        stages = max(3, min(ng + 2, _PREFILL_STAGES))
        while stages > 3 and core_smem(tm, tn, stages, ng, False, wrows=wrows) > _SMEM_BLOCK:
            stages -= 1
    smem = core_smem(tm, tn, stages, ng, False, wrows=wrows)
    if stages < 3 or smem > _SMEM_BLOCK:
        raise ValueError(f"packed_w4_gemm: {ng} groups at {tm} x {tn} leave no room for a ring of {stages} stages")
    return PackedW4Plan("prefill", tm, tn, stages, smem, (-(-m // tm), -(-n // tn)))


@functools.cache
def _lib():
    lib = _build.load("gemm_packed")
    lib.atom_gemm_packed.argtypes = [_P] * 6 + [_I] * 3 + [_PLAN, _P]
    lib.atom_gemm_packed.restype = _I
    lib.atom_qkv_ring_fused.argtypes = [_P] * 14 + [_I] * 7 + [_F, _PLAN, _P]
    lib.atom_qkv_ring_fused.restype = _I
    lib.atom_qkv_ring.argtypes = [_P] * 11 + [_I] * 6 + [_PLAN, _P]
    lib.atom_qkv_ring.restype = _I
    lib.atom_qkv_codes.argtypes = [_P] * 13 + [_I] * 4 + [_PLAN, _P]
    lib.atom_qkv_codes.restype = _I
    lib.atom_gemm_fused_in.argtypes = [_P] * 11 + [_I] * 5 + [_F, _PLAN, _P]
    lib.atom_gemm_fused_in.restype = _I
    lib.atom_fused_mlp.argtypes = [_P] * 18 + [_I] * 6 + [_F, _PLAN, _PLAN, _P]
    lib.atom_fused_mlp.restype = _I
    lib.atom_silu_quant_max_clusters.argtypes = [_PLAN, _I, ctypes.POINTER(ctypes.c_int)]
    lib.atom_silu_quant_max_clusters.restype = _I
    return lib


def plan_arg(plan: PackedW4Plan):
    """A plan as the C entry points take it (four ints)."""
    return (ctypes.c_int * 4)(*plan.args())


def unpack_nibble_planes(wp: torch.Tensor) -> torch.Tensor:
    """Nibble-plane bytes [ng * 64, N] -> signed int4 codes int32 [ng, 128, N]."""
    ng = wp.shape[0] // HALF
    u = wp.reshape(ng, HALF, wp.shape[1]).to(torch.int32) & 0xFF
    lo = ((u & 0x0F) ^ 8) - 8
    hi = ((u >> 4) ^ 8) - 8
    return torch.cat([lo, hi], dim=1)


def packed_w4_gemm_plain(a, wp, wk, sa, sw) -> torch.Tensor:
    """Plain version of K1, in the TPU kernel's f32 order: one chain over the
    groups and the keeper last up to ``KBLK_THRESHOLD`` body groups; above it
    partial sums of ``KBLK_G`` groups added to the output block by block,
    the keeper's term before the last block's partial."""
    m, ktot = a.shape
    ng = ktot // GROUP - 1
    codes = unpack_nibble_planes(wp).to(torch.float32)  # [ng, 128, N]
    ag = a[:, : ng * GROUP].reshape(m, ng, GROUP).transpose(0, 1).to(torch.float32)
    acc_g = torch.bmm(ag, codes)  # [ng, M, N] integer-valued, exact
    acc_k = a[:, ng * GROUP :].to(torch.float32) @ wk.to(torch.float32)
    keeper = acc_k * sa[:, ng : ng + 1] * sw[ng : ng + 1, :]

    def chain(g0, g1):
        acc = torch.zeros((m, wp.shape[1]), dtype=torch.float32, device=a.device)
        for g in range(g0, g1):
            acc = acc + acc_g[g] * sa[:, g : g + 1] * sw[g : g + 1, :]
        return acc

    if ng <= KBLK_THRESHOLD:
        return chain(0, ng) + keeper
    out = torch.zeros((m, wp.shape[1]), dtype=torch.float32, device=a.device)
    for g0 in range(0, ng, KBLK_G):
        part = chain(g0, min(g0 + KBLK_G, ng))
        if g0 + KBLK_G >= ng:
            out = out + keeper
        out = out + part
    return out


def packed_w4_gemm(
    a: torch.Tensor,  # int8 [M, kb + 128]  (body codes ++ keeper codes)
    wp: torch.Tensor,  # int8 [kb // 2, N]   (nibble planes)
    wk: torch.Tensor,  # int8 [128, N]       (keeper)
    sa: torch.Tensor,  # f32 [M, ng + 1]
    sw: torch.Tensor,  # f32 [ng + 1, N]
) -> torch.Tensor:
    """Kernel K1: the dual-path 4-bit GEMM -> f32 [M, N]."""
    if on_cpu(a, wp, wk, sa, sw):
        return packed_w4_gemm_plain(a, wp, wk, sa, sw)
    m, ktot = a.shape
    plan = packed_w4_plan(m, ktot, wp.shape[1])
    out = packed_w4_gemm_with_plan(a, wp, wk, sa, sw, plan)
    if m:
        packed_w4_gemm.launches += 1
        packed_w4_gemm.launches_by_path[plan.path] += 1
    return out


def packed_w4_gemm_with_plan(a, wp, wk, sa, sw, plan: PackedW4Plan) -> torch.Tensor:
    """K1's CUDA launch under a given plan (CUDA tensors only; counts no
    launch): what :func:`packed_w4_gemm` runs with ``packed_w4_plan``'s
    choice, and what a measurement of other layouts calls.  The kernel runs
    the plan as given."""
    m, ktot = a.shape
    n = wp.shape[1]
    ng = ktot // GROUP - 1
    if ktot % GROUP or n % _TN:
        raise ValueError(f"packed_w4_gemm: K={ktot} must be a multiple of 128, N={n} of {_TN}")
    check_kernel_input(a, "a", torch.int8)
    check_kernel_input(wp, "wp", torch.int8, (ng * HALF, n))
    check_kernel_input(wk, "wk", torch.int8, (GROUP, n))
    check_kernel_input(sa, "sa", torch.float32, (m, ng + 1))
    check_kernel_input(sw, "sw", torch.float32, (ng + 1, n))
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m:
        _build.check(
            _lib().atom_gemm_packed(
                a.data_ptr(), wp.data_ptr(), wk.data_ptr(), sa.data_ptr(), sw.data_ptr(),
                out.data_ptr(), m, n, ng, plan_arg(plan), _build.stream(),
            ),
            "packed_w4_gemm",
        )
    return out


packed_w4_gemm.launches = 0
packed_w4_gemm.launches_by_path = {"core": 0, "prefill": 0}


def quant_gemm_packed(
    qa: QuantizedActivation, kw: KernelPackedWeight, out_dtype=torch.bfloat16
) -> torch.Tensor:
    """``ops.reference.quant_gemm`` with 4-bit device weights (K1)."""
    return packed_w4_gemm(qa.codes, kw.body_packed, kw.keeper, qa.scales, kw.scales).to(out_dtype)


def quant_gemm_o4_packed(qa: QuantizedActivation, kw: KernelPackedWeight, head_dim: int = 128):
    """The k/v projection's drop-in: K1 into float32, then the asymmetric
    per-head u4 quantization of its output -> ``KVQuant`` (codes [M, N //
    head_dim, head_dim], params [M, N // head_dim, 2])."""
    out = quant_gemm_packed(qa, kw, out_dtype=torch.float32)
    m, n = out.shape
    return quantize_kv_asym(out.reshape(m, n // head_dim, head_dim))


# ---------------------------------------------------------------------------
# K2: fused qkv projection storing K/V into the hot ring
# ---------------------------------------------------------------------------


def quant_prologue_plain(y, norm_w, rstd, abits: int, a_clip: float):
    """RMSNorm (given rstd, bf16 roundings pinned; skipped when ``norm_w`` is
    None) + dual-path quantization of a gathered bf16 [M, K] activation with
    a bf16 norm weight -> (codes int8 [M, K], scales f32 [M, ng+1])."""
    v = y.to(torch.float32)
    if norm_w is not None:
        xn = rp_bf16(v * rstd)
        v = rp_bf16(xn * norm_w.to(torch.float32))
    qa = quantize_dual_path(v, abits, a_clip, GROUP)
    return qa.codes, qa.scales


def rope_quant_heads_plain(acc, cos, sin, n_q: int, n_kv: int, head_dim: int):
    """The qkv epilogues' per-head arithmetic on the f32 product [M, N]: RoPE on
    q and k, per-head asymmetric u4 quantization of post-RoPE K and of V
    -> (q bf16 [M, n_q], K ``KVQuant``, V ``KVQuant``)."""
    m = acc.shape[0]
    h = n_kv // head_dim
    half = head_dim // 2

    def rope(x):  # [M, heads, D] f32
        rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
        return x * cos[:, None, :] + rot * sin[:, None, :]

    q = rope(acc[:, :n_q].reshape(m, n_q // head_dim, head_dim)).to(torch.bfloat16)
    kq = quantize_kv_asym(rope(acc[:, n_q : n_q + n_kv].reshape(m, h, head_dim)))
    vq = quantize_kv_asym(acc[:, n_q + n_kv :].reshape(m, h, head_dim))
    return q.reshape(m, n_q), kq, vq


def qkv_ring_epilogue_plain(acc, cos, sin, k_codes, prm, v_codes, row: int, n_q: int, n_kv: int, head_dim: int):
    """RoPE + per-head KV quantization + in-place ring stores; returns q bf16."""
    q, kq, vq = rope_quant_heads_plain(acc, cos, sin, n_q, n_kv, head_dim)
    k_codes[:, :, :, row] = pack_channel_planes(kq.codes[..., None])[..., 0]
    prm[:, 0, :, row] = kq.params[..., 0].to(prm.dtype)
    prm[:, 1, :, row] = kq.params[..., 1].to(prm.dtype)
    prm[:, 2, :, row] = vq.params[..., 0].to(prm.dtype)
    prm[:, 3, :, row] = vq.params[..., 1].to(prm.dtype)
    v_codes[:, :, row, :] = vq.codes
    return q


def packed_w4_gemm_qkv_ring_fused_plain(
    y, norm_w, wp, wk, sw, cos, sin, k_codes, prm, v_codes, row, n_q, n_kv,
    head_dim=128, abits=4, a_clip=1.0, eps=1e-5, rstd=None,
):
    """Plain version of K2 (same signature as the kernel's wrapper)."""
    if rstd is None:
        rstd = rms_rstd(y, eps)
    a, sa = quant_prologue_plain(y, norm_w, rstd, abits, a_clip)
    acc = packed_w4_gemm_plain(a, wp, wk, sa, sw)
    return qkv_ring_epilogue_plain(acc, cos, sin, k_codes, prm, v_codes, row, n_q, n_kv, head_dim)


def packed_w4_gemm_qkv_ring_fused(
    y: torch.Tensor,  # bf16 [M, K] — gathered hidden (pre-norm)
    norm_w: torch.Tensor,  # bf16 [K] — gathered attn norm weight
    wp: torch.Tensor,  # int8 [kb // 2, N]  (N = n_q + 2 * n_kv)
    wk: torch.Tensor,  # int8 [128, N]
    sw: torch.Tensor,  # f32 [ng + 1, N]
    cos: torch.Tensor,  # f32 [M, head_dim]
    sin: torch.Tensor,
    k_codes: torch.Tensor,  # int8 [M, H, D/2, W] — hot ring, updated in place
    prm: torch.Tensor,  # bf16 [M, 4, H, W]
    v_codes: torch.Tensor,  # int8 [M, H, W, D]
    row: int,  # ring column to write
    n_q: int,
    n_kv: int,
    head_dim: int = 128,
    abits: int = 4,
    a_clip: float = 1.0,
    eps: float = 1e-5,
    rstd: torch.Tensor | None = None,  # f32 [M, 1]
) -> torch.Tensor:
    """Kernel K2 -> q bf16 [M, n_q] (RoPE'd); K/V land in the ring in place."""
    if rstd is None:
        rstd = rms_rstd(y, eps)
    if on_cpu(y, norm_w, wp, wk, sw, cos, sin, k_codes, prm, v_codes, rstd):
        return packed_w4_gemm_qkv_ring_fused_plain(
            y, norm_w, wp, wk, sw, cos, sin, k_codes, prm, v_codes, row, n_q, n_kv,
            head_dim=head_dim, abits=abits, a_clip=a_clip, rstd=rstd,
        )
    m, k = y.shape
    n = n_q + 2 * n_kv
    ng = k // GROUP - 1
    h = n_kv // head_dim
    w = k_codes.shape[3]
    if head_dim != 128 or n_q % head_dim or n_kv % head_dim or k % GROUP:
        raise ValueError("packed_w4_gemm_qkv_ring_fused: needs head_dim 128 and K % 128 == 0")
    if not 0 <= row < w:
        raise ValueError(f"ring row {row} outside [0, {w})")
    check_kernel_input(y, "y", torch.bfloat16)
    check_kernel_input(norm_w, "norm_w", torch.bfloat16, (k,))
    check_kernel_input(wp, "wp", torch.int8, (ng * HALF, n))
    check_kernel_input(wk, "wk", torch.int8, (GROUP, n))
    check_kernel_input(sw, "sw", torch.float32, (ng + 1, n))
    check_kernel_input(cos, "cos", torch.float32, (m, head_dim))
    check_kernel_input(sin, "sin", torch.float32, (m, head_dim))
    check_kernel_input(k_codes, "k_codes", torch.int8, (m, h, head_dim // 2, w))
    check_kernel_input(prm, "prm", torch.bfloat16, (m, 4, h, w))
    check_kernel_input(v_codes, "v_codes", torch.int8, (m, h, w, head_dim))
    rstd = rstd.to(torch.float32).reshape(m, 1).contiguous()
    dev = y.device
    a = torch.empty((m, k), dtype=torch.int8, device=dev)
    sa = torch.empty((m, ng + 1), dtype=torch.float32, device=dev)
    q = torch.empty((m, n_q), dtype=torch.bfloat16, device=dev)
    _build.check(
        _lib().atom_qkv_ring_fused(
            y.data_ptr(), norm_w.data_ptr(), rstd.data_ptr(), wp.data_ptr(), wk.data_ptr(),
            sw.data_ptr(), cos.data_ptr(), sin.data_ptr(), a.data_ptr(), sa.data_ptr(),
            q.data_ptr(), k_codes.data_ptr(), prm.data_ptr(), v_codes.data_ptr(),
            m, k, n_q, h, w, row, abits, a_clip, plan_arg(packed_w4_plan(m, k, n, head=True)), _build.stream(),
        ),
        "packed_w4_gemm_qkv_ring_fused",
    )
    packed_w4_gemm_qkv_ring_fused.launches += 1
    return q


packed_w4_gemm_qkv_ring_fused.launches = 0


# ---------------------------------------------------------------------------
# K7 / K8: the qkv projection on an already quantized activation
# ---------------------------------------------------------------------------


def _check_qkv_inputs(name, a, wp, wk, sa, sw, cos, sin, n_q, n_kv, head_dim):
    m, ktot = a.shape
    n = n_q + 2 * n_kv
    ng = ktot // GROUP - 1
    if head_dim != 128 or n_q % head_dim or n_kv % head_dim or ktot % GROUP:
        raise ValueError(f"{name}: needs head_dim 128 and K % 128 == 0")
    check_kernel_input(a, "a", torch.int8)
    check_kernel_input(wp, "wp", torch.int8, (ng * HALF, n))
    check_kernel_input(wk, "wk", torch.int8, (GROUP, n))
    check_kernel_input(sa, "sa", torch.float32, (m, ng + 1))
    check_kernel_input(sw, "sw", torch.float32, (ng + 1, n))
    check_kernel_input(cos, "cos", torch.float32, (m, head_dim))
    check_kernel_input(sin, "sin", torch.float32, (m, head_dim))
    return m, n, ng


def packed_w4_gemm_qkv_plain(a, wp, wk, sa, sw, cos, sin, n_q: int, n_kv: int, head_dim: int = 128):
    """Plain version of K7 (same return contract as the kernel's wrapper)."""
    acc = packed_w4_gemm_plain(a, wp, wk, sa, sw)
    q, kq, vq = rope_quant_heads_plain(acc, cos, sin, n_q, n_kv, head_dim)
    return q, kq.codes, kq.params, vq.codes, vq.params


def packed_w4_gemm_qkv(
    a: torch.Tensor,  # int8 [M, kb + 128]
    wp: torch.Tensor,  # int8 [kb // 2, N]  (N = n_q + 2 * n_kv)
    wk: torch.Tensor,  # int8 [128, N]
    sa: torch.Tensor,  # f32 [M, ng + 1]
    sw: torch.Tensor,  # f32 [ng + 1, N]
    cos: torch.Tensor,  # f32 [M, head_dim]
    sin: torch.Tensor,
    n_q: int,
    n_kv: int,
    head_dim: int = 128,
):
    """Kernel K7 -> (q bf16 [M, n_q] RoPE'd, k_codes int8 [M, H, D], k_prm f32
    [M, H, 2] = (scale, zero value), v_codes, v_prm); K quantized after RoPE."""
    if on_cpu(a, wp, wk, sa, sw, cos, sin):
        return packed_w4_gemm_qkv_plain(a, wp, wk, sa, sw, cos, sin, n_q, n_kv, head_dim)
    m, n, ng = _check_qkv_inputs("packed_w4_gemm_qkv", a, wp, wk, sa, sw, cos, sin, n_q, n_kv, head_dim)
    h = n_kv // head_dim
    dev = a.device
    qkv = torch.empty((m, n), dtype=torch.float32, device=dev)
    q = torch.empty((m, n_q), dtype=torch.bfloat16, device=dev)
    k_codes = torch.empty((m, h, head_dim), dtype=torch.int8, device=dev)
    v_codes = torch.empty((m, h, head_dim), dtype=torch.int8, device=dev)
    k_prm = torch.empty((m, h, 2), dtype=torch.float32, device=dev)
    v_prm = torch.empty((m, h, 2), dtype=torch.float32, device=dev)
    if m:
        _build.check(
            _lib().atom_qkv_codes(
                a.data_ptr(), wp.data_ptr(), wk.data_ptr(), sa.data_ptr(), sw.data_ptr(),
                cos.data_ptr(), sin.data_ptr(), qkv.data_ptr(), q.data_ptr(), k_codes.data_ptr(),
                k_prm.data_ptr(), v_codes.data_ptr(), v_prm.data_ptr(), m, ng, n_q, h,
                plan_arg(packed_w4_plan(m, a.shape[1], n, path="prefill")), _build.stream(),
            ),
            "packed_w4_gemm_qkv",
        )
        packed_w4_gemm_qkv.launches += 1
    return q, k_codes, k_prm, v_codes, v_prm


packed_w4_gemm_qkv.launches = 0


def packed_w4_gemm_qkv_ring_plain(a, wp, wk, sa, sw, cos, sin, k_codes, prm, v_codes, row, n_q, n_kv, head_dim=128):
    """Plain version of K8 (same signature as the kernel's wrapper)."""
    acc = packed_w4_gemm_plain(a, wp, wk, sa, sw)
    return qkv_ring_epilogue_plain(acc, cos, sin, k_codes, prm, v_codes, row, n_q, n_kv, head_dim)


def packed_w4_gemm_qkv_ring(
    a: torch.Tensor,  # int8 [M, kb + 128]
    wp: torch.Tensor,  # int8 [kb // 2, N]  (N = n_q + 2 * n_kv)
    wk: torch.Tensor,  # int8 [128, N]
    sa: torch.Tensor,  # f32 [M, ng + 1]
    sw: torch.Tensor,  # f32 [ng + 1, N]
    cos: torch.Tensor,  # f32 [M, head_dim]
    sin: torch.Tensor,
    k_codes: torch.Tensor,  # int8 [M, H, D/2, W] — hot ring, updated in place
    prm: torch.Tensor,  # bf16 [M, 4, H, W]
    v_codes: torch.Tensor,  # int8 [M, H, W, D]
    row: int,  # ring column to write
    n_q: int,
    n_kv: int,
    head_dim: int = 128,
) -> torch.Tensor:
    """Kernel K8 -> q bf16 [M, n_q] (RoPE'd); K/V land in the ring in place.
    M must equal the ring's batch dimension."""
    if on_cpu(a, wp, wk, sa, sw, cos, sin, k_codes, prm, v_codes):
        return packed_w4_gemm_qkv_ring_plain(
            a, wp, wk, sa, sw, cos, sin, k_codes, prm, v_codes, row, n_q, n_kv, head_dim
        )
    m, n, ng = _check_qkv_inputs("packed_w4_gemm_qkv_ring", a, wp, wk, sa, sw, cos, sin, n_q, n_kv, head_dim)
    h = n_kv // head_dim
    w = k_codes.shape[3]
    if not 0 <= row < w:
        raise ValueError(f"ring row {row} outside [0, {w})")
    check_kernel_input(k_codes, "k_codes", torch.int8, (m, h, head_dim // 2, w))
    check_kernel_input(prm, "prm", torch.bfloat16, (m, 4, h, w))
    check_kernel_input(v_codes, "v_codes", torch.int8, (m, h, w, head_dim))
    q = torch.empty((m, n_q), dtype=torch.bfloat16, device=a.device)
    _build.check(
        _lib().atom_qkv_ring(
            a.data_ptr(), wp.data_ptr(), wk.data_ptr(), sa.data_ptr(), sw.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), q.data_ptr(), k_codes.data_ptr(), prm.data_ptr(), v_codes.data_ptr(),
            m, ng, n_q, h, w, row, plan_arg(packed_w4_plan(m, a.shape[1], n, head=True)), _build.stream(),
        ),
        "packed_w4_gemm_qkv_ring",
    )
    packed_w4_gemm_qkv_ring.launches += 1
    return q


packed_w4_gemm_qkv_ring.launches = 0


# ---------------------------------------------------------------------------
# K9: activation quantization (+ RMSNorm) -> GEMM -> residual add
# ---------------------------------------------------------------------------


def resid_epilogue_plain(acc, resid, row_scale=None, out_dtype=torch.bfloat16):
    """The fused GEMMs' epilogue on the f32 product, in the residual's type
    (bf16 or float32): ``resid + acc`` with ``acc`` first rounded to that
    type's precision (``bf16(acc)`` for a bf16 residual: the unfused ``x +
    quant_gemm``; ``acc`` itself for a float32 one), then the sum rounded to
    it; or with ``row_scale`` ``resid + row_scale * acc`` without the pin.
    ``acc`` cast when there is no residual."""
    if resid is None:
        return acc.to(out_dtype)
    if resid.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"resid: expected bfloat16 or float32, got {resid.dtype}")
    if row_scale is not None:
        return (resid.to(torch.float32) + row_scale.to(torch.float32).reshape(-1, 1) * acc).to(resid.dtype)
    pinned = rp_bf16(acc) if resid.dtype == torch.bfloat16 else acc
    return (resid.to(torch.float32) + pinned).to(resid.dtype)


def packed_w4_gemm_fused_in_plain(y, kw: KernelPackedWeight, norm_w=None, rstd=None, resid=None,
                                  abits=4, a_clip=1.0, eps=1e-5, out_dtype=torch.bfloat16, reorder=None):
    """Plain version of K9 (same signature as the kernel's wrapper)."""
    if reorder is not None:
        y = torch.index_select(y, -1, reorder)
    if norm_w is not None and rstd is None:
        rstd = rms_rstd(y, eps)
    a, sa = quant_prologue_plain(y, norm_w, rstd, abits, a_clip)
    acc = packed_w4_gemm_plain(a, kw.body_packed, kw.keeper, sa, kw.scales)
    return resid_epilogue_plain(acc, resid, out_dtype=out_dtype)


def check_fused_in_inputs(name, y, kw: KernelPackedWeight, norm_w, rstd, eps, reorder=None):
    """Checks shared by K9 and K10's input side -> (rstd f32 [M, 1] or None).
    ``reorder``: int32 [K], a permutation of the channels that the prologue
    gathers ``y`` by (its vector loads need 16-byte alignment)."""
    m, k = y.shape
    ng = k // GROUP - 1
    n = kw.body_packed.shape[1]
    if k % GROUP or k < 2 * GROUP or n % _TN:
        raise ValueError(f"{name}: K={k} must be a multiple of 128 (at least 256), N={n} of {_TN}")
    check_kernel_input(y, "y", torch.bfloat16)
    check_kernel_input(kw.body_packed, "body_packed", torch.int8, (ng * HALF, n))
    check_kernel_input(kw.keeper, "keeper", torch.int8, (GROUP, n))
    check_kernel_input(kw.scales, "scales", torch.float32, (ng + 1, n))
    if reorder is not None:
        check_kernel_input(reorder, "reorder", torch.int32, (k,))
        if reorder.data_ptr() % 16:
            raise ValueError(f"{name}: reorder must start on a 16-byte boundary")
    if norm_w is None:
        if rstd is not None:
            raise ValueError(f"{name}: rstd is only meaningful with norm_w")
        return None
    check_kernel_input(norm_w, "norm_w", torch.bfloat16, (k,))
    if rstd is None:  # the statistic of the gathered row, as the plain version takes it
        rstd = rms_rstd(y if reorder is None else torch.index_select(y, -1, reorder), eps)
    return rstd.to(torch.float32).reshape(m, 1).contiguous()


def check_resid(resid, name, shape) -> None:
    """K9's and K10's residual: bf16 or float32 (the output's type), on the card."""
    if resid.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: resid must be bfloat16 or float32, got {resid.dtype}")
    check_kernel_input(resid, "resid", resid.dtype, shape)


def packed_w4_gemm_fused_in(
    y: torch.Tensor,  # bf16 [M, K] — the activation, gathered (reordered) unless `reorder` is given
    kw: KernelPackedWeight,  # K -> N
    norm_w: torch.Tensor | None = None,  # bf16 [K] — gathered norm weight
    rstd: torch.Tensor | None = None,  # f32 [M, 1] — the norm's reciprocal std
    resid: torch.Tensor | None = None,  # bf16 or f32 [M, N] — residual added in the epilogue
    abits: int = 4,
    a_clip: float = 1.0,
    eps: float = 1e-5,
    out_dtype=torch.bfloat16,
    reorder: torch.Tensor | None = None,  # int32 [K] — the layer's channel order, gathered in the prologue
) -> torch.Tensor:
    """Kernel K9: 4-bit GEMM with the dynamic quantization (+ optional
    RMSNorm) in front and the residual add behind -> [M, N] in the residual's
    type (``out_dtype`` without one).  ``rstd`` comes from outside the
    kernel (``numerics.rms_rstd``; computed here when a norm weight comes
    without it), so the statistic is the unfused chain's.  With ``reorder``,
    ``y`` is the ungathered activation and the result is that of
    ``torch.index_select(y, -1, reorder)`` without it, bit for bit."""
    tensors = [t for t in (y, *kw, norm_w, rstd, resid, reorder) if t is not None]
    if on_cpu(*tensors):
        return packed_w4_gemm_fused_in_plain(y, kw, norm_w, rstd, resid, abits, a_clip, eps, out_dtype, reorder)
    m, k = y.shape
    n = kw.body_packed.shape[1]
    rstd = check_fused_in_inputs("packed_w4_gemm_fused_in", y, kw, norm_w, rstd, eps, reorder)
    if resid is not None:
        check_resid(resid, "packed_w4_gemm_fused_in", (m, n))
        out_dtype = resid.dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"packed_w4_gemm_fused_in: out_dtype {out_dtype} is neither bfloat16 nor float32")
    dev = y.device
    a = torch.empty((m, k), dtype=torch.int8, device=dev)
    sa = torch.empty((m, k // GROUP), dtype=torch.float32, device=dev)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m:
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        _build.check(
            _lib().atom_gemm_fused_in(
                y.data_ptr(), ptr(reorder), ptr(norm_w), ptr(rstd), kw.body_packed.data_ptr(), kw.keeper.data_ptr(),
                kw.scales.data_ptr(), ptr(resid), a.data_ptr(), sa.data_ptr(), out.data_ptr(),
                m, k, n, abits, int(out_dtype == torch.float32), a_clip, plan_arg(packed_w4_plan(m, k, n)),
                _build.stream(),
            ),
            "packed_w4_gemm_fused_in",
        )
        packed_w4_gemm_fused_in.launches += 1
    return out


packed_w4_gemm_fused_in.launches = 0
