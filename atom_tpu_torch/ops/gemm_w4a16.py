"""Weight-only GEMMs with bf16 activations (``atom_tpu/ops/pallas_gemm_w4a16.py``):
kernels K13 (INT4) and K5 (INT8).

``w4a16_gemm`` (K13): ``out [M, N] = sum_g (sum_{k in g} bf16(a[m, k]) *
code[k, n]) * scale[g, n]``: signed 4-bit codes in 128-row groups, nibble
planes as in K1, the per-group scale applied to each group's float32 partial
sum.  It runs the W4A16 baseline stack's projections and the opt-in 4-bit
lm_head.  The TPU kernel adds the scaled partial sums of ``KBLK = 8`` groups,
then that block sum into the output; the plain version keeps that order.  The
CUDA kernel (``csrc/gemm_w4a16.cu``, wgmma with the converted weights as the
register operand) has two paths, chosen by :func:`w4a16_plan` from M: up to
``SKINNY_MAX_M`` rows (decode, the head) a skinny path that splits the groups
over the blocks of a thread block cluster and adds their partial tiles in rank
order; above it (prefill) 128 x 128 tiles over all of K.  Both add the scaled
group partials ``KBLK`` at a time, as the TPU kernel does.  Every product (bf16
x 4-bit code) is exact in float32, so they differ only by the order of the
float32 additions inside a group and, under a split, across its ranks: within
``W4A16_RTOL`` of the largest output.

``w8a16_gemm`` (K5): ``out f32 [M, N] = (sum_k bf16(a[m, k]) * codes[k, n]) *
scale[n]`` with float32 accumulation; the per-column scale multiplies once,
after the whole sum.  It is the serving lm_head's default precision.  int8
codes are exact in bf16, so every product is exact in float32 and only the
order of the float32 additions differs between implementations: the TPU
kernel adds K blocks of 1024, the CUDA kernel (``csrc/gemm_w8a16.cu``, a
weight stream by TMA into ``wgmma`` with the converted weights as the
register operand, each code split exactly into two terms ``16 * (c >> 4)``
and ``c & 15``) 16-wide tensor-core steps term by term, the plain version
whatever ``torch.mm`` does.  They are held to each other within
``W8A16_RTOL`` of the largest output: no partial sum is ever rounded to
bf16, which would cost 2**-9.  :func:`w8a16_plan` gives the kernel its
launch: blocks of up to 64 activation rows by 256 columns over all of K.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from atom_tpu_torch.ops import _build
from atom_tpu_torch.ops.gemm_packed import unpack_nibble_planes
from atom_tpu_torch.ops.runtime import check_kernel_input, on_cpu
from atom_tpu_torch.quant.core import div_exact

# kernel vs plain version: |diff| <= W8A16_RTOL * max|out| (float32 sums of
# exact products taken in another order; a bf16-rounded partial sum would
# show as ~2e-3)
W8A16_RTOL = 1e-4
_TN = 64  # N is whole 64-column groups
_TK = 16  # K step of the tensor-core instruction
_W8_TILE = 256  # weight columns of a K5 block
_W8_ROWS = (8, 16, 32, 40, 48, 64)  # activation rows of a K5 block (wgmma's N); above 64, passes of 64

_P, _I = ctypes.c_void_p, ctypes.c_int


# ---------------------------------------------------------------------------
# W4A16: weight-only INT4, per-128-group scales (K13)
# ---------------------------------------------------------------------------

GROUP = 128
HALF = GROUP // 2
KBLK = 8  # groups whose scaled partial sums the TPU kernel adds before the output
# kernel vs plain version: |diff| <= W4A16_RTOL * max|out| (float32 sums of
# exact products taken in another order)
W4A16_RTOL = 1e-4
_TN4 = 32  # N is whole 32-column tiles
SKINNY_MAX_M = 64  # rows up to which K13 takes the skinny split-K path
_SKINNY_ROWS = (8, 16, 32, 64)  # activation rows of a skinny block (wgmma's N)
_SMS = 132  # the H100's SMs: the skinny path's grid covers them where N allows
_MAX_CLUSTER = 8  # blocks of a portable thread block cluster
_TILE = 128  # the tile path's block tile, rows and columns; the skinny path's columns


class W4A16Weight(NamedTuple):
    """Nibble-plane packed weight-only-quantized matrix.

    ``packed``: int8 [K/2, N]: per 128-group, byte row r holds code rows
    ``g*128 + r`` (low nibble) and ``g*128 + 64 + r`` (high), sign-extended;
    ``scale``: f32 [K/128, N].
    """

    packed: torch.Tensor
    scale: torch.Tensor


def quantize_w4a16(w: torch.Tensor) -> W4A16Weight:
    """Symmetric per-128-group INT4 quantization of a [K, N] weight."""
    k, n = w.shape
    if k % GROUP:
        raise ValueError(f"quantize_w4a16: K={k} must be a multiple of {GROUP}")
    ng = k // GROUP
    g = w.to(torch.float32).reshape(ng, GROUP, n)
    scale = div_exact(torch.clamp_min(g.abs().amax(dim=1), 1e-8), 7.0)  # [ng, n]
    codes = torch.clamp(torch.round(g / scale[:, None, :]), -8, 7).to(torch.int16)
    lo = codes[:, :HALF] & 0x0F
    hi = codes[:, HALF:] & 0x0F
    packed = (lo | (hi << 4)).to(torch.uint8).view(torch.int8).reshape(k // 2, n)
    return W4A16Weight(packed=packed, scale=scale)


def dequantize_w4a16(wq: W4A16Weight) -> torch.Tensor:
    ng = wq.scale.shape[0]
    codes = unpack_nibble_planes(wq.packed).to(torch.float32)  # [ng, 128, N]
    return (codes * wq.scale[:, None, :]).reshape(ng * GROUP, -1)


class W4A16Plan(NamedTuple):
    """K13's launch for one shape, as the kernel takes it: blocks of
    ``tile_m`` rows by 128 columns, ``split`` blocks per cluster, rank r
    summing groups ``groups[r]`` (``range(g0, g1)``), grid ``(x, y)`` with
    ``x = column tiles * split``."""

    path: str  # "skinny" (M <= SKINNY_MAX_M: split K over a cluster) or "tile"
    tile_m: int
    split: int
    groups: tuple
    grid: tuple


@functools.lru_cache(maxsize=256)
def w4a16_plan(m: int, k: int, n: int) -> W4A16Plan:
    """The launch K13 makes for a [m, k] x [k, n] product; raises on a shape
    the kernel does not take (N not whole 32-column tiles, K not whole
    groups).

    Skinny path: the block holds all m rows (8, 16, 32 or 64, the fewest
    that hold them) and 128 columns; the split is the smallest cluster (at
    most 8 blocks, at most one per group) whose grid covers the 132 SMs, or
    the largest where none does.  Tile path: 128 x 128 tiles over all of K."""
    if n <= 0 or n % _TN4:
        raise ValueError(f"w4a16_gemm: N={n} must be a positive multiple of {_TN4}")
    if k <= 0 or k % GROUP:
        raise ValueError(f"w4a16_gemm: K={k} must be a positive multiple of {GROUP}")
    ng = k // GROUP
    tiles = -(-n // _TILE)
    if m > SKINNY_MAX_M:
        return W4A16Plan("tile", _TILE, 1, ((0, ng),), (tiles, -(-m // _TILE)))
    max_split = min(_MAX_CLUSTER, ng)
    split = next((s for s in range(1, max_split + 1) if tiles * s >= _SMS), max_split)
    groups = tuple((r * ng // split, (r + 1) * ng // split) for r in range(split))
    rows = next(r for r in _SKINNY_ROWS if r >= m)
    return W4A16Plan("skinny", rows, split, groups, (tiles * split, 1))


@functools.lru_cache(maxsize=256)
def _group_starts(groups: tuple) -> ctypes.Array:
    """A plan's group ranges as the kernel takes them: rank r sums groups
    ``[starts[r], starts[r + 1])``."""
    starts = [g0 for g0, _ in groups] + [groups[-1][1]]
    return (ctypes.c_int * len(starts))(*starts)


@functools.cache
def _kernel4():
    fn = _build.load("gemm_w4a16").atom_gemm_w4a16
    fn.argtypes = [_P] * 4 + [_I] * 6 + [ctypes.POINTER(ctypes.c_int)] + [_I] * 2 + [_P]
    fn.restype = _I
    return fn


def _activation_groups(a: torch.Tensor, wq: W4A16Weight, name: str) -> tuple[int, W4A16Weight]:
    """The activation's group count and the weight cut to it: a head padded
    past the hidden size carries zero groups the activation has no columns
    for, which the JAX kernel leaves out the same way (its K grid follows the
    activation)."""
    k = a.shape[1]
    if k % GROUP:
        raise ValueError(f"{name}: K={k} must be a multiple of {GROUP}")
    ng = k // GROUP
    if wq.scale.shape[0] < ng:
        raise ValueError(f"{name}: the weight has {wq.scale.shape[0]} groups, the activation {ng}")
    if wq.scale.shape[0] == ng:
        return ng, wq
    return ng, W4A16Weight(wq.packed[: ng * HALF], wq.scale[:ng])


def w4a16_gemm_plain(a: torch.Tensor, wq: W4A16Weight, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of K13: bf16 activation, one float32 dot per 128-group,
    scaled, added ``KBLK`` groups at a time, then into the output."""
    m = a.shape[0]
    ng, wq = _activation_groups(a, wq, "w4a16_gemm")
    codes = unpack_nibble_planes(wq.packed).to(torch.float32)  # [ng, 128, N]
    ag = a.to(torch.bfloat16).to(torch.float32).reshape(m, ng, GROUP).transpose(0, 1)
    acc_g = torch.bmm(ag, codes)  # [ng, M, N]: exact products, float32 sums
    out = torch.zeros((m, codes.shape[2]), dtype=torch.float32, device=a.device)
    for b0 in range(0, ng, KBLK):
        blk = torch.zeros_like(out)
        for g in range(b0, min(b0 + KBLK, ng)):
            blk = blk + acc_g[g] * wq.scale[g]
        out = out + blk
    return out.to(out_dtype)


def w4a16_gemm(a: torch.Tensor, wq: W4A16Weight, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel K13: bf16/f32 ``a`` [M, K] x W4A16 weight -> [M, N] in
    ``out_dtype`` (bfloat16 or float32).  ``a`` is rounded to bf16, as every
    caller in the JAX package passes it."""
    if on_cpu(a, wq.packed, wq.scale):
        return w4a16_gemm_plain(a, wq, out_dtype)
    m = a.shape[0]
    ng, wq = _activation_groups(a, wq, "w4a16_gemm")
    n = wq.packed.shape[1]
    plan = w4a16_plan(m, ng * GROUP, n)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"w4a16_gemm: out_dtype {out_dtype} is neither bfloat16 nor float32")
    ab = a.to(torch.bfloat16).contiguous()
    check_kernel_input(ab, "a", torch.bfloat16)
    check_kernel_input(wq.packed, "packed", torch.int8, (ng * HALF, n))
    check_kernel_input(wq.scale, "scale", torch.float32, (ng, n))
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m:
        _build.check(
            _kernel4()(ab.data_ptr(), wq.packed.data_ptr(), wq.scale.data_ptr(), out.data_ptr(), m, n, ng,
                       int(out_dtype == torch.bfloat16), plan.tile_m, plan.split, _group_starts(plan.groups),
                       *plan.grid, _build.stream()),
            "w4a16_gemm",
        )
        w4a16_gemm.launches += 1
    return out


w4a16_gemm.launches = 0


# ---------------------------------------------------------------------------
# W8A16: weight-only INT8, per-column scales (K5)
# ---------------------------------------------------------------------------


class W8A16Weight(NamedTuple):
    """Per-output-column symmetric INT8 weight-only matrix.

    ``codes``: int8 [K, N]; ``scale``: f32 [1, N]; ``w ~ codes * scale``.
    """

    codes: torch.Tensor
    scale: torch.Tensor


def quantize_w8a16(w: torch.Tensor) -> W8A16Weight:
    w32 = w.to(torch.float32)
    scale = div_exact(torch.clamp_min(w32.abs().amax(dim=0, keepdim=True), 1e-8), 127.0)
    codes = torch.clamp(torch.round(w32 / scale), -128, 127).to(torch.int8)
    return W8A16Weight(codes=codes, scale=scale)


def dequantize_w8a16(wq: W8A16Weight) -> torch.Tensor:
    return wq.codes.to(torch.float32) * wq.scale


class W8A16Plan(NamedTuple):
    """K5's launch for one shape, as the kernel takes it: blocks of ``rows``
    activation rows by 256 weight columns over all of K, grid ``(column
    tiles, row passes)``."""

    rows: int
    grid: tuple


@functools.lru_cache(maxsize=256)
def w8a16_plan(m: int, k: int, n: int) -> W8A16Plan:
    """The launch K5 makes for an [m, k] x [k, n] product; raises on a shape
    the kernel does not take (N not whole 64-column groups, K not whole
    16-row steps).  The block holds the fewest of 8, 16, 32, 40, 48 or 64
    rows that hold m, so up to 64 rows stream the weight once; above 64
    rows, passes of 64.  A last column tile past N is zero-filled by TMA and
    masked at the store."""
    if m < 1:
        raise ValueError(f"w8a16_gemm: M={m} has no row to launch")
    if n <= 0 or n % _TN:
        raise ValueError(f"w8a16_gemm: N={n} must be a positive multiple of {_TN}")
    if k < 0 or k % _TK:
        raise ValueError(f"w8a16_gemm: K={k} must be a multiple of {_TK}")
    rows = next((r for r in _W8_ROWS if r >= m), _W8_ROWS[-1])
    return W8A16Plan(rows, (-(-n // _W8_TILE), -(-m // rows)))


@functools.cache
def _kernel():
    fn = _build.load("gemm_w8a16").atom_gemm_w8a16
    fn.argtypes = [_P] * 4 + [_I] * 6 + [_P]
    fn.restype = _I
    return fn


def w8a16_gemm_plain(a: torch.Tensor, wq: W8A16Weight) -> torch.Tensor:
    """Plain version of K5: bf16 operands, float32 sums, scale at the end."""
    ab = a.to(torch.bfloat16)
    if ab.is_cuda:
        acc = torch.mm(ab, wq.codes.to(torch.bfloat16), out_dtype=torch.float32)
    else:
        acc = ab.to(torch.float32) @ wq.codes.to(torch.float32)
    return acc * wq.scale


def w8a16_gemm(a: torch.Tensor, wq: W8A16Weight) -> torch.Tensor:
    """Kernel K5: bf16/f32 ``a`` [M, K] x W8A16 weight -> f32 [M, N]."""
    if on_cpu(a, wq.codes, wq.scale):
        return w8a16_gemm_plain(a, wq)
    m, k = a.shape
    n = wq.codes.shape[1]
    if k % _TK or n % _TN:
        raise ValueError(f"w8a16_gemm: K={k} must be a multiple of {_TK}, N={n} of {_TN}")
    ab = a.to(torch.bfloat16).contiguous()
    check_kernel_input(ab, "a", torch.bfloat16)
    check_kernel_input(wq.codes, "codes", torch.int8, (k, n))
    check_kernel_input(wq.scale, "scale", torch.float32, (1, n))
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m and n:
        plan = w8a16_plan(m, k, n)
        _build.check(
            _kernel()(ab.data_ptr(), wq.codes.data_ptr(), wq.scale.data_ptr(), out.data_ptr(), m, n, k, plan.rows,
                      *plan.grid, _build.stream()),
            "w8a16_gemm",
        )
        w8a16_gemm.launches += 1
    return out


w8a16_gemm.launches = 0
