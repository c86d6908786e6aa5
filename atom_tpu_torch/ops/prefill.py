"""Causal flash attention over u4 K/V codes (``atom_tpu/ops/pallas_prefill.py``),
kernel K12.

``flash_code_attention`` is the prefill attention core as one kernel: q times
raw u4 K codes with the affine correction, float32 online softmax, V's
dequantization folded into the probabilities, GQA without repeating K/V, and
a row offset for callers whose queries start past key 0.  It launches
``csrc/prefill.cu`` on CUDA tensors and runs its plain version on CPU tensors.

The kernel's blocks come from :func:`flash_plan`, a pure-Python launch plan
that the kernel takes as it is: the 64-row query tiles in launch order
(heaviest first) and each tile's count of 64-slot key tiles, up to the last
one its last row can see.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from atom_tpu_torch.ops import _build
from atom_tpu_torch.ops.runtime import check_kernel_input, on_cpu

_NEG_INF = -1e30

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

TILE_Q = 64  # query rows of a block: 4 warps of 16
TILE_K = 64  # key slots of a step
MAX_PLAN_TILES = 256  # query tiles one launch may list (csrc/prefill.cu MAX_ENTRIES)


class FlashPlan(NamedTuple):
    """K12's launch: ``q_tiles`` the query tiles (rows t * TILE_Q ..) in
    launch order and ``key_tiles`` the 64-slot key tiles each walks (0 ..
    n - 1).  A launch has one block per (entry, query head), entry-major, so
    a tile's query heads sit side by side."""

    q_tiles: tuple
    key_tiles: tuple

    def args(self) -> list:
        return [len(self.q_tiles), *self.q_tiles, *self.key_tiles]


def flash_plan(tq: int, tk: int, row_offset: int = 0) -> FlashPlan:
    """The plan of a causal launch: query tile t walks the key tiles up to the
    one holding its last row's position (row_offset + its last row), or the
    last key tile; tiles with more key tiles first (the causal triangle's
    heaviest), ties by the later tile first."""
    if tq < 1 or tk < 1 or row_offset < 0:
        raise ValueError(f"flash_plan: Tq {tq}, Tk {tk} (>= 1), row_offset {row_offset} (>= 0)")
    n_q = -(-tq // TILE_Q)
    if n_q > MAX_PLAN_TILES:
        raise ValueError(f"flash_plan: {tq} query rows are {n_q} tiles of {TILE_Q}, above {MAX_PLAN_TILES}")
    n_k = -(-tk // TILE_K)
    walk = [min(n_k, (row_offset + min((t + 1) * TILE_Q, tq) - 1) // TILE_K + 1) for t in range(n_q)]
    order = sorted(range(n_q), key=lambda t: (-walk[t], -t))
    return FlashPlan(tuple(order), tuple(walk[t] for t in order))


@functools.cache
def _lib():
    lib = _build.load("prefill")
    lib.atom_flash_code_attention.argtypes = [_P] * 6 + [_I] * 6 + [_F, ctypes.POINTER(ctypes.c_int), _P]
    lib.atom_flash_code_attention.restype = _I
    return lib


def flash_code_attention_plain(q, k_codes, k_params, v_codes, v_params, groups: int, sm_scale: float,
                               row_offset: int = 0, offset_max: int = 0):
    """Plain version of K12 (same signature as the kernel's wrapper): one
    masked softmax per query head over all keys (materialises [HQ, Tq, Tk]
    float32 scores)."""
    tq, hq, dh = q.shape
    attn = flash_code_attention_f32(q, k_codes, k_params, v_codes, v_params, groups, sm_scale, row_offset)
    return attn.to(torch.bfloat16).transpose(0, 1).reshape(tq, hq * dh)


def flash_code_attention_f32(q, k_codes, k_params, v_codes, v_params, groups: int, sm_scale: float,
                             row_offset: int = 0):
    """The plain version's float32 result before its one rounding: [HQ, Tq, D]."""
    tq, hq, dh = q.shape
    tk = k_codes.shape[0]
    dev = q.device
    qf = q.to(torch.float32)
    q_sum = qf.sum(dim=2)  # [Tq, HQ]
    kc = k_codes.repeat_interleave(groups, dim=1).to(torch.float32)  # [Tk, HQ, D]
    kp = k_params.repeat_interleave(groups, dim=1).to(torch.float32)  # [Tk, HQ, 2]
    vc = v_codes.repeat_interleave(groups, dim=1).to(torch.float32)
    vp = v_params.repeat_interleave(groups, dim=1).to(torch.float32)
    dot = torch.einsum("qhd,khd->hqk", qf, kc)
    scores = (dot * kp[:, :, 0].T[:, None, :] + q_sum.T[:, :, None] * kp[:, :, 1].T[:, None, :]) * sm_scale
    rows = row_offset + torch.arange(tq, device=dev)
    visible = (torch.arange(tk, device=dev)[None, :] <= rows[:, None])[None]  # [1, Tq, Tk]
    scores = torch.where(visible, scores, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(visible, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("hqk,khd->hqd", p * vp[:, :, 0].T[:, None, :], vc)
    z = torch.einsum("hqk,kh->hq", p, vp[:, :, 1])[..., None]
    return (pv + z) / torch.clamp_min(l, 1e-20)  # [HQ, Tq, D]


def flash_code_attention(
    q: torch.Tensor,  # bf16 [Tq, HQ, D] (RoPE'd)
    k_codes: torch.Tensor,  # int8 [Tk, Hkv, D] — u4 values
    k_params: torch.Tensor,  # f32 [Tk, Hkv, 2] — (scale, zero value)
    v_codes: torch.Tensor,
    v_params: torch.Tensor,
    groups: int,
    sm_scale: float,
    row_offset: int = 0,  # query row r sits at position row_offset + r
    offset_max: int = 0,
) -> torch.Tensor:
    """Kernel K12: causal affine-code attention -> bf16 [Tq, HQ * D].

    ``offset_max`` bounds ``row_offset`` for the TPU kernel, whose grid is
    enumerated on the host for the largest offset; it is accepted so that
    callers read the same in both packages.  The CUDA grid needs no bound: the
    plan finds each tile's last visible key tile from ``row_offset`` itself."""
    row_offset = int(row_offset)
    if on_cpu(q, k_codes, k_params, v_codes, v_params):
        return flash_code_attention_plain(q, k_codes, k_params, v_codes, v_params, groups, sm_scale, row_offset)
    tq, hq, dh = q.shape
    tk, hkv, _ = k_codes.shape
    if dh != 128 or hq != hkv * groups or row_offset < 0:
        raise ValueError(
            f"flash_code_attention: needs head_dim 128, HQ = Hkv * groups and a row offset >= 0, got D={dh}, "
            f"HQ={hq}, Hkv={hkv}, groups={groups}, row_offset={row_offset}"
        )
    check_kernel_input(q, "q", torch.bfloat16)
    check_kernel_input(k_codes, "k_codes", torch.int8, (tk, hkv, dh))
    check_kernel_input(k_params, "k_params", torch.float32, (tk, hkv, 2))
    check_kernel_input(v_codes, "v_codes", torch.int8, (tk, hkv, dh))
    check_kernel_input(v_params, "v_params", torch.float32, (tk, hkv, 2))
    if not tk:  # nothing to attend to: l = 0, out = 0
        return torch.zeros((tq, hq * dh), dtype=torch.bfloat16, device=q.device)
    out = torch.empty((tq, hq * dh), dtype=torch.bfloat16, device=q.device)
    if tq:
        args = flash_plan(tq, tk, row_offset).args()
        _build.check(
            _lib().atom_flash_code_attention(
                q.data_ptr(), k_codes.data_ptr(), k_params.data_ptr(), v_codes.data_ptr(), v_params.data_ptr(),
                out.data_ptr(), tq, tk, hq, hkv, groups, row_offset, float(sm_scale), (ctypes.c_int * len(args))(*args),
                _build.stream(),
            ),
            "flash_code_attention",
        )
        flash_code_attention.launches += 1
    return out


flash_code_attention.launches = 0
