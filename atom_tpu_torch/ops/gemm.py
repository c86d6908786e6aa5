"""Grouped-scale int8 GEMMs (``atom_tpu/ops/pallas_gemm.py``), kernel K14.

``grouped_int8_gemm`` (K14a): ``out f32 [M, N] = sum_g (A_g . W_g)_i32 *
sa[:, g] * sw[g, :]`` over 128-wide groups of int8 codes, added in group
order.  With the W4A4 operands (the INT4 body's codes in int8 carriers, then
the INT8 keeper as the last group) it is ``ops.reference.quant_gemm``.

``grouped_int8_gemm_o4`` (K14b): the same product, then per 128-column head
the asymmetric u4 quantization of ``ops.reference.quantize_kv_asym``: the
k/v projection feeding the INT4 KV cache.

Both launch ``csrc/gemm_packed.cu`` on CUDA tensors and run their plain
versions on CPU tensors: K14 is K1's function on int8 weights (the keeper
the last group), so it runs on K1's two kernels in their int8-weight form,
at the launch :func:`grouped_int8_plan` picks (the decode core up to 64 rows,
the prefill GEMM above, and at K = 128), in the order the TPU kernel adds:
group by group, keeper last, never K-blocked at any depth.  K14b is two
launches: K14a's product into a float32 scratch, then the per-head
quantizer.  The plain versions compute each group's integer dot as a
float32 matmul, exact because every partial sum is an integer below 2**24
(|sum| <= 128 * 128 * 128); on the card that needs
``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default.  The
kernels add in the same float32 order, so they equal the plain versions bit
for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from atom_tpu_torch.ops import _build
from atom_tpu_torch.ops.formats import PackedWeight, QuantizedActivation
from atom_tpu_torch.ops.gemm_packed import PackedW4Plan, packed_w4_plan, plan_arg
from atom_tpu_torch.ops.reference import KVQuant, quantize_kv_asym
from atom_tpu_torch.ops.runtime import check_kernel_input, on_cpu

GROUP = 128
HEAD = 128  # head width of the o4 variant's output quantization
_TN = 32  # N is whole 32-column tiles

_P, _I = ctypes.c_void_p, ctypes.c_int
_PLAN = ctypes.POINTER(ctypes.c_int)


@functools.cache
def _lib():
    lib = _build.load("gemm_packed")
    lib.atom_grouped_int8_gemm.argtypes = [_P] * 5 + [_I] * 3 + [_PLAN, _P]
    lib.atom_grouped_int8_gemm.restype = _I
    lib.atom_grouped_int8_gemm_o4.argtypes = [_P] * 7 + [_I] * 3 + [_PLAN, _P]
    lib.atom_grouped_int8_gemm_o4.restype = _I
    return lib


def grouped_int8_plan(m: int, k: int, n: int, **layout) -> PackedW4Plan:
    """K14's launch for an [m, k] x [k, n] product (k = groups * 128, the
    keeper the last): ``packed_w4_plan``'s kernel and tiles (cached there)
    for int8 weights, a group a 128-row ring slot, never K-blocked (the TPU
    kernel adds every group in order at any depth, so the prefill GEMM may
    take 128-row blocks there too); ``layout`` (``tile_m``, ``tile_n``,
    ``stages``, ``path``) overrides the defaults, as ``packed_w4_plan``'s.
    Raises on a shape the kernels do not take, and where shared memory holds
    no ring of 3 stages beside the staged activation scales, (k / 128) x
    tile_m floats."""
    return packed_w4_plan(m, k, n, int8=True, **layout)


@functools.lru_cache(maxsize=512)
def _plan_arg(plan: PackedW4Plan):
    """``plan_arg`` once a plan (the C side only reads it)."""
    return plan_arg(plan)


def grouped_int8_gemm_plain(a, w, sa, sw) -> torch.Tensor:
    """Plain version of K14a (the kernel's float32 order: group by group)."""
    m, k = a.shape
    ng = k // GROUP
    ag = a.reshape(m, ng, GROUP).transpose(0, 1).to(torch.float32)  # [ng, M, 128]
    acc_g = torch.bmm(ag, w.reshape(ng, GROUP, -1).to(torch.float32))  # integer-valued, exact
    acc = torch.zeros((m, w.shape[1]), dtype=torch.float32, device=a.device)
    for g in range(ng):
        acc = acc + acc_g[g] * sa[:, g : g + 1] * sw[g : g + 1, :]
    return acc


def _check_inputs(name, a, w, sa, sw, n_mult):
    m, k = a.shape
    n = w.shape[1]
    ng = k // GROUP
    if k % GROUP or n % n_mult:
        raise ValueError(f"{name}: K={k} must be a multiple of {GROUP}, N={n} of {n_mult}")
    check_kernel_input(a, "a", torch.int8)
    check_kernel_input(w, "w", torch.int8, (k, n))
    check_kernel_input(sa, "sa", torch.float32, (m, ng))
    check_kernel_input(sw, "sw", torch.float32, (ng, n))
    return m, n, ng


def grouped_int8_gemm(
    a: torch.Tensor,  # int8 [M, K]   (body codes ++ keeper codes)
    w: torch.Tensor,  # int8 [K, N]
    sa: torch.Tensor,  # f32 [M, K // 128]
    sw: torch.Tensor,  # f32 [K // 128, N]
) -> torch.Tensor:
    """Kernel K14a: the grouped-scale integer GEMM -> f32 [M, N]."""
    if on_cpu(a, w, sa, sw):
        return grouped_int8_gemm_plain(a, w, sa, sw)
    out = grouped_int8_gemm_with_plan(a, w, sa, sw, grouped_int8_plan(*a.shape, w.shape[1]))
    if out.shape[0]:
        grouped_int8_gemm.launches += 1
    return out


def grouped_int8_gemm_with_plan(a, w, sa, sw, plan: PackedW4Plan) -> torch.Tensor:
    """K14a's CUDA launch under a given plan (CUDA tensors only; counts no
    launch): what :func:`grouped_int8_gemm` runs with ``grouped_int8_plan``'s
    choice, and what a measurement of other layouts calls."""
    m, n, ng = _check_inputs("grouped_int8_gemm", a, w, sa, sw, _TN)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m:
        _build.check(
            _lib().atom_grouped_int8_gemm(a.data_ptr(), w.data_ptr(), sa.data_ptr(), sw.data_ptr(), out.data_ptr(),
                                          m, n, ng - 1, _plan_arg(plan), _build.stream()),
            "grouped_int8_gemm",
        )
    return out


grouped_int8_gemm.launches = 0


def grouped_int8_gemm_o4_plain(a, w, sa, sw, head_dim: int = HEAD):
    """Plain version of K14b: the K14a product, then ``quantize_kv_asym`` per
    head -> (codes int8 [M, N], params f32 [M, N // head_dim, 2])."""
    acc = grouped_int8_gemm_plain(a, w, sa, sw)
    m, n = acc.shape
    kq = quantize_kv_asym(acc.reshape(m, n // head_dim, head_dim))
    return kq.codes.reshape(m, n), kq.params


def grouped_int8_gemm_o4(
    a: torch.Tensor,
    w: torch.Tensor,
    sa: torch.Tensor,
    sw: torch.Tensor,
    head_dim: int = HEAD,
):
    """Kernel K14b: GEMM + per-head asymmetric u4 output quantization ->
    (codes int8 [M, N] in [0, 15], params f32 [M, N // head_dim, 2] =
    (scale, zero value))."""
    if on_cpu(a, w, sa, sw):
        return grouped_int8_gemm_o4_plain(a, w, sa, sw, head_dim)
    if head_dim != HEAD:
        raise ValueError(f"grouped_int8_gemm_o4: the kernel quantizes heads of {HEAD}, got head_dim {head_dim}")
    m, n, ng = _check_inputs("grouped_int8_gemm_o4", a, w, sa, sw, HEAD)
    plan = grouped_int8_plan(m, ng * GROUP, n)
    scratch = torch.empty((m, n), dtype=torch.float32, device=a.device)
    codes = torch.empty((m, n), dtype=torch.int8, device=a.device)
    params = torch.empty((m, n // HEAD, 2), dtype=torch.float32, device=a.device)
    if m:
        _build.check(
            _lib().atom_grouped_int8_gemm_o4(a.data_ptr(), w.data_ptr(), sa.data_ptr(), sw.data_ptr(),
                                             scratch.data_ptr(), codes.data_ptr(), params.data_ptr(), m, n, ng - 1,
                                             _plan_arg(plan), _build.stream()),
            "grouped_int8_gemm_o4",
        )
        grouped_int8_gemm_o4.launches += 1
    return codes, params


grouped_int8_gemm_o4.launches = 0


def _assemble_operands(qa: QuantizedActivation, pw: PackedWeight):
    """The weight side as one grouped operand: body codes, then the keeper as
    one more 128-group (the activation already holds its keeper last)."""
    w = torch.cat([pw.body, pw.keeper], dim=0)
    sw = torch.cat([pw.body_scale, pw.keeper_scale[None, :]], dim=0)
    return qa.codes, w, qa.scales, sw


def quant_gemm(qa: QuantizedActivation, pw: PackedWeight, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``ops.reference.quant_gemm`` on int8-carrier weights through K14a; the
    counterpart of the JAX package's ``ops.pallas_gemm.quant_gemm_pallas``."""
    a, w, sa, sw = _assemble_operands(qa, pw)
    return grouped_int8_gemm(a, w, sa, sw).to(out_dtype)


def quant_gemm_o4(qa: QuantizedActivation, pw: PackedWeight, head_dim: int = HEAD) -> KVQuant:
    """``ops.reference.quant_gemm_o4`` through K14b -> ``KVQuant`` (codes
    [M, heads, head_dim], params [M, heads, 2]); the counterpart of the JAX
    package's ``ops.pallas_gemm.quant_gemm_o4_pallas``."""
    a, w, sa, sw = _assemble_operands(qa, pw)
    codes, params = grouped_int8_gemm_o4(a, w, sa, sw, head_dim)
    m, n = codes.shape
    return KVQuant(codes=codes.reshape(m, n // head_dim, head_dim), params=params)
