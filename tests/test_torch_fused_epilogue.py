"""K9 and K10 given the layer's reorder index, and the arithmetic of K10's
SiLU-quant gate/up epilogue, on the CPU.

The kernels read the reorder gather in their prologue (``reorder=``): the
wrappers take the ungathered activation, and the plain versions gather first
and then do what they do without the index, so the index changes no bit
(here against ``index_select`` + the plain version; on the card
``chip_smoke.py`` holds the kernels the same way).  The same inputs through
``jnp.take`` and the Pallas kernels in interpret mode agree with the port
within the bounds of ``tests/test_torch_fused.py``.  K10's gate/up launch
on the card takes SiLU(gate) * up and its requantization in the epilogue: a
block holds t = 32 or 64 channels of a 128-channel group, the group's |max|
is the max of its 4 or 2 blocks' partial maxima, read across a thread-block
cluster; a numpy emulation of that split gives the codes and scales of
``quantize_dual_path`` bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atom_tpu.config import ATOM_W4A4 as JSPEC
from atom_tpu.numerics import rms_rstd as j_rms_rstd
from atom_tpu.ops.formats import pack_for_kernel as j_pack
from atom_tpu.ops.formats import quantize_weight_packed as j_quantize_weight
from atom_tpu.ops.pallas_gemm_packed import packed_w4_gemm_fused_in as j_fused_in
from atom_tpu.ops.pallas_mlp import fused_mlp_packed as j_fused_mlp
from atom_tpu_torch.ops.formats import KernelPackedWeight, quantize_dual_path
from atom_tpu_torch.ops.gemm_packed import packed_w4_gemm_fused_in, packed_w4_gemm_fused_in_plain
from atom_tpu_torch.ops.mlp import fused_mlp_act_plain, fused_mlp_packed, fused_mlp_packed_plain, fused_mlp_packed_stages
from atom_tpu_torch.serving.convert import tensor_from_numpy
from test_torch_serving import cap_torch_threads

cap_torch_threads()

A_CLIP = JSPEC.a_clip_ratio


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _bf16(x):
    return np.array(jnp.asarray(np.asarray(x, np.float32)).astype(jnp.bfloat16))


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _weights(seed, in_f, out_f, scale=0.05):
    """One random weight in both packages' kernel layouts (same codes)."""
    w = np.random.default_rng(seed).standard_normal((in_f, out_f)).astype(np.float32) * scale
    jkw = j_pack(j_quantize_weight(jnp.asarray(w), JSPEC))
    scales = np.concatenate([np.asarray(jkw.body_scale), np.asarray(jkw.keeper_scale)[None]], 0)
    return jkw, KernelPackedWeight(_t(jkw.body_packed), _t(jkw.keeper), _t(scales))


def _inputs(seed, m, k, n, f32_resid=False):
    rng = np.random.default_rng(seed)
    y = _t(_bf16(rng.standard_normal((m, k)) * 1.5))
    r = rng.standard_normal((m, n)).astype(np.float32)
    resid = _t(r) if f32_resid else _t(_bf16(r))
    norm_w = _t(_bf16(rng.uniform(0.7, 1.3, (k,))))
    perm = torch.from_numpy(rng.permutation(k).astype(np.int32))
    row_scale = _t(rng.uniform(0.1, 1.0, (m,)).astype(np.float32))
    return y, resid, norm_w, perm, row_scale


# ---------------------------------------------------------------------------
# (a) reorder: bitwise with index_select + the plain version without it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["resid", "norm_resid", "norm_no_rstd", "f32_resid", "f32_out"])
def test_fused_in_reorder_equals_index_select(case):
    """K9 with ``reorder`` (the wrapper on CPU tensors and the plain version)
    equals ``index_select`` followed by K9 without it, bit for bit, with and
    without the norm (rstd given, or computed by the function), on a bf16 or
    float32 residual and into float32 without one."""
    m, k, n = 8, 384, 256
    _, kw = _weights(3, k, n)
    y, resid, norm_w, perm, _ = _inputs(11, m, k, n, f32_resid=case == "f32_resid")
    kwargs = dict(abits=4, a_clip=A_CLIP)
    if case != "f32_out":
        kwargs["resid"] = resid
    else:
        kwargs["out_dtype"] = torch.float32
    if case.startswith("norm"):
        kwargs["norm_w"] = norm_w
        if case == "norm_resid":
            kwargs["rstd"] = torch.rsqrt(y.float().pow(2).mean(-1, keepdim=True) + 1e-5)
    want = packed_w4_gemm_fused_in_plain(torch.index_select(y, -1, perm), kw, **kwargs)
    for fn in (packed_w4_gemm_fused_in, packed_w4_gemm_fused_in_plain):
        got = fn(y, kw, reorder=perm, **kwargs)
        assert got.dtype == want.dtype and torch.equal(_bits(got), _bits(want))


K10_CASES = ["norm", "no_norm", "row_scale", "f32_resid", "f32_resid_row_scale"]


@pytest.mark.parametrize("case", K10_CASES)
def test_fused_mlp_reorder_equals_index_select(case):
    """K10 with ``reorder`` in the five epilogue cases the card checks (norm;
    no norm; row_scale; a float32 residual; a float32 residual with
    row_scale, MoE's chain): the wrapper, its stages and the plain version
    equal ``index_select`` followed by K10 without it, bit for bit, output,
    act codes and act scales."""
    m, d, inter = 8, 512, 768
    _, gu = _weights(20, d, 2 * inter)
    _, dn = _weights(21, inter, d)
    x, resid, norm_w, perm, row_scale = _inputs(5 + K10_CASES.index(case), m, d, d, f32_resid=case.startswith("f32"))
    kwargs = dict(abits=4, a_clip=A_CLIP)
    if case != "no_norm":
        kwargs.update(norm_w=norm_w, rstd=torch.rsqrt(x.float().pow(2).mean(-1, keepdim=True) + 1e-5))
    if case.endswith("row_scale"):
        kwargs["row_scale"] = row_scale
    gathered = torch.index_select(x, -1, perm)
    want = fused_mlp_packed_stages(gathered, resid, gu, dn, **kwargs)
    assert want[0].dtype == resid.dtype
    got = fused_mlp_packed_stages(x, resid, gu, dn, reorder=perm, **kwargs)
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))
    assert torch.equal(_bits(fused_mlp_packed(x, resid, gu, dn, reorder=perm, **kwargs)), _bits(want[0]))
    assert torch.equal(_bits(fused_mlp_packed_plain(x, resid, gu, dn, reorder=perm, **kwargs)), _bits(want[0]))
    in_kwargs = {key: v for key, v in kwargs.items() if key != "row_scale"}
    act, act_scales = fused_mlp_act_plain(x, gu, reorder=perm, **in_kwargs)
    assert torch.equal(act, want[1]) and torch.equal(act_scales, want[2])


# ---------------------------------------------------------------------------
# (b) against jnp.take + the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def _rows_beyond_one_ulp(got, want):
    return (np.abs(got - want) > np.abs(want) * 2**-7 + 1e-6).any(axis=1)


def test_fused_in_reorder_matches_take_and_pallas():
    """K9 with ``reorder`` against ``jnp.take`` then the Pallas kernel in
    interpret mode, with the norm and the residual: the bound of
    ``test_fused_in_gemm_matches_pallas`` (at most 35% of the rows beyond
    one bf16 ulp, every element within 0.2)."""
    m, k, n = 16, 384, 256
    jkw, tkw = _weights(4, k, n)
    rng = np.random.default_rng(12)
    y = _bf16(rng.standard_normal((m, k)) * 1.5)
    resid = _bf16(rng.standard_normal((m, n)))
    perm = rng.permutation(k).astype(np.int32)
    norm_w = _bf16(rng.uniform(0.7, 1.3, (k,)))  # the gathered norm weight, as the layer keeps it
    yg = jnp.take(jnp.asarray(y), jnp.asarray(perm), axis=-1)
    rstd = np.asarray(j_rms_rstd(jnp.asarray(y)))  # of the ungathered row, as the decode step passes it
    want = j_fused_in(yg, jkw, norm_w=jnp.asarray(norm_w), rstd=jnp.asarray(rstd), resid=jnp.asarray(resid),
                      abits=4, a_clip=A_CLIP, interpret=True)
    got = packed_w4_gemm_fused_in(_t(y), tkw, norm_w=_t(norm_w), rstd=_t(rstd), resid=_t(resid), abits=4,
                                  a_clip=A_CLIP, reorder=_t(perm))
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert _rows_beyond_one_ulp(got, want).mean() <= 0.35
    np.testing.assert_allclose(got, want, rtol=0, atol=0.2)


def test_fused_mlp_reorder_matches_take_and_pallas():
    """K10 with ``reorder`` against ``jnp.take`` then the Pallas kernel in
    interpret mode (the JAX decode step's call: the gathered hidden, the
    gathered norm weight, rstd of the ungathered row): the bound of
    ``test_fused_mlp_matches_pallas`` (at most 25% of the rows beyond one
    bf16 ulp; rtol 5e-2, atol 1.0, under 2% of the elements moved beyond flip
    noise)."""
    m, d, inter = 16, 512, 768
    jgu, tgu = _weights(30, d, 2 * inter)
    jdn, tdn = _weights(31, inter, d)
    rng = np.random.default_rng(13)
    x = _bf16(rng.standard_normal((m, d)))
    perm = rng.permutation(d).astype(np.int32)
    norm_w = _bf16(rng.uniform(0.7, 1.3, (d,)))
    rstd = np.asarray(j_rms_rstd(jnp.asarray(x)))
    xg = jnp.take(jnp.asarray(x), jnp.asarray(perm), axis=-1)
    want = j_fused_mlp(xg, jnp.asarray(x), jgu, jdn, norm_w=jnp.asarray(norm_w), rstd=jnp.asarray(rstd), abits=4,
                       a_clip=A_CLIP, interpret=True)
    got = fused_mlp_packed(_t(x), _t(x), tgu, tdn, norm_w=_t(norm_w), rstd=_t(rstd), abits=4, a_clip=A_CLIP,
                           reorder=_t(perm))
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert _rows_beyond_one_ulp(got, want).mean() <= 0.25
    np.testing.assert_allclose(got, want, rtol=5e-2, atol=1.0)
    moved = np.abs(got - want) > (0.1 + 0.02 * np.abs(want))
    assert moved.mean() < 0.02


# ---------------------------------------------------------------------------
# (c) the cluster epilogue's split of the group max
# ---------------------------------------------------------------------------


def _cluster_epilogue(gate, up, t, abits, a_clip):
    """K10's SiLU-quant epilogue in numpy float32, block by block: a block
    holds t channels of each row (gate and up), takes act = SiLU(g) * u and
    its rows' partial |max|; a 128-channel group's max is the max of its
    128 / t blocks' partials; each block then quantizes its own channels
    (the last group the INT8 keeper without clip, the others abits with the
    clip) -> (codes int8 [M, inter], scales f32 [M, inter / 128])."""
    m, inter = gate.shape
    act = (torch.nn.functional.silu(torch.from_numpy(gate)) * torch.from_numpy(up)).numpy()
    nblk, ranks = inter // 128, 128 // t
    codes = np.zeros((m, inter), np.int8)
    scales = np.zeros((m, nblk), np.float32)
    for grp in range(nblk):
        partial = [np.abs(act[:, grp * 128 + q * t : grp * 128 + (q + 1) * t]).max(axis=1, initial=np.float32(0))
                   for q in range(ranks)]
        amax = np.maximum(np.maximum.reduce(partial[::-1]), np.float32(1e-5))  # any order: the max is exact
        keeper = grp == nblk - 1
        qmax = np.float32(127 if keeper else 2 ** (abits - 1) - 1)
        if not keeper and a_clip < 1.0:
            amax = (amax * np.float32(a_clip)).astype(np.float32)
        scale = (amax / qmax).astype(np.float32)
        for q in range(ranks):
            cols = slice(grp * 128 + q * t, grp * 128 + (q + 1) * t)
            codes[:, cols] = np.clip(np.rint(act[:, cols] / scale[:, None]), -qmax - 1, qmax).astype(np.int8)
        scales[:, grp] = scale
    return codes, scales, act


@pytest.mark.parametrize("t", [32, 64])
@pytest.mark.parametrize("a_clip", [A_CLIP, 1.0])
def test_cluster_epilogue_equals_quantize_dual_path(t, a_clip):
    """The group max taken from 4 (t = 32) or 2 (t = 64) partial maxima, then
    each block's channels quantized, gives ``quantize_dual_path``'s codes and
    scales bit for bit, the keeper group included, with and without the
    clip; gate/up products of the scale a 7B MLP gives, a few rows of all
    zeros (the floor 1e-5) and one group's largest value in each block."""
    rng = np.random.default_rng(t)
    m, inter = 24, 768
    gate = (rng.standard_normal((m, inter)) * 3).astype(np.float32)
    up = (rng.standard_normal((m, inter)) * 2).astype(np.float32)
    gate[3], up[5] = 0, 0
    for q in range(128 // t):  # row 7: the largest |act| of group 1 in block q of it, in turn over the rows
        gate[7 + q, 128 + q * t] = 9.0
    codes, scales, act = _cluster_epilogue(gate, up, t, 4, a_clip)
    want = quantize_dual_path(torch.from_numpy(act), 4, a_clip, 128)
    assert np.array_equal(codes, want.codes.numpy()) and np.array_equal(scales, want.scales.numpy())
    floor = np.float32(1e-5) * (np.float32(a_clip) if a_clip < 1.0 else np.float32(1))
    assert (scales[3] == np.array([floor / np.float32(7)] * 5 + [np.float32(1e-5) / np.float32(127)], np.float32)).all()
