"""GPTQ weight calibration (``atom_tpu/calib/gptq.py``): blocked,
error-propagating quantization of one linear against its input Hessian.

  * the Hessian is a running mean of ``2 X^T X`` over calibration batches;
  * dead columns get a unit diagonal and zero weights, then ``percdamp`` x the
    mean diagonal is added;
  * ``hinv`` is the upper Cholesky factor of ``H^-1``: ``cholesky``, the
    inverse by ``cholesky_solve`` against the identity, symmetrisation, then
    ``cholesky`` again, in the JAX package's order;
  * within a block (one quantization group wide) each column is rounded on
    the group's grid and its error spread over the block's later columns;
    after the block, its errors update every later column at once;
  * each group's scale comes from the error-compensated weights at the
    moment its block is reached (returned with ``return_scales``: the packed
    serving format needs them);
  * the last ``keeper`` columns take the error feedback but not the loop and
    are quantized at keeper precision at the end.

The JAX version's ``fori_loop`` over a block's columns and ``scan`` over the
blocks are Python loops over tensors here; on the card a block's column loop
replays from a CUDA graph.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from atom_tpu_torch.config import KeeperPrecision, QuantSpec, QuantType
from atom_tpu_torch.quant.core import div_exact, quantize_keeper
from atom_tpu_torch.quant.fp import fp4_round_normalized

_FP4_MAXQ = 24.0  # 2 * 12, the FP4 codebook's span


class GPTQState(NamedTuple):
    """Running Hessian estimate of one linear layer."""

    hessian: torch.Tensor  # float32 [in, in]
    nsamples: int


def gptq_init(in_features: int, device=None) -> GPTQState:
    return GPTQState(torch.zeros((in_features, in_features), dtype=torch.float32, device=device), 0)


def gptq_add_batch(state: GPTQState, x: torch.Tensor) -> GPTQState:
    """Fold one batch of layer inputs [..., in] into the Hessian: with t the
    number of leading-axis samples, H <- H n/(n+t) + (2/(n+t)) X^T X."""
    t = 1 if x.ndim <= 2 else int(x.shape[0])
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    n_new = state.nsamples + t
    # the two coefficients as float32 divisions, as the JAX version computes them
    ratio = float(np.float32(state.nsamples) / np.float32(n_new))
    coef = float(np.float32(2.0) / np.float32(n_new))
    return GPTQState(state.hessian * ratio + coef * (x2.T @ x2), n_new)


def _find_params(slab, bits: int, sym: bool, channel_group: int, clip_ratio: float, quant_type: QuantType):
    """Scale and zero [rows // channel_group, 1] over a [rows, cols] slab."""
    rows = slab.shape[0]
    x = slab.reshape(rows // channel_group, -1)
    xmin = torch.clamp_max(x.amin(dim=1), 0.0)
    xmax = torch.clamp_min(x.amax(dim=1), 0.0)
    if sym:
        xmax = torch.maximum(xmin.abs(), xmax)
        xmin = torch.where(xmin < 0, -xmax, xmin)
    degenerate = (xmin == 0) & (xmax == 0)
    xmin = torch.where(degenerate, -1.0, xmin)
    xmax = torch.where(degenerate, 1.0, xmax)
    maxq = _FP4_MAXQ if quant_type == QuantType.FP else float(2**bits - 1)
    scale = div_exact((xmax - xmin) * clip_ratio, maxq)
    zero = torch.full_like(scale, (maxq + 1) / 2) if sym else torch.round(-xmin / scale)
    return scale[:, None], zero[:, None]


def _quantize_column(w, scale, bounds, channel_group: int, quant_type: QuantType):
    """Round one weight column [rows] on the current grid.  The INT grid's
    ``clamp(round(x / s) + zero, 0, maxq) - zero`` is computed as
    ``clamp(round(x / s), -zero, maxq - zero)`` (``bounds``): integers, so
    the same values in two launches fewer."""
    rows = w.shape[0]
    x = w.reshape(rows // channel_group, channel_group)
    if quant_type == QuantType.FP:
        half = _FP4_MAXQ / 2
        v = torch.clamp(x / scale, -half, half)
        q = fp4_round_normalized(div_exact(v, half)) * half * scale
    else:
        q = scale * torch.clamp(torch.round(x / scale), *bounds)
    return q.reshape(rows)


def _column_loop(w1, hinv1, scale, bounds, channel_group: int, quant_type: QuantType):
    """Quantize a block's columns in order, in place in ``w1``, each
    column's error spread over the block's later columns -> the errors
    [rows, block] (column i of ``w1`` becomes w - e d, the quantized value up
    to rounding)."""
    errs = []
    for i in range(w1.shape[1]):
        w = w1[:, i]
        q = _quantize_column(w, scale, bounds, channel_group, quant_type)
        e = (w - q) / hinv1[i, i]
        w1[:, i:] -= e[:, None] * hinv1[i, i:][None, :]
        errs.append(e)
    return torch.stack(errs, dim=1)


_GRAPHS: dict = {}


def _column_loop_graphed(w1, hinv1, scale, bounds, channel_group: int):
    """:func:`_column_loop` (INT grid) on the card, replayed from a CUDA graph
    captured once per shape: the loop is ~8 small launches a column, and the
    host, not the card, sets its pace.  The same kernels run, so the results
    are those of the eager loop bit for bit."""
    key = (tuple(w1.shape), tuple(scale.shape), channel_group, w1.device)
    if key not in _GRAPHS:
        static = [t.clone() for t in (w1, hinv1, scale, *bounds)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up, as capture requires
            _column_loop(static[0].clone(), static[1], static[2], (static[3], static[4]), channel_group, QuantType.INT)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            err = _column_loop(static[0], static[1], static[2], (static[3], static[4]), channel_group, QuantType.INT)
        _GRAPHS[key] = (graph, static, err)
    graph, static, err = _GRAPHS[key]
    for dst, src in zip(static, (w1, hinv1, scale, *bounds)):
        dst.copy_(src)
    graph.replay()
    w1.copy_(static[0])
    return err.clone()


def _process_block(w_full, hinv, i1: int, block: int, find_scale_at_start: bool, scale0, zero0, *,
                   bits: int, sym: bool, channel_group: int, clip_ratio: float, quant_type: QuantType):
    """Quantize columns [i1, i1 + block) of ``w_full`` in place, spreading
    each column's error right within the block, then the block's errors over
    every later column -> (w_full, the block's scale [rows // cg, 1])."""
    w1 = w_full[:, i1 : i1 + block].clone()
    hinv1 = hinv[i1 : i1 + block, i1 : i1 + block]
    if find_scale_at_start:
        scale, zero = _find_params(w1, bits, sym, channel_group, clip_ratio, quant_type)
    else:
        scale, zero = scale0, zero0
    bounds = (-zero, float(2**bits - 1) - zero)  # the INT codes' range less the zero point
    if w1.is_cuda and quant_type == QuantType.INT:
        err = _column_loop_graphed(w1, hinv1, scale, bounds, channel_group)
    else:
        err = _column_loop(w1, hinv1, scale, bounds, channel_group, quant_type)
    w_full[:, i1 : i1 + block] = w1
    if i1 + block < w_full.shape[1]:
        w_full[:, i1 + block :] -= err @ hinv[i1 : i1 + block, i1 + block :]
    return w_full, scale


def hinv_upper(h: torch.Tensor) -> torch.Tensor:
    """Upper Cholesky factor U of inv(H), inv(H) = U^T U."""
    chol = torch.linalg.cholesky(h)
    eye = torch.eye(h.shape[0], dtype=h.dtype, device=h.device)
    hinv_full = torch.cholesky_solve(eye, chol)
    hinv_full = (hinv_full + hinv_full.T) / 2  # symmetrised against f32 solve noise
    return torch.linalg.cholesky(hinv_full).T


def gptq_blocks(
    w32: torch.Tensor,
    hinv: torch.Tensor,
    *,
    bits: int = 4,
    sym: bool = True,
    group_size: int = 128,
    channel_group: int = 2,
    keeper: int = 128,
    keeper_precision: KeeperPrecision = KeeperPrecision.INT8,
    quant_type: QuantType = QuantType.INT,
    clip_ratio: float = 1.0,
):
    """The block loop on given ``hinv``: f32 [out, in] weights (dead columns
    already zeroed) -> (fake-quantized f32 weights, scales [n_blocks, out // cg])."""
    n_nonout = w32.shape[1] - keeper
    if n_nonout <= 0:
        raise ValueError("GPTQ needs at least one non-keeper column")
    grouped = group_size > 0
    block = min(group_size if grouped else 128, n_nonout)
    scale0 = zero0 = None
    if not grouped:
        scale0, zero0 = _find_params(w32[:, :n_nonout], bits, sym, channel_group, clip_ratio, quant_type)
    w32 = w32.clone()
    scales = []
    for i1 in range(0, n_nonout, block):
        w32, scale = _process_block(w32, hinv, i1, min(block, n_nonout - i1), grouped, scale0, zero0, bits=bits,
                                    sym=sym, channel_group=channel_group, clip_ratio=clip_ratio, quant_type=quant_type)
        scales.append(scale[:, 0])
    if keeper > 0:
        w32[:, n_nonout:] = quantize_keeper(w32[:, n_nonout:], keeper_precision)
    return w32, torch.stack(scales)


@torch.no_grad()
def gptq_quantize_weight(
    w: torch.Tensor,
    hessian: torch.Tensor,
    *,
    bits: int = 4,
    sym: bool = True,
    group_size: int = 128,
    channel_group: int = 2,
    keeper: int = 128,
    keeper_precision: KeeperPrecision = KeeperPrecision.INT8,
    quant_type: QuantType = QuantType.INT,
    percdamp: float = 0.01,
    clip_ratio: float = 1.0,
    return_scales: bool = False,
):
    """GPTQ-quantize an [out, in] weight given its input Hessian -> the
    fake-quantized weight (w's dtype and shape), and with ``return_scales``
    the per-group scales [n_groups, out // channel_group] f32 it was
    quantized on."""
    cols = w.shape[1]
    w32 = w.to(torch.float32)
    h = hessian.to(torch.float32)
    dead = torch.diagonal(h) == 0
    h = h + torch.diag(dead.to(torch.float32))
    w32 = torch.where(dead[None, :], 0.0, w32)
    damp = percdamp * torch.mean(torch.diagonal(h))
    h = h + damp * torch.eye(cols, dtype=h.dtype, device=h.device)
    wq, scales = gptq_blocks(w32, hinv_upper(h), bits=bits, sym=sym, group_size=group_size,
                             channel_group=channel_group, keeper=keeper, keeper_precision=keeper_precision,
                             quant_type=quant_type, clip_ratio=clip_ratio)
    if return_scales:
        return wq.to(w.dtype), scales
    return wq.to(w.dtype)


def gptq_quantize_weight_spec(w: torch.Tensor, hessian: torch.Tensor, spec: QuantSpec, return_scales: bool = False):
    """:func:`gptq_quantize_weight` with its settings from a :class:`QuantSpec`."""
    return gptq_quantize_weight(
        w,
        hessian,
        bits=spec.wbits,
        sym=spec.w_sym,
        group_size=spec.weight_group_size,
        channel_group=spec.weight_channel_group,
        keeper=spec.keeper,
        keeper_precision=spec.keeper_precision,
        quant_type=spec.quant_type,
        percdamp=spec.percdamp,
        clip_ratio=spec.w_clip_ratio,
        return_scales=return_scales,
    )
