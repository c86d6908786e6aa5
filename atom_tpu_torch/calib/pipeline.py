"""Calibration pipeline (``atom_tpu/calib/pipeline.py``): saliency ->
reorder -> weight quantization (GPTQ or round to nearest).

Saliency comes from the unquantized model.  GPTQ streams the layers: embed
once, then for each layer accumulate one Hessian per distinct linear input
from tap-collecting forwards (activations fake-quantized per the spec),
quantize the layer's linears, and feed the layer's outputs with the
quantized weights to the next layer, so quantization error reaches the
calibration data of later layers.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from atom_tpu_torch.calib.gptq import gptq_add_batch, gptq_init, gptq_quantize_weight
from atom_tpu_torch.calib.outlier import SaliencyAccumulator
from atom_tpu_torch.config import FP16_BASELINE, QuantSpec
from atom_tpu_torch.models.configs import Arch, ModelConfig


def _model_api(cfg: ModelConfig):
    """The architecture's accuracy model module."""
    if cfg.arch == Arch.LLAMA:
        from atom_tpu_torch.models import llama as m
    elif cfg.arch == Arch.OPT:
        from atom_tpu_torch.models import opt as m
    elif cfg.arch == Arch.MIXTRAL:
        from atom_tpu_torch.models import mixtral as m
    else:
        raise ValueError(cfg.arch)
    return m


@torch.no_grad()
def collect_saliency(params, cfg: ModelConfig, batches: Sequence[torch.Tensor], metric: str = "hessian"
                     ) -> Dict[str, torch.Tensor]:
    """Fold the unquantized model's activation statistics over the batches."""
    m = _model_api(cfg)
    acc = SaliencyAccumulator(metric=metric, nsamples=len(batches))
    for b in batches:
        _, taps = m.forward_collect_taps(params, b, cfg, FP16_BASELINE)
        acc.update(taps)
    return acc.stats


def compute_reorder_indices(saliency: Dict[str, torch.Tensor], head_dim: int) -> Dict[str, torch.Tensor]:
    acc = SaliencyAccumulator()
    acc.stats = dict(saliency)
    return acc.reorder_indices(head_dim=head_dim)


def reorder_model(params, cfg: ModelConfig, indices: Dict[str, torch.Tensor]):
    return _model_api(cfg).apply_reorder(params, cfg, indices)


def quantize_model_rtn(params, cfg: ModelConfig, spec: QuantSpec):
    return _model_api(cfg).quantize_weights_rtn(params, cfg, spec)


@torch.no_grad()
def quantize_model_gptq(params, cfg: ModelConfig, spec: QuantSpec, batches: Sequence[torch.Tensor],
                        scales_out: Optional[Dict[str, torch.Tensor]] = None):
    """Layer-streamed GPTQ over the (already reordered) model.

    ``scales_out``: a dict that receives the per-group GPTQ scales, keyed
    ``"{layer}.{weight}"`` -> [n_groups, out // channel_group] f32, which the
    exact export into the packed serving format needs.
    """
    m = _model_api(cfg)
    xs = [m.embed(params, b) for b in batches]
    aux = m.layer_aux(params, cfg, batches[0].shape[1])
    dev = params["embed"].device
    for i in range(cfg.num_layers):

        def quantize_fn(w_out_in, hessian, name=None, _layer=i):
            out = gptq_quantize_weight(
                w_out_in,
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
                return_scales=scales_out is not None,
            )
            if scales_out is None:
                return out
            wq, scales = out
            scales_out[f"{_layer}.{name}"] = scales
            return wq

        lp = m.get_layer(params, i)
        states = {t: gptq_init(f, device=dev) for t, f in m.hessian_tap_specs(cfg).items()}
        for x in xs:
            _, taps = m.forward_layer(lp, x, *aux, cfg, spec, collect_taps=True)
            for tapname in states:
                states[tapname] = gptq_add_batch(states[tapname], taps[tapname])
        lp_q = m.gptq_apply(lp, {t: s.hessian for t, s in states.items()}, quantize_fn)
        del states
        params = m.set_layer(params, i, lp_q)
        xs = [m.forward_layer(lp_q, x, *aux, cfg, spec)[0] for x in xs]
    return params


def calibrate(params, cfg: ModelConfig, spec: QuantSpec, batches: Sequence[torch.Tensor],
              scales_out: Optional[Dict[str, torch.Tensor]] = None) -> Tuple[object, Dict[str, torch.Tensor]]:
    """Saliency -> reorder -> weight quantization (GPTQ or RTN) -> (params,
    reorder indices).  ``scales_out`` (GPTQ only): see :func:`quantize_model_gptq`."""
    indices: Dict[str, torch.Tensor] = {}
    if spec.reorder:
        saliency = collect_saliency(params, cfg, batches, spec.act_sort_metric)
        indices = compute_reorder_indices(saliency, head_dim=cfg.head_dim)
        params = reorder_model(params, cfg, indices)
    if spec.quantize_weights:
        if spec.use_gptq:
            params = quantize_model_gptq(params, cfg, spec, batches, scales_out)
        else:
            params = quantize_model_rtn(params, cfg, spec)
    return params, indices
