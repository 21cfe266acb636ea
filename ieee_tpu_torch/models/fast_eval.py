"""Folded-BN IEEE eval head with the fused partpool kernel.

Counterpart of ``ieee_tpu/models/fast_eval.py``: the same feature as
``IEEE3modalPart`` in eval mode, with every head BatchNorm folded into an
affine (running statistics: exact in eval) and each pool -> 2048->768 reduce
-> BN -> ReLU chain run as the partpool kernel (``ops/kernels/partpool.py``).
The CIM convs, channel attention, REM and part necks are a handful of folded
products in PyTorch, as the JAX package leaves them to XLA. The trunks are
the model's own (with ``fused_1x1``, their layer4 1x1 sites run the
mm_affine kernel).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.kernels.partpool import fold_bn, fused_partpool_project
from .ieee3modal import IEEE3modalPart

__all__ = ["build_fast_ieee_eval", "build_fast_ieee_eval_step",
           "head_from_maps", "supports_fast_eval"]

_MODAL = "RNT"


def supports_fast_eval(model) -> bool:
    """The fused head covers the full IEEE head (CIM + CA + REM); ablation
    variants take the plain forward."""
    return (isinstance(model, IEEE3modalPart) and model.interaction
            and model.attention and model.using_REM)


def _fold(convbn):
    """1x1 ConvBN -> (W (C_in, C_out) with the BN scale folded in, shift)."""
    conv, bn = convbn.layers
    s, t = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var,
                   bn.eps)
    return conv.weight[:, :, 0, 0].T * s[None, :], t


def _fold_head(model: IEEE3modalPart):
    cim, reduce_folded, rem, fc_folded = [], [], [], []
    for i in range(3):
        w_one, b_one = _fold(model.convOne[i])
        w_rest, b_rest = _fold(model.convAvgRest[i])
        ca = model.CA[i].fc
        cim.append(dict(w_one=w_one, b_one=b_one, w_rest=w_rest,
                        b_rest=b_rest, ca_fc1=ca[0].weight[:, :, 0, 0].T,
                        ca_fc2=ca[2].weight[:, :, 0, 0].T))
        conv, bn = model.reduce_layer[i].layers
        s, t = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var)
        reduce_folded.append((conv.weight[:, :, 0, 0].T, s, t))
        r = model.REM[i]
        rem.append((r.conv_part.weight.T, r.conv_part.bias, r.param))
    for m in _MODAL:
        fc = getattr(model, f"fc_{m}")
        k = torch.stack([blk[0].weight.T for blk in fc])  # (P, 768, 128)
        b = torch.stack([blk[0].bias for blk in fc])  # (P, 128)
        st = [fold_bn(blk[1].weight, blk[1].bias, blk[1].running_mean,
                      blk[1].running_var) for blk in fc]
        fc_folded.append((k, b, torch.stack([x[0] for x in st]),
                          torch.stack([x[1] for x in st])))
    return cim, reduce_folded, rem, fc_folded


def _cim_apply(one, rest_sum, c):
    # one, rest_sum: (B, H, W, C) f32
    f_one = torch.relu(one @ c["w_one"] + c["b_one"])
    f_rest = torch.relu(rest_sum @ c["w_rest"] + c["b_rest"])
    avg = f_rest.mean((1, 2))
    mx = f_rest.amax((1, 2))

    def mlp(v):
        return torch.relu(v @ c["ca_fc1"]) @ c["ca_fc2"]

    gate = torch.sigmoid(mlp(avg) + mlp(mx))[:, None, None, :]
    return f_one + gate * f_rest + f_rest


def head_from_maps(model: IEEE3modalPart, maps):
    """Folded IEEE head on the three trunk maps ((B, 2048, H, W) each):
    CIM -> fused part-pool -> REM -> per-part neck -> (B, 2304) f32."""
    parts = model.parts
    cim, reduce_folded, rem, fc_folded = _fold_head(model)
    # NHWC f32 views (free for channels_last maps), the JAX package's layout
    maps = [m.float().permute(0, 2, 3, 1) for m in maps]
    cims = [_cim_apply(maps[0], maps[1] + maps[2], cim[0]),
            _cim_apply(maps[1], maps[0] + maps[2], cim[1]),
            _cim_apply(maps[2], maps[0] + maps[1], cim[2])]
    fc_flat = []
    for i in range(3):
        w, s, t = reduce_folded[i]
        g = fused_partpool_project(maps[i], w, s, t, parts=parts)[:, 0]
        p = fused_partpool_project(cims[i], w, s, t, parts=parts)[:, 1:]
        wp, bp, gamma = rem[i]
        p = p + ((2.0 * gamma) * (g @ wp + bp))[:, None, :]
        k, b2, s2, t2 = fc_folded[i]
        y = torch.einsum("bpd,pdf->bpf", p.to(torch.bfloat16),
                         k.to(torch.bfloat16)).float() + b2
        y = torch.relu(y * s2 + t2)
        fc_flat.append(y.reshape(y.shape[0], -1))
    fc_R, fc_N, fc_T = fc_flat
    return torch.cat([fc_T, fc_R, fc_N], dim=1)


def _fast_eval_core(model, imgs):
    maps = model(imgs, return_featuremaps=True)
    return head_from_maps(model, maps)


def build_fast_ieee_eval(model: IEEE3modalPart) -> Callable:
    """fn(imgs: (R, N, T) tuple of (B, 3, H, W)) -> (B, 2304), using the
    model's current weights (feature-extractor style)."""

    @torch.inference_mode()
    def fast_eval(imgs):
        return _fast_eval_core(model, imgs)

    return fast_eval


def build_fast_ieee_eval_step(model: IEEE3modalPart,
                              transform=None) -> Callable:
    """Engine-shaped fused eval step: fn(imgs) -> (B, 2304), with
    ``transform`` (the test transform) applied to each modality first."""

    @torch.inference_mode()
    def step(imgs):
        if transform is not None:
            imgs = tuple(transform(m) for m in imgs)
        return _fast_eval_core(model, imgs)

    return step
