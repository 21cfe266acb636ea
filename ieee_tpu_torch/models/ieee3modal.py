"""IEEE3modalPart: the multi-modal (RGB + NI + TI) part model.

Counterpart of ``ieee_tpu/models/ieee3modal.py`` (reference
``torchreid/models/ieee3modalPart.py:285-555``): three ResNet-50 trunks
(last_stride 1) -> CIM cross-modal interaction with channel attention ->
global and 6-stripe pooling -> the shared 2048->768 reduce -> REM -> per-part
768->128 FC necks -> per-part classifiers. The eval feature is
``concat([fc_T, fc_R, fc_N])`` (2304-d; T, R, N order as the reference); the
training forward returns the JAX package's dict (``ieee3modal.py:294-318``):
per-part logits ``logits_R/N/T`` (B, P, C), the l2-normalised
``feat_R/N/T`` (margin, hcloss and CMT losses) or ``feat`` (triplet), and
``fc_all``.

Same factorisation as the JAX package: REM in its exact reduced form
``part + 2*gamma*W_part(global)`` (conv_query and conv_value are kept for the
checkpoint layout), and the per-part necks computed as one stacked product.
Module and key names are the reference's, so ``state_dict()`` is a reference
checkpoint (``models/weights.py``). In training the part necks' BNs use
batch statistics (f32, biased, momentum 0.9 as flax's ``nn.BatchNorm`` over
the (B, P*F) axis, whose statistics are per column); REM's conv_query and
conv_value take no part in the forward, so their gradients are zero, which
the engine makes explicit before the optimizer step.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import (
    ConvBN,
    DenseBNReLU,
    FusedConvBN1x1,
    adaptive_avg_pool,
    fuse_worthwhile,
    global_avg_pool,
    global_max_pool,
)
from .resnet import ResNetTrunk

__all__ = ["IEEE3modalPart", "ChannelAttention", "NonLocalREM"]

_MODAL = "RNT"


class ChannelAttention(nn.Module):
    """Sigmoid channel gate from an avg+max pooled shared MLP (reference
    ``ieee3modalPart.py:266-282``); keys ``fc.0.weight``, ``fc.2.weight``."""

    def __init__(self, channels: int = 2048, ratio: int = 16,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.fc = nn.Sequential(
            nn.Conv2d(channels, channels // ratio, 1, bias=False),
            nn.ReLU(),
            nn.Conv2d(channels // ratio, channels, 1, bias=False),
        )

    def mlp(self, v):
        dt = self.dtype
        w1 = self.fc[0].weight[:, :, 0, 0].to(dt)
        w2 = self.fc[2].weight[:, :, 0, 0].to(dt)
        return F.relu(v.to(dt) @ w1.T) @ w2.T

    def forward(self, x):
        # x: (B, C, H, W) -> gate (B, C, 1, 1) in x's dtype
        z = self.mlp(global_avg_pool(x)) + self.mlp(global_max_pool(x))
        return torch.sigmoid(z.float())[:, :, None, None].to(x.dtype)


class NonLocalREM(nn.Module):
    """REM relation block (reference ``nonLocal``, ``ieee3modalPart.py:51-80``)
    in its exact reduced form ``query + 2*gamma*conv_part(part)``: the
    reference softmaxes a (B, 1, 1) energy, which is constantly 1."""

    def __init__(self, dim: int = 768, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv_query = nn.Linear(dim, dim)
        self.conv_part = nn.Linear(dim, dim)
        self.conv_value = nn.Linear(dim, dim)
        self.param = nn.Parameter(torch.zeros(1))

    def forward(self, query, part):
        dt = self.dtype
        f_part = F.linear(part.to(dt), self.conv_part.weight.to(dt),
                          self.conv_part.bias.to(dt))
        return query + (self.param * 2.0).to(query.dtype) * f_part


def _l2norm(x, eps: float = 1e-12):
    return x / x.norm(dim=1, keepdim=True).clamp_min(eps)


class IEEE3modalPart(nn.Module):
    """3-branch multi-modal part model. Input: a tuple (R, N, T) of
    (B, 3, H, W) f32 images; eval output: (B, 2304) f32 ``fc_all``;
    training output: the dict of the module docstring."""

    def __init__(self, num_classes: int = 100, loss: str = "softmax",
                 parts: int = 6, fc_dim: int = 128, pooling_dim: int = 768,
                 interaction: bool = True, attention: bool = True,
                 using_REM: bool = True,
                 backbone_layers: Sequence[int] = (3, 4, 6, 3),
                 dtype=torch.bfloat16, fused_1x1: bool = False,
                 block_megakernel: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.loss = loss
        self.parts = parts
        self.fc_dim = fc_dim
        self.interaction = interaction
        self.attention = attention
        self.using_REM = using_REM
        self.dtype = dtype
        self.num_streams = 3
        self.feature_dim = parts * fc_dim * 3

        def conv_bn_1x1(features, k_in=2048):
            if fused_1x1 and fuse_worthwhile(k_in, features):
                return FusedConvBN1x1(k_in, features, "relu", dtype)
            return ConvBN(k_in, features, nonlinear="relu", dtype=dtype)

        self.backbone = nn.ModuleList(
            ResNetTrunk(tuple(backbone_layers), last_stride=1, dtype=dtype,
                        fused_1x1=fused_1x1, block_megakernel=block_megakernel)
            for _ in _MODAL)
        if interaction:
            self.convOne = nn.ModuleList(conv_bn_1x1(2048) for _ in range(3))
            self.convAvgRest = nn.ModuleList(
                conv_bn_1x1(2048) for _ in range(3))
            if attention:
                self.CA = nn.ModuleList(
                    ChannelAttention(2048, dtype=dtype) for _ in range(3))
        self.reduce_layer = nn.ModuleList(
            conv_bn_1x1(pooling_dim) for _ in range(3))
        if using_REM:
            self.REM = nn.ModuleList(
                NonLocalREM(pooling_dim, dtype=dtype) for _ in range(3))
        for m in _MODAL:
            self.add_module(f"fc_{m}", nn.ModuleList(
                DenseBNReLU(pooling_dim, fc_dim, dtype)
                for _ in range(parts)))
            self.add_module(f"classifier_{m}", nn.ModuleList(
                nn.Linear(fc_dim, num_classes) for _ in range(parts)))

    def named_units(self):
        """(name, module) of each top-level module under the JAX package's
        name for it (``backbone_R``, ``convOne_0``, ``CA_0``, ``reduce_0``,
        ``REM_0``, ``fc_R``, ``classifier_R``, ...): the names that
        ``train.open_layers`` matches during a fixbase warm-up."""
        for m, trunk in zip(_MODAL, self.backbone):
            yield f"backbone_{m}", trunk
        groups = [("convOne", "convOne"), ("convAvgRest", "convAvgRest"),
                  ("CA", "CA"), ("reduce", "reduce_layer"), ("REM", "REM")]
        for name, attr in groups:
            for i, mod in enumerate(getattr(self, attr, ())):
                yield f"{name}_{i}", mod
        for m in _MODAL:
            yield f"fc_{m}", getattr(self, f"fc_{m}")
            yield f"classifier_{m}", getattr(self, f"classifier_{m}")

    def _cim(self, one, rest1, rest2, idx):
        """Cross-modal interaction (reference ``ieee3modalPart.py:427-435``)."""
        f_one = self.convOne[idx](one)
        f_rest = self.convAvgRest[idx](rest1 + rest2)
        if self.attention:
            f_rest = self.CA[idx](f_rest) * f_rest + f_rest
        return f_one + f_rest

    def part_fc(self, i: int, x):
        """Stacked per-part neck of modality i: (B, P, D) -> (B, P, F) in the
        compute dtype. One (B,P,D) x (P,D,F) product in ``dtype``, then the
        per-part BN (f32: running stats in eval, batch stats in training)
        and ReLU."""
        fc = getattr(self, f"fc_{_MODAL[i]}")
        dt = self.dtype
        w = torch.stack([blk[0].weight.T for blk in fc]).to(dt)  # (P, D, F)
        b = torch.stack([blk[0].bias for blk in fc])  # (P, F)
        y = torch.einsum("bpd,pdf->bpf", x.to(dt), w).float() + b
        if self.training:
            y = torch.stack([blk[1](y[:, p]) for p, blk in enumerate(fc)], 1)
            return F.relu(y).to(dt)
        folded = [blk[1].folded() for blk in fc]
        inv = torch.stack([f[0] for f in folded])
        shift = torch.stack([f[1] for f in folded])
        return F.relu(y * inv + shift).to(dt)

    def part_classifier(self, i: int, x):
        """Stacked per-part classifiers of modality i (the JAX
        ``PartClassifier``): (B, P, F) -> (B, P, C) logits in f32."""
        cls = getattr(self, f"classifier_{_MODAL[i]}")
        w = torch.stack([c.weight.T for c in cls])  # (P, F, C)
        b = torch.stack([c.bias for c in cls])  # (P, C)
        return torch.einsum("bpf,pfc->bpc", x.float(), w) + b

    def forward(self, x, return_featuremaps: bool = False):
        maps = [self.backbone[i](x[i]) for i in range(3)]
        if return_featuremaps:
            return tuple(maps)
        return self.head(maps)

    def head(self, maps):
        """Everything after the trunks: CIM, global and part pooling, the
        shared reduce (global first, then parts; reference
        ``ieee3modalPart.py:449-455``; in training the running stats take
        both updates in that order), REM, part necks, the T,R,N concat; in
        training also the classifiers and the output dict."""
        if self.interaction:
            pooled = [self._cim(maps[0], maps[1], maps[2], 0),
                      self._cim(maps[1], maps[0], maps[2], 1),
                      self._cim(maps[2], maps[0], maps[1], 2)]
        else:
            pooled = maps
        fc = []
        for i in range(3):
            g = adaptive_avg_pool(maps[i], 1, 1)  # (B, 2048, 1, 1)
            p = adaptive_avg_pool(pooled[i], self.parts, 1)  # (B, 2048, P, 1)
            red_g = self.reduce_layer[i](g)[:, :, 0, 0]  # (B, 768)
            red_p = self.reduce_layer[i](p)[:, :, :, 0].transpose(1, 2)
            if self.using_REM:
                # 2*gamma*W_part(global), broadcast over the P parts
                delta = self.REM[i](torch.zeros_like(red_g), red_g)
                red_p = red_p + delta[:, None, :]
            fc.append(self.part_fc(i, red_p))
        fc_R, fc_N, fc_T = (f.reshape(f.shape[0], -1).float() for f in fc)
        fc_all = torch.cat([fc_T, fc_R, fc_N], dim=1)
        if not self.training:
            return fc_all
        out = {f"logits_{m}": self.part_classifier(i, fc[i])
               for i, m in enumerate(_MODAL)}
        if self.loss in ("margin", "hcloss", "CMT"):
            out.update(feat_R=_l2norm(fc_R), feat_N=_l2norm(fc_N),
                       feat_T=_l2norm(fc_T))
        elif self.loss == "triplet":
            out["feat"] = _l2norm(fc_all)
        out["fc_all"] = fc_all
        return out
