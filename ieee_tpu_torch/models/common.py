"""Shared building blocks of the port's models.

Counterpart of ``ieee_tpu/models/common.py``. Conventions, as in the JAX
package: parameters are float32 masters cast to the compute ``dtype``
(bfloat16 on the card) at each op; BatchNorm statistics are float32.
Activations are NCHW tensors in ``torch.channels_last`` memory, so the
(N*H*W, C) view a 1x1 conv-as-matmul kernel takes is free.

State-dict keys follow the reference (torchvision / torchreid) layout, so
reference checkpoints load directly and ``ieee_tpu``'s converter maps them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.matmul_bn import mm_affine_act, mm_bn_act_train

__all__ = ["FastBatchNorm", "ConvBN", "FusedConvBN1x1", "fused_conv_bn_1x1",
           "DenseBNReLU", "fuse_worthwhile", "global_avg_pool",
           "global_max_pool", "adaptive_avg_pool"]


def fuse_worthwhile(k_in: int, c_out: int, min_dim: int = 384) -> bool:
    """Per-site gate for the fused 1x1 path, the JAX package's
    ``models/resnet.py:fuse_worthwhile``: both channel dims at least
    ``min_dim``. At full width it admits layer4's cb1, cb3 and downsample,
    CIM and the reduce layer."""
    return min(k_in, c_out) >= min_dim


class FastBatchNorm(nn.Module):
    """BatchNorm with float32 statistics and compute-dtype normalisation
    (``ieee_tpu/models/common.py:FastBatchNorm``).

    It holds flax's state, not torch's: the running variance is the BIASED
    batch variance (one-pass E[x^2] - m^2) and the running update is
    ``momentum * running + (1 - momentum) * batch`` with flax's momentum 0.9
    (torch's 0.1). Keys match ``nn.BatchNorm2d`` (weight, bias, running_mean,
    running_var, num_batches_tracked). Channels are dim 1 of the input.
    ``clip_var`` clips a negative batch variance (f32 cancellation) to 0, as
    flax's own ``nn.BatchNorm`` does; the JAX ``FastBatchNorm`` does not.

    Two flags, set by the engine on the BNs of frozen modules during a
    fixbase warm-up (``engine/engine.py``), follow the JAX package's
    ``_bn_eval_interceptor`` and ``stats_mask``: ``use_running`` makes a
    training forward of THIS module normalise with the running statistics
    (the interceptor reaches flax BN modules only, so the fused 1x1 and
    block sites, which take the BN's parameters without calling it, still
    normalise with batch statistics); ``pin_stats`` keeps the running
    statistics as they are at every site.
    """

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.bfloat16,
                 clip_var: bool = False):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.clip_var = clip_var
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))
        self.use_running = False
        self.pin_stats = False

    def folded(self, mean=None, var=None):
        """(inv, shift) in f32 such that bn(x) = x * inv + shift."""
        mean = self.running_mean if mean is None else mean
        var = self.running_var if var is None else var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return inv, self.bias - mean * inv

    @torch.no_grad()
    def update_running(self, mean, var) -> None:
        """Fold batch statistics into the running ones (flax's momentum);
        nothing while ``pin_stats``."""
        if self.pin_stats:
            return
        m = self.momentum
        self.running_mean.mul_(m).add_((1 - m) * mean)
        self.running_var.mul_(m).add_((1 - m) * var)
        self.num_batches_tracked.add_(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training and not self.use_running:
            dims = [d for d in range(x.ndim) if d != 1]
            xf = x.float()
            mean = xf.mean(dims)
            var = (xf * xf).mean(dims) - mean * mean
            if self.clip_var:
                var = var.clamp_min(0.0)
            self.update_running(mean, var)
            inv, shift = self.folded(mean, var)
        else:
            inv, shift = self.folded()
        dt = self.dtype
        return (x.to(dt) * inv.to(dt).view(shape)
                + shift.to(dt).view(shape))


def conv_bn(x, conv: nn.Conv2d, bn: FastBatchNorm, nonlinear=None,
            dtype=torch.bfloat16):
    """Conv (no bias, ``conv.groups`` groups) in ``dtype`` + BN [+ ReLU for
    ``nonlinear="relu"``]: the plain path."""
    y = bn(F.conv2d(x.to(dtype), conv.weight.to(dtype), None, conv.stride,
                    conv.padding, 1, conv.groups))
    return F.relu(y) if nonlinear == "relu" else y


def fused_conv_bn_1x1(x, weight, bn: FastBatchNorm, relu: bool,
                      residual=None):
    """1x1 conv + BN [+ ReLU] through the fused matmul kernels: in eval
    (``bn.training`` False) the mm_affine kernel on the folded running
    statistics; in training ``mm_bn_act_train`` (mm_stats forward, mm_bn_da
    and mm_bn_dw backward) on the batch statistics, which then update the
    running ones (momentum ``bn.momentum``, flax's convention).

    ``x`` (N, C_in, H, W) is read as its (N*H*W, C_in) rows (a free view
    when it is channels_last; the backward's gradient comes back through the
    same view), cast to ``bn.dtype``. The result is (N, C_out, H, W) bf16 in
    channels_last memory. With ``residual`` the output is bn(conv(x)) +
    residual without ReLU; the caller applies it (the JAX package's
    ``FusedConvBN1x1`` contract)."""
    if relu and residual is not None:
        raise ValueError("residual variant applies relu outside")
    n, cin, h, w = x.shape
    cout = weight.shape[0]
    a = x.permute(0, 2, 3, 1).reshape(-1, cin)
    wt = weight.reshape(cout, cin).t()
    res = (None if residual is None
           else residual.permute(0, 2, 3, 1).reshape(-1, cout))
    if bn.training:
        res = None if res is None else res.to(bn.dtype)
        y, mean, var = mm_bn_act_train(a.to(bn.dtype), wt, bn.weight,
                                       bn.bias, res, relu)
        bn.update_running(mean, var)
    else:
        inv, shift = bn.folded()
        y = mm_affine_act(a, wt, inv, shift, relu)
        if res is not None:
            y = y + res.to(y.dtype)
    return y.view(n, h, w, cout).permute(0, 3, 1, 2)


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm [+ ReLU]: the reference's DimReduceLayer
    (``layers.0`` conv, ``layers.1`` BN) and the JAX package's ``ConvBN``."""

    def __init__(self, in_channels: int, features: int, kernel: int = 1,
                 stride: int = 1, padding: int = 0, nonlinear=None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.nonlinear = nonlinear
        self.dtype = dtype
        self.layers = nn.Sequential(
            nn.Conv2d(in_channels, features, kernel, stride, padding,
                      bias=False),
            FastBatchNorm(features, dtype=dtype),
        )

    def forward(self, x):
        return conv_bn(x, self.layers[0], self.layers[1], self.nonlinear,
                       self.dtype)


class FusedConvBN1x1(ConvBN):
    """Drop-in for a 1x1 stride-1 ``ConvBN`` backed by the fused matmul
    kernels (``ieee_tpu/models/common.py:FusedConvBN1x1``): mm_affine in
    eval, ``mm_bn_act_train`` in training (``fused_conv_bn_1x1``). Same
    parameters and keys as ``ConvBN``."""

    def __init__(self, in_channels: int, features: int, nonlinear=None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_channels, features, 1, 1, 0, nonlinear, dtype)

    def forward(self, x, residual=None):
        return fused_conv_bn_1x1(x, self.layers[0].weight, self.layers[1],
                                 self.nonlinear == "relu", residual)


class DenseBNReLU(nn.Sequential):
    """Linear + BatchNorm1d + ReLU [+ dropout]: the reference's
    ``_construct_fc_layer`` unit for one dimension (``ieee_tpu/models/
    common.py:DenseBNReLU``; keys ``0`` the Linear, ``1`` the BN). The
    product runs in ``dtype``; the BN is flax's ``nn.BatchNorm`` in the JAX
    package: f32, biased one-pass variance clipped at 0, momentum 0.9.
    With ``dropout_p`` a training forward zeroes each output with that
    probability, drawn from the ``generator`` it is given."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, dropout_p=None):
        super().__init__(nn.Linear(in_features, features),
                         FastBatchNorm(features, dtype=torch.float32,
                                       clip_var=True),
                         nn.ReLU())
        self.dtype = dtype
        self.dropout_p = dropout_p or 0.0

    def forward(self, x, generator=None):
        dt = self.dtype
        lin = self[0]
        y = F.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))
        y = F.relu(self[1](y)).to(dt)
        if self.dropout_p and self.training:
            p = self.dropout_p
            keep = torch.rand(y.shape, generator=generator,
                              device=y.device) >= p
            y = torch.where(keep, y / (1.0 - p), torch.zeros_like(y))
        return y


def global_avg_pool(x):
    """(B, C, H, W) -> (B, C)."""
    return x.mean((2, 3))


def global_max_pool(x):
    """(B, C, H, W) -> (B, C)."""
    return x.amax((2, 3))


def adaptive_avg_pool(x, out_h: int, out_w: int):
    """(B, C, H, W) -> (B, C, out_h, out_w) with AdaptiveAvgPool2d's buckets
    [floor(i*H/out), ceil((i+1)*H/out)), which overlap when ``out_h`` does
    not divide H (P = 6 stripes of a 16-row map at 256x128)."""
    return F.adaptive_avg_pool2d(x, (out_h, out_w))
