"""ResNet trunk (bottleneck blocks) for the IEEE model.

Counterpart of ``ieee_tpu/models/resnet.py`` (``Bottleneck``,
``ResNetTrunk``): conv1..layer4 returning the final map, with ``last_stride``
1 keeping a 16x8 map at 256x128 input. Keys are torchvision's (``conv1``,
``bn1``, ``layer{s}.{b}.conv{1,2,3}``, ``bn{1,2,3}``, ``downsample.{0,1}``).

With ``fused_1x1`` each 1x1 conv+BN site that passes ``fuse_worthwhile``
runs through the fused matmul kernels (mm_affine in eval, mm_bn_act_train in
training: layer4's cb1, cb3 and downsample at full width); the cb3 +
residual contract and the strided-downsample subsample follow the JAX
package (``resnet.py:176-189``). With ``block_megakernel`` a training
forward of each stride-1 block without downsample that passes
``megakernel_ok`` runs as ``bottleneck_train`` (the whole-block backward
kernels, ``ops/kernels/block_bwd.py``), which takes precedence over
``fused_1x1`` as in the JAX package (``resnet.py:140-143``); eval keeps the
plain block.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.block_bwd import bottleneck_train
from .common import FastBatchNorm, conv_bn, fuse_worthwhile, fused_conv_bn_1x1

__all__ = ["Bottleneck", "ResNetTrunk", "megakernel_ok"]


def megakernel_ok(width: int) -> bool:
    """Width gate of the whole-block path: the widths the JAX package's
    ``megakernel_vmem_ok`` admits (width <= 256: layer1-3 of a ResNet-50,
    10 blocks per trunk), so both packages take the block path on the same
    blocks. That gate is a TPU VMEM limit; the CUDA kernels have none (they
    are checked at width 512 on the card), and widening it to layer4 waits
    for measured times (ROADMAP B.4)."""
    return width <= 256


def _conv(cin, cout, k, stride=1, padding=0):
    return nn.Conv2d(cin, cout, k, stride, padding, bias=False)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.bfloat16,
                 fused_1x1: bool = False, block_megakernel: bool = False):
        super().__init__()
        width = planes
        c_out = planes * self.expansion
        self.dtype = dtype
        self.stride = stride
        self.conv1 = _conv(in_planes, width, 1)
        self.bn1 = FastBatchNorm(width, dtype=dtype)
        self.conv2 = _conv(width, width, 3, stride, 1)
        self.bn2 = FastBatchNorm(width, dtype=dtype)
        self.conv3 = _conv(width, c_out, 1)
        self.bn3 = FastBatchNorm(c_out, dtype=dtype)
        self.downsample = (
            nn.Sequential(_conv(in_planes, c_out, 1, stride),
                          FastBatchNorm(c_out, dtype=dtype))
            if downsample else None)
        # per-site gates, as the JAX Bottleneck: cb3 and downsample must
        # agree, since the fused cb3 consumes the identity as its residual
        self.fuse_cb1 = fused_1x1 and fuse_worthwhile(in_planes, width)
        self.fuse_cb3 = (fused_1x1 and fuse_worthwhile(width, c_out)
                         and (not downsample
                              or fuse_worthwhile(in_planes, c_out)))
        # the JAX Bottleneck takes its whole-block backward for stride-1
        # blocks without downsample within its width gate
        self.megakernel = (block_megakernel and stride == 1
                           and not downsample and megakernel_ok(width))

    def forward(self, x):
        dt = self.dtype
        if self.training and self.megakernel:
            return self._block_train(x)
        identity = x
        if self.fuse_cb1:
            out = fused_conv_bn_1x1(x, self.conv1.weight, self.bn1, True)
        else:
            out = conv_bn(x, self.conv1, self.bn1, "relu", dt)
        out = conv_bn(out, self.conv2, self.bn2, "relu", dt)
        if self.fuse_cb3:
            if self.downsample is not None:
                # 1x1 stride-s conv == subsample rows/cols, then stride-1 1x1
                xs = (x[:, :, ::self.stride, ::self.stride]
                      if self.stride != 1 else x)
                identity = fused_conv_bn_1x1(
                    xs, self.downsample[0].weight, self.downsample[1], False)
            out = fused_conv_bn_1x1(out, self.conv3.weight, self.bn3, False,
                                    residual=identity)
            return F.relu(out)
        out = conv_bn(out, self.conv3, self.bn3, None, dt)
        if self.downsample is not None:
            identity = conv_bn(x, self.downsample[0], self.downsample[1],
                               None, dt)
        return F.relu(out + identity)

    def _block_train(self, x):
        """``bottleneck_train`` on the NHWC view of x (free for a
        channels_last map) with the OIHW weights viewed as (kh, kw, in,
        out); the batch statistics update the three BNs' running ones once
        per forward (flax's momentum, as the JAX ``_megakernel_block``)."""
        def hwio(conv):
            return conv.weight.permute(2, 3, 1, 0)

        y, stats = bottleneck_train(
            x.to(self.dtype).permute(0, 2, 3, 1),
            hwio(self.conv1), self.bn1.weight, self.bn1.bias,
            hwio(self.conv2), self.bn2.weight, self.bn2.bias,
            hwio(self.conv3), self.bn3.weight, self.bn3.bias)
        for bn, mean, var in zip((self.bn1, self.bn2, self.bn3), stats[0::2],
                                 stats[1::2]):
            bn.update_running(mean, var)
        return y.permute(0, 3, 1, 2)


class ResNetTrunk(nn.Module):
    """Stem + layer1..layer4 of a bottleneck ResNet; returns the final map
    (N, 2048, H/16, W/16) at ``last_stride`` 1."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 last_stride: int = 2, dtype=torch.bfloat16,
                 fused_1x1: bool = False, block_megakernel: bool = False):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(3, 64, 7, 2, 3)
        self.bn1 = FastBatchNorm(64, dtype=dtype)
        in_planes = 64
        strides = (1, 2, 2, last_stride)
        for s, (planes, n_blocks, stride) in enumerate(
                zip((64, 128, 256, 512), layers, strides), start=1):
            blocks = []
            for b in range(n_blocks):
                st = stride if b == 0 else 1
                down = b == 0 and (st != 1
                                   or in_planes != planes * Bottleneck.expansion)
                blocks.append(Bottleneck(in_planes, planes, st, down, dtype,
                                         fused_1x1, block_megakernel))
                in_planes = planes * Bottleneck.expansion
            self.add_module(f"layer{s}", nn.Sequential(*blocks))
        self.feature_dim = in_planes

    def forward(self, x):
        x = conv_bn(x, self.conv1, self.bn1, "relu", self.dtype)
        x = F.max_pool2d(x, 3, 2, 1)
        for s in range(1, 5):
            x = getattr(self, f"layer{s}")(x)
        return x
