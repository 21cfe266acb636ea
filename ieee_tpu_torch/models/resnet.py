"""ResNet family: the trunk of the IEEE model and the single-modal
``ReIDResNet``.

Counterpart of ``ieee_tpu/models/resnet.py`` (``RESNET_SPECS``,
``BasicBlock``, ``Bottleneck``, ``ResNetTrunk``, ``ReIDResNet``): conv1..
layer4 returning the final map, with ``last_stride`` 1 keeping a 16x8 map
at 256x128 input. Keys are torchvision's (``conv1``, ``bn1``,
``layer{s}.{b}.conv{1,2[,3]}``, ``bn{1,2[,3]}``, ``downsample.{0,1}``);
``ReIDResNet`` adds Torchreid's ``fc.{0,1}`` neck and ``classifier``.

With ``fused_1x1`` each 1x1 conv+BN site that passes ``fuse_worthwhile``
runs through the fused matmul kernels (mm_affine in eval, mm_bn_act_train in
training: layer4's cb1, cb3 and downsample at full width); the cb3 +
residual contract and the strided-downsample subsample follow the JAX
package (``resnet.py:176-189``). With ``block_megakernel`` a training
forward of each stride-1 block without downsample that passes
``megakernel_ok`` runs as ``bottleneck_train`` (the whole-block backward
kernels, ``ops/kernels/block_bwd.py``), which takes precedence over
``fused_1x1`` as in the JAX package (``resnet.py:140-143``); eval keeps the
plain block. Both kernel paths are the IEEE model's only: the JAX package
passes neither flag to ``ReIDResNet`` (``ieee_tpu/models/__init__.py:80``),
so its blocks take the plain path, and so do the port's.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.block_bwd import bottleneck_train
from .common import (
    DenseBNReLU,
    FastBatchNorm,
    conv_bn,
    fuse_worthwhile,
    fused_conv_bn_1x1,
    global_avg_pool,
)

__all__ = ["RESNET_SPECS", "BasicBlock", "Bottleneck", "ResNetTrunk",
           "ReIDResNet", "megakernel_ok"]

RESNET_SPECS = {
    # name: (block, layers, groups, width_per_group)
    "resnet18": ("basic", (2, 2, 2, 2), 1, 64),
    "resnet34": ("basic", (3, 4, 6, 3), 1, 64),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 1, 64),
    "resnet101": ("bottleneck", (3, 4, 23, 3), 1, 64),
    "resnet152": ("bottleneck", (3, 8, 36, 3), 1, 64),
    "resnext50_32x4d": ("bottleneck", (3, 4, 6, 3), 32, 4),
    "resnext101_32x8d": ("bottleneck", (3, 4, 23, 3), 32, 8),
}


def megakernel_ok(width: int) -> bool:
    """Width gate of the whole-block path: the widths the JAX package's
    ``megakernel_vmem_ok`` admits (width <= 256: layer1-3 of a ResNet-50,
    10 blocks per trunk), so both packages take the block path on the same
    blocks. That gate is a TPU VMEM limit; the CUDA kernels have none (they
    are checked at width 512 on the card), and widening it to layer4 waits
    for measured times (ROADMAP B.4)."""
    return width <= 256


def _conv(cin, cout, k, stride=1, padding=0, groups=1):
    return nn.Conv2d(cin, cout, k, stride, padding, bias=False, groups=groups)


def _downsample(cin, cout, stride, dtype):
    return nn.Sequential(_conv(cin, cout, 1, stride),
                         FastBatchNorm(cout, dtype=dtype))


class BasicBlock(nn.Module):
    """Two 3x3 conv+BN and the residual (resnet18/34). As the JAX
    ``BasicBlock``, it takes ``groups`` and ``base_width`` for a common
    signature and ignores them."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.bfloat16,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv(in_planes, planes, 3, stride, 1)
        self.bn1 = FastBatchNorm(planes, dtype=dtype)
        self.conv2 = _conv(planes, planes, 3, 1, 1)
        self.bn2 = FastBatchNorm(planes, dtype=dtype)
        self.downsample = (_downsample(in_planes, planes, stride, dtype)
                           if downsample else None)

    def forward(self, x):
        dt = self.dtype
        out = conv_bn(x, self.conv1, self.bn1, "relu", dt)
        out = conv_bn(out, self.conv2, self.bn2, None, dt)
        identity = x
        if self.downsample is not None:
            identity = conv_bn(x, self.downsample[0], self.downsample[1],
                               None, dt)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1, 3x3 (``groups`` groups) and 1x1 conv+BN and the residual; the
    3x3's width is ``int(planes * base_width / 64) * groups`` (resnext).
    The fused 1x1 and whole-block paths take only ungrouped blocks, as in
    the JAX ``Bottleneck``: a grouped block given either flag raises."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.bfloat16,
                 fused_1x1: bool = False, block_megakernel: bool = False,
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        if groups != 1 and (fused_1x1 or block_megakernel):
            raise ValueError("fused_1x1 and block_megakernel take ungrouped "
                             f"blocks only, got groups={groups}")
        width = int(planes * (base_width / 64.0)) * groups
        c_out = planes * self.expansion
        self.dtype = dtype
        self.stride = stride
        self.conv1 = _conv(in_planes, width, 1)
        self.bn1 = FastBatchNorm(width, dtype=dtype)
        self.conv2 = _conv(width, width, 3, stride, 1, groups)
        self.bn2 = FastBatchNorm(width, dtype=dtype)
        self.conv3 = _conv(width, c_out, 1)
        self.bn3 = FastBatchNorm(c_out, dtype=dtype)
        self.downsample = (_downsample(in_planes, c_out, stride, dtype)
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


_BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


class ResNetTrunk(nn.Module):
    """Stem + layer1..layer4 of a ResNet of ``block`` ("bottleneck" or
    "basic") blocks; returns the final map (N, 512 * expansion, H/16, W/16)
    at ``last_stride`` 1. ``fused_1x1`` and ``block_megakernel`` reach
    bottleneck blocks only, as in the JAX ``ResNetTrunk``."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 last_stride: int = 2, dtype=torch.bfloat16,
                 fused_1x1: bool = False, block_megakernel: bool = False,
                 block: str = "bottleneck", groups: int = 1,
                 width_per_group: int = 64):
        super().__init__()
        block_cls = _BLOCKS[block]
        extra = (dict(fused_1x1=fused_1x1, block_megakernel=block_megakernel)
                 if block == "bottleneck" else {})
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
                                   or in_planes != planes * block_cls.expansion)
                blocks.append(block_cls(in_planes, planes, st, down, dtype,
                                        groups=groups,
                                        base_width=width_per_group, **extra))
                in_planes = planes * block_cls.expansion
            self.add_module(f"layer{s}", nn.Sequential(*blocks))
        self.feature_dim = in_planes

    def forward(self, x):
        x = conv_bn(x, self.conv1, self.bn1, "relu", self.dtype)
        x = F.max_pool2d(x, 3, 2, 1)
        for s in range(1, 5):
            x = getattr(self, f"layer{s}")(x)
        return x


class ReIDResNet(ResNetTrunk):
    """The classic single-modal re-ID model (JAX ``ReIDResNet``; reference
    ``torchreid/models/resnet.py:187-399``): the trunk, global average
    pooling, the optional ``fc_dims`` neck of ``DenseBNReLU`` units and a
    classifier. Input: (B, 3, H, W) f32 images. Eval returns the pooled
    (or neck) feature in f32; training returns the logits for ``softmax``
    and ``(logits, feature)`` for ``triplet``. ``return_featuremaps``
    returns the trunk's final map.

    The trunk's modules sit at the top level, so ``state_dict()`` has
    Torchreid's keys (``conv1``, ``layer1.0.conv1``, ..., ``fc.0``,
    ``fc.1``, ``classifier``). With more than one ``fc_dims`` entry ``fc``
    holds one unit per entry (``fc.{i}.0``, ...), where Torchreid flattens
    them into one Sequential. ``dropout_p`` draws its masks from
    ``dropout_generator``: the engine sets it to its own generator, seeded
    with the run's seed, as the JAX engine draws dropout from its seeded
    key; left at None, torch's default generator is used."""

    def __init__(self, num_classes: int = 1000, loss: str = "softmax",
                 block: str = "bottleneck",
                 layers: Sequence[int] = (3, 4, 6, 3), groups: int = 1,
                 width_per_group: int = 64, last_stride: int = 2,
                 fc_dims=None, dropout_p=None, dtype=torch.bfloat16):
        super().__init__(tuple(layers), last_stride, dtype, block=block,
                         groups=groups, width_per_group=width_per_group)
        if loss not in ("softmax", "triplet"):
            raise KeyError(f"Unsupported loss: {loss}")
        self.num_classes = num_classes
        self.loss = loss
        self.num_streams = 1
        dim = self.feature_dim
        units = []
        for f in fc_dims or ():
            units.append(DenseBNReLU(dim, f, dtype, dropout_p))
            dim = f
        self.fc = (None if not units
                   else units[0] if len(units) == 1 else nn.Sequential(*units))
        self.feature_dim = dim
        self.classifier = nn.Linear(dim, num_classes)
        self.dropout_generator = None

    def named_units(self):
        """(name, module) under the JAX package's top-level names, which
        ``train.open_layers`` matches: ``trunk`` (stem and layer1-4),
        ``fc0``.. and ``classifier``."""
        yield "trunk", nn.ModuleList(
            [self.conv1, self.bn1] + [getattr(self, f"layer{s}")
                                      for s in range(1, 5)])
        for i, unit in enumerate(self._fc_units()):
            yield f"fc{i}", unit
        yield "classifier", self.classifier

    def _fc_units(self):
        if self.fc is None:
            return []
        return [self.fc] if isinstance(self.fc, DenseBNReLU) else list(self.fc)

    def forward(self, x, return_featuremaps: bool = False):
        f = super().forward(x)
        if return_featuremaps:
            return f
        v = global_avg_pool(f).float()
        units = self._fc_units()
        if units:
            for unit in units:
                v = unit(v, self.dropout_generator)
            v = v.float()
        if not self.training:
            return v
        y = self.classifier(v)
        return y if self.loss == "softmax" else (y, v)
