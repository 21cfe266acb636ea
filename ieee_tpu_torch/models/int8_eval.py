"""Post-training-quantized (w8a8) inference path for the ResNet trunks.

Counterpart of ``ieee_tpu/models/int8_eval.py``, same scheme and names:
 - eval-mode BatchNorm is folded into each conv (exact);
 - weights: symmetric per-output-channel int8 (absmax / 127), requantized
   from the live f32 parameters at every call;
 - activations: symmetric per-tensor int8 with STATIC per-site scales,
   calibrated once from one representative batch (absmax);
 - each conv site runs the ``conv_s8`` kernel (``ops/kernels/conv_s8.py``:
   int8 gathered and quantized on load, s32 sums on the tensor cores, the
   dequantizing epilogue y = f32(acc) * (sw[c] * sx) + b[c] in bf16); a CPU
   tensor takes its plain version. Residual adds, ReLU and the max pool
   stay bf16 PyTorch ops, in the JAX walker's order.

The walker replays ``ResNetTrunk.forward`` (``models/resnet.py``) over the
trunk's own modules in NHWC (the JAX package's layout, channels_last
memory), so it serves any trained checkpoint. The IEEE head reuses the
folded head with the partpool kernel (``fast_eval.head_from_maps``).
Opt-in via ``cfg.cuda.int8_eval``; re-validate the quantization error per
checkpoint before serving (the CPU tests bound it against the plain
forward).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.conv_s8 import conv_s8, out_hw
from .common import conv2d
from .fast_eval import head_from_maps, supports_fast_eval
from .resnet import ReIDResNet, ResNetTrunk

__all__ = [
    "make_trunk_exec",
    "collect_scales",
    "trunk_forward_ref",
    "trunk_forward_int8",
    "build_int8_ieee_eval_step",
    "build_int8_reid_eval_step",
    "export_forward_int8",
    "supports_int8_eval",
    "quantize_weights",
    "act_scale",
    "trunk_sites",
]

def supports_int8_eval(model) -> bool:
    """The IEEE model with the full head (the folded head is reused) or a
    ``ReIDResNet`` without grouped convs (the walker replays ungrouped
    convs only, so resnext* takes the plain path)."""
    if supports_fast_eval(model):
        return True
    return isinstance(model, ReIDResNet) and all(
        m.groups == 1 for m in model.modules() if isinstance(m, nn.Conv2d))


def _fold(conv: nn.Conv2d, bn):
    """ConvBN eval fold: (weight OIHW * inv[c_out], shift[c_out]) in f32,
    with the JAX fold's rsqrt(var + eps) * scale (``FastBatchNorm.folded``)."""
    inv, shift = bn.folded()
    return conv.weight * inv[:, None, None, None], shift


def make_trunk_exec(block: str, layers, last_stride: int) -> Callable:
    """Returns ``forward(trunk, x, conv)`` replaying ``ResNetTrunk.forward``
    on an NHWC ``x`` through a pluggable ``conv(x, site, conv_module,
    bn_module, stride, padding, relu)`` callback, with the JAX walker's site
    names (``stem``, ``layer1_0/cb1``, ``.../conv2``, ``.../cb3``,
    ``.../cb2``, ``.../downsample``). groups == 1 only."""
    expansion = 4 if block == "bottleneck" else 1
    layers = tuple(layers)

    def forward(trunk, x, conv):
        x = conv(x, "stem", trunk.conv1, trunk.bn1, 2, 3, True)
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        in_planes = 64
        for stage_idx, (p_, n_blocks, s) in enumerate(
                zip((64, 128, 256, 512), layers, (1, 2, 2, last_stride))):
            stage = getattr(trunk, f"layer{stage_idx + 1}")
            for b in range(n_blocks):
                stride = s if b == 0 else 1
                needs_down = b == 0 and (
                    stride != 1 or in_planes != p_ * expansion)
                name = f"layer{stage_idx + 1}_{b}"
                blk = stage[b]
                identity = x
                if block == "bottleneck":
                    out = conv(x, f"{name}/cb1", blk.conv1, blk.bn1, 1, 0,
                               True)
                    out = conv(out, f"{name}/conv2", blk.conv2, blk.bn2,
                               stride, 1, True)
                    out = conv(out, f"{name}/cb3", blk.conv3, blk.bn3, 1, 0,
                               False)
                else:
                    out = conv(x, f"{name}/cb1", blk.conv1, blk.bn1, stride,
                               1, True)
                    out = conv(out, f"{name}/cb2", blk.conv2, blk.bn2, 1, 1,
                               False)
                if needs_down:
                    identity = conv(x, f"{name}/downsample",
                                    blk.downsample[0], blk.downsample[1],
                                    stride, 0, False)
                x = F.relu(out + identity)
            in_planes = p_ * expansion
        return x

    return forward


def trunk_sites(block: str, layers, last_stride: int, batch: int,
                height: int, width: int):
    """Every conv site of a trunk, in the walker's order, as (site, (B, H,
    W, C_in, C_out, K, stride, padding), relu, input dtype): the walker run
    on meta tensors, so nothing is computed or allocated."""
    with torch.device("meta"):
        trunk = ResNetTrunk(tuple(layers), last_stride, block=block)
        x = torch.empty(batch, height, width, 3)
    sites = []

    def conv(x, site, conv_m, bn, stride, padding, relu):
        b, h, w, cin = x.shape
        cout, _, k, _ = conv_m.weight.shape
        sites.append((site, (b, h, w, cin, cout, k, stride, padding), relu,
                      x.dtype))
        ho, wo = out_hw(h, w, k, k, stride, padding)
        return torch.empty(b, ho, wo, cout, dtype=torch.bfloat16,
                           device="meta")

    make_trunk_exec(block, layers, last_stride)(trunk, x, conv)
    return sites


def _trunk_exec(trunk) -> Callable:
    """The walker for a ``ResNetTrunk`` (or ``ReIDResNet``), from its spec."""
    return make_trunk_exec(trunk.block, trunk.layers, trunk.last_stride)


def _conv_bf16(x, conv, bn, stride, padding, relu):
    """The folded conv in bf16 (the JAX package leaves it to XLA): NHWC in
    and out, channels_last memory."""
    w, b = _fold(conv, bn)
    y = conv2d(x.to(torch.bfloat16).permute(0, 3, 1, 2),
               w.to(torch.bfloat16), stride, padding)
    y = y.permute(0, 2, 3, 1) + b.to(torch.bfloat16)
    return F.relu(y) if relu else y


def trunk_forward_ref(exec_, trunk, x):
    """Folded-BN bf16 reference forward: validates the walker against the
    model's own forward and is the calibration-mode compute."""

    def conv(x, site, conv_m, bn, stride, padding, relu):
        return _conv_bf16(x, conv_m, bn, stride, padding, relu)

    return exec_(trunk, x, conv)


def collect_scales(exec_, trunk, x) -> Dict[str, torch.Tensor]:
    """One calibration pass: the absmax of every conv site's input, as 0-d
    f32 tensors on the input's device (read them in one transfer)."""
    amax = {}

    def conv(x, site, conv_m, bn, stride, padding, relu):
        amax[site] = x.float().abs().amax()
        return _conv_bf16(x, conv_m, bn, stride, padding, relu)

    exec_(trunk, x, conv)
    return amax


def _to_floats(amax: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The sites' absmax as Python floats, with one device-to-host copy."""
    vals = torch.stack(list(amax.values())).tolist() if amax else []
    return dict(zip(amax, vals))


def quantize_weights(conv: nn.Conv2d, bn):
    """(wq (C_out, KH, KW, C_in) int8, sw (C_out,) f32, shift (C_out,) f32)
    from the live parameters: sw = max(absmax over (KH, KW, C_in), 1e-8) /
    127, wq = round(w / sw) (half to even), as the JAX site quantizes."""
    w, b = _fold(conv, bn)
    sw = w.abs().amax(dim=(1, 2, 3)).clamp_min(1e-8) / 127.0
    wq = torch.round(w / sw[:, None, None, None]).to(torch.int8)
    return wq.permute(0, 2, 3, 1).contiguous(), sw, b


def act_scale(amax: float):
    """(sx, inv_sx) of a site, in the JAX package's Python-float arithmetic
    (``int8_eval.py:169-170``): sx = max(amax, 1e-6) / 127, inv_sx the f32
    of 1 / sx (a reciprocal, then a multiply: never a divide)."""
    sx = max(amax, 1e-6) / 127.0  # all-zero site guard
    return sx, float(np.float32(1.0 / sx))


def trunk_forward_int8(exec_, trunk, x, scales: Dict[str, float],
                       conv_fn: Callable = conv_s8):
    """w8a8 forward: weights quantized from the live parameters at every
    call, activations quantized per site with the static calibrated
    scales; every conv on ``conv_fn`` (``conv_s8``; its plain version to
    hold the kernel to it on the card)."""

    def conv(x, site, conv_m, bn, stride, padding, relu):
        wq, sw, b = quantize_weights(conv_m, bn)
        sx, inv_sx = act_scale(scales[site])
        # a Python scalar multiplies an f32 tensor as f32(sx), as in JAX
        return conv_fn(x, wq, sw * sx, b, stride, padding, relu, inv_sx)

    return exec_(trunk, x, conv)


def _nhwc(img: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) image -> NHWC (free for the test transform's output,
    which is a permuted view of an NHWC batch)."""
    return img.permute(0, 2, 3, 1).contiguous()


def build_int8_ieee_eval_step(model, transform=None) -> Callable:
    """Engine-shaped int8 eval step for the full IEEE model:
    ``fn(imgs) -> (B, 2304)`` f32, ``imgs`` the (R, N, T) tuple.

    The first call calibrates the per-site activation scales from its own
    batch (one host transfer for the three trunks) and keeps them in
    ``step.holder["scales"]``; later calls reuse them. Weights requantize
    from the live parameters every call; the static activation scales
    assume the serving regime (a trained, stable checkpoint)."""
    execs = [_trunk_exec(t) for t in model.backbone]
    holder: dict = {}

    @torch.inference_mode()
    def step(imgs):
        if transform is not None:
            imgs = tuple(transform(m) for m in imgs)
        xs = [_nhwc(m) for m in imgs]
        if "scales" not in holder:
            amax = [collect_scales(execs[i], model.backbone[i], xs[i])
                    for i in range(3)]
            flat = _to_floats({f"{i}:{k}": v for i, am in enumerate(amax)
                               for k, v in am.items()})
            holder["scales"] = [
                {k: flat[f"{i}:{k}"] for k in amax[i]} for i in range(3)]
        maps = [trunk_forward_int8(execs[i], model.backbone[i], xs[i],
                                   holder["scales"][i]) for i in range(3)]
        return head_from_maps(model, [m.permute(0, 3, 1, 2) for m in maps])

    step.holder = holder  # the calibrated scales, for serving export
    return step


def _folded_fc_chain(model: ReIDResNet, v):
    """Eval-folded ``DenseBNReLU`` neck: the Linear's bias and the BN fold
    into one affine; bf16 compute as the model's own path. Without a neck
    it only rounds ``v`` to bf16 and back, as the JAX chain does."""
    v = v.to(torch.bfloat16)
    for unit in model._fc_units():
        lin, bn = unit[0], unit[1]
        inv, shift = bn.folded()
        k = lin.weight.T * inv[None, :]
        b = lin.bias * inv + shift
        v = F.relu(v @ k.to(torch.bfloat16) + b.to(torch.bfloat16))
    return v.float()


def build_int8_reid_eval_step(model: ReIDResNet, transform=None) -> Callable:
    """Engine-shaped int8 eval step for a ``ReIDResNet``: ``fn(imgs) ->
    (B, D)`` f32; quantized trunk, f32 global average pool, folded-bf16 fc
    neck, matching the model's eval output. Calibrates on its first call."""
    exec_ = _trunk_exec(model)
    holder: dict = {}

    @torch.inference_mode()
    def step(imgs):
        if transform is not None:
            imgs = transform(imgs)
        x = _nhwc(imgs)
        if "scales" not in holder:
            holder["scales"] = _to_floats(collect_scales(exec_, model, x))
        f = trunk_forward_int8(exec_, model, x, holder["scales"])
        v = f.float().mean(dim=(1, 2))
        return _folded_fc_chain(model, v)

    step.holder = holder
    return step


def export_forward_int8(model, transform, calib_imgs) -> Callable:
    """A self-contained ``fwd(*uint8_image_batches) -> features`` with the
    activation scales calibrated on ``calib_imgs`` (a tuple of 3 batches for
    the IEEE model, one batch otherwise) and the weights quantized from the
    model's parameters at each call: the int8 serving analog of the plain
    forward. Serving export through ``torch.export`` waits for ROADMAP
    A.11, which needs ``conv_s8`` registered as a ``torch.library`` op."""
    if supports_fast_eval(model):
        step = build_int8_ieee_eval_step(model, transform=transform)
        step(calib_imgs)  # calibrate

        def fwd(*imgs):
            return step(tuple(imgs))

        return fwd
    step = build_int8_reid_eval_step(model, transform=transform)
    step(calib_imgs)

    def fwd(img):
        return step(img)

    return fwd
