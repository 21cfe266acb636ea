"""Weights of the port's models (the IEEE model and ``ReIDResNet``):
random init from a seed, the JAX package's flax variables, torchvision and
reference checkpoints.

The port's ``state_dict`` uses the reference's key layout (the IEEE model:
``ieee_tpu/models/ieee_converter.py:8-15``; ``ReIDResNet``: Torchreid's
``conv1``, ``layer1.0.conv1``, ..., ``fc.0``, ``fc.1``, ``classifier``), so
``load_jax_variables`` is the inverse of ``ieee_tpu``'s
``convert_ieee_torch_checkpoint`` and of its ``convert_torch_zoo`` on a
``ReIDResNet``, and a reference ``.pth.tar`` state dict loads with
``load_state_dict``.
"""

from __future__ import annotations

import math
import os
import os.path as osp
import warnings
from typing import Dict

import numpy as np
import torch
from torch import nn

from .common import FastBatchNorm
from .ieee3modal import ChannelAttention, NonLocalREM
from .resnet import ReIDResNet

__all__ = ["init_weights", "load_jax_variables", "load_reference_checkpoint",
           "load_pretrained_trunks"]

_MODAL = "RNT"


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random init from ``generator``, with the JAX package's initialisers:
    convs kaiming-normal (fan_out, relu), CA and REM dense layers
    lecun-normal, necks and classifiers normal(0, 0.01), zero biases,
    identity BatchNorms, REM gamma 0. Writes every parameter and buffer, so
    it may follow ``to_empty``."""

    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    dense_lecun = set()
    for mod in model.modules():
        if isinstance(mod, ChannelAttention):
            dense_lecun.update(id(m) for m in mod.fc if isinstance(m, nn.Conv2d))
        elif isinstance(mod, NonLocalREM):
            dense_lecun.update(id(m) for m in
                               (mod.conv_query, mod.conv_part, mod.conv_value))
            mod.param.zero_()
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            if id(mod) in dense_lecun:
                normal_(mod.weight, 1.0 / math.sqrt(fan_in))
            elif isinstance(mod, nn.Conv2d):
                fan_out = mod.weight.shape[0] * mod.weight[0, 0].numel()
                normal_(mod.weight, math.sqrt(2.0 / fan_out))
            else:
                normal_(mod.weight, 0.01)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, FastBatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
            mod.num_batches_tracked.zero_()


def _hwio_to_oihw(k):
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def _bn(sd: Dict, dst: str, p: Dict, s: Dict) -> None:
    sd[f"{dst}.weight"] = p["scale"]
    sd[f"{dst}.bias"] = p["bias"]
    sd[f"{dst}.running_mean"] = s["mean"]
    sd[f"{dst}.running_var"] = s["var"]


def _convbn(sd: Dict, dst_conv: str, dst_bn: str, p: Dict, s: Dict) -> None:
    sd[f"{dst_conv}.weight"] = _hwio_to_oihw(p["conv"]["kernel"])
    _bn(sd, dst_bn, p["bn"], s["bn"])


def _trunk_to_state_dict(sd: Dict, pre: str, tp: Dict, ts: Dict) -> None:
    """A flax ``ResNetTrunk``'s (params, batch_stats) into ``sd`` under the
    torchvision keys at ``pre`` (``""`` or ``"backbone.0."``): bottleneck
    blocks (cb1, conv2/bn2, cb3) and basic ones (cb1, cb2)."""
    _convbn(sd, f"{pre}conv1", f"{pre}bn1", tp["stem"], ts["stem"])
    for name in tp:
        if not name.startswith("layer"):
            continue
        stage, b = name[len("layer"):].split("_")
        q = f"{pre}layer{stage}.{b}"
        bp, bs = tp[name], ts[name]
        _convbn(sd, f"{q}.conv1", f"{q}.bn1", bp["cb1"], bs["cb1"])
        if "cb2" in bp:  # BasicBlock
            _convbn(sd, f"{q}.conv2", f"{q}.bn2", bp["cb2"], bs["cb2"])
        else:
            sd[f"{q}.conv2.weight"] = _hwio_to_oihw(bp["conv2"]["kernel"])
            _bn(sd, f"{q}.bn2", bp["bn2"], bs["bn2"])
            _convbn(sd, f"{q}.conv3", f"{q}.bn3", bp["cb3"], bs["cb3"])
        if "downsample" in bp:
            _convbn(sd, f"{q}.downsample.0", f"{q}.downsample.1",
                    bp["downsample"], bs["downsample"])


def _reid_resnet_to_state_dict(params: Dict, stats: Dict) -> Dict:
    """flax (params, batch_stats) of ``ieee_tpu``'s ``ReIDResNet`` -> a
    Torchreid-layout state dict of numpy arrays (``fc`` is the unit itself
    for one ``fc_dims`` entry, ``fc.{i}`` for more)."""
    sd = {}
    _trunk_to_state_dict(sd, "", params["trunk"], stats["trunk"])
    necks = sorted((k for k in params if k.startswith("fc")),
                   key=lambda k: int(k[2:]))
    for i, name in enumerate(necks):
        pre = "fc" if len(necks) == 1 else f"fc.{i}"
        p, s = params[name], stats[name]
        sd[f"{pre}.0.weight"] = np.asarray(p["fc"]["kernel"]).T
        sd[f"{pre}.0.bias"] = p["fc"]["bias"]
        _bn(sd, f"{pre}.1", p["bn"], s["bn"])
    sd["classifier.weight"] = np.asarray(params["classifier"]["kernel"]).T
    sd["classifier.bias"] = params["classifier"]["bias"]
    return sd


def _jax_to_state_dict(params: Dict, stats: Dict, parts: int) -> Dict:
    """flax (params, batch_stats) of ``ieee_tpu``'s IEEE3modalPart -> a
    reference-layout state dict of numpy arrays."""
    sd = {}
    for i, m in enumerate(_MODAL):
        _trunk_to_state_dict(sd, f"backbone.{i}.", params[f"backbone_{m}"],
                             stats[f"backbone_{m}"])

    # the ablation variants (interaction, attention or using_REM off) have
    # no CIM, CA or REM modules in either tree
    for i in range(3):
        for src, dst in ((f"convOne_{i}", f"convOne.{i}.layers"),
                         (f"convAvgRest_{i}", f"convAvgRest.{i}.layers"),
                         (f"reduce_{i}", f"reduce_layer.{i}.layers")):
            if src in params:
                _convbn(sd, f"{dst}.0", f"{dst}.1", params[src], stats[src])
        if f"CA_{i}" in params:
            ca = params[f"CA_{i}"]
            for j, fc in ((0, "fc1"), (2, "fc2")):
                sd[f"CA.{i}.fc.{j}.weight"] = np.asarray(
                    ca[fc]["kernel"]).T[:, :, None, None]
        if f"REM_{i}" in params:
            rem = params[f"REM_{i}"]
            for nm in ("conv_query", "conv_part", "conv_value"):
                sd[f"REM.{i}.{nm}.weight"] = np.asarray(rem[nm]["kernel"]).T
                sd[f"REM.{i}.{nm}.bias"] = rem[nm]["bias"]
            sd[f"REM.{i}.param"] = np.asarray(rem["gamma"]).reshape(1)

    for m in _MODAL:
        fp, fs = params[f"fc_{m}"], stats[f"fc_{m}"]
        f = np.asarray(fp["kernel"]).shape[-1]
        cp = params[f"classifier_{m}"]
        for p in range(parts):
            sl = slice(p * f, (p + 1) * f)
            sd[f"fc_{m}.{p}.0.weight"] = np.asarray(fp["kernel"][p]).T
            sd[f"fc_{m}.{p}.0.bias"] = fp["bias"][p]
            sd[f"fc_{m}.{p}.1.weight"] = fp["bn"]["scale"][sl]
            sd[f"fc_{m}.{p}.1.bias"] = fp["bn"]["bias"][sl]
            sd[f"fc_{m}.{p}.1.running_mean"] = fs["bn"]["mean"][sl]
            sd[f"fc_{m}.{p}.1.running_var"] = fs["bn"]["var"][sl]
            sd[f"classifier_{m}.{p}.weight"] = np.asarray(cp["kernel"][p]).T
            sd[f"classifier_{m}.{p}.bias"] = cp["bias"][p]
    return sd


@torch.no_grad()
def load_jax_variables(model: nn.Module, params: Dict,
                       batch_stats: Dict) -> None:
    """Fill ``model`` (the IEEE model or a ``ReIDResNet``) from the JAX
    package's flax variables of the same model (nested dicts of numpy
    arrays). Every parameter and running statistic must be covered and
    every flax leaf must land somewhere; shapes must match exactly."""
    src = (_reid_resnet_to_state_dict(params, batch_stats)
           if isinstance(model, ReIDResNet)
           else _jax_to_state_dict(params, batch_stats, model.parts))
    own = model.state_dict()
    unknown = sorted(set(src) - set(own))
    missing = sorted(k for k in own
                     if k not in src and not k.endswith("num_batches_tracked"))
    if unknown or missing:
        raise KeyError(f"flax tree does not match the model: unknown "
                       f"{unknown[:5]}, missing {missing[:5]}")
    for k, v in src.items():
        v = torch.from_numpy(np.array(v, np.float32))
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: flax shape {tuple(v.shape)} vs "
                             f"{tuple(own[k].shape)}")
        own[k].copy_(v)


def load_reference_checkpoint(model: nn.Module, path: str) -> None:
    """Load a reference-format torch checkpoint (``model.pth.tar-<epoch>``,
    optional ``state_dict`` wrapper and DataParallel ``module.`` prefix).
    Entries the port does not hold (the trunks' unused fc heads) are
    ignored; any parameter the checkpoint lacks is an error."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in sd.items()}
    result = model.load_state_dict(sd, strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"checkpoint {path} lacks {missing[:5]} "
                       f"({len(missing)} keys)")


def load_pretrained_trunks(model: nn.Module) -> bool:
    """ImageNet init of the model's trunks (the IEEE model's three
    ResNet-50s, a ``ReIDResNet``'s own, by its ``arch``) from a local
    torchvision state dict (``~/.cache/torch/hub/checkpoints/<arch>-*.pth``),
    as the JAX package's ``apply_pretrained``; the torchvision ``fc`` head
    is left out. Returns False, with a warning, when no file is there."""
    if isinstance(model, ReIDResNet):
        arch, trunks = model.arch, [model]
    else:
        arch, trunks = "resnet50", list(model.backbone)
    root = osp.expanduser("~/.cache/torch/hub/checkpoints")
    files = (sorted(f for f in os.listdir(root)
                    if f.startswith(f"{arch}-") and f.endswith(".pth"))
             if osp.isdir(root) else [])
    if not files:
        warnings.warn(f"No local pretrained weights for {arch} "
                      f"(looked in {root}); using random init")
        return False
    sd = torch.load(osp.join(root, files[0]), map_location="cpu",
                    weights_only=True)
    sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    for trunk in trunks:
        result = trunk.load_state_dict(sd, strict=False)
        missing = [k for k in result.missing_keys
                   if not k.startswith(("fc.", "classifier."))
                   and not k.endswith("num_batches_tracked")]
        if missing or result.unexpected_keys:
            raise KeyError(f"{files[0]} does not fit {arch}'s trunk: missing "
                           f"{missing[:5]}, unexpected "
                           f"{result.unexpected_keys[:5]}")
    return True
