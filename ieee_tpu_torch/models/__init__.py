"""Model factory and registry (counterpart of ``ieee_tpu/models/__init__.py``;
reference ``torchreid/models/__init__.py:28-111``).

It registers the single-modal ResNet family (every ``RESNET_SPECS`` name and
``resnet50_fc512``) and the IEEE model; the rest of the zoo comes later
(ROADMAP A.9). ``build_model`` returns the ``nn.Module`` itself, initialised
from a seeded ``torch.Generator`` and placed on ``device``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from .ieee3modal import IEEE3modalPart
from .resnet import RESNET_SPECS, ReIDResNet
from .weights import init_weights, load_pretrained_trunks

__all__ = ["build_model", "IEEE3modalPart", "ReIDResNet", "COMPUTE_DTYPES"]

COMPUTE_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def _reid_resnet(arch: str, last_stride: int = 2, fc_dims=None) -> Callable:
    block, layers, groups, wpg = RESNET_SPECS[arch]

    def factory(num_classes, loss, dtype, **kwargs):
        # kwargs: ReIDResNet's own, over the spec (e.g. ``layers``,
        # ``dropout_p``)
        kwargs = {"block": block, "layers": layers, "groups": groups,
                  "width_per_group": wpg, "last_stride": last_stride,
                  "fc_dims": fc_dims, **kwargs}
        model = ReIDResNet(num_classes=num_classes, loss=loss, dtype=dtype,
                           **kwargs)
        model.arch = arch
        return model

    return factory


__model_factory: Dict[str, Callable] = {
    arch: _reid_resnet(arch) for arch in RESNET_SPECS}
__model_factory["resnet50_fc512"] = _reid_resnet("resnet50", last_stride=1,
                                                 fc_dims=[512])
__model_factory["ieee3modalPart"] = IEEE3modalPart


def build_model(name: str, num_classes: int, loss: str = "softmax",
                pretrained: bool = True, dtype="bfloat16", device="cuda",
                seed: int = 0, **kwargs) -> nn.Module:
    """Build ``name`` from the registry in eval mode. ``dtype`` is the
    conv/matmul compute dtype (a name or a torch dtype); parameters stay
    float32. Other kwargs go to the model (``ieee3modalPart``: ``parts``,
    ``interaction``, ``attention``, ``using_REM``, ``backbone_layers``,
    ``fused_1x1``, ``block_megakernel``; the ResNets: ``layers``,
    ``dropout_p``, ...). ``pretrained`` loads ImageNet trunk weights where
    a local file has them (``load_pretrained_trunks``). ``device`` defaults
    to the card, as every other entry point of the port; CPU callers pass
    "cpu"."""
    if name not in __model_factory:
        raise KeyError(f"Unknown model: {name}. Must be one of "
                       f"{sorted(__model_factory)}")
    if isinstance(dtype, str):
        if dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute dtype {dtype!r}; choose from "
                             f"{sorted(COMPUTE_DTYPES)}")
        dtype = COMPUTE_DTYPES[dtype]
    # built without storage, then every parameter and buffer is written by
    # init_weights (no second, discarded default init)
    with torch.device("meta"):
        model = __model_factory[name](num_classes=num_classes, loss=loss,
                                      dtype=dtype, **kwargs)
    model = model.to_empty(device="cpu")
    init_weights(model, torch.Generator().manual_seed(int(seed)))
    if pretrained:
        load_pretrained_trunks(model)
    return model.to(device=device, memory_format=torch.channels_last).eval()
