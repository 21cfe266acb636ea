"""Model factory (counterpart of ``ieee_tpu/models/__init__.py``).

This slice registers the IEEE model only; the rest of the zoo comes later.
``build_model`` returns the ``nn.Module`` itself, initialised from a seeded
``torch.Generator`` and placed on ``device``.
"""

from __future__ import annotations

import torch

from .ieee3modal import IEEE3modalPart
from .weights import init_weights, load_pretrained_trunks

__all__ = ["build_model", "IEEE3modalPart", "COMPUTE_DTYPES"]

COMPUTE_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


def build_model(name: str, num_classes: int, loss: str = "softmax",
                pretrained: bool = True, dtype="bfloat16", device="cuda",
                seed: int = 0, **kwargs) -> IEEE3modalPart:
    """Build ``name`` (only ``ieee3modalPart`` in this slice) in eval mode.
    ``dtype`` is the conv/matmul compute dtype (a name or a torch dtype);
    parameters stay float32. Other kwargs go to the model (``parts``,
    ``interaction``, ``attention``, ``using_REM``, ``backbone_layers``,
    ``fused_1x1``, ``block_megakernel``). ``device`` defaults to the card,
    as every other entry point of the port; CPU callers pass "cpu"."""
    if name != "ieee3modalPart":
        raise KeyError(f"Unknown model: {name}; this port registers only "
                       "ieee3modalPart so far")
    if isinstance(dtype, str):
        if dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute dtype {dtype!r}; choose from "
                             f"{sorted(COMPUTE_DTYPES)}")
        dtype = COMPUTE_DTYPES[dtype]
    # built without storage, then every parameter and buffer is written by
    # init_weights (no second, discarded default init)
    with torch.device("meta"):
        model = IEEE3modalPart(num_classes=num_classes, loss=loss,
                               dtype=dtype, **kwargs)
    model = model.to_empty(device="cpu")
    init_weights(model, torch.Generator().manual_seed(int(seed)))
    if pretrained:
        load_pretrained_trunks(model)
    return model.to(device=device, memory_format=torch.channels_last).eval()
