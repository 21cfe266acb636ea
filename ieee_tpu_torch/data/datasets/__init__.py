"""Dataset registry (counterpart of ``ieee_tpu/data/datasets/__init__.py``;
reference ``torchreid/data/datasets/__init__.py:13-126``), under the JAX
registry's names. It holds Market-1501 and the multi-modal image datasets
of the fork (RGBNT201, market_to_RGBNT201, AllDay, UAVdata) and the two
synthetic sets; the other image datasets and the video ones are not
ported yet."""

from __future__ import annotations

from .base import Dataset, ImageDataset, MultiModalImageDataset
from .image.allday import AllDay
from .image.market1501 import Market1501
from .image.market_to_rgbnt201 import MarketToRGBNT201
from .image.rgbnt201 import RGBNT201
from .image.synthetic import Synthetic, SyntheticMM
from .image.uav import UAV

__image_datasets = {
    "market1501": Market1501,
    "RGBNT201": RGBNT201,
    "market_to_RGBNT201": MarketToRGBNT201,
    "AllDay": AllDay,
    "UAVdata": UAV,
    "synthetic": Synthetic,
    "synthetic_mm": SyntheticMM,
}


def init_image_dataset(name, **kwargs):
    """Initializes an image dataset (reference ``datasets/__init__.py:41-50``)."""
    avai = list(__image_datasets.keys())
    if name not in __image_datasets:
        raise ValueError(f'Invalid dataset name. Received "{name}", '
                         f"but expected to be one of {avai}")
    return __image_datasets[name](**kwargs)


def register_image_dataset(name, cls):
    """Register a new image dataset (reference ``datasets/__init__.py:63-94``)."""
    curr = list(__image_datasets.keys())
    if name in curr:
        raise ValueError(f"The given name already exists: {name} "
                         f"(choose from {curr})")
    __image_datasets[name] = cls


__all__ = [
    "Dataset",
    "ImageDataset",
    "MultiModalImageDataset",
    "init_image_dataset",
    "register_image_dataset",
]
