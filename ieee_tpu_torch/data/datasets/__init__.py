"""Dataset registry (counterpart of ``ieee_tpu/data/datasets/__init__.py``;
reference ``torchreid/data/datasets/__init__.py:13-126``). This slice holds
the two multi-modal image datasets of the IEEE retrieval path."""

from __future__ import annotations

from .base import Dataset, MultiModalImageDataset
from .image.rgbnt201 import RGBNT201
from .image.synthetic import SyntheticMM

__image_datasets = {
    "RGBNT201": RGBNT201,
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
    "MultiModalImageDataset",
    "init_image_dataset",
    "register_image_dataset",
]
