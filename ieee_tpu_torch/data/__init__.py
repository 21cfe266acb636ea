from .datamanager import ImageDataManager
from .datasets import (
    Dataset,
    MultiModalImageDataset,
    init_image_dataset,
    register_image_dataset,
)
from .loader import DataLoader
from .sampler import RandomIdentitySampler, build_train_sampler
from .transforms import build_test_transform, build_transforms

__all__ = [
    "ImageDataManager",
    "Dataset",
    "MultiModalImageDataset",
    "init_image_dataset",
    "register_image_dataset",
    "DataLoader",
    "RandomIdentitySampler",
    "build_train_sampler",
    "build_test_transform",
    "build_transforms",
]
