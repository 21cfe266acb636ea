"""Batch image transforms on the device.

Counterpart of ``ieee_tpu/data/transforms.py``. This slice ports the test
transform (``transforms.py:398-400``): uint8 (B, H, W, 3) -> /255 ->
per-channel normalise, in f32 on the batch's device, returned as NCHW in
channels_last memory (a free view of the NHWC batch). The train transforms
(flip, crop, patch, colour, erase) come with the training slice.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["build_transforms", "build_test_transform"]

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def build_test_transform(norm_mean=None, norm_std=None) -> Callable:
    """fn(batch uint8 (B, H, W, 3) tensor) -> (B, 3, H, W) f32."""
    if norm_mean is None or norm_std is None:
        norm_mean, norm_std = _IMAGENET_MEAN, _IMAGENET_STD
    mean = tuple(float(m) for m in norm_mean)
    std = tuple(float(s) for s in norm_std)

    def test_fn(batch: torch.Tensor) -> torch.Tensor:
        x = batch.float() / 255.0
        x = (x - x.new_tensor(mean)) / x.new_tensor(std)
        return x.permute(0, 3, 1, 2)

    return test_fn


def build_transforms(height, width, transforms=None, norm_mean=None,
                     norm_std=None, **kwargs) -> Tuple[None, Callable]:
    """(train_fn, test_fn) as ``ieee_tpu``'s ``build_transforms``; the train
    transform is not ported yet, so train_fn is None."""
    del height, width, transforms, kwargs
    return None, build_test_transform(norm_mean, norm_std)
