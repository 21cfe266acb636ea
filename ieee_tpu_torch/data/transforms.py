"""Batch image transforms on the device.

Counterpart of ``ieee_tpu/data/transforms.py``: the host only decodes and
collates uint8 batches; the transforms run on the batch's device. Both
functions take a uint8 (B, H, W, 3) tensor and return (B, 3, H, W) f32,
/255 and normalised per channel, as NCHW in channels_last memory (a free
view of the NHWC batch).

The train transform ports ``random_flip`` (horizontal, p = 0.5 per image).
Its draws come from a ``torch.Generator`` the caller passes (the engine
holds one per device, seeded from ``cfg.train.seed``); they are not the
JAX package's ``jax.random`` draws, so tests feed both the same flip mask.
With ``k_tfm`` > 1 it makes K independent draws per image and returns
them as (K, B, 3, H, W) (``ieee_tpu/data/transforms.py:388-397``); the
engine folds them into the batch. The other train transforms of the JAX
package (crop, colour jitter, erase, patch, PCA lighting) are not ported
yet: asking for them raises when the train transform is called (ROADMAP
A.4).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

__all__ = ["build_transforms", "build_test_transform", "random_flip",
           "AVAI_TRANSFORMS"]

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

AVAI_TRANSFORMS = ["random_flip", "random_crop", "color_jitter",
                   "random_erase", "random_patch", "color_aug"]
_PORTED = ("random_flip",)


def _normalizer(norm_mean, norm_std) -> Callable:
    if norm_mean is None or norm_std is None:
        norm_mean, norm_std = _IMAGENET_MEAN, _IMAGENET_STD
    mean = tuple(float(m) for m in norm_mean)
    std = tuple(float(s) for s in norm_std)

    def normalize(x: torch.Tensor) -> torch.Tensor:
        return (x - x.new_tensor(mean)) / x.new_tensor(std)

    return normalize


def random_flip(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) images; ``flip`` (B,) bool: mirror those images left to
    right (the JAX ``_random_flip`` for a given draw)."""
    return torch.where(flip[:, None, None, None], x.flip(2), x)


def build_test_transform(norm_mean=None, norm_std=None) -> Callable:
    """fn(batch uint8 (B, H, W, 3) tensor) -> (B, 3, H, W) f32."""
    normalize = _normalizer(norm_mean, norm_std)

    def test_fn(batch: torch.Tensor) -> torch.Tensor:
        return normalize(batch.float() / 255.0).permute(0, 3, 1, 2)

    return test_fn


def build_transforms(height, width, transforms="random_flip", norm_mean=None,
                     norm_std=None, k_tfm: int = 1,
                     **kwargs) -> Tuple[Callable, Callable]:
    """(train_fn, test_fn) as ``ieee_tpu``'s ``build_transforms``:
    ``train_fn(batch, generator)`` draws its augmentation from
    ``generator`` (on the batch's device), ``k_tfm`` draws of it stacked on
    a leading axis when ``k_tfm`` > 1; ``test_fn(batch)``."""
    del height, width, kwargs
    if transforms is None:
        transforms = []
    if isinstance(transforms, str):
        transforms = [transforms]
    transforms = [t.lower() for t in transforms]
    for t in transforms:
        if t not in AVAI_TRANSFORMS:
            raise ValueError(f"unknown transform {t}; choose from "
                             f"{AVAI_TRANSFORMS}")
    if k_tfm < 1:
        raise ValueError(f"k_tfm must be >= 1, got {k_tfm}")
    missing = [t for t in transforms if t not in _PORTED]
    normalize = _normalizer(norm_mean, norm_std)

    def train_one(x: torch.Tensor, generator: torch.Generator):
        if "random_flip" in transforms:
            flip = torch.rand(x.shape[0], generator=generator,
                              device=x.device) < 0.5
            x = random_flip(x, flip)
        return x

    def train_fn(batch: torch.Tensor, generator: torch.Generator):
        if missing:
            raise NotImplementedError(
                f"train transforms {missing} are not ported yet (ROADMAP "
                f"A.4); ported: {list(_PORTED)}")
        x = batch.float() / 255.0
        if k_tfm == 1:
            return normalize(train_one(x, generator)).permute(0, 3, 1, 2)
        xs = torch.stack([train_one(x, generator) for _ in range(k_tfm)])
        return normalize(xs).permute(0, 1, 4, 2, 3)

    return train_fn, build_test_transform(norm_mean, norm_std)
