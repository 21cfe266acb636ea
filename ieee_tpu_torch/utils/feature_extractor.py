"""FeatureExtractor: a model with its test transform, for inference.

Counterpart of ``ieee_tpu/utils/feature_extractor.py`` (reference
``torchreid/utils/feature_extractor.py:13-152``): image paths, HWC uint8
arrays or a pre-batched (B, H, W, 3) array in, (B, D) f32 features on the
device out. The model runs on ``device`` (the card unless the caller asks
for the CPU).
"""

from __future__ import annotations

from typing import List, Union

import numpy as np
import torch

from ..data.transforms import build_transforms
from ..models import build_model
from .checkpoint import load_pretrained_weights
from .tools import read_image

__all__ = ["FeatureExtractor"]


class FeatureExtractor:
    def __init__(
        self,
        model_name: str = "resnet50",
        model_path: str = "",
        image_size=(256, 128),
        pixel_mean=(0.485, 0.456, 0.406),
        pixel_std=(0.229, 0.224, 0.225),
        pixel_norm: bool = True,
        num_classes: int = 1,
        pretrained: bool = True,
        seed: int = 0,
        verbose: bool = False,
        int8: bool = False,
        device="cuda",
    ):
        """``int8=True`` serves through the w8a8 path
        (``models/int8_eval.py``, the ``conv_s8`` kernel on the card):
        activation scales calibrate on the first batch; single-stream
        ``ReIDResNet`` models only (others warn and take the plain
        forward). ``pretrained`` loads ImageNet trunk weights where a local
        file has them, else warns and keeps the seeded init."""
        self.device = torch.device(device)
        model = build_model(model_name, num_classes=num_classes,
                            loss="softmax", pretrained=pretrained,
                            device=self.device, seed=seed)
        if model_path:
            load_pretrained_weights(model, model_path)

        if pixel_norm:
            _, test_fn = build_transforms(
                image_size[0], image_size[1], transforms=None,
                norm_mean=pixel_mean, norm_std=pixel_std, verbose=verbose)
        else:
            def test_fn(b):
                return (b.float() / 255.0).permute(0, 3, 1, 2)

        forward = None
        if int8:
            from ..models.fast_eval import supports_fast_eval
            from ..models.int8_eval import (
                build_int8_reid_eval_step,
                supports_int8_eval,
            )

            # single-stream extractor: the ReIDResNet variant only (the
            # 3-modal IEEE model takes an (R, N, T) tuple, not one batch)
            if supports_int8_eval(model) and not supports_fast_eval(model):
                forward = build_int8_reid_eval_step(model, transform=test_fn)
            else:
                print("WARN: int8=True unsupported for "
                      f"{model_name}; using the plain forward")
        if forward is None:
            @torch.inference_mode()
            def forward(batch_uint8):
                return model(test_fn(batch_uint8))

        self.model = model
        self.image_size = image_size
        self._forward = forward

    def _load(self, item) -> np.ndarray:
        from PIL import Image

        if isinstance(item, str):
            img = read_image(item)
        elif isinstance(item, np.ndarray):
            img = item.astype(np.uint8)
        else:
            raise TypeError(f"Unsupported input type: {type(item)}")
        if img.shape[:2] != tuple(self.image_size):
            img = np.asarray(
                Image.fromarray(img).resize(
                    (self.image_size[1], self.image_size[0]), Image.BILINEAR))
        return img

    def __call__(self, inputs: Union[str, np.ndarray, List]) -> torch.Tensor:
        if isinstance(inputs, (str, np.ndarray)) and not (
                isinstance(inputs, np.ndarray) and inputs.ndim == 4):
            inputs = [inputs]
        if isinstance(inputs, np.ndarray) and inputs.ndim == 4:
            batch = inputs.astype(np.uint8)
        else:
            batch = np.stack([self._load(i) for i in inputs])
        return self._forward(torch.from_numpy(batch).to(self.device))
