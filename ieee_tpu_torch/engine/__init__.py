"""Engine dispatch (counterpart of ``ieee_tpu/engine/__init__.py``).

``loss.name margin`` builds ``Image3MEngine`` (the IEEE run configs) and
``loss.name softmax`` the multi-modal CE engine (the ablation configs) or,
for single-modal data, the single-modal one (the Market-1501 baseline);
the triplet, hcloss/CMT and video engines come later (ROADMAP A.8).
"""

from __future__ import annotations

from .engine import Engine
from .image.margin import Image3MEngine
from .image.softmax import ImageSoftmaxEngine, MultiModalImageSoftmaxEngine

__all__ = ["Engine", "Image3MEngine", "ImageSoftmaxEngine",
           "MultiModalImageSoftmaxEngine", "build_engine"]


def build_engine(cfg, datamanager, model, optimizer=None, scheduler=None,
                 device="cuda") -> Engine:
    """Engine for ``cfg.loss.name`` (reference
    ``scripts/mainMultiModal.py:45-130``)."""
    name = cfg.loss.name
    common = dict(device=device, fused_eval=bool(cfg.cuda.fused_eval),
                  int8_eval=bool(cfg.cuda.int8_eval),
                  seed=cfg.train.seed,
                  accum_steps=int(cfg.train.accum_steps),
                  label_smooth=cfg.loss.softmax.label_smooth)
    if getattr(datamanager, "data_type", "image") == "video":
        raise NotImplementedError(
            "the video engines are not ported yet (ROADMAP A.4, A.8)")
    if name == "softmax":
        cls = (MultiModalImageSoftmaxEngine if datamanager.num_streams > 1
               else ImageSoftmaxEngine)
        return cls(datamanager, model, optimizer, scheduler, **common)
    if name == "margin":
        return Image3MEngine(
            datamanager, model, optimizer, scheduler,
            margin=cfg.loss.ieee_margin, weight_m=cfg.loss.weight_m,
            weight_x=cfg.loss.weight_x,
            weight_m_warmup=int(cfg.loss.weight_m_warmup),
            margin_mean_over_ids=bool(cfg.loss.margin_mean_over_ids),
            **common)
    if name in ("triplet", "hcloss", "CMT"):
        raise NotImplementedError(
            f"the {name!r} engine is not ported yet (ROADMAP A.8)")
    raise ValueError(f"Unsupported loss: {name}")
