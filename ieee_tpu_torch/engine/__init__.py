"""Engine dispatch (counterpart of ``ieee_tpu/engine/__init__.py``).

This slice builds ``Image3MEngine`` for ``loss.name margin`` (the IEEE run
config), for training and evaluation; the other engines come later
(ROADMAP A.11, A.12).
"""

from __future__ import annotations

from .engine import Engine
from .image.margin import Image3MEngine

__all__ = ["Engine", "Image3MEngine", "build_engine"]


def build_engine(cfg, datamanager, model, optimizer=None, scheduler=None,
                 device="cuda") -> Engine:
    """Engine for ``cfg.loss.name`` (reference
    ``scripts/mainMultiModal.py:45-130``)."""
    name = cfg.loss.name
    if name != "margin":
        raise NotImplementedError(
            f"the {name!r} engine is not ported yet (only margin)")
    return Image3MEngine(
        datamanager, model, optimizer, scheduler, device=device,
        fused_eval=bool(cfg.cuda.fused_eval), seed=cfg.train.seed,
        accum_steps=int(cfg.train.accum_steps), margin=cfg.loss.ieee_margin,
        weight_m=cfg.loss.weight_m, weight_x=cfg.loss.weight_x,
        weight_m_warmup=int(cfg.loss.weight_m_warmup),
        margin_mean_over_ids=bool(cfg.loss.margin_mean_over_ids),
        label_smooth=cfg.loss.softmax.label_smooth)
