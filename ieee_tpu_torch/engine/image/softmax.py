"""Softmax (cross-entropy) engines (counterpart of
``ieee_tpu/engine/image/softmax.py``; reference
``torchreid/engine/image/softmax.py``).

- ``MultiModalImageSoftmaxEngine``: CE_R + CE_N + CE_T over the per-part
  logits (reference ``softmax.py:81-130``); metrics loss_R/N/T and
  acc_R/N/T. It trains the ablation configs ``rgbnt_base_softmax.yaml``
  and ``rgbnt_cim_softmax.yaml``.
- ``ImageSoftmaxEngine``: the single-modal CE engine (reference
  ``softmax.py:137-228``); ``build_engine`` builds it once a single-modal
  model is ported (ROADMAP A.5).
- ``_deep_ce``: the part-summed CE, which the 3M engine uses too.
"""

from __future__ import annotations

from ...losses import cross_entropy_loss
from ..engine import Engine, _traced_accuracy

__all__ = ["ImageSoftmaxEngine", "MultiModalImageSoftmaxEngine"]


def _deep_ce(logits, pids, num_classes, label_smooth):
    """DeepSupervision CE over the part axis: (B, P, C) -> sum_p CE, which
    is P times the mean CE over the B*P rows."""
    if logits.ndim == 3:
        p = logits.shape[1]
        flat = logits.reshape(-1, logits.shape[-1])
        rep_pids = pids[:, None].expand(-1, p).reshape(-1)
        return p * cross_entropy_loss(flat, rep_pids, num_classes,
                                      label_smooth=label_smooth)
    return cross_entropy_loss(logits, pids, num_classes,
                              label_smooth=label_smooth)


class ImageSoftmaxEngine(Engine):
    """Single-modal CE engine: the model's logits (or the first of its
    outputs), metric ``acc``."""

    def __init__(self, datamanager, model, optimizer=None, scheduler=None,
                 use_gpu=True, label_smooth=True, **kwargs):
        del use_gpu  # the engine's device decides
        super().__init__(datamanager, model, optimizer, scheduler, **kwargs)
        self.label_smooth = label_smooth
        self.num_classes = datamanager.num_train_pids

    def compute_loss(self, out, pids, hp=None):
        logits = out[0] if isinstance(out, (tuple, list)) else out
        loss = _deep_ce(logits, pids, self.num_classes, self.label_smooth)
        return loss, {"acc": _traced_accuracy(logits, pids)}


class MultiModalImageSoftmaxEngine(Engine):
    """3-modality CE engine: loss = CE_R + CE_N + CE_T over the per-part
    logits."""

    def __init__(self, datamanager, model, optimizer=None, scheduler=None,
                 use_gpu=True, label_smooth=True, **kwargs):
        del use_gpu  # the engine's device decides
        super().__init__(datamanager, model, optimizer, scheduler, **kwargs)
        self.label_smooth = label_smooth
        self.num_classes = datamanager.num_train_pids

    def compute_loss(self, out, pids, hp=None):
        metrics = {}
        loss = 0.0
        for m in "RNT":
            logits = out[f"logits_{m}"]
            loss_m = _deep_ce(logits, pids, self.num_classes,
                              self.label_smooth)
            loss = loss + loss_m
            metrics[f"loss_{m}"] = loss_m
            metrics[f"acc_{m}"] = _traced_accuracy(logits, pids)
        return loss, metrics
