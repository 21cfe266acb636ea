"""Image3MEngine: the full-IEEE training engine, loss = 3M margin + CE.

Counterpart of ``ieee_tpu/engine/image/margin.py`` (reference
``torchreid/engine/image/margin.py:9-154``):
``loss = weight_m * 3M(f_R, f_N, f_T) + weight_x * (CE_R + CE_N + CE_T)``,
with the per-part CE summed over the parts. Metrics: LossM, LossX,
lossR/N/T, accR/N/T (and ``loss`` from the engine).
"""

from __future__ import annotations

from ...losses import multi_modal_margin_loss
from ..engine import Engine, _traced_accuracy
from .softmax import _deep_ce


class Image3MEngine(Engine):
    """``weight_m_warmup`` ramps weight_m linearly from 0 over the first
    epochs and ``margin_mean_over_ids`` averages the 3M term over ids, both
    as in the JAX package."""

    def __init__(self, datamanager, model, optimizer=None, scheduler=None,
                 use_gpu=True, label_smooth=True, margin=3.0, weight_m=1.0,
                 weight_x=1.0, weight_m_warmup=0,
                 margin_mean_over_ids=False, **kwargs):
        del use_gpu  # the engine's device decides
        super().__init__(datamanager, model, optimizer, scheduler, **kwargs)
        self.label_smooth = label_smooth
        self.margin = float(margin)
        self.weight_m = weight_m
        self.weight_x = weight_x
        self.margin_mean_over_ids = bool(margin_mean_over_ids)
        self.weight_m_warmup = int(weight_m_warmup)
        self.num_classes = datamanager.num_train_pids
        # (P, K) contract of the RandomIdentitySampler
        self.num_instances = (getattr(datamanager, "num_instances", 4)
                              * getattr(datamanager, "k_tfm", 1))

    def loss_hparams(self, epoch):
        if self.weight_m_warmup > 0 and self.weight_m > 0:
            # epoch is 0-based: epoch 0 trains pure CE
            ramp = min(1.0, epoch / self.weight_m_warmup)
            return {"weight_m": self.weight_m * ramp}
        return None

    def compute_loss(self, out, pids, hp=None):
        loss = 0.0
        metrics = {}
        if self.weight_m > 0:
            loss_m = multi_modal_margin_loss(
                out["feat_R"], out["feat_N"], out["feat_T"],
                num_instances=self.num_instances, margin=self.margin,
                mean_over_ids=self.margin_mean_over_ids)
            wm = hp["weight_m"] if hp and "weight_m" in hp else self.weight_m
            loss = loss + wm * loss_m
            metrics["LossM"] = loss_m
        if self.weight_x > 0:
            loss_r, loss_n, loss_t = (
                _deep_ce(out[f"logits_{m}"], pids, self.num_classes,
                         self.label_smooth) for m in "RNT")
            loss_x = loss_r + loss_n + loss_t
            loss = loss + self.weight_x * loss_x
            metrics.update(
                LossX=loss_x, lossR=loss_r, lossN=loss_n, lossT=loss_t,
                accR=_traced_accuracy(out["logits_R"], pids),
                accN=_traced_accuracy(out["logits_N"], pids),
                accT=_traced_accuracy(out["logits_T"], pids))
        return loss, metrics
