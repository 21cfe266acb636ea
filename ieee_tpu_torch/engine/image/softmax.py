"""Softmax (cross-entropy) pieces of the image engines (counterpart of
``ieee_tpu/engine/image/softmax.py``). This slice ports ``_deep_ce``, which
the 3M engine uses; the softmax engines come later (ROADMAP A.11, A.12).
"""

from __future__ import annotations

from ...losses import cross_entropy_loss


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
