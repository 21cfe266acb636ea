"""Label-smoothed cross entropy (counterpart of
``ieee_tpu/losses/cross_entropy.py``; reference
``torchreid/losses/cross_entropy_loss.py:29-50``): smoothed one-hot targets,
``(-targets * log_probs).mean(0).sum()``, built on the logits' device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["cross_entropy_loss"]


def cross_entropy_loss(logits, targets, num_classes=None, eps=0.1,
                       label_smooth=True):
    """logits (B, C) pre-softmax scores; targets (B,) int labels."""
    if num_classes is None:
        num_classes = logits.shape[-1]
    e = eps if label_smooth else 0.0
    log_probs = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(targets.long(), num_classes).to(log_probs.dtype)
    smoothed = (1.0 - e) * onehot + e / num_classes
    return (-smoothed * log_probs).mean(0).sum()
