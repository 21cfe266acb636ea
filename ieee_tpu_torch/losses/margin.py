"""3M loss: the multi-modal margin loss (counterpart of
``ieee_tpu/losses/margin.py``; reference
``torchreid/losses/multi_modal_margin_loss_new.py:19-40``).

Per identity in the batch, each modality's feature center, then the pairwise
center MSE (sum reduction) across the three modalities; the loss pushes each
pair's distance toward the margin:

    loss = sum_id max_{(i,j) in pairs} | margin - MSE(center_i, center_j) |

The batch is read as (P, K, D) with P = batch // num_instances: the
RandomIdentitySampler's K consecutive instances per pid are a contract, as
in the JAX package.
"""

from __future__ import annotations

import torch

__all__ = ["multi_modal_margin_loss"]


def _pair_mse_sum(c1, c2):
    """nn.MSELoss(reduction='sum') between two center matrices: (P,)."""
    d = c1 - c2
    return (d * d).sum(-1)


def multi_modal_margin_loss(feat1, feat2, feat3, num_instances, margin=3.0,
                            mean_over_ids=False):
    """feat1/2/3: (B, D) per-modality features (R, N, T), B = P *
    num_instances in the sampler's K-consecutive-per-pid layout.
    ``mean_over_ids`` averages the per-id terms instead of summing them (the
    JAX package's batch-size-invariant variant)."""
    b, d = feat1.shape
    if b % num_instances != 0:
        raise ValueError(f"batch {b} not divisible by num_instances "
                         f"{num_instances}")
    p = b // num_instances
    centers = [f.reshape(p, num_instances, d).mean(1)
               for f in (feat1, feat2, feat3)]
    d12 = (margin - _pair_mse_sum(centers[0], centers[1])).abs()
    d23 = (margin - _pair_mse_sum(centers[1], centers[2])).abs()
    d13 = (margin - _pair_mse_sum(centers[0], centers[2])).abs()
    per_id = torch.maximum(torch.maximum(d12, d23), d13)  # (P,)
    return per_id.mean() if mean_over_ids else per_id.sum()
