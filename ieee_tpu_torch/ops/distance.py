"""Query-gallery distance matrices on the tensors' device.

Counterpart of ``ieee_tpu/ops/distance.py``. The squared-euclidean distance
goes through the distmat kernel on a CUDA tensor (``ops/kernels/distmat.py``)
for every shape; cosine distance stays plain PyTorch, as in the JAX package
(no Pallas kernel there).
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels.distmat import euclidean_sq

__all__ = ["compute_distance_matrix", "euclidean_squared_distance",
           "cosine_distance"]


def _as_tensor(x, device=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    if device is not None:
        t = t.to(device)
    return t.float()


def compute_distance_matrix(input1, input2, metric: str = "euclidean",
                            device=None) -> torch.Tensor:
    """(m, k), (n, k) features -> (m, n) f32 distances on ``device`` (default:
    where ``input1`` lies). Accepts tensors or numpy arrays."""
    input1 = _as_tensor(input1, device)
    input2 = _as_tensor(input2, input1.device)
    if input1.ndim != 2 or input2.ndim != 2:
        raise ValueError(
            f"Expected 2-D inputs, got {input1.ndim}-D and {input2.ndim}-D")
    if input1.shape[1] != input2.shape[1]:
        raise ValueError(
            f"Feature dims differ: {input1.shape[1]} vs {input2.shape[1]}")
    if metric == "euclidean":
        return euclidean_squared_distance(input1, input2)
    if metric == "cosine":
        return cosine_distance(input1, input2)
    raise ValueError(
        f'Unknown distance metric: {metric}; use "euclidean" or "cosine"')


def euclidean_squared_distance(input1: torch.Tensor,
                               input2: torch.Tensor) -> torch.Tensor:
    """|a|^2 + |b|^2 - 2 a.b, not rooted (reference
    ``metrics/distance.py:49-64``); full f32, the ranking is sensitive to it."""
    return euclidean_sq(input1.float(), input2.float())


def cosine_distance(input1: torch.Tensor, input2: torch.Tensor) -> torch.Tensor:
    """1 - cosine similarity (reference ``metrics/distance.py:67-80``)."""
    a = input1 / input1.norm(dim=1, keepdim=True).clamp_min(1e-12)
    b = input2 / input2.norm(dim=1, keepdim=True).clamp_min(1e-12)
    return 1.0 - a @ b.T
