"""Metric and compute ops on the tensors' device (distance, ranking) and the
hand-written CUDA kernels (``ops/kernels``).

Counterpart of ``ieee_tpu/ops``.
"""

from .distance import (
    compute_distance_matrix,
    cosine_distance,
    euclidean_squared_distance,
)
from .ranking import eval_market1501_numpy, evaluate_rank

__all__ = [
    "compute_distance_matrix",
    "cosine_distance",
    "euclidean_squared_distance",
    "eval_market1501_numpy",
    "evaluate_rank",
]
