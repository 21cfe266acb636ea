"""Metric and compute ops on the tensors' device (distance, ranking,
re-ranking) and the hand-written CUDA kernels (``ops/kernels``).

Counterpart of ``ieee_tpu/ops``.
"""

from .distance import (
    compute_distance_matrix,
    cosine_distance,
    euclidean_squared_distance,
)
from .gnn_rerank import gnn_reranking
from .ranking import eval_market1501_numpy, evaluate_rank
from .rerank import re_ranking
from .rerank_device import re_ranking_device

__all__ = [
    "compute_distance_matrix",
    "cosine_distance",
    "euclidean_squared_distance",
    "eval_market1501_numpy",
    "evaluate_rank",
    "gnn_reranking",
    "re_ranking",
    "re_ranking_device",
]
