"""GNN re-ranking (Zhang et al., arXiv:2012.07620) on the tensors' device.

Counterpart of ``ieee_tpu/ops/gnn_rerank.py``; reference analog
``torchreid/utils/GPU-Re-Ranking/``, two CUDA kernels driven by
``gnn_reranking.py:27-59``:

- the adjacency: 1 at each row's top-k1 by cosine similarity
  (``build_adjacency_matrix_kernel.cu``), here ``torch.topk`` and a
  ``scatter_add_``;
- two propagation rounds ``A <- normalize(W @ (A + A^T))`` with W the
  squared similarities of each row's k2 nearest (``gnn_propagate_kernel.cu``),
  here ``C = A + A.T`` and the hand-written ``gnn_propagate`` kernel
  (``ops/kernels/rerank.py``), which gathers the k2 rows of C an output row
  needs instead of densifying W.

The similarity and the final scores are plain f32 products
(``torch.matmul``; TF32 stays off), as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch

from .distance import _as_tensor
from .kernels.rerank import gnn_propagate

__all__ = ["gnn_reranking"]


def _gnn_graph(X_q, X_g, k1: int):
    """-> (A, S, rank): the (n, n) adjacency of each row's top-k1 by
    similarity, those similarities squared (n, k1) and their indices."""
    X_u = torch.cat([X_q, X_g], dim=0)
    n = X_u.shape[0]
    score = torch.matmul(X_u, X_u.T)
    S, rank = torch.topk(score, k1, dim=1)
    del score
    A = torch.zeros((n, n), dtype=torch.float32, device=X_u.device)
    A.scatter_add_(1, rank, torch.ones_like(S))
    return A, S * S, rank


def _gnn_rerank_scores(X_q, X_g, k1: int, k2: int,
                       track_transpose: bool = False) -> torch.Tensor:
    """(num_q, num_g) f32 scores ``A[:q] @ A[q:].T`` after the propagation
    (the JAX ``_gnn_rerank_scores``). ``track_transpose`` keeps A^T as its
    own matrix, propagated by gathers of C's columns (C = A + A^T is
    symmetric, so A^T's update is C @ W^T), in place of the transpose each
    round: the JAX package's slower, non-default variant, kept as tensor
    code; A's rows still go through ``gnn_propagate``."""
    qn = X_q.shape[0]
    A, S, rank = _gnn_graph(X_q, X_g, k1)
    if k2 != 1:
        idx = rank[:, :k2].contiguous()
        vals = S[:, :k2].contiguous()
        if track_transpose:
            At = torch.zeros_like(A)
            At.scatter_add_(0, rank.T.contiguous(), torch.ones_like(S.T))
            for _ in range(2):
                C = A + At
                del A, At
                At = torch.zeros_like(C)
                for j in range(k2):
                    At = At + vals[None, :, j] * C[:, idx[:, j]]
                A = gnn_propagate(C, idx, vals)
                del C
                # A's row norms are At's column norms (the same sums)
                At = At / torch.linalg.norm(
                    At, dim=0, keepdim=True).clamp_min(1e-12)
        else:
            for _ in range(2):
                C = A + A.T
                del A
                A = gnn_propagate(C, idx, vals)
                del C
    return torch.matmul(A[:qn], A[qn:].T)


def gnn_reranking(X_q, X_g, k1: int = 26, k2: int = 7,
                  track_transpose: bool = False) -> torch.Tensor:
    """The re-ranked gallery index list L (num_q, num_g), int64 where
    ``X_q`` lies (tensors, or numpy arrays on the CPU), the reference CLI's
    contract (``gnn_reranking.py:27-59``). Features should be L2-normalized
    (cosine similarity). Ties (many scores are exactly 0) rank by gallery
    index."""
    X_q = _as_tensor(X_q)
    X_g = _as_tensor(X_g, X_q.device)
    scores = _gnn_rerank_scores(X_q, X_g, int(k1), int(k2),
                                bool(track_transpose))
    return torch.argsort(-scores, dim=1, stable=True)
