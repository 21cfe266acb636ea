"""k-reciprocal re-ranking (Zhong et al., CVPR 2017) on the tensors' device.

Counterpart of ``ieee_tpu/ops/rerank_device.py``: the protocol of the numpy
oracle (``ops/rerank.py``) as masked matrix algebra, so the whole re-rank
runs on the card:

- each probe's k-reciprocal set is a row of a boolean mask, ``R = F & F.T``
  with F the top-(k1+1) membership (``torch.topk``, exact);
- the candidate expansion ("add Rh(j) when it overlaps R(i) by more than
  2/3") is two mask products, ``R @ Rh.T`` for the overlap counts and
  ``cond @ Rh > 0`` for the union, as ``torch.matmul`` of 0/1 bf16
  operands: every count is an integer of at most k1 + 1 <= 256, exact in
  bf16 and in any order of summation;
- the gaussian membership vectors V and the k2 local query expansion are
  row operations and a k2-term gather-sum;
- the Jaccard min-sum runs on the ``jaccard_minsum`` kernel
  (``ops/kernels/rerank.py``), over the gallery columns only.

A problem smaller than its neighbourhoods (n <= max(k1 + 1, k2)) takes
every row where the oracle's slices of its full argsort do, and stays on
the device; the JAX package hands it to the oracle, as ``approx_max_k``
needs k < n.

The n x n intermediates (1.49 GB each in f32 at Market-1501's n = 19281)
are built in place where the oracle's arithmetic allows it and freed as
soon as they are spent.
"""

from __future__ import annotations

import numpy as np
import torch

from .distance import _as_tensor
from .kernels.rerank import jaccard_minsum

__all__ = ["re_ranking_device"]


def _original(q_g, q_q, g_g) -> torch.Tensor:
    """The oracle's original_dist: the (n, n) block matrix squared,
    divided by its column maxima, then transposed (``rerank.py:44-47``;
    D is not symmetric)."""
    qn, gn = q_q.shape[0], g_g.shape[0]
    n = qn + gn
    orig = torch.empty((n, n), dtype=torch.float32, device=q_g.device)
    orig[:qn, :qn] = q_q
    orig[:qn, qn:] = q_g
    orig[qn:, :qn] = q_g.T
    orig[qn:, qn:] = g_g
    orig.mul_(orig)
    orig.div_(orig.amax(0))
    return orig.T.contiguous()


def _reciprocal(rank: torch.Tensor, k: int) -> torch.Tensor:
    """The (n, n) boolean mask of each row's k-reciprocal set: j among i's
    first k of ``rank`` (its whole row if shorter) and i among j's."""
    n = rank.shape[0]
    f = torch.zeros((n, n), dtype=torch.bool, device=rank.device)
    f.scatter_(1, rank[:, :k], True)
    return f & f.T


def _membership(q_g, q_q, g_g, k1: int, k2: int):
    """-> (V, D[:q, q:]): the membership vectors after the local query
    expansion, (n, n) f32, and the normalized query x gallery distances for
    the blend."""
    if k1 + 1 > 256:
        raise ValueError(f"k1 = {k1}: the mask products count in bf16, "
                         "exact up to 256")
    qn = q_q.shape[0]
    D = _original(q_g, q_q, g_g)
    n = D.shape[0]
    kh = int(np.around(k1 / 2.0)) + 1
    k2 = min(k2, n)     # the oracle's initial_rank[i, :k2]
    rank = torch.topk(D, min(max(k1 + 1, k2), n), dim=1,
                      largest=False).indices
    R = _reciprocal(rank, k1 + 1)               # k-reciprocal sets
    Rh = _reciprocal(rank, kh)                  # half-k reciprocal sets
    # candidate expansion: for j in R(i), add Rh(j) when
    # |Rh(j) & R(i)| > 2/3 |Rh(j)| (strict, as the reference)
    Rhb = Rh.to(torch.bfloat16)
    del Rh
    sizes_h = Rhb.sum(1, dtype=torch.float32)   # |Rh(j)|
    inter = torch.matmul(R.to(torch.bfloat16), Rhb.T)
    cond = inter > (2.0 / 3.0) * sizes_h[None, :]
    del inter
    cond &= R
    union = torch.matmul(cond.to(torch.bfloat16), Rhb) > 0
    del cond, Rhb
    E = R.logical_or_(union)
    del union

    Dq = D[:qn, qn:].clone()
    idx2 = rank[:, :k2].T.contiguous()
    del rank
    # gaussian membership vectors, row-normalized over the expanded set: D
    # becomes W in place
    W = D.neg_().exp_().mul_(E)
    del D, E
    W.div_(W.sum(1, keepdim=True))
    if k2 == 1:
        return W, Dq
    # local query expansion: the mean of V over the k2 nearest rows, summed
    # in order from zero as the JAX package's loop sums
    V = torch.zeros_like(W)
    rows = torch.empty_like(W)
    for j in range(k2):
        torch.index_select(W, 0, idx2[j], out=rows)
        V.add_(rows)
    del rows, W
    V.div_(k2)
    return V, Dq


def _rerank_core(q_g, q_q, g_g, k1: int, k2: int, minsum_bf16: bool = False):
    """-> (jaccard, D[:q, q:]), both (q, g) f32 on the inputs' device: the
    JAX ``_rerank_core`` restricted to the gallery columns, which are all
    that re-ranking returns. ``minsum_bf16`` (``cfg.cuda.rerank_bf16``)
    stages V in bf16 for the min-sum and sums in f32: about 1e-3 off the
    f32 result, as in the JAX package."""
    qn = q_q.shape[0]
    V, Dq = _membership(q_g, q_q, g_g, k1, k2)
    if minsum_bf16:
        V = V.to(torch.bfloat16)
    jaccard = jaccard_minsum(V[:qn], V[qn:])
    return jaccard, Dq


def re_ranking_device(q_g_dist, q_q_dist, g_g_dist, k1: int = 20,
                      k2: int = 6, lambda_value: float = 0.3,
                      minsum_bf16: bool = False) -> torch.Tensor:
    """The re-ranked (num_q, num_g) f32 distance matrix where ``q_g_dist``
    lies (tensors, or numpy arrays on the CPU). Drop-in for
    ``ops.rerank.re_ranking``."""
    q_g = _as_tensor(q_g_dist)
    q_q = _as_tensor(q_q_dist, q_g.device)
    g_g = _as_tensor(g_g_dist, q_g.device)
    jaccard, Dq = _rerank_core(q_g, q_q, g_g, int(k1), int(k2),
                               bool(minsum_bf16))
    return jaccard.mul_(1 - lambda_value).add_(Dq.mul_(lambda_value))
