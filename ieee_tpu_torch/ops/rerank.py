"""k-reciprocal re-ranking (Zhong et al., CVPR 2017): the numpy oracle.

Counterpart of ``ieee_tpu/ops/rerank.py``, copied line for line so that the
two agree bit for bit. Reference analog: ``torchreid/utils/rerank.py:31-113``
(CPU numpy loops). Same protocol: k-reciprocal expansion (k1, with the
1/2-k1 candidate augmentation), gaussian-weighted membership vectors, local
query expansion over k2 neighbors, Jaccard distance, and the final
``(1 - lambda) * jaccard + lambda * original`` blend. The engine runs it for
``test.rerank`` on a CPU engine; ``ops/rerank_device.py`` is the card's
path, held to this oracle.
"""

from __future__ import annotations

import numpy as np

__all__ = ["re_ranking"]


def re_ranking(q_g_dist, q_q_dist, g_g_dist, k1: int = 20, k2: int = 6,
               lambda_value: float = 0.3) -> np.ndarray:
    q_g_dist = np.asarray(q_g_dist, np.float32)
    q_q_dist = np.asarray(q_q_dist, np.float32)
    g_g_dist = np.asarray(g_g_dist, np.float32)

    num_query = q_q_dist.shape[0]
    original_dist = np.concatenate(
        [
            np.concatenate([q_q_dist, q_g_dist], axis=1),
            np.concatenate([q_g_dist.T, g_g_dist], axis=1),
        ],
        axis=0,
    )
    all_num = original_dist.shape[0]
    # square, then column-max normalize (``utils/rerank.py:44-47``): the
    # squaring changes the gaussian weights exp(-d) and the final blend, so
    # it is kept for protocol parity with the reference
    original_dist = np.square(original_dist)
    original_dist = np.transpose(
        original_dist / np.max(original_dist, axis=0)
    )
    V = np.zeros_like(original_dist, dtype=np.float32)
    initial_rank = np.argsort(original_dist, axis=1)

    def k_reciprocal_neigh(i, k):
        forward = initial_rank[i, : k + 1]
        backward = initial_rank[forward, : k + 1]
        fi = np.where(backward == i)[0]
        return forward[fi]

    for i in range(all_num):
        k_recip = k_reciprocal_neigh(i, k1)
        expansion = k_recip.copy()
        for candidate in k_recip:
            cand_recip = k_reciprocal_neigh(candidate, int(np.around(k1 / 2)))
            if len(np.intersect1d(cand_recip, k_recip)) > 2 / 3 * len(cand_recip):
                expansion = np.append(expansion, cand_recip)
        expansion = np.unique(expansion)
        weight = np.exp(-original_dist[i, expansion])
        V[i, expansion] = weight / np.sum(weight)

    original_dist = original_dist[:num_query]
    if k2 != 1:  # local query expansion
        V_qe = np.zeros_like(V, dtype=np.float32)
        for i in range(all_num):
            V_qe[i] = np.mean(V[initial_rank[i, :k2]], axis=0)
        V = V_qe

    inv_index = [np.where(V[:, i] != 0)[0] for i in range(all_num)]

    jaccard_dist = np.zeros((num_query, all_num), dtype=np.float32)
    for i in range(num_query):
        temp_min = np.zeros((1, all_num), dtype=np.float32)
        ind_non_zero = np.where(V[i] != 0)[0]
        ind_images = [inv_index[ind] for ind in ind_non_zero]
        for j, ind in enumerate(ind_non_zero):
            temp_min[0, ind_images[j]] += np.minimum(
                V[i, ind], V[ind_images[j], ind]
            )
        jaccard_dist[i] = 1 - temp_min / (2.0 - temp_min)

    final_dist = (
        jaccard_dist * (1 - lambda_value) + original_dist * lambda_value
    )
    return final_dist[:, num_query:]
