"""CMC / mAP ranking metrics.

Counterpart of ``ieee_tpu/ops/ranking.py``. ``eval_market1501_numpy`` is the
parity oracle, copied unchanged. The default path, ``eval_market1501_device``,
is the JAX package's ``_device_rank_impl`` in PyTorch: one stable argsort
over the gallery axis and prefix sums, batched over queries, on the
distmat's device. Its sums run in float64 (the oracle's type), so it agrees
with the oracle to rounding.

Protocol (reference ``torchreid/metrics/rank.py:103-171``): gallery entries
with the query's (pid, camid) are removed per query; queries with no
remaining positive are dropped; CMC counts over the compressed kept-gallery
ranking. Ties rank by gallery index (stable sorts everywhere).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["evaluate_rank", "eval_market1501_numpy", "eval_market1501_device"]


def eval_market1501_numpy(distmat, q_pids, g_pids, q_camids, g_camids, max_rank):
    """Market1501 protocol: same-(pid, camid) gallery removed per query
    (reference ``rank.py:103-171``)."""
    distmat = np.asarray(distmat)
    q_pids, g_pids = np.asarray(q_pids), np.asarray(g_pids)
    q_camids, g_camids = np.asarray(q_camids), np.asarray(g_camids)
    num_q, num_g = distmat.shape
    if num_g < max_rank:
        max_rank = num_g
        print(f"Note: number of gallery samples is quite small, got {num_g}")

    indices = np.argsort(distmat, axis=1, kind="stable")
    matches = (g_pids[indices] == q_pids[:, np.newaxis]).astype(np.int32)

    all_cmc, all_AP = [], []
    num_valid_q = 0.0
    for q_idx in range(num_q):
        order = indices[q_idx]
        remove = (g_pids[order] == q_pids[q_idx]) & (g_camids[order] == q_camids[q_idx])
        keep = ~remove
        raw_cmc = matches[q_idx][keep]
        if not np.any(raw_cmc):
            continue
        cmc = raw_cmc.cumsum()
        cmc[cmc > 1] = 1
        cmc = cmc[:max_rank]
        if len(cmc) < max_rank:
            cmc = np.concatenate(
                [cmc, np.full(max_rank - len(cmc), cmc[-1], cmc.dtype)]
            )
        all_cmc.append(cmc)
        num_valid_q += 1.0
        num_rel = raw_cmc.sum()
        tmp_cmc = raw_cmc.cumsum() / (np.arange(len(raw_cmc)) + 1.0)
        AP = (tmp_cmc * raw_cmc).sum() / num_rel
        all_AP.append(AP)

    assert num_valid_q > 0, "Error: all query identities do not appear in gallery"
    all_cmc = np.asarray(all_cmc, dtype=np.float32).sum(0) / num_valid_q
    return all_cmc, float(np.mean(all_AP))


def _device_rank(distmat: torch.Tensor, q_pids, g_pids, q_camids, g_camids,
                 max_rank: int):
    order = torch.argsort(distmat, dim=1, stable=True)  # (Q, G)
    g_pid_sorted = g_pids[order]
    g_cam_sorted = g_camids[order]

    same_pid = g_pid_sorted == q_pids[:, None]
    match = same_pid.double()
    keep = (~(same_pid & (g_cam_sorted == q_camids[:, None]))).double()

    kept_match = keep * match
    pos = torch.cumsum(keep, dim=1)  # 1-indexed position among kept
    cum_match = torch.cumsum(kept_match, dim=1)

    num_rel = kept_match.sum(1)
    valid = num_rel > 0

    prec = torch.where(pos > 0, cum_match / pos.clamp_min(1.0),
                       torch.zeros_like(pos))
    ap = (prec * kept_match).sum(1) / num_rel.clamp_min(1.0)

    inf = torch.full_like(pos, float("inf"))
    first_pos = torch.where(kept_match > 0, pos - 1.0, inf).amin(1)  # (Q,)
    ranks = torch.arange(max_rank, dtype=torch.float64, device=distmat.device)
    cmc_per_q = (first_pos[:, None] <= ranks[None, :]).double()

    validf = valid.double()
    num_valid = validf.sum()
    all_cmc = (cmc_per_q * validf[:, None]).sum(0) / num_valid.clamp_min(1.0)
    m_ap = (ap * validf).sum() / num_valid.clamp_min(1.0)
    return all_cmc, m_ap, num_valid


def eval_market1501_device(distmat, q_pids, g_pids, q_camids, g_camids,
                           max_rank):
    """Vectorised market1501 CMC/mAP on the distmat's device (a tensor or a
    numpy array, which stays on the CPU). Returns (cmc numpy f32, mAP)."""
    if not isinstance(distmat, torch.Tensor):
        distmat = torch.from_numpy(np.array(distmat))
    dev = distmat.device

    def ids(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.int64, device=dev)

    max_rank = min(int(max_rank), distmat.shape[1])
    cmc, m_ap, num_valid = _device_rank(
        distmat, ids(q_pids), ids(g_pids), ids(q_camids), ids(g_camids),
        max_rank)
    if float(num_valid) <= 0:
        raise ValueError("all query identities do not appear in gallery")
    return cmc.cpu().numpy().astype(np.float32), float(m_ap)


def evaluate_rank(distmat, q_pids, g_pids, q_camids, g_camids, max_rank=50,
                  use_metric_cuhk03=False):
    """Evaluate CMC and mAP (reference ``rank.py:246-287`` dispatch) on the
    distmat's device."""
    if use_metric_cuhk03:
        raise NotImplementedError(
            "the CUHK03 single-gallery-shot metric is not ported yet "
            "(ieee_tpu/ops/ranking.py:eval_cuhk03_numpy)")
    return eval_market1501_device(
        distmat, q_pids, g_pids, q_camids, g_camids, max_rank)
