"""CMC / mAP ranking metrics.

Counterpart of ``ieee_tpu/ops/ranking.py``. ``eval_market1501_numpy`` is the
parity oracle, and ``eval_regdb`` and ``eval_cuhk03_numpy`` the RegDB and
CUHK03 protocols, copied unchanged. ``evaluate_rank`` dispatches as the JAX
package does: the CUHK03 metric, then the native C++ ranker
(``native/ranking``, ``use_cython``), then the device path, else the numpy
oracle; a tensor distmat goes to host numpy for the numpy and native
branches. The default path, ``eval_market1501_device``,
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

import warnings
from collections import defaultdict

import numpy as np
import torch

__all__ = ["evaluate_rank", "eval_market1501_numpy", "eval_market1501_device",
           "eval_regdb"]


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


def eval_regdb(distmat, q_pids, g_pids, q_timeids=None, g_timeids=None,
               max_rank: int = 20):
    """RegDB protocol (reference ``rank.py:175-230``): visible<->thermal
    cross-modal eval. The reference hardwires q_camid=1 / g_camid=2, so the
    same-(pid, camid) removal never fires — equivalently, market1501 eval
    with no camera filtering. ``q_timeids``/``g_timeids`` are accepted and
    ignored, as the reference does."""
    num_q, num_g = np.asarray(distmat).shape
    q_camids = np.ones(num_q, np.int32)
    g_camids = 2 * np.ones(num_g, np.int32)
    return eval_market1501_numpy(
        distmat, q_pids, g_pids, q_camids, g_camids, max_rank
    )


def eval_cuhk03_numpy(
    distmat, q_pids, g_pids, q_camids, g_camids, max_rank, num_repeats=10, rng=None
):
    """CUHK03 protocol: single-gallery-shot, averaged over ``num_repeats``
    random samplings (reference ``rank.py:24-100``; the fork's extra timeid
    mask, whose call site was broken, ``rank.py:236-243``, is dropped)."""
    distmat = np.asarray(distmat)
    q_pids, g_pids = np.asarray(q_pids), np.asarray(g_pids)
    q_camids, g_camids = np.asarray(q_camids), np.asarray(g_camids)
    rng = np.random.default_rng(rng)
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
        kept_g_pids = g_pids[order][keep]
        g_pids_dict = defaultdict(list)
        for idx, pid in enumerate(kept_g_pids):
            g_pids_dict[pid].append(idx)
        cmc = np.zeros(max_rank, dtype=np.float64)
        for _ in range(num_repeats):
            mask = np.zeros(len(raw_cmc), dtype=bool)
            for _, idxs in g_pids_dict.items():
                mask[rng.choice(idxs)] = True
            masked = raw_cmc[mask]
            _cmc = masked.cumsum()
            _cmc[_cmc > 1] = 1
            pad = np.zeros(max_rank, dtype=np.float64)
            upto = min(max_rank, len(_cmc))
            pad[:upto] = _cmc[:upto]
            if upto < max_rank and upto > 0:
                pad[upto:] = _cmc[upto - 1]
            cmc += pad
        all_cmc.append(cmc / num_repeats)
        num_rel = raw_cmc.sum()
        tmp_cmc = raw_cmc.cumsum() / (np.arange(len(raw_cmc)) + 1.0)
        all_AP.append((tmp_cmc * raw_cmc).sum() / num_rel)
        num_valid_q += 1.0

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
    numpy array, which stays on the CPU; the ids are tensors or arrays).
    Returns (cmc numpy f32, mAP)."""
    if not isinstance(distmat, torch.Tensor):
        distmat = torch.from_numpy(np.array(distmat))
    dev = distmat.device

    def ids(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=torch.int64)
        return torch.as_tensor(np.asarray(x), dtype=torch.int64, device=dev)

    max_rank = min(int(max_rank), distmat.shape[1])
    cmc, m_ap, num_valid = _device_rank(
        distmat, ids(q_pids), ids(g_pids), ids(q_camids), ids(g_camids),
        max_rank)
    if float(num_valid) <= 0:
        raise ValueError("all query identities do not appear in gallery")
    return cmc.cpu().numpy().astype(np.float32), float(m_ap)


def _host(distmat):
    """A distmat as host numpy: a tensor (on the card or the CPU) is copied
    back; anything else goes through ``np.asarray``."""
    if isinstance(distmat, torch.Tensor):
        return distmat.detach().cpu().numpy()
    return np.asarray(distmat)


def evaluate_rank(distmat, q_pids, g_pids, q_camids, g_camids, max_rank=50,
                  use_metric_cuhk03=False, use_cython=False, use_device=True):
    """Evaluate CMC and mAP (reference ``rank.py:246-287`` dispatch): the
    CUHK03 metric, else the native ranker (``use_cython``; if it cannot be
    loaded, a warning and the device path), else the device path on the
    distmat's device (``use_device``), else the numpy oracle."""
    if use_metric_cuhk03:
        return eval_cuhk03_numpy(_host(distmat), q_pids, g_pids, q_camids,
                                 g_camids, max_rank)
    if use_cython:
        try:
            from ..native.ranking import eval_market1501_native

            return eval_market1501_native(
                _host(distmat), q_pids, g_pids, q_camids, g_camids, max_rank)
        except (ImportError, OSError) as e:
            warnings.warn(f"native ranking unavailable ({e}); using device "
                          "path")
    if use_device:
        return eval_market1501_device(
            distmat, q_pids, g_pids, q_camids, g_camids, max_rank)
    return eval_market1501_numpy(_host(distmat), q_pids, g_pids, q_camids,
                                 g_camids, max_rank)
