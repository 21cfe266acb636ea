"""The port's distance and CMC/mAP against the numpy oracle and the JAX
package's device path."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ieee_tpu.ops.distance import compute_distance_matrix as jax_distmat
from ieee_tpu.ops.ranking import evaluate_rank as jax_evaluate_rank
from ieee_tpu_torch.ops import (
    compute_distance_matrix,
    eval_market1501_numpy,
    evaluate_rank,
)
from torch_threads import one_torch_thread  # noqa: F401


def _case(seed, num_q=40, num_g=120, num_pids=12, num_cams=4, dim=16):
    rng = np.random.default_rng(seed)
    qf = rng.standard_normal((num_q, dim)).astype(np.float32)
    gf = rng.standard_normal((num_g, dim)).astype(np.float32)
    q_pids = rng.integers(0, num_pids, num_q)
    g_pids = rng.integers(0, num_pids, num_g)
    q_cams = rng.integers(0, num_cams, num_q)
    g_cams = rng.integers(0, num_cams, num_g)
    return qf, gf, q_pids, g_pids, q_cams, g_cams


@pytest.mark.parametrize("seed,max_rank", [(0, 50), (1, 10), (2, 200)])
def test_device_rank_matches_numpy_oracle(seed, max_rank):
    qf, gf, qp, gp, qc, gc = _case(seed)
    d = compute_distance_matrix(torch.tensor(qf), torch.tensor(gf))
    cmc, mAP = evaluate_rank(d, qp, gp, qc, gc, max_rank=max_rank)
    cmc_o, mAP_o = eval_market1501_numpy(d.numpy(), qp, gp, qc, gc, max_rank)
    # float64 sums in both: equal up to rounding
    np.testing.assert_allclose(cmc, cmc_o, rtol=0, atol=1e-12)
    assert abs(mAP - mAP_o) < 1e-12


def test_ties_rank_by_gallery_index():
    # integer-valued distances tie often; stable sorts on both sides
    rng = np.random.default_rng(5)
    d = rng.integers(0, 4, (30, 60)).astype(np.float32)
    qp, gp = rng.integers(0, 5, 30), rng.integers(0, 5, 60)
    qc, gc = rng.integers(0, 3, 30), rng.integers(0, 3, 60)
    cmc, mAP = evaluate_rank(torch.tensor(d), qp, gp, qc, gc, max_rank=20)
    cmc_o, mAP_o = eval_market1501_numpy(d, qp, gp, qc, gc, 20)
    np.testing.assert_allclose(cmc, cmc_o, rtol=0, atol=1e-12)
    assert abs(mAP - mAP_o) < 1e-12


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_distmat_and_rank_match_jax(metric):
    qf, gf, qp, gp, qc, gc = _case(3, dim=64)
    d = compute_distance_matrix(qf, gf, metric)
    d_j = np.asarray(jax_distmat(jnp.asarray(qf), jnp.asarray(gf), metric))
    np.testing.assert_allclose(d.numpy(), d_j, rtol=0,
                               atol=1e-5 * np.abs(d_j).max())
    cmc, mAP = evaluate_rank(d_j, qp, gp, qc, gc)
    cmc_j, mAP_j = jax_evaluate_rank(d_j, qp, gp, qc, gc)
    np.testing.assert_allclose(cmc, cmc_j, rtol=0, atol=1e-6)
    assert abs(mAP - mAP_j) < 1e-6


def test_queries_without_positives_are_dropped_and_all_missing_raises():
    d = torch.tensor([[0.1, 0.2], [0.3, 0.4]])
    cmc, mAP = evaluate_rank(d, [0, 9], [0, 1], [0, 0], [1, 1], max_rank=2)
    np.testing.assert_allclose(cmc, [1.0, 1.0])
    assert mAP == 1.0
    with pytest.raises(ValueError):
        evaluate_rank(d, [7, 9], [0, 1], [0, 0], [1, 1])
    # the CUHK03 metric runs: one positive per query, ranked first
    cmc, mAP = evaluate_rank(d, [0, 9], [0, 1], [0, 0], [1, 1], max_rank=2,
                             use_metric_cuhk03=True)
    np.testing.assert_allclose(cmc, [1.0, 1.0])
    assert mAP == 1.0


def test_distance_input_checks():
    with pytest.raises(ValueError):
        compute_distance_matrix(np.zeros((2, 3)), np.zeros((2, 4)))
    with pytest.raises(ValueError):
        compute_distance_matrix(np.zeros((2, 3)), np.zeros((2, 3)), "l1")
