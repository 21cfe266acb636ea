"""The port's re-ranking against the JAX package's, on the CPU: the numpy
oracle (``ops/rerank.py``), the device k-reciprocal re-rank
(``ops/rerank_device.py``) and GNN re-ranking (``ops/gnn_rerank.py``) on
CPU tensors, the plain versions of the ``jaccard_minsum`` and
``gnn_propagate`` kernels, ``test.rerank`` through the engine and the CLI,
and the two tools.

Inputs are made with numpy from seeds at the JAX tests' sizes
(``tests/test_rerank.py``: 12 query x 48 gallery at 16-d). The kernels run
only on a card (``tests/test_torch_kernels_cuda.py`` holds them to these
plain versions there).
"""

import functools
import os
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ieee_tpu.ops.distance import compute_distance_matrix as jax_distmat
from ieee_tpu.ops.gnn_rerank import _gnn_rerank_scores as jax_gnn_scores
from ieee_tpu.ops.gnn_rerank import _scatter_rows
from ieee_tpu.ops.gnn_rerank import gnn_reranking as jax_gnn_reranking
from ieee_tpu.ops.ranking import evaluate_rank as jax_evaluate_rank
from ieee_tpu.ops.rerank import re_ranking as jax_re_ranking
from ieee_tpu.ops.rerank_device import re_ranking_device as jax_rr_device
from ieee_tpu_torch import main_multimodal
from ieee_tpu_torch.config import get_default_config
from ieee_tpu_torch.data import ImageDataManager
from ieee_tpu_torch.engine import Engine, build_engine
from ieee_tpu_torch.models import build_model
from ieee_tpu_torch.ops import (gnn_reranking, re_ranking,
                                re_ranking_device)
from ieee_tpu_torch.ops.gnn_rerank import _gnn_rerank_scores
from ieee_tpu_torch.ops.kernels import rerank as kr
from ieee_tpu_torch.tools import gnn_rerank_cli, rerank_bench

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (seed, k1, k2) of tests/test_rerank.py's device test
SETTINGS = [(0, 8, 3), (1, 20, 6), (2, 11, 1)]
DATA = dict(sources="synthetic_mm", height=96, width=32, batch_size_test=4,
            workers=0, num_pids=6, imgs_per_pid=2, verbose=False, seed=0)
LAYERS = (1, 1, 1, 1)


def _sqdist(a, b):
    return ((a[:, None] - b[None]) ** 2).sum(-1).astype(np.float32)


def _distances(seed, nq=12, ng=48, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    g = rng.standard_normal((ng, d)).astype(np.float32)
    return _sqdist(q, g), _sqdist(q, q), _sqdist(g, g)


def _unit_features(seed, nq=12, ng=40, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    g = rng.standard_normal((ng, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    return q, g


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("seed,k1,k2", SETTINGS)
def test_oracle_equals_the_jax_oracle_bit_for_bit(seed, k1, k2):
    args = _distances(seed)
    ours = re_ranking(*args, k1=k1, k2=k2)
    assert ours.dtype == np.float32 and ours.shape == (12, 48)
    np.testing.assert_array_equal(ours, jax_re_ranking(*args, k1=k1, k2=k2))


@pytest.mark.parametrize("seed,k1,k2", SETTINGS)
def test_device_rerank_matches_jax(seed, k1, k2):
    # tolerance of tests/test_rerank.py's device-vs-oracle test: sums in
    # other orders (V's row sums, the query expansion, the min-sum)
    args = _distances(seed)
    ours = re_ranking_device(*_torch(*args), k1=k1, k2=k2)
    assert isinstance(ours, torch.Tensor) and ours.dtype == torch.float32
    assert ours.shape == (12, 48)
    np.testing.assert_allclose(ours.numpy(), np.asarray(
        jax_rr_device(*args, k1=k1, k2=k2)), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ours.numpy(), re_ranking(*args, k1=k1, k2=k2),
                               rtol=1e-4, atol=1e-5)


def test_bf16_minsum_close_to_exact_and_different():
    # tests/test_rerank.py's clustered features: the bf16 min-sum within
    # 2e-3 of the exact result, as the JAX package's, and not equal to it
    rng = np.random.default_rng(11)
    feats = np.asarray([c + rng.standard_normal(24)
                        for c in 3.0 * rng.standard_normal((8, 24))
                        for _ in range(5)], np.float32)
    args = _torch(_sqdist(feats[:12], feats[12:]),
                  _sqdist(feats[:12], feats[:12]),
                  _sqdist(feats[12:], feats[12:]))
    exact = re_ranking_device(*args, k1=10, k2=4).numpy()
    fast = re_ranking_device(*args, k1=10, k2=4, minsum_bf16=True).numpy()
    assert np.abs(fast - exact).max() < 2e-3
    assert not np.array_equal(fast, exact)


def _tiny(seed, nq=3, ng=5, d=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    g = rng.standard_normal((ng, d)).astype(np.float32)
    return _sqdist(q, g), _sqdist(q, q), _sqdist(g, g)


# n = 8: at or below k1 + 1 (the JAX package hands these to the oracle: no
# approx top-k of k >= n), below k2 alone, and both
TINY = [(20, 6), (7, 3), (4, 10), (11, 9)]


def test_tiny_problem_dispatches_to_the_oracle():
    # the port answers as the oracle does, each neighbourhood capped at n
    # as the oracle's slices of its full argsort are; tolerance of the
    # device test above
    for seed, (k1, k2) in enumerate(TINY):
        args = _tiny(seed)
        ours = re_ranking_device(*_torch(*args), k1=k1, k2=k2)
        assert ours.shape == (3, 5)
        np.testing.assert_allclose(ours.numpy(), re_ranking(
            *args, k1=k1, k2=k2), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ours.numpy(), np.asarray(jax_rr_device(
            *args, k1=k1, k2=k2)), rtol=1e-4, atol=1e-5)


def test_tiny_problem_stays_on_the_min_sum(monkeypatch):
    # n <= k1 + 1 runs the device path, so on the card the min-sum kernel:
    # one jaccard_minsum call, on the query and gallery rows of V
    from ieee_tpu_torch.ops import rerank_device

    calls = []

    def spy(vq, vg):
        calls.append((tuple(vq.shape), tuple(vg.shape)))
        return kr.jaccard_minsum(vq, vg)

    monkeypatch.setattr(rerank_device, "jaccard_minsum", spy)
    re_ranking_device(*_torch(*_tiny(0)), k1=20, k2=6)
    assert calls == [((3, 8), (5, 8))]


def _membership_like(rows, k, seed, dtype):
    """Non-negative rows summing to 1 with about a third zeros, as V."""
    rng = np.random.default_rng(seed)
    v = rng.random((rows, k)) * (rng.random((rows, k)) > 0.3)
    v = (v / v.sum(1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(v).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_jaccard_minsum_matches_a_float64_loop(dtype, monkeypatch):
    vq = _membership_like(5, 37, 0, dtype)
    vg = _membership_like(7, 37, 1, dtype)
    a, b = vq.double().numpy(), vg.double().numpy()
    want = np.empty((5, 7))
    for i in range(5):
        for c in range(7):
            m = sum(min(a[i, k], b[c, k]) for k in range(37))
            want[i, c] = 1.0 - m / (2.0 - m)
    got = kr.jaccard_minsum(vq, vg)
    assert got.dtype == torch.float32 and got.shape == (5, 7)
    # f32 sums of at most 37 terms of at most 1: a few f32 ulps
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # blocked over rows and columns (a 2 x 3 x 37 intermediate at most):
    # each entry's sum is the same
    monkeypatch.setattr(kr, "PLAIN_MINSUM_ELEMS", 6 * 37)
    assert torch.equal(kr.jaccard_minsum_plain(vq, vg), got)


@pytest.mark.parametrize("track,k2", [(False, 4), (True, 4), (False, 1)])
def test_gnn_scores_match_jax(track, k2):
    q, g = _unit_features(3)
    ours = _gnn_rerank_scores(*_torch(q, g), 8, k2, track)
    theirs = np.asarray(jax_gnn_scores(jnp.asarray(q), jnp.asarray(g), 8, k2,
                                       track))
    # tests/test_rerank.py's tolerance between the two propagation forms
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-5, atol=1e-6)


def test_gnn_reranking_order_matches_jax_where_scores_differ():
    q, g = _unit_features(5)
    ours = gnn_reranking(q, g, k1=8, k2=3).numpy()
    theirs = np.asarray(jax_gnn_reranking(q, g, k1=8, k2=3))
    assert ours.shape == theirs.shape == (12, 40)
    assert (np.sort(ours, axis=1) == np.arange(40)).all()
    scores = np.asarray(jax_gnn_scores(jnp.asarray(q), jnp.asarray(g), 8, 3))
    s = np.take_along_axis(scores, theirs, axis=1)
    # a position is determined where its score stands more than the scores'
    # tolerance (1e-6 absolute) from both neighbours in the order
    gap = np.abs(np.diff(s, axis=1)) > 1e-6
    apart = np.ones_like(s, dtype=bool)
    apart[:, 1:] &= gap
    apart[:, :-1] &= gap
    assert apart.sum() > s.size // 4
    np.testing.assert_array_equal(ours[apart], theirs[apart])


def test_plain_gnn_propagate_matches_the_dense_product():
    # tests/test_rerank.py's dense oracle: W @ C with W[i, idx[i, j]] =
    # vals[i, j], rows normalized; here in float64
    rng = np.random.default_rng(11)
    a = (rng.random((30, 30)) > 0.7).astype(np.float32)
    c = a + a.T
    vals, idx = torch.topk(torch.from_numpy(rng.random((30, 30)).astype(
        np.float32)), 5, dim=1)
    got = kr.gnn_propagate(torch.from_numpy(c), idx, vals)
    w = np.asarray(_scatter_rows(jnp.asarray(idx.numpy()),
                                 jnp.asarray(vals.numpy()), 30), np.float64)
    want = w @ c.astype(np.float64)
    want /= np.maximum(np.linalg.norm(want, axis=1, keepdims=True), 1e-12)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_wrappers_check_operands_and_never_fall_back():
    v = torch.rand(4, 8)
    with pytest.raises(TypeError):
        kr.jaccard_minsum(v, v.to(torch.bfloat16))
    with pytest.raises(TypeError):
        kr.jaccard_minsum(v.double(), v.double())
    with pytest.raises(ValueError):
        kr.jaccard_minsum(v, torch.rand(4, 9))
    idx = torch.zeros((4, 2), dtype=torch.int64)
    with pytest.raises(TypeError):
        kr.gnn_propagate(v, idx.int(), torch.rand(4, 2))
    with pytest.raises(TypeError):
        kr.gnn_propagate(v.double(), idx, torch.rand(4, 2))
    with pytest.raises(ValueError):
        kr.gnn_propagate(v, idx, torch.rand(4, 3))
    # a device with no kernel raises, it does not take the plain version
    meta = v.to("meta")
    with pytest.raises(ValueError, match="no jaccard_minsum kernel"):
        kr.jaccard_minsum(meta, meta)
    with pytest.raises(ValueError, match="no gnn_propagate kernel"):
        kr.gnn_propagate(meta, idx.to("meta"), torch.rand(4, 2).to("meta"))


def test_minsum_kernel_takes_rows_any_distance_apart():
    # the stride the card's wrapper passes: rows of a wider matrix and V's
    # own rows (n floats apart, odd n) as they are; a transpose or
    # overlapping rows refused
    v = torch.rand(6, 40)
    assert kr._row_stride("v", v[:, :37]) == 40
    assert kr._row_stride("v", v[1:4, 3:]) == 40
    assert kr._row_stride("v", torch.rand(5, 37)[2:]) == 37
    assert kr._row_stride("row", v[2:3, 5:]) == 35
    with pytest.raises(ValueError, match="unit column stride"):
        kr._row_stride("v.T", v.T)
    with pytest.raises(ValueError, match="overlap"):
        kr._row_stride("expanded", torch.rand(1, 8).expand(4, 8))


@pytest.fixture(scope="module")
def engine():
    dm = ImageDataManager(**DATA)
    model = build_model("ieee3modalPart", dm.num_train_pids, "margin",
                        pretrained=False, dtype="float32",
                        backbone_layers=LAYERS, device="cpu")
    return Engine(dm, model, device="cpu", fused_eval=False)


def test_engine_rerank_matches_the_jax_pipeline(engine, monkeypatch):
    loaders = engine.test_loader["synthetic_mm"]
    feats = {split: engine._feature_extraction(loaders[split])
             for split in ("query", "gallery")}
    # _evaluate extracts the same features again: hand it these
    monkeypatch.setattr(engine, "_feature_extraction", lambda loader: next(
        f for s, f in feats.items() if loaders[s] is loader))
    cmc, mAP = engine._evaluate(query_loader=loaders["query"],
                                gallery_loader=loaders["gallery"],
                                rerank=True)
    (qf, qp, qc), (gf, gp, gc) = feats["query"], feats["gallery"]
    qf, gf = qf.numpy(), gf.numpy()
    distmat = jax_re_ranking(np.asarray(jax_distmat(qf, gf)),
                             np.asarray(jax_distmat(qf, qf)),
                             np.asarray(jax_distmat(gf, gf)))
    cmc_j, mAP_j = jax_evaluate_rank(distmat, qp, gp, qc, gc)
    # the eval-slice test's bound on the ranking metrics
    np.testing.assert_allclose(cmc, cmc_j, rtol=0, atol=1e-6)
    assert abs(mAP - mAP_j) < 1e-6


def test_visrank_is_still_refused(engine):
    with pytest.raises(NotImplementedError, match="visrank"):
        engine._evaluate(visrank=True)


def test_config_key_reaches_the_engine(engine):
    cfg = get_default_config()
    assert cfg.cuda.rerank_bf16 is False and cfg.test.rerank is False
    cfg.cuda.rerank_bf16 = True
    eng = build_engine(cfg, engine.datamanager, engine.model, device="cpu")
    assert eng.rerank_bf16 is True


def test_cli_evaluates_with_rerank_on_cpu(tmp_path, capsys, monkeypatch):
    orig = main_multimodal.imagedata_kwargs
    monkeypatch.setattr(main_multimodal, "imagedata_kwargs", lambda cfg: {
        **orig(cfg), "num_pids": 4, "imgs_per_pid": 4})
    monkeypatch.setattr(main_multimodal, "build_model", functools.partial(
        main_multimodal.build_model, backbone_layers=LAYERS))
    rank1 = main_multimodal.main([
        "--config-file",
        os.path.join(ROOT, "configs", "rgbnt_ieee_part_margin.yaml"),
        "--device", "cpu", "model.pretrained", "False",
        "data.sources", "['synthetic_mm']", "data.targets",
        "['synthetic_mm']", "data.height", "64", "data.width", "32",
        "data.save_dir", str(tmp_path), "test.evaluate", "True",
        "test.batch_size", "8", "test.rerank", "True"])
    out = capsys.readouterr().out
    assert 0.0 <= rank1 <= 1.0
    assert "Applying person re-ranking ..." in out and "mAP:" in out


@pytest.mark.parametrize("tool", [rerank_bench, gnn_rerank_cli])
def test_tool_refuses_cuda_without_a_card(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.main(["--device", "cuda", "--data", "unused.pkl"]
                  if tool is gnn_rerank_cli else ["--device", "cuda"])


def test_rerank_bench_on_cpu(capsys):
    res = rerank_bench.main(["--device", "cpu", "--num-q", "12", "--num-g",
                             "40", "--dim", "16", "--reps", "1"])
    out = capsys.readouterr().out
    assert set(res) == {"f32 exact", "bf16 minsum", "A+A.T",
                        "transpose-free"}
    assert all(np.isfinite(v) and v >= 0 for v in res.values())
    assert "k-reciprocal device [bf16 minsum] (12x40, k1=20 k2=6)" in out
    assert "gnn re-rank scores device [transpose-free] (k1=26 k2=7)" in out


def test_gnn_rerank_cli_matches_the_jax_scoring(tmp_path, capsys):
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((6, 16))
    feats = np.concatenate([c + 0.3 * rng.standard_normal((5, 16))
                            for c in centers]).astype(np.float32)
    pids = np.repeat(np.arange(6), 5)
    q = np.arange(30) % 5 == 0
    data = {"query_f": feats[q], "gallery_f": feats[~q],
            "query_pid": pids[q], "gallery_pid": pids[~q],
            "query_cam": np.zeros(q.sum(), int),
            "gallery_cam": np.ones((~q).sum(), int)}
    path = tmp_path / "features.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    res = gnn_rerank_cli.main(["--data", str(path), "--device", "cpu",
                               "--k1", "8", "--k2", "3"])
    assert "mAP:" in capsys.readouterr().out
    # the JAX tool's scoring of its own ranking: distance = position
    nq = data["query_f"]
    nq = nq / np.linalg.norm(nq, axis=1, keepdims=True)
    ng = data["gallery_f"] / np.linalg.norm(data["gallery_f"], axis=1,
                                            keepdims=True)
    L = np.asarray(jax_gnn_reranking(nq, ng, k1=8, k2=3))
    np.testing.assert_array_equal(res["ranking"].numpy(), L)
    distmat = np.empty(L.shape, np.float32)
    distmat[np.arange(L.shape[0])[:, None], L] = np.arange(L.shape[1])
    cmc, mAP = jax_evaluate_rank(distmat, data["query_pid"],
                                 data["gallery_pid"], data["query_cam"],
                                 data["gallery_cam"], max_rank=20)
    np.testing.assert_allclose(res["cmc"], cmc, rtol=0, atol=1e-6)
    assert abs(res["mAP"] - mAP) < 1e-6
