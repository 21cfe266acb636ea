"""The port's retrieval path as a whole against the JAX package: data,
features, distmat, CMC/mAP, and the CLI.

Tiny ``synthetic_mm`` (6 pids: 6 query and 12 gallery triplets at 96x32,
test batch 4, so the query's tail batch is padded), the IEEE model at
``backbone_layers=(1, 1, 1, 1)`` in f32 on random numpy weights.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ieee_tpu.data import ImageDataManager as JaxImageDataManager
from ieee_tpu.models import build_model as jax_build_model
from ieee_tpu.ops import compute_distance_matrix as jax_distmat
from ieee_tpu.ops import evaluate_rank as jax_evaluate_rank
from ieee_tpu_torch import main_multimodal
from ieee_tpu_torch.data import DataLoader, ImageDataManager
from ieee_tpu_torch.engine import Engine
from ieee_tpu_torch.models import build_model
from ieee_tpu_torch.models.weights import load_jax_variables
from ieee_tpu_torch.ops import compute_distance_matrix, evaluate_rank

from test_torch_model import _random_variables
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = dict(sources="synthetic_mm", height=96, width=32, batch_size_test=4,
            workers=0, num_pids=6, imgs_per_pid=2, verbose=False, seed=0)
LAYERS = (1, 1, 1, 1)


@pytest.fixture(scope="module")
def managers():
    return ImageDataManager(**DATA), JaxImageDataManager(**DATA)


@pytest.fixture(scope="module")
def jax_reference(managers):
    """The JAX package's path: the model applied per batch, then
    compute_distance_matrix, then evaluate_rank."""
    _, jdm = managers
    m = jax_build_model("ieee3modalPart", num_classes=jdm.num_train_pids,
                        loss="margin", pretrained=False,
                        backbone_layers=LAYERS, dtype=jnp.float32)
    params, stats = _random_variables(m.module)
    v = {"params": params, "batch_stats": stats}
    fwd = jax.jit(lambda x: m.module.apply(v, x, train=False))
    out = {}
    for split in ("query", "gallery"):
        feats, pids, cams = [], [], []
        for data in jdm.test_loader["synthetic_mm"][split]:
            imgs = tuple(jdm.transform_te(x) for x in data["img"])
            feats.append(np.asarray(fwd(imgs)))
            pids.extend(data["pid"].tolist())
            cams.extend(data["camid"].tolist())
        out[split] = (np.concatenate(feats), np.asarray(pids),
                      np.asarray(cams))
    (qf, qp, qc), (gf, gp, gc) = out["query"], out["gallery"]
    distmat = np.asarray(jax_distmat(qf, gf))
    cmc, mAP = jax_evaluate_rank(distmat, qp, gp, qc, gc)
    return dict(params=params, stats=stats, qf=qf, gf=gf, distmat=distmat,
                cmc=cmc, mAP=mAP)


def test_datamanager_matches_jax(managers):
    dm, jdm = managers
    assert dm.num_train_pids == jdm.num_train_pids == 6
    assert dm.num_streams == jdm.num_streams == 3
    for split in ("query", "gallery"):
        ours = list(dm.test_loader["synthetic_mm"][split])
        theirs = list(jdm.test_loader["synthetic_mm"][split])
        assert len(ours) == len(theirs) == (2 if split == "query" else 3)
        for a, b in zip(ours, theirs):
            assert a["impath"] == b["impath"]
            np.testing.assert_array_equal(a["pid"], b["pid"])
            np.testing.assert_array_equal(a["camid"], b["camid"])
            for x, y in zip(a["img"], b["img"]):
                assert x.dtype == np.uint8
                np.testing.assert_array_equal(x, y)
    # the train loader: the same sampler draw (RandomSampler, seed 0) and,
    # with drop_last, no batch of 32 from 12 items
    assert list(dm.train_loader.sampler) == list(jdm.train_loader.sampler)
    assert len(dm.train_loader) == len(jdm.train_loader) == 0


def test_threaded_loader_delivers_the_same_batches_in_order(managers):
    dm, _ = managers
    loader = dm.test_loader["synthetic_mm"]["gallery"]
    threaded = DataLoader(loader.dataset, loader.sampler, batch_size=5,
                          workers=3, prefetch=1)
    serial = DataLoader(loader.dataset, loader.sampler, batch_size=5)
    assert len(threaded) == len(serial) == 3  # 12 items, ragged tail
    ours, theirs = list(threaded), list(serial)
    assert len(ours) == 3
    for a, b in zip(ours, theirs):
        assert a["impath"] == b["impath"]
        np.testing.assert_array_equal(a["pid"], b["pid"])
        for x, y in zip(a["img"], b["img"]):
            np.testing.assert_array_equal(x, y)


def test_test_transform_matches_jax(managers):
    dm, jdm = managers
    batch = next(iter(dm.test_loader["synthetic_mm"]["query"]))["img"][0]
    got = dm.transform_te(torch.from_numpy(batch))
    assert got.shape == (4, 3, 96, 32)
    want = np.asarray(jdm.transform_te(batch))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6, atol=1e-6)


def test_engine_eval_matches_jax_pipeline(managers, jax_reference):
    dm, _ = managers
    ref = jax_reference
    model = build_model("ieee3modalPart", dm.num_train_pids, "margin",
                        pretrained=False, dtype="float32",
                        backbone_layers=LAYERS, device="cpu")
    load_jax_variables(model, ref["params"], ref["stats"])
    engine = Engine(dm, model, device="cpu", fused_eval=False)
    loaders = dm.test_loader["synthetic_mm"]
    qf, qp, qc = engine._feature_extraction(loaders["query"])
    gf, gp, gc = engine._feature_extraction(loaders["gallery"])
    # features: the eval-feature bound of the JAX suite
    np.testing.assert_allclose(qf.numpy(), ref["qf"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(gf.numpy(), ref["gf"], rtol=2e-4, atol=2e-4)
    distmat = compute_distance_matrix(qf, gf)
    np.testing.assert_allclose(distmat.numpy(), ref["distmat"], rtol=1e-4,
                               atol=1e-4 * np.abs(ref["distmat"]).max())
    cmc, mAP = evaluate_rank(distmat, qp, gp, qc, gc)
    np.testing.assert_allclose(cmc, ref["cmc"], rtol=0, atol=1e-6)
    assert abs(mAP - ref["mAP"]) < 1e-6
    rank1 = engine.test()
    assert abs(rank1 - float(ref["cmc"][0])) < 1e-6


def test_cli_evaluates_on_cpu(tmp_path, capsys):
    argv = ["--config-file",
            os.path.join(ROOT, "configs", "rgbnt_ieee_part_margin.yaml"),
            "--device", "cpu", "model.pretrained", "False",
            "data.sources", "['synthetic_mm']",
            "data.targets", "['synthetic_mm']",
            "data.height", "64", "data.width", "32",
            "data.save_dir", str(tmp_path), "test.evaluate", "True",
            "test.batch_size", "16"]
    rank1 = main_multimodal.main(argv)
    out = capsys.readouterr().out
    assert 0.0 <= rank1 <= 1.0
    assert "mAP:" in out and "Rank-1" in out
    assert any(f.startswith("test.log") for f in os.listdir(tmp_path))
    assert os.path.isfile(tmp_path / "metrics.jsonl")


def test_cli_refuses_what_this_slice_does_not_run(tmp_path):
    base = ["--config-file",
            os.path.join(ROOT, "configs", "rgbnt_ieee_part_margin.yaml"),
            "--device", "cpu", "model.pretrained", "False",
            "data.sources", "['synthetic_mm']",
            "data.targets", "['synthetic_mm']",
            "data.height", "32", "data.width", "16",
            "data.save_dir", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="A.11"):  # fixbase
        main_multimodal.main(base + ["train.fixbase_epoch", "1",
                                     "train.max_epoch", "1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main_multimodal.main(["--device", "cuda"])
