"""The port's image datasets against the JAX package's.

- Each parser (market1501, with and without its 500k distractors,
  market_to_RGBNT201, AllDay with its test layout, UAVdata) on a small
  on-disk tree built here (as ``tests/test_dataset_parsers.py`` builds
  them): the same ``(paths, pid, camid[, timeid])`` lists as the JAX
  parser, exactly, and the same decoded pixels.
- ``Synthetic``: the JAX set's items and pixels, bit for bit.
- The registry holds the JAX registry's names for every ported set.
- ``configs/market_mm_margin.yaml`` (``BASELINE.json`` configs[4]) through
  the port's CLI on a ``market1501_to_RGBNT201`` tree, with the kernel
  flags on (their plain versions on the CPU), trunks of one block a stage.
"""

import functools
import os
import os.path as osp
import shutil

import numpy as np
import pytest
from PIL import Image

from ieee_tpu.data import datasets as jax_datasets
from ieee_tpu.data import init_image_dataset as jax_init_image_dataset
from ieee_tpu.data.datasets.image.synthetic import Synthetic as JaxSynthetic
from ieee_tpu_torch import main_multimodal
from ieee_tpu_torch.data import ImageDataManager, ImageDataset
from ieee_tpu_torch.data import datasets, init_image_dataset
from ieee_tpu_torch.data.datasets.image.synthetic import Synthetic

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(verbose=False, height=32, width=16)


def _write_jpg(path, seed=0, h=40, w=20):
    os.makedirs(osp.dirname(path), exist_ok=True)
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 255, (h, w, 3), np.uint8)).save(path)


def _market_names(pids, cams, n_per):
    return [f"{p:04d}_c{c}s1_{p * 100 + j:06d}_0{j}.jpg"
            for p in pids for j in range(n_per)
            for c in [cams[(p + j) % len(cams)]]]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """market1501 (junk -1 and background 0, 500k distractors under
    images/), market1501_to_RGBNT201, AllDay and UAVdata, in one root."""
    root = tmp_path_factory.mktemp("datasets")
    seed = iter(range(10 ** 6))
    base = root / "market1501" / "Market-1501-v15.09.15"
    for d, names in (
            ("bounding_box_train", _market_names((2, 7, 11, 1501), (1, 3, 6), 3)),
            ("query", _market_names((2, 7), (2, 5), 1)),
            ("bounding_box_test", _market_names((2, 7, 0), (1, 4), 2)
             + ["-1_c1s1_000401_03.jpg", "-1_c6s2_000402_01.jpg"]),
            ("images", _market_names((1000, 1001), (1, 2), 1))):
        for n in names:
            _write_jpg(str(base / d / n), next(seed))
    mm = root / "market1501_to_RGBNT201"
    for split, pids, n_per in (("train", (3, 5, 9, 12), 4),
                               ("query", (21, 22), 1),
                               ("gallery", (21, 22, 0), 3)):
        names = _market_names(pids, (1, 2, 3, 6), n_per)
        if split == "gallery":
            names.append("-1_c2s1_000001_00.jpg")
        for modal in ("RGB", "NI", "TI"):
            for n in names:
                _write_jpg(str(mm / split / modal / n), next(seed), 64, 32)
    ad = root / "AllDay"
    for split, modals in (("train", ("RGB", "NI", "TI")),
                          ("test", ("RGB", "NI_change_ID_final",
                                    "TI_change_ID_final"))):
        names = [f"{p:06d}_cam{c}_{t}_{j}.jpg" for p, c, t, j in
                 ((1, 1, 1, 0), (1, 3, 2, 1), (4, 2, 2, 0), (9, 4, 1, 0))]
        for modal in modals:
            for n in names:
                _write_jpg(str(ad / split / modal / n), next(seed))
    uav = root / "UAVdata"
    for split in ("train", "query", "gallery"):
        for modal in ("RGB", "Gray"):
            for n in ("p001a.jpg", "p002b.jpg", "p001c.jpg", "p017a.jpg"):
                _write_jpg(str(uav / split / modal / n), next(seed))
    return str(root)


@pytest.mark.parametrize("name,kwargs", [
    ("market1501", {}), ("market1501", {"market1501_500k": True}),
    ("market_to_RGBNT201", {}), ("AllDay", {}), ("UAVdata", {})])
def test_parser_matches_jax(trees, name, kwargs):
    for mode in ("train", "query", "gallery"):
        ours = init_image_dataset(name, root=trees, mode=mode, **KW, **kwargs)
        theirs = jax_init_image_dataset(name, root=trees, mode=mode, **KW,
                                        **kwargs)
        for split in ("train", "query", "gallery"):
            assert getattr(ours, split) == getattr(theirs, split), split
        assert ours.num_train_pids == theirs.num_train_pids
        assert ours.num_train_cams == theirs.num_train_cams
        assert ours._junk_pids == theirs._junk_pids
        assert len(ours) == len(theirs) > 0
        a, b = ours[len(ours) - 1], theirs[len(theirs) - 1]
        assert a.keys() == b.keys()
        for k in a:
            if k == "img" and isinstance(a[k], list):
                assert all(np.array_equal(x, y) for x, y in zip(a[k], b[k]))
            elif k == "img":
                assert np.array_equal(a[k], b[k]) and a[k].shape == (32, 16, 3)
            else:
                assert a[k] == b[k], k


def test_market1501_drops_junk_and_keeps_the_background(trees):
    ds = init_image_dataset("market1501", root=trees, mode="gallery", **KW)
    assert isinstance(ds, ImageDataset)
    pids = {item[1] for item in ds.gallery}
    assert -1 not in pids and 0 in pids
    assert ds.num_train_pids == 4 and {i[1] for i in ds.train} == {0, 1, 2, 3}
    assert {i[2] for i in ds.train} <= set(range(6))
    big = init_image_dataset("market1501", root=trees, mode="gallery",
                             market1501_500k=True, **KW)
    assert len(big.gallery) == len(ds.gallery) + 2
    with pytest.raises(RuntimeError, match="is not found"):
        init_image_dataset("market1501", root=str(trees) + "/nothing", **KW)


def test_allday_test_layout_and_timeids(trees):
    ds = init_image_dataset("AllDay", root=trees, mode="query", **KW)
    assert [i[3] for i in ds.train] == [1, 2, 2, 1]  # timeid, dsetid slot
    paths = ds.query[0][0]
    assert "NI_change_ID_final" in paths[1] and "TI_change_ID_final" in paths[2]
    assert "NI_change_ID_final" not in ds.train[0][0][1]
    assert ds[0]["timeid"] == ds.query[0][3]


def test_synthetic_gives_the_jax_pixels_bit_for_bit():
    for kw in ({}, {"correlated": True}, {"heldout_test": True, "seed": 3}):
        for mode in ("train", "query", "gallery"):
            ours = Synthetic(mode=mode, height=24, width=12, num_pids=6, **kw)
            theirs = JaxSynthetic(mode=mode, height=24, width=12, num_pids=6,
                                  **kw)
            assert ours.data == theirs.data
            for i in (0, len(ours) // 2, len(ours) - 1):
                a, b = ours[i], theirs[i]
                assert a["img"].dtype == np.uint8
                assert np.array_equal(a["img"], b["img"])
                assert (a["pid"], a["camid"], a["impath"]) == (
                    b["pid"], b["camid"], b["impath"])


def test_sum_of_single_modal_sets_stays_single_modal():
    a = Synthetic(num_pids=4, seed=0)
    b = Synthetic(num_pids=3, seed=1)
    ja, jb = JaxSynthetic(num_pids=4, seed=0), JaxSynthetic(num_pids=3, seed=1)
    ours, theirs = a + b, ja + jb
    assert type(ours).__name__ == type(theirs).__name__ == "ImageDataset"
    assert ours.train == theirs.train and ours.num_train_pids == 7


def test_registry_names_are_the_jax_names():
    ours = vars(datasets)["__image_datasets"]
    theirs = vars(jax_datasets)["__image_datasets"]
    assert set(ours) == {"market1501", "RGBNT201", "market_to_RGBNT201",
                         "AllDay", "UAVdata", "synthetic", "synthetic_mm"}
    for name, cls in ours.items():
        assert theirs[name].__name__ == cls.__name__, name


def test_datamanager_single_stream(trees):
    dm = ImageDataManager(root=trees, sources="market1501", height=32,
                          width=16, batch_size_train=4, batch_size_test=3,
                          workers=0, seed=0, verbose=False)
    assert dm.num_streams == 1 and dm.num_train_pids == 4
    batch = next(iter(dm.train_loader))
    assert batch["img"].shape == (4, 32, 16, 3)
    assert batch["img"].dtype == np.uint8
    q = dm.test_loader["market1501"]["query"]
    assert [b["img"].shape[0] for b in q] == [2]


@pytest.fixture
def tiny_ieee(monkeypatch):
    monkeypatch.setattr(main_multimodal, "build_model", functools.partial(
        main_multimodal.build_model, backbone_layers=(1, 1, 1, 1)))


def test_cli_market_mm_margin_trains_and_evaluates(trees, tiny_ieee,
                                                   tmp_path, capsys):
    rank1 = main_multimodal.main([
        "--config-file", os.path.join(ROOT, "configs",
                                      "market_mm_margin.yaml"),
        "--root", trees, "--device", "cpu", "model.pretrained", "False",
        "data.height", "64", "data.width", "32",
        "data.save_dir", str(tmp_path), "train.max_epoch", "1",
        "train.print_freq", "1", "test.batch_size", "4",
        "cuda.fused_1x1", "True", "cuda.fused_eval", "True"])
    out = capsys.readouterr().out
    assert "Building margin-engine" in out and "LossM" in out
    assert out.count("epoch: [1/1]") == 2  # 16 images, batch 8
    assert "Done, obtained 2-by-2304 matrix" in out
    assert "Done, obtained 9-by-2304 matrix" in out  # -1 junk dropped
    assert "mAP:" in out and 0.0 <= rank1 <= 1.0
    assert (tmp_path / "model" / "model.pth.tar-1").is_file()
    shutil.rmtree(tmp_path, ignore_errors=True)  # ~250 MB with moments
