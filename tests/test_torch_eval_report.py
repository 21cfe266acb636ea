"""The port's evaluation reporting against the JAX package's, on the CPU:
the CUHK03 and RegDB metrics and ``evaluate_rank``'s dispatch
(``ops/ranking.py``), the native C++ ranker (``native/ranking``), the
ranked-result strips and the t-SNE scatter (``utils/reidtools.py``),
``test.visrank`` through the engine and both CLIs, the activation maps
(``tools/visualize_actmap.py``), ``rank_speed_test``, ``parse_test_res``,
``RankLogger`` and the JSON helpers.

Inputs are made with numpy from seeds. The numpy and C++ metrics and the
images must equal the JAX package's exactly; the torch ranking within 1e-6.
"""

import functools
import importlib.util
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

import ieee_tpu.native.ranking as jax_native
from ieee_tpu.ops.ranking import eval_cuhk03_numpy as jax_cuhk03
from ieee_tpu.ops.ranking import eval_regdb as jax_regdb
from ieee_tpu.ops.ranking import evaluate_rank as jax_evaluate_rank
from ieee_tpu.utils import reidtools as jax_reidtools
from ieee_tpu.utils import tools as jax_tools
from ieee_tpu.utils.loggers import RankLogger as JaxRankLogger
from ieee_tpu_torch import main as single_main
from ieee_tpu_torch import main_multimodal
from ieee_tpu_torch.data import ImageDataManager
from ieee_tpu_torch.engine import Engine
from ieee_tpu_torch.engine import engine as engine_mod
from ieee_tpu_torch.models import build_model
from ieee_tpu_torch.native import ranking as native
from ieee_tpu_torch.ops import ranking
from ieee_tpu_torch.tools import parse_test_res, rank_speed_test
from ieee_tpu_torch.tools import visualize_actmap as actmap
from ieee_tpu_torch.utils import RankLogger, reidtools, tools

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = (1, 1, 1, 1)
H, W = 64, 32


def _jax_tool(name):
    """A script of the JAX package's ``tools/`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _problem(num_q, num_g, num_pids, seed, num_cams=3):
    rng = np.random.default_rng(seed)
    distmat = rng.random((num_q, num_g)).astype(np.float32)
    q_pids = rng.integers(0, num_pids, num_q)
    g_pids = rng.integers(0, num_pids, num_g)
    q_camids = rng.integers(0, num_cams, num_q)
    g_camids = rng.integers(0, num_cams, num_g)
    return distmat, q_pids, g_pids, q_camids, g_camids


# -------------------------------------------------------------- metrics ----

@pytest.mark.parametrize("shape", [(12, 80, 8, 3, 10), (6, 7, 4, 5, 20)],
                         ids=["12x80", "max_rank_above_num_g"])
def test_cuhk03_metric_equals_jax(shape):
    num_q, num_g, num_pids, seed, max_rank = shape
    prob = _problem(num_q, num_g, num_pids, seed)
    cmc, mAP = ranking.eval_cuhk03_numpy(*prob, max_rank=max_rank, rng=0)
    cmc_j, mAP_j = jax_cuhk03(*prob, max_rank=max_rank, rng=0)
    assert cmc.dtype == cmc_j.dtype and cmc.shape == (min(max_rank, num_g),)
    np.testing.assert_array_equal(cmc, cmc_j)
    assert mAP == mAP_j


def test_regdb_metric_equals_jax():
    d, q_pids, g_pids, _, _ = _problem(10, 30, 5, 11)
    cmc, mAP = ranking.eval_regdb(d, q_pids, g_pids, max_rank=10)
    cmc_j, mAP_j = jax_regdb(d, q_pids, g_pids, max_rank=10)
    np.testing.assert_array_equal(cmc, cmc_j)
    assert mAP == mAP_j


@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    """The JAX package's ranker, built from its source into a directory of
    this test's own (the JAX loader writes next to its source, which other
    test processes may be building at the same time)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "_LIB",
               str(tmp_path_factory.mktemp("jax_rank") / "librank.so"))
    mp.setattr(jax_native, "_lib", None)
    yield jax_native.eval_market1501_native
    mp.undo()


@pytest.fixture
def seeded_cuhk03_draws(monkeypatch):
    """``evaluate_rank``'s CUHK03 branch draws from ``default_rng(None)``
    in both packages: seed it alike for the comparison."""
    orig = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda seed=None: orig(0 if seed is None else seed))


@pytest.mark.parametrize("kw", [
    {"use_metric_cuhk03": True}, {"use_cython": True},
    {"use_device": True}, {"use_device": False}],
    ids=["cuhk03", "cython", "device", "numpy"])
def test_evaluate_rank_dispatch_matches_jax(kw, seeded_cuhk03_draws,
                                            jax_native_lib):
    prob = _problem(16, 60, 6, 21)
    # a CPU tensor distmat reaches the numpy and native branches as numpy
    d = torch.from_numpy(prob[0])
    cmc, mAP = ranking.evaluate_rank(d, *prob[1:], max_rank=20, **kw)
    cmc_j, mAP_j = jax_evaluate_rank(*prob, max_rank=20, **kw)
    np.testing.assert_allclose(cmc, cmc_j, rtol=0, atol=1e-6)
    assert abs(mAP - mAP_j) < 1e-6


def test_native_failure_warns_and_takes_the_device_path(monkeypatch):
    prob = _problem(8, 30, 4, 2)

    def fail():
        raise OSError("no compiler")

    monkeypatch.setattr(native, "load_library", fail)
    with pytest.warns(UserWarning, match="native ranking unavailable"):
        cmc, mAP = ranking.evaluate_rank(*prob, max_rank=10, use_cython=True)
    cmc_d, mAP_d = ranking.eval_market1501_device(*prob, max_rank=10)
    np.testing.assert_array_equal(cmc, cmc_d)
    assert mAP == mAP_d


# --------------------------------------------------------- native ranker ----

@pytest.mark.parametrize("shape", [(20, 100, 10, 7), (5, 40, 30, 8)],
                         ids=["dense", "queries_without_positives"])
def test_native_ranker_matches_numpy_and_jax(shape, jax_native_lib):
    num_q, num_g, num_pids, seed = shape
    prob = _problem(num_q, num_g, num_pids, seed)
    if seed == 8:  # query 0's id is in no gallery entry
        prob[1][0] = num_pids + 1
    cmc, mAP = native.eval_market1501_native(*prob, max_rank=20)
    cmc_np, mAP_np = ranking.eval_market1501_numpy(*prob, max_rank=20)
    np.testing.assert_allclose(cmc, cmc_np, rtol=0, atol=1e-6)
    assert abs(mAP - mAP_np) < 1e-6
    cmc_j, mAP_j = jax_native_lib(*prob, max_rank=20)
    np.testing.assert_array_equal(cmc, cmc_j)
    assert mAP == mAP_j


def test_native_ranker_all_missing_raises(jax_native_lib):
    d, _, g_pids, q_camids, g_camids = _problem(4, 10, 3, 1)
    q_pids = np.full(4, 99)
    with pytest.raises(ValueError, match="do not appear in gallery"):
        native.eval_market1501_native(d, q_pids, g_pids, q_camids, g_camids,
                                      5)
    with pytest.raises(AssertionError):
        jax_native_lib(d, q_pids, g_pids, q_camids, g_camids, 5)


def test_native_second_load_does_not_rebuild(monkeypatch):
    native.load_library()
    path = native._library_path()
    mtime = path.stat().st_mtime_ns

    def no_compiler(*a, **k):
        raise AssertionError("rebuilt")

    monkeypatch.setattr(native, "_state", {"lib": None, "seconds": None})
    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    native.load_library()
    assert native.build_seconds() is None
    assert path.stat().st_mtime_ns == mtime


def test_native_concurrent_builds_load_whole_libraries(tmp_path):
    """Processes that build at once each load a whole library."""
    code = (
        "import pathlib, sys, numpy as np\n"
        "from ieee_tpu_torch.native import ranking as r\n"
        "r.BUILD_ROOT = pathlib.Path(sys.argv[1])\n"
        "d = np.array([[0.1, 0.2], [0.3, 0.4]], np.float32)\n"
        "cmc, m = r.eval_market1501_native(d, [0, 1], [0, 1], [0, 0], "
        "[1, 1], 2)\n"
        "assert list(cmc) == [0.5, 1.0] and m == 0.75, (cmc, m)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, cwd=ROOT, stderr=subprocess.PIPE)
             for _ in range(4)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=120)[1].decode())
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert [p.returncode for p in procs] == [0] * 4, errs
    built = list(tmp_path.glob("rank-*/*"))
    assert [p.name for p in built] == ["librank.so"]  # no temporary left


# -------------------------------------------------------- visualisation ----

def _write_img(path, seed, h=H, w=W):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, (h, w, 3), np.uint8)).save(path)


def _tree_files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = np.asarray(Image.open(p))
    return out


def _assert_same_tree(a, b):
    fa, fb = _tree_files(a), _tree_files(b)
    assert sorted(fa) == sorted(fb) and fa
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_ranked_strips_equal_jax(tmp_path):
    # multi-modal entries (a path per modality; the strips show the first)
    def entries(split, n, seed):
        out = []
        for i in range(n):
            paths = [str(tmp_path / "img" / split / m / f"{i:04d}_c{i % 3}.jpg")
                     for m in ("RGB", "NI", "TI")]
            for j, p in enumerate(paths):
                _write_img(p, seed + 10 * i + j)
            out.append((paths, i % 4, i % 3, 0))
        return out

    query, gallery = entries("q", 5, 0), entries("g", 12, 100)
    distmat = np.random.default_rng(3).random((5, 12))  # tie-free
    for mod, out in ((reidtools, "port"), (jax_reidtools, "jax")):
        mod.visualize_ranked_results(distmat, (query, gallery), width=W,
                                     height=H, save_dir=str(tmp_path / out),
                                     topk=4)
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    strip = np.asarray(Image.open(tmp_path / "port" / "0000_c0.jpg"))
    assert strip.shape == (H + 10, (W + 10) * 5 + 90 + 3 * 10, 3)


def test_ranked_tracklets_equal_jax(tmp_path):
    def tracklet(tag, n=2):
        paths = []
        for i in range(n):
            p = str(tmp_path / "frames" / f"{tag}_{i}.jpg")
            _write_img(p, sum(map(ord, tag)) + i, 16, 8)
            paths.append(p)
        return tuple(paths)

    query = [(tracklet("q0"), 0, 0), (tracklet("q1"), 1, 0)]
    gallery = [(tracklet("g0"), 0, 1), (tracklet("g1"), 1, 1),
               (tracklet("g2"), 2, 1), (tracklet("g3"), 0, 0)]
    distmat = np.array([[0.1, 0.5, 0.9, 0.05], [0.8, 0.2, 0.4, 0.3]])
    for mod, out in ((reidtools, "port"), (jax_reidtools, "jax")):
        mod.visualize_ranked_results(distmat, (query, gallery),
                                     data_type="video",
                                     save_dir=str(tmp_path / out), topk=2)
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    assert sorted(os.listdir(tmp_path / "port" / "q0_0")) == [
        "gallery_top001_TRUE", "gallery_top002_FALSE", "query_top000"]


def test_tsne_scatter_equals_jax(tmp_path):
    pytest.importorskip("sklearn")
    rng = np.random.default_rng(5)
    labels = np.repeat(np.arange(4), 4)
    feats = (rng.standard_normal((4, 24))[labels]
             + 0.3 * rng.standard_normal((16, 24))).astype(np.float32)
    for mod, out in ((reidtools, "port.png"), (jax_reidtools, "jax.png")):
        mod.show_point_multi_modal(feats, labels,
                                   save_path=str(tmp_path / out),
                                   modal_dims=(8, 8, 8))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                                  np.asarray(Image.open(tmp_path / "jax.png")))


# ------------------------------------------------------- engine and CLI ----

def _market_name(p, j, split):
    cam = 1 + (j + (split in ("gallery", "bounding_box_test"))) % 6
    return f"{p:04d}_c{cam}s1_{j:06d}_00.jpg"


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A ``market1501_to_RGBNT201`` and a ``market1501`` tree of 64x32
    jpegs from a seed: 4 ids x 2 images in each split, test ids apart from
    train ids."""
    root = tmp_path_factory.mktemp("market")
    seed = iter(range(10 ** 6))
    for split, first in (("train", 1), ("query", 101), ("gallery", 101)):
        for p in range(first, first + 4):
            for j in range(2):
                name = _market_name(p, j, split)
                for modal in ("RGB", "NI", "TI"):
                    _write_img(str(root / "market1501_to_RGBNT201" / split
                                   / modal / name), next(seed))
    base = root / "market1501" / "Market-1501-v15.09.15"
    for split, first in (("bounding_box_train", 1), ("query", 101),
                         ("bounding_box_test", 101)):
        for p in range(first, first + 4):
            for j in range(2):
                _write_img(str(base / split / _market_name(p, j, split)),
                           next(seed))
    return str(root)


@pytest.fixture
def ranked(monkeypatch):
    """The distmats the engine ranks, seen at the name it calls."""
    seen = []
    real = engine_mod.evaluate_rank

    def spy(distmat, *args, **kw):
        seen.append(distmat)
        return real(distmat, *args, **kw)

    monkeypatch.setattr(engine_mod, "evaluate_rank", spy)
    return seen


@pytest.mark.parametrize("rerank", [False, True], ids=["plain", "rerank"])
def test_engine_visrank_strips_equal_jax_on_the_ranked_distmat(
        trees, tmp_path, ranked, rerank):
    dm = ImageDataManager(root=trees, sources="market_to_RGBNT201",
                          height=H, width=W, batch_size_test=4, workers=0,
                          verbose=False, seed=0)
    model = build_model("ieee3modalPart", dm.num_train_pids, "margin",
                        pretrained=False, dtype="float32",
                        backbone_layers=LAYERS, device="cpu")
    eng = Engine(dm, model, device="cpu")
    loaders = dm.test_loader["market_to_RGBNT201"]
    eng._evaluate(dataset_name="market_to_RGBNT201",
                  query_loader=loaders["query"],
                  gallery_loader=loaders["gallery"], visrank=True,
                  visrank_topk=3, save_dir=str(tmp_path), rerank=rerank)
    (distmat,) = ranked
    distmat = (distmat.numpy() if isinstance(distmat, torch.Tensor)
               else distmat)
    td = dm.test_dataset["market_to_RGBNT201"]
    assert len(td["query"]) == 8 and len(td["gallery"]) == 8
    jax_reidtools.visualize_ranked_results(
        distmat, (td["query"], td["gallery"]), width=W, height=H,
        save_dir=str(tmp_path / "jax"), topk=3)
    _assert_same_tree(tmp_path / "visrank_market_to_RGBNT201",
                      tmp_path / "jax")
    try:
        import matplotlib  # noqa: F401
        import sklearn  # noqa: F401
    except ImportError:
        return
    assert (tmp_path / "tsne_market_to_RGBNT201.png").is_file()


@pytest.mark.parametrize("cli", ["main_multimodal", "main"])
def test_cli_visrank_and_cuhk03_metric(cli, trees, tmp_path, capsys,
                                       monkeypatch):
    opts = ["data.height", str(H), "data.width", str(W),
            "data.save_dir", str(tmp_path), "test.evaluate", "True",
            "test.batch_size", "4", "test.visrank", "True",
            "test.visrank_topk", "2", "cuhk03.use_metric_cuhk03", "True",
            "data.workers", "0", "model.pretrained", "False"]
    if cli == "main_multimodal":
        monkeypatch.setattr(main_multimodal, "build_model", functools.partial(
            main_multimodal.build_model, backbone_layers=LAYERS))
        config, name = "market_mm_margin.yaml", "market_to_RGBNT201"
    else:
        config, name = "market1501_softmax_r50.yaml", "market1501"
        opts += ["model.name", "resnet18"]
    rank1 = getattr(single_main if cli == "main" else main_multimodal,
                    "main")(["--config-file",
                             os.path.join(ROOT, "configs", config),
                             "--root", trees, "--device", "cpu", *opts])
    out = capsys.readouterr().out
    assert 0.0 <= rank1 <= 1.0 and "mAP:" in out
    strips = os.listdir(tmp_path / f"visrank_{name}")
    assert len(strips) == 8
    strip = np.asarray(Image.open(tmp_path / f"visrank_{name}" / strips[0]))
    assert strip.shape == (H + 10, (W + 10) * 3 + 90 + 10, 3)


# ------------------------------------------------------ activation maps ----

class _JaxStub:
    """The JAX tool's model: ``module.apply`` returns the seeded maps."""

    def __init__(self, maps):
        import jax.numpy as jnp

        module = type("M", (), {})()

        def apply(variables, imgs, train, return_featuremaps):
            b = (imgs[0] if isinstance(imgs, tuple) else imgs).shape[0]
            out = tuple(jnp.asarray(m[:b]) for m in maps)
            return out if isinstance(imgs, tuple) else out[0]

        module.apply = apply
        self.module = module


class _TorchStub(torch.nn.Module):
    """The port's model: NCHW bf16 channels_last maps of the same values."""

    def __init__(self, maps):
        super().__init__()
        self.maps = [torch.from_numpy(m).permute(0, 3, 1, 2) for m in maps]
        self.w = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x, return_featuremaps=False):
        assert return_featuremaps and not torch.is_grad_enabled()
        assert not self.training
        b = (x[0] if isinstance(x, tuple) else x).shape[0]
        out = tuple(m[:b].to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last) for m in self.maps)
        return out if isinstance(x, tuple) else out[0]


@pytest.mark.parametrize("modal,multi", [("RGB", True), ("TI", True),
                                         ("RGB", False)],
                         ids=["RGB", "TI", "single_modal"])
def test_visactmap_equals_jax(modal, multi, tmp_path):
    rng = np.random.default_rng(9)
    # bf16 values, so the port's bf16 maps hold the JAX maps exactly
    maps = [torch.from_numpy(rng.standard_normal((4, 8, 4, 32)).astype(
        np.float32)).to(torch.bfloat16).float().numpy() for _ in range(3)]
    batches = []
    for b_idx, n in enumerate((4, 3)):  # a full and a tail batch
        imgs = tuple(rng.integers(0, 256, (n, H, W, 3), np.uint8)
                     for _ in range(3))
        batches.append({
            "img": imgs if multi else imgs[0],
            "impath": [[f"/d/RGB/{b_idx}_{i}.jpg"] * 3 if multi
                       else f"/d/{b_idx}_{i}.jpg" for i in range(n)]})
    loader = {"synthetic_mm": {"query": batches}}
    written = actmap.visactmap(_TorchStub(maps), loader,
                               str(tmp_path / "port"), W, H, modal=modal,
                               device="cpu")
    assert len(written) == 7
    _jax_tool("visualize_actmap").visactmap(
        _JaxStub(maps), None, loader, str(tmp_path / "jax"), W, H,
        modal=modal)
    _assert_same_tree(tmp_path / "port", tmp_path / "jax")
    grid = np.asarray(Image.open(written[0]))
    assert grid.shape == (H, 3 * W + 20, 3)


def test_jet_table_equals_matplotlib():
    cm = pytest.importorskip("matplotlib.cm")
    levels = np.arange(256) / 255.0
    x = np.random.default_rng(0).random(1000).astype(np.float32)
    for v in (levels, levels.astype(np.float32), x):
        np.testing.assert_array_equal(
            actmap._colormap_jet(v),
            (cm.jet(v)[..., :3] * 255).astype(np.uint8))
    np.testing.assert_array_equal(actmap.JET_LUT,
                                  cm.jet(np.arange(256))[:, :3])


def test_visualize_actmap_main_on_cpu(tmp_path, monkeypatch):
    orig = actmap.imagedata_kwargs
    monkeypatch.setattr(actmap, "imagedata_kwargs", lambda cfg: {
        **orig(cfg), "num_pids": 4, "imgs_per_pid": 2})
    written = actmap.main([
        "--device", "cpu", "--save-dir", str(tmp_path),
        "model.name", "resnet18", "model.pretrained", "False",
        "data.sources", "['synthetic']", "data.targets", "['synthetic']",
        "data.height", str(H), "data.width", str(W), "data.workers", "0",
        "test.batch_size", "4"])
    assert written and len(os.listdir(tmp_path / "actmap_synthetic")) == len(
        written)
    assert np.asarray(Image.open(written[-1])).shape == (H, 3 * W + 20, 3)


# -------------------------------------------------------------- tools ----

def test_rank_speed_test_on_cpu(capsys):
    res = rank_speed_test.main(["--device", "cpu", "--num-q", "30",
                                "--num-g", "200", "--repeat", "1"])
    out = capsys.readouterr().out
    assert "all implementations agree" in out and "x vs numpy" in out
    assert set(res) == {"numpy", "native C++", "device (cpu)",
                        "native build s"}
    for name in ("native C++", "device (cpu)"):
        np.testing.assert_allclose(res[name][1], res["numpy"][1], atol=1e-6)


def _write_logs(root):
    for split, (m, r1) in enumerate(((46.4, 47.1), (44.4, 45.1))):
        d = root / f"split{split}"
        d.mkdir()
        (d / "test.log-2020").write_text(
            f"** Results **\nmAP: {m}%\nCMC curve\nRank-1  : {r1}%\n"
            "Rank-5  : 58.5%\nRank-10 : 64.2%\n")


def test_parse_test_res_equals_jax(tmp_path, capsys, monkeypatch):
    _write_logs(tmp_path)
    averages = parse_test_res.main([str(tmp_path)])
    out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["parse_test_res.py", str(tmp_path)])
    _jax_tool("parse_test_res").main()
    assert out == capsys.readouterr().out
    assert "mAP: 45.4%" in out and "r1: 46.1%" in out
    assert averages["mAP"] == pytest.approx(45.4)
    assert parse_test_res.main([str(tmp_path / "split0"),
                                "--suffix", "train.log"]) == {}


def test_rank_logger_equals_jax(capsys):
    outs = []
    for cls in (RankLogger, JaxRankLogger):
        rl = cls("synthetic", ["synthetic", "other"])
        rl.write("synthetic", 1, 0.5)
        rl.write("synthetic", 2, 0.625)
        rl.write("other", 2, 0.1)
        rl.show_summary()
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "- epoch 2\t rank1 62.5%" in outs[0]


def test_json_helpers_equal_jax(tmp_path):
    obj = {"a": [1, 2.5, "x"], "b": {"c": None}}
    tools.write_json(obj, str(tmp_path / "port" / "o.json"))
    jax_tools.write_json(obj, str(tmp_path / "jax" / "o.json"))
    assert ((tmp_path / "port" / "o.json").read_bytes()
            == (tmp_path / "jax" / "o.json").read_bytes())
    assert tools.read_json(str(tmp_path / "jax" / "o.json")) == obj
    assert tools.check_isfile(str(tmp_path / "port" / "o.json"))
    for mod in (tools, jax_tools):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert not mod.check_isfile(str(tmp_path / "missing.json"))
        assert any("No file found" in str(w.message) for w in caught)
