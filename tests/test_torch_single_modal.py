"""The single-modal path (``BASELINE.json`` configs[0]) against the JAX
package's, and through the port's CLI.

- The engine's single-stream train step at the config's batch 32, in two
  micro-batches (``train.accum_steps 2``, the single-stream branch of
  ``_accum_grads``), against the JAX ``ImageSoftmaxEngine``'s jitted step:
  resnet18 at ``layers=(1, 1, 1, 1)`` in f32, 64x32 ``synthetic`` images,
  SGD; metrics within 1e-4, each update within 2e-2 in relative norm,
  running statistics within 1e-4.
- The engine's feature extraction at test batch 32 (the 16-image query
  set padded to it) for a 512-d (resnet18) and a 2048-d (resnet50) model,
  against the JAX engine's (2e-4); then ``compute_distance_matrix`` and
  ``evaluate_rank`` on those features against the JAX package's distmat
  and ``eval_market1501_numpy``.
- ``python -m ieee_tpu_torch.main --device cpu`` on
  ``configs/market1501_softmax_r50.yaml`` (resnet50 at full depth, adam)
  at 64x32 on ``synthetic`` for one short epoch: the single-modal engine,
  finite mAP and CMC; with ``--device cuda`` and no card it refuses.
"""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ieee_tpu.data import ImageDataManager as JaxImageDataManager
from ieee_tpu.engine import ImageSoftmaxEngine as JaxSoftmaxEngine
from ieee_tpu.models.base import ReIDModel
from ieee_tpu.ops.distance import compute_distance_matrix as jax_distmat
from ieee_tpu.ops.ranking import eval_market1501_numpy
from ieee_tpu.optim import build_optimizer as jax_build_optimizer
from ieee_tpu.parallel import make_mesh
from ieee_tpu_torch import main as port_main
from ieee_tpu_torch.config import get_default_config
from ieee_tpu_torch.data import ImageDataManager
from ieee_tpu_torch.engine import ImageSoftmaxEngine, build_engine
from ieee_tpu_torch.models.weights import (
    _reid_resnet_to_state_dict,
    load_jax_variables,
)
from ieee_tpu_torch.ops import compute_distance_matrix, evaluate_rank
from ieee_tpu_torch.ops import kernels
from ieee_tpu_torch.optim import build_optimizer, set_lr

from test_torch_resnet_zoo import (
    H,
    W,
    _jax_module,
    _port_model,
    _random_variables,
)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "market1501_softmax_r50.yaml")
LR = 0.01
DATA = dict(sources="synthetic", height=H, width=W, batch_size_train=32,
            batch_size_test=32, workers=0, train_sampler="RandomSampler",
            num_pids=16, imgs_per_pid=4, transforms=[], verbose=False,
            seed=0)
OPTIM = dict(optim="sgd", lr=LR, momentum=0.9, weight_decay=5e-4)


def _engines(name, seed, **engine_kw):
    """A JAX and a port ImageSoftmaxEngine on the same random weights."""
    jdm = JaxImageDataManager(**DATA)
    module = _jax_module(name, jdm.num_train_pids)
    params, stats = _random_variables(module, seed=seed)
    jeng = JaxSoftmaxEngine(
        jdm, ReIDModel(module=module, name=name,
                       num_classes=jdm.num_train_pids, loss="softmax"),
        optimizer=jax_build_optimizer(**OPTIM),
        variables={"params": params, "batch_stats": stats},
        mesh=make_mesh([1]), donate=False, seed=0, label_smooth=True,
        **engine_kw)
    dm = ImageDataManager(**DATA)
    model = _port_model(name, dm.num_train_pids)
    load_jax_variables(model, params, stats)
    eng = ImageSoftmaxEngine(dm, model, build_optimizer(model, **OPTIM),
                             device="cpu", seed=0, **engine_kw)
    set_lr(eng.optimizer, LR)
    return jeng, (params, stats), eng


def test_build_engine_gives_the_single_modal_engine():
    cfg = get_default_config()
    cfg.merge_from_file(CONFIG)
    dm = ImageDataManager(**DATA)
    model = _port_model("resnet18", dm.num_train_pids)
    eng = build_engine(cfg, dm, model, device="cpu")
    assert type(eng) is ImageSoftmaxEngine and dm.num_streams == 1


def test_batch32_step_in_two_micro_batches_matches_jax():
    jeng, (params, stats), eng = _engines("resnet18", seed=7, accum_steps=2)
    jbatch = next(iter(jeng.datamanager.train_loader))
    s1, m1 = jeng._build_train_step()(jeng.state, *jeng._put_batch(jbatch),
                                      jax.random.PRNGKey(0), LR, None)
    batch = next(iter(eng.train_loader))
    assert batch["impath"] == jbatch["impath"]
    assert batch["img"].shape == (32, H, W, 3)
    model = eng.model
    old = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = eng.train_step(*eng._put_batch(batch))
    for k in ("acc", "loss"):
        np.testing.assert_allclose(float(metrics[k]), float(m1[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    w_old = _reid_resnet_to_state_dict(params, stats)
    w_new = _reid_resnet_to_state_dict(*jax.tree_util.tree_map(
        np.asarray, (s1.params, s1.batch_stats)))
    got = model.state_dict()
    trainable = {k for k, _ in model.named_parameters()}
    for k, want in w_new.items():
        want = np.asarray(want, np.float32)
        g = got[k].numpy()
        if k not in trainable:  # the running statistics, chained twice
            np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
            continue
        d_want = want - np.asarray(w_old[k], np.float32)
        rel = (np.linalg.norm(g - old[k].numpy() - d_want)
               / np.linalg.norm(d_want))
        assert rel <= 2e-2, (k, rel)
    assert int(model.bn1.num_batches_tracked) == 2


@pytest.mark.parametrize("name,dim", [("resnet18", 512), ("resnet50", 2048)])
def test_eval_features_distmat_and_ranking_match_jax(name, dim):
    jeng, _, eng = _engines(name, seed=9)
    for split, n in (("query", 16), ("gallery", 32)):
        jloader = jeng.datamanager.test_loader["synthetic"][split]
        loader = eng.test_loader["synthetic"][split]
        want, jp, jc = jeng._feature_extraction(jloader)
        got, pids, cams = eng._feature_extraction(loader)
        assert got.shape == want.shape == (n, dim)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
        assert np.array_equal(pids, jp) and np.array_equal(cams, jc)
        if split == "query":
            qf, q = got, (pids, cams)
        else:
            gf, g = got, (pids, cams)
    distmat = compute_distance_matrix(qf, gf)
    want_d = np.asarray(jax_distmat(qf.numpy(), gf.numpy()))
    np.testing.assert_allclose(distmat.numpy(), want_d, rtol=1e-5,
                               atol=1e-5 * np.abs(want_d).max())
    cmc, mAP = evaluate_rank(distmat, q[0], g[0], q[1], g[1])
    want_cmc, want_map = eval_market1501_numpy(want_d, q[0], g[0], q[1],
                                               g[1], 50)
    np.testing.assert_allclose(cmc, want_cmc, atol=1e-6)
    np.testing.assert_allclose(mAP, want_map, atol=1e-6)


def test_cli_market1501_softmax_r50_on_cpu(tmp_path, capsys):
    kernels.reset_launch_counts()
    rank1 = port_main.main([
        "--config-file", CONFIG, "--device", "cpu",
        "model.pretrained", "False",
        "data.sources", "['synthetic']", "data.targets", "['synthetic']",
        "data.height", "64", "data.width", "32",
        "data.save_dir", str(tmp_path), "train.max_epoch", "1",
        "train.print_freq", "1", "data.workers", "0"])
    out = capsys.readouterr().out
    assert "Building model: resnet50" in out
    assert "Building softmax-engine for image-reid" in out
    # 16 ids x 8 images: 4 steps of the config's batch 32
    assert out.count("epoch: [1/1]") == 4 and "acc" in out
    assert "Done, obtained 16-by-2048 matrix" in out
    assert "Done, obtained 32-by-2048 matrix" in out
    mAP = float(out.split("mAP: ")[1].split("%")[0])
    cmc = [float(out.split(f"Rank-{r:<3}: ")[1].split("%")[0])
           for r in (1, 5, 10, 20)]
    assert np.isfinite([mAP] + cmc).all() and 0.0 <= rank1 <= 1.0
    assert cmc == sorted(cmc)
    assert not any(kernels.launch_counts().values())  # CPU: plain versions
    assert (tmp_path / "model" / "model.pth.tar-1").is_file()
    shutil.rmtree(tmp_path, ignore_errors=True)  # ~300 MB with moments


def test_main_module_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot show")
    run = subprocess.run(
        [sys.executable, "-m", "ieee_tpu_torch.main", "--config-file",
         CONFIG, "data.save_dir", str(tmp_path)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert "CUDA is not available" in run.stderr
