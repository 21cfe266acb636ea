"""The port's training path as a whole against the JAX package: one train
step of the IEEE model on the same weights and batch, and the CLI training
run on the CPU.

The JAX side is ``Image3MEngine``'s own jitted step (``_build_train_step``)
on one device, at ``backbone_layers=(1, 1, 1, 1)`` in f32 on random numpy
weights (``test_torch_model._random_variables``), 64x32 images, batch 8
(P = 2 ids x K = 4) from the RandomIdentitySampler, augmentation off, SGD
with nesterov momentum and weight decay (the headline config's optimizer).
The port takes the same step through its engine API; its post-step
``state_dict`` goes back through ``ieee_tpu.models.ieee_converter``. The
fused path (the kernels' plain versions here) trains in the CLI test; its
step is held to the plain step on the card (``chip_smoke.py`` phase 7).
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ieee_tpu.data import ImageDataManager as JaxImageDataManager
from ieee_tpu.engine import Image3MEngine as JaxImage3MEngine
from ieee_tpu.models import build_model as jax_build_model
from ieee_tpu.models.ieee_converter import convert_ieee_torch_checkpoint
from ieee_tpu.optim import build_lr_scheduler as jax_build_lr_scheduler
from ieee_tpu.optim import build_optimizer as jax_build_optimizer
from ieee_tpu.parallel import make_mesh
from ieee_tpu_torch import main_multimodal
from ieee_tpu_torch.data import ImageDataManager
from ieee_tpu_torch.engine import Image3MEngine
from ieee_tpu_torch.models import build_model
from ieee_tpu_torch.models.weights import load_jax_variables
from ieee_tpu_torch.optim import build_lr_scheduler, build_optimizer, set_lr

from test_torch_model import _random_variables
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = (1, 1, 1, 1)
LR = 0.01
DATA = dict(sources="synthetic_mm", height=64, width=32, batch_size_train=8,
            batch_size_test=8, workers=0,
            train_sampler="RandomIdentitySampler", num_instances=4,
            num_pids=4, imgs_per_pid=4, transforms=[], verbose=False, seed=0)
OPTIM = dict(optim="sgd", lr=LR, momentum=0.9, weight_decay=5e-4,
             sgd_nesterov=True)
ENGINE = dict(margin=1.0, label_smooth=True, seed=0)
METRICS = ("loss", "LossM", "LossX", "lossR", "lossN", "lossT", "accR",
           "accN", "accT")


@pytest.fixture(scope="module")
def jax_step():
    """The JAX step's inputs and results, numpy only."""
    jdm = JaxImageDataManager(**DATA)
    m = jax_build_model("ieee3modalPart", num_classes=jdm.num_train_pids,
                        loss="margin", pretrained=False,
                        backbone_layers=LAYERS, dtype=jnp.float32)
    params, stats = _random_variables(m.module, seed=4)
    eng = JaxImage3MEngine(
        jdm, m, optimizer=jax_build_optimizer(**OPTIM),
        scheduler=jax_build_lr_scheduler("multi_step", stepsize=[20, 40],
                                         base_lr=LR),
        variables={"params": params, "batch_stats": stats},
        mesh=make_mesh([1]), donate=False, **ENGINE)
    batch = next(iter(jdm.train_loader))
    imgs, pids = eng._put_batch(batch)
    state, metrics = eng._build_train_step()(
        eng.state, imgs, pids, jax.random.PRNGKey(0), LR, None)
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(params=params, stats=stats, batch=batch,
                metrics={k: float(v) for k, v in metrics.items()},
                new_params=to_np(state.params),
                new_stats=to_np(state.batch_stats))


def _port_engine(ref, **model_kw):
    dm = ImageDataManager(**DATA)
    model = build_model("ieee3modalPart", dm.num_train_pids, "margin",
                        pretrained=False, dtype="float32",
                        backbone_layers=LAYERS, device="cpu", **model_kw)
    load_jax_variables(model, ref["params"], ref["stats"])
    opt = build_optimizer(model, **OPTIM)
    sched = build_lr_scheduler("multi_step", stepsize=[20, 40], base_lr=LR)
    eng = Image3MEngine(dm, model, opt, sched, device="cpu", **ENGINE)
    return dm, model, eng


def test_train_step_matches_jax(jax_step):
    ref = jax_step
    dm, model, eng = _port_engine(ref)
    batch = next(iter(dm.train_loader))
    # the sampler's copy draws the same P x K batch for the same seed
    assert batch["impath"] == ref["batch"]["impath"]
    np.testing.assert_array_equal(batch["pid"], ref["batch"]["pid"])
    imgs, pids = eng._put_batch(batch)
    set_lr(eng.optimizer, eng.scheduler(0))
    metrics = eng.train_step(imgs, pids)
    assert set(metrics) == set(METRICS) == set(ref["metrics"])
    # f32 on both sides, other summation orders: 1e-4 relative; accuracies
    # are counts of argmax hits and agree exactly
    for k in METRICS:
        np.testing.assert_allclose(float(metrics[k]), ref["metrics"][k],
                                   rtol=1e-4, atol=1e-5, err_msg=k)

    p_got, s_got = convert_ieee_torch_checkpoint(
        {k: v.detach() for k, v in model.state_dict().items()},
        layers=LAYERS)
    # the step's update (new - old) per tensor, in relative norm: 2e-2.
    # Both sides are f32, but the forward maps differ by ~1e-5 relative
    # (other summation orders), so now and then a ReLU input within that
    # noise of 0 takes the other branch, and one such element moves a BN
    # backward's sums; the largest such error measured is 8e-3. Every
    # tensor moves, REM's conv_query/conv_value by weight decay alone
    flat = jax.tree_util.tree_flatten_with_path
    olds = dict(flat(ref["params"])[0])
    wants = dict(flat(ref["new_params"])[0])
    gots = dict(flat(p_got)[0])
    assert wants.keys() == gots.keys() == olds.keys()
    for path, want in wants.items():
        old = np.asarray(olds[path])
        d_want, d_got = want - old, np.asarray(gots[path]) - old
        assert np.abs(d_want).max() > 0, path
        rel = np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want)
        assert rel <= 2e-2, (jax.tree_util.keystr(path), rel)
    # running statistics after the step's update (momentum 0.9)
    for path, want in flat(ref["new_stats"])[0]:
        got = dict(flat(s_got)[0])[path]
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                                   atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_cli_trains_on_cpu(tmp_path, capsys, monkeypatch):
    # the headline config through the CLI: 1 epoch on a tiny synthetic_mm
    # (4 ids x 4 images: 2 steps of 8), the trunks cut to one block per
    # stage, then the final eval and a reference-format checkpoint
    orig = main_multimodal.imagedata_kwargs
    monkeypatch.setattr(main_multimodal, "imagedata_kwargs", lambda cfg: {
        **orig(cfg), "num_pids": 4, "imgs_per_pid": 4})
    monkeypatch.setattr(main_multimodal, "build_model", functools.partial(
        main_multimodal.build_model, backbone_layers=LAYERS))
    argv = ["--config-file",
            os.path.join(ROOT, "configs", "rgbnt_ieee_part_margin.yaml"),
            "--device", "cpu", "model.pretrained", "False",
            "data.sources", "['synthetic_mm']",
            "data.targets", "['synthetic_mm']",
            "data.height", "64", "data.width", "32",
            "data.save_dir", str(tmp_path), "train.max_epoch", "1",
            "train.print_freq", "1", "test.batch_size", "16"]
    rank1 = main_multimodal.main(argv)
    out = capsys.readouterr().out
    assert 0.0 <= rank1 <= 1.0
    assert out.count("epoch: [1/1]") == 2 and "mAP:" in out
    assert "Rank-1" in out
    ckpt = torch.load(tmp_path / "model" / "model.pth.tar-1",
                      weights_only=False)
    assert set(ckpt) == {"state_dict", "epoch", "rank1"}
    assert ckpt["epoch"] == 1 and abs(ckpt["rank1"] - rank1) < 1e-9
    assert os.path.isfile(tmp_path / "model" / "model-best.pth.tar")
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert '"train_epoch"' in lines[0] and '"eval"' in lines[1]
