"""Checkpoints and resume in the port (``ieee_tpu_torch/utils/checkpoint.py``,
``Engine.run``'s ``resume``, ``save_freq`` and ``save_best``), at
``backbone_layers=(1, 1, 1, 1)`` on the CPU.

Two epochs straight must equal one epoch, a resume and one epoch, bit for
bit: weights, running statistics and SGD moments. The resumed run's
loader is taken through the first epoch's batches first, as the straight
run's was (the sampler's state is not saved, in either package), and
augmentation is off (the transform generator's state is not saved either,
as the JAX package does not save its transform key).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from ieee_tpu_torch.data import ImageDataManager
from ieee_tpu_torch.engine import MultiModalImageSoftmaxEngine
from ieee_tpu_torch.models import build_model
from ieee_tpu_torch.models.weights import load_reference_checkpoint
from ieee_tpu_torch.optim import build_lr_scheduler, build_optimizer
from ieee_tpu_torch.utils.checkpoint import (
    list_checkpoints,
    load_checkpoint,
    load_pretrained_weights,
    resume_from_checkpoint,
    save_checkpoint,
)

from torch_threads import one_torch_thread  # noqa: F401

LAYERS = (1, 1, 1, 1)
DATA = dict(sources="synthetic_mm", height=32, width=16, batch_size_train=8,
            batch_size_test=8, workers=0,
            train_sampler="RandomIdentitySampler", num_instances=4,
            num_pids=4, imgs_per_pid=4, transforms=[], verbose=False, seed=0)
BASE = dict(interaction=False, attention=False, using_REM=False)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    # each full-width checkpoint with its moments is about 250 MB
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _model(flags=BASE, num_classes=4, seed=0):
    return build_model("ieee3modalPart", num_classes, "softmax",
                       pretrained=False, dtype="float32",
                       backbone_layers=LAYERS, device="cpu", seed=seed,
                       **flags)


def _engine(seed=0, model=None):
    dm = ImageDataManager(**DATA)
    model = _model(seed=seed) if model is None else model
    opt = build_optimizer(model, optim="sgd", lr=0.01, momentum=0.9,
                          weight_decay=5e-4, sgd_nesterov=True)
    sched = build_lr_scheduler("multi_step", stepsize=[1], base_lr=0.01)
    return MultiModalImageSoftmaxEngine(dm, model, opt, sched, device="cpu",
                                        seed=0)


def _moments(eng):
    names = {p: n for n, p in eng.model.named_parameters()}
    return {names[p]: s["momentum_buffer"]
            for p, s in eng.optimizer.state.items()}


def test_two_epochs_equal_one_epoch_resume_one_epoch(tmp_path, capsys):
    straight = _engine()
    straight.run(save_dir=str(tmp_path / "a"), max_epoch=2, print_freq=1)
    first = _engine()
    first.run(save_dir=str(tmp_path / "b"), max_epoch=1, print_freq=1)
    ckpt = tmp_path / "b" / "model" / "model.pth.tar-1"
    resumed = _engine(seed=9)  # other initial weights: the checkpoint wins
    for _ in resumed.train_loader:  # the straight run's first epoch
        pass
    capsys.readouterr()
    resumed.run(save_dir=str(tmp_path / "b"), max_epoch=2, print_freq=1,
                resume=str(ckpt))
    out = capsys.readouterr().out
    assert "Last epoch = 1" in out and out.count("epoch: [2/2]") == 2
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    ma, mb = _moments(straight), _moments(resumed)
    assert ma.keys() == mb.keys() and len(ma) == len(a) - sum(
        k.endswith(("running_mean", "running_var", "num_batches_tracked"))
        for k in a)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    # the resumed run's checkpoint is the straight run's, and the
    # reference loader still reads it
    sa = load_checkpoint(str(tmp_path / "a" / "model"))
    sb = load_checkpoint(str(tmp_path / "b" / "model"))
    assert sa["epoch"] == sb["epoch"] == 2
    for k in sa["state_dict"]:
        assert torch.equal(sa["state_dict"][k], sb["state_dict"][k]), k
    load_reference_checkpoint(first.model, str(tmp_path / "a" / "model" /
                                               "model.pth.tar-2"))
    assert all(torch.equal(v, a[k])
               for k, v in first.model.state_dict().items())


def _small(seed):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))


def test_save_list_load_round_trip(tmp_path):
    model = _small(0)
    opt = build_optimizer(model, optim="sgd", lr=0.1, momentum=0.9)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    d = str(tmp_path / "model")
    for epoch in (3, 1, 12):
        save_checkpoint(model, d, epoch, rank1=0.25, optimizer=opt,
                        is_best=epoch == 3)
    for name in ("model.pth.tar-7.tmp", "model.pth.tar-x", "other-2"):
        (tmp_path / "model" / name).write_text("")
    assert list_checkpoints(d) == [(e, os.path.join(d, f"model.pth.tar-{e}"))
                                   for e in (1, 3, 12)]
    assert list_checkpoints(str(tmp_path / "none")) == []
    for e in (1, 3, 12):  # each sidecar, written before its checkpoint
        meta = (tmp_path / "model" / f"model.pth.tar-{e}.json").read_text()
        assert meta == f'{{"epoch": {e}, "rank1": 0.25}}'
    assert load_checkpoint(d)["epoch"] == 12  # a directory: the newest
    best = load_checkpoint(os.path.join(d, "model-best.pth.tar"))
    assert set(best) == {"state_dict", "epoch", "rank1", "optimizer"}
    assert best["epoch"] == 3 and best["rank1"] == 0.25
    other = _small(4)
    opt2 = build_optimizer(other, optim="sgd", lr=0.1, momentum=0.9)
    assert resume_from_checkpoint(os.path.join(d, "model.pth.tar-3"),
                                  other, opt2) == 3
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    assert opt2.state_dict()["state"].keys() == opt.state_dict()[
        "state"].keys()
    for i, st in opt.state_dict()["state"].items():
        assert torch.equal(opt2.state_dict()["state"][i]["momentum_buffer"],
                           st["momentum_buffer"])
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "missing"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "empty"))


def test_load_pretrained_weights_across_variants(tmp_path, recwarn):
    base, full = _model(BASE, seed=1), _model({}, seed=2)
    path = save_checkpoint(base, str(tmp_path), 1)
    before = {k: v.clone() for k, v in full.state_dict().items()}
    matched, discarded = load_pretrained_weights(full, path)
    # the base variant's tree is a subset of the full model's: every base
    # entry loads, CIM, CA and REM keep their values
    assert sorted(matched) == sorted(base.state_dict()) and not discarded
    for k, v in full.state_dict().items():
        src = base.state_dict()[k] if k in matched else before[k]
        assert torch.equal(v, src), k
    assert any(k.startswith(("convOne.", "CA.", "REM.")) for k in before)
    # the other way, and a classifier of another width: reported, kept
    path = save_checkpoint(full, str(tmp_path / "full"), 1)
    small = _model(BASE, num_classes=3, seed=3)
    keep = small.classifier_R[0].weight.clone()
    matched, discarded = load_pretrained_weights(small, path)
    assert all(k.startswith(("convOne.", "convAvgRest.", "CA.", "REM.",
                             "classifier_")) for k in discarded)
    assert any(k.startswith("REM.") for k in discarded)
    assert "classifier_R.0.weight" in discarded
    assert torch.equal(small.classifier_R[0].weight, keep)
    assert torch.equal(small.fc_R[0][0].weight, full.fc_R[0][0].weight)
    torch.save({"state_dict": {"nothing.here": torch.zeros(1)}},
               tmp_path / "none.pth")
    assert load_pretrained_weights(small, str(tmp_path / "none.pth")) == (
        [], ["nothing.here"])
    assert any("cannot be loaded" in str(w.message) for w in recwarn)


@pytest.mark.parametrize("save_freq, save_best, eval_freq, want", [
    (-1, True, 2, [2, 4, 5]),  # at each evaluation and the last epoch
    (2, False, 3, [2, 4, 5]),  # every 2 epochs and the last
    (2, True, 3, [1, 2, 3, 4, 5]),  # also at each best evaluation
])
def test_run_save_schedule(tmp_path, save_freq, save_best, eval_freq, want):
    eng = _engine(model=_small(0))  # train and test stand in below
    ranks = iter([0.1, 0.2, 0.3, 0.4, 0.5])
    eng.train = lambda **kw: None
    eng.test = lambda **kw: next(ranks)
    if save_freq > 0 and save_best:
        eval_freq = 1  # every epoch a new best
    eng.run(save_dir=str(tmp_path), max_epoch=5, eval_freq=eval_freq,
            save_freq=save_freq, save_best=save_best)
    got = [e for e, _ in list_checkpoints(str(tmp_path / "model"))]
    assert got == want
    meta = load_checkpoint(str(tmp_path / "model"))
    assert meta["epoch"] == 5 and np.isfinite(meta["rank1"])
