"""The port's ``train_e2e`` and ``summarize_e2e`` tools.

``python -m ieee_tpu_torch.tools.train_e2e --variant base`` against the
JAX package's ``tools/train_e2e.py`` with the same flags: 5 epochs of 4
steps (4 ids x 8 images, batch 8) at ``backbone_layers=(1, 1, 1, 1)`` and
32x16, both in f32 with augmentation off, from the same random numpy
variables (``test_torch_model._random_variables``, which the JAX model's
``init_variables`` hands the JAX engine; ``load_jax_variables`` moves them
into the port). One JAX run serves the file.

Tolerance: the first epoch's mean loss within 5e-3 relative of the JAX
tool's, every epoch's within 5e-2. The first steps agree to 1e-6, but
the trajectory is chaotic at this size: the JAX step run against itself
from initial weights perturbed by 1e-6 (relative, random) differs by
1e-4 at the second step and by up to 6e-2 within 18 steps, as the port
does (up to 4e-2). The test prints the worst gap.
"""

import functools
import importlib.util
import json
import os
import os.path as osp
import shutil
import sys

import pytest

import jax.numpy as jnp

import ieee_tpu.data
import ieee_tpu.engine
import ieee_tpu.models
from ieee_tpu.parallel import make_mesh
from ieee_tpu_torch.models.weights import load_jax_variables
from ieee_tpu_torch.tools import summarize_e2e, train_e2e

from test_torch_model import _random_variables
from torch_threads import one_torch_thread  # noqa: F401

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
ARGS = ["--variant", "base", "--backbone-layers", "1,1,1,1", "--epochs", "5",
        "--batch", "8", "--pids", "4", "--imgs-per-pid", "8", "--height",
        "32", "--width", "16", "--eval-freq", "5", "--workers", "0",
        "--seed", "3"]
LOSS_RTOL = (5e-3, 5e-2)  # the first epoch, every epoch


def _no_flip(cls):
    return lambda **kw: cls(**{**kw, "transforms": []})


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX tool's artifact and its initial variables (numpy)."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_e2e", osp.join(ROOT, "tools", "train_e2e.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    d = tmp_path_factory.mktemp("jax_e2e")
    init = {}
    real_build = ieee_tpu.models.build_model

    def build(*a, **kw):
        m = real_build(*a, dtype=jnp.float32, **kw)
        init["params"], init["batch_stats"] = _random_variables(m.module, 11)
        m.init_variables = lambda *a, **kw: dict(init)
        return m

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ieee_tpu.data, "ImageDataManager",
                   _no_flip(ieee_tpu.data.ImageDataManager))
        mp.setattr(ieee_tpu.models, "build_model", build)
        # one device, as the port's run (the tests' JAX has 8 virtual ones)
        mp.setattr(ieee_tpu.engine, "Image3MEngine", functools.partial(
            ieee_tpu.engine.Image3MEngine, mesh=make_mesh([1])))
        mp.setattr(sys, "argv", ["train_e2e.py", *ARGS, "--out",
                                 str(d / "E2E_JAX.json"), "--save-dir",
                                 str(d / "run")])
        tool.main()
    with open(d / "E2E_JAX.json") as f:
        yield json.load(f), init
    shutil.rmtree(d, ignore_errors=True)  # a 250 MB checkpoint


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    """The port's run from the same initial variables; returns its
    artifact and the directory it wrote."""
    _, init = jax_run
    d = tmp_path_factory.mktemp("port_e2e")
    real_build = train_e2e.build_model

    def build(*a, **kw):
        model = real_build(*a, **{**kw, "dtype": "float32"})
        load_jax_variables(model, init["params"], init["batch_stats"])
        return model

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_e2e, "ImageDataManager",
                   _no_flip(train_e2e.ImageDataManager))
        mp.setattr(train_e2e, "build_model", build)
        train_e2e.main([*ARGS, "--device", "cpu", "--out",
                        str(d / "E2E_PORT.json"), "--save-dir",
                        str(d / "run")])
    with open(d / "E2E_PORT.json") as f:
        yield json.load(f), d
    shutil.rmtree(d, ignore_errors=True)  # 250 MB checkpoints


def test_base_trajectory_tracks_the_jax_tool(jax_run, port_run, capsys):
    want, _ = jax_run
    got, _ = port_run
    assert got["complete"] and want["complete"]
    assert sorted(got) == sorted(want)
    pw, pg = dict(want["protocol"]), dict(got["protocol"])
    assert (pw.pop("backend"), pg.pop("backend")) == ("cpu", "cpu")
    assert pg == pw
    assert list(got["loss_per_epoch"]) == [str(e) for e in range(1, 6)]
    gaps = []
    for epoch, w in want["loss_per_epoch"].items():
        g = got["loss_per_epoch"][epoch]
        assert set(g) == set(w)  # LossX, lossR/N/T, accR/N/T, loss
        gaps.append(abs(g["loss"] - w["loss"]) / abs(w["loss"]))
    losses = [w["loss"] for w in want["loss_per_epoch"].values()]
    with capsys.disabled():
        print(f"\ntrain_e2e base: JAX epoch losses {losses}; the port's "
              f"relative gaps {[f'{x:.2e}' for x in gaps]}")
    assert gaps[0] <= LOSS_RTOL[0] and max(gaps) <= LOSS_RTOL[1]
    # it learns, by far more than the gaps
    assert losses[-1] < losses[0] * (1 - 2 * LOSS_RTOL[1])
    assert [e["epoch"] for e in got["evals"]] == [5]
    assert 0.0 <= got["final_rank1"] <= 1.0
    assert len(got["params_fingerprint"]) == 20


def test_resume_init_from_and_distill_only(port_run, capsys):
    first, d = port_run
    run = str(d / "run")
    art = train_e2e.main([*ARGS[:4], "--epochs", "0", "--device", "cpu",
                          "--out", str(d / "E2E_FULL.json"), "--save-dir",
                          str(d / "full"), "--variant", "full",
                          "--init-from", osp.join(run, "model",
                                                  "model.pth.tar-5")])
    out = capsys.readouterr().out
    # a base checkpoint under the full model: the shared tree loads
    assert "Successfully loaded pretrained weights" in out
    assert art["protocol"]["init_from"].endswith("model.pth.tar-5")
    assert art["protocol"]["variant"] == "full" and art["complete"]
    art = train_e2e.main([*ARGS, "--epochs", "6", "--device", "cpu",
                          "--out", str(d / "E2E_PORT_6.json"),
                          "--save-dir", run, "--resume"])
    out = capsys.readouterr().out
    assert f"resuming from {osp.join(run, 'model', 'model.pth.tar-5')}" in out
    assert "Last epoch = 5" in out
    assert list(art["loss_per_epoch"]) == list(range(1, 7))
    assert art["loss_per_epoch"][5] == first["loss_per_epoch"]["5"]
    art = train_e2e.main([*ARGS, "--out", str(d / "E2E_PART.json"),
                          "--save-dir", run, "--distill-only"])
    assert not art["complete"] and len(art["loss_per_epoch"]) == 6
    assert art["protocol"]["backend"] == "unknown (distill-only)"
    with pytest.raises(NotImplementedError, match="A.4"):
        train_e2e.main([*ARGS, "--device", "cpu", "--decode-cache"])
    # the defaults write under log/, never over the JAX package's records
    args = train_e2e._parser().parse_args([])
    assert args.out.startswith("log" + os.sep)
    assert args.save_dir.startswith("log" + os.sep)


def test_summarize_e2e_reads_the_port_artifact(port_run, capsys):
    art, d = port_run
    assert summarize_e2e.main([str(d / "E2E_PORT.json")]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == summarize_e2e.COLUMNS
    row = dict(zip(summarize_e2e.COLUMNS, lines[1].split()))
    assert row["variant"] == "base" and row["backend"] == "cpu"
    assert row["epochs"] == "5/5" and row["split"] == "seen-ids"
    assert float(row["loss_last"]) == art["loss_per_epoch"]["5"]["loss"]
    assert row["complete"] == "True"
    assert summarize_e2e.main([str(d / "nothing_*.json")]) == 1
    assert summarize_e2e.DEFAULT_GLOB.startswith("log" + os.sep)
