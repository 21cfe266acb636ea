"""The ablation configs through the port's CLI and its Table-3 tools on
the CPU, at ``backbone_layers=(1, 1, 1, 1)`` and 64x32 images (at 32x16
the 2x1 maps of layer3-4 can turn the one-pass BN variance negative in
bf16, in both packages).

- ``python -m ieee_tpu_torch.main_multimodal`` on
  ``configs/rgbnt_base_softmax.yaml`` with ``train.fixbase_epoch 1``, then
  ``model.resume`` from its checkpoint, and on
  ``configs/rgbnt_cim_softmax.yaml`` with ``data.k_tfm 2
  train.accum_steps 2``: 4 ids x 4 images, 2 steps of the configs' batch 8
  an epoch, trunks of one block a stage.
- ``ablation_sweep`` (one variant) and ``diag_train`` at the same size.

The parity of each piece with the JAX package is in
``tests/test_torch_ablation_train.py``, ``test_torch_accum_ktfm.py``,
``test_torch_resume.py`` and ``test_torch_train_e2e.py``.
"""

import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch

from ieee_tpu_torch import main_multimodal
from ieee_tpu_torch.tools import ablation_sweep, diag_train

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = (1, 1, 1, 1)


def _cli(config, tmp_path, *opts):
    return main_multimodal.main([
        "--config-file", os.path.join(ROOT, "configs", config),
        "--device", "cpu", "model.pretrained", "False",
        "data.sources", "['synthetic_mm']", "data.targets", "['synthetic_mm']",
        "data.height", "64", "data.width", "32",
        "data.save_dir", str(tmp_path), "train.print_freq", "1",
        "test.batch_size", "16", *opts])


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    # each full-width checkpoint with its moments is about 250 MB
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def tiny_cli(monkeypatch):
    # 4 ids x 4 images (2 steps of 8 an epoch), trunks of one block a stage
    orig = main_multimodal.imagedata_kwargs
    monkeypatch.setattr(main_multimodal, "imagedata_kwargs", lambda cfg: {
        **orig(cfg), "num_pids": 4, "imgs_per_pid": 4})
    monkeypatch.setattr(main_multimodal, "build_model", functools.partial(
        main_multimodal.build_model, backbone_layers=LAYERS))


def test_cli_base_softmax_fixbase_then_resume(tiny_cli, tmp_path, capsys):
    rank1 = _cli("rgbnt_base_softmax.yaml", tmp_path, "train.max_epoch",
                 "2", "train.fixbase_epoch", "1")
    out = capsys.readouterr().out
    assert 0.0 <= rank1 <= 1.0 and "mAP:" in out
    assert "* Only train ['classifier'] (epoch: 1/1)" in out
    assert out.count("epoch: [1/2]") == out.count("epoch: [2/2]") == 2
    ckpt = tmp_path / "model" / "model.pth.tar-2"
    assert (tmp_path / "model" / "model.pth.tar-2.json").is_file()
    saved = torch.load(ckpt, weights_only=False)
    assert saved["epoch"] == 2 and "optimizer" in saved

    rank1 = _cli("rgbnt_base_softmax.yaml", tmp_path, "train.max_epoch",
                 "3", "model.resume", str(ckpt))
    out = capsys.readouterr().out
    assert "Last epoch = 2" in out and 0.0 <= rank1 <= 1.0
    assert out.count("epoch: [3/3]") == 2 and "epoch: [1/3]" not in out
    assert torch.load(tmp_path / "model" / "model.pth.tar-3",
                      weights_only=False)["epoch"] == 3


def test_cli_cim_softmax_k_tfm_and_accum(tiny_cli, tmp_path, capsys):
    rank1 = _cli("rgbnt_cim_softmax.yaml", tmp_path, "train.max_epoch", "1",
                 "data.k_tfm", "2", "train.accum_steps", "2")
    out = capsys.readouterr().out
    assert 0.0 <= rank1 <= 1.0 and "mAP:" in out
    assert out.count("epoch: [1/1]") == 2
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert '"train_epoch"' in lines[0] and "nan" not in lines[0].lower()


def test_ablation_sweep_writes_one_line_per_variant(tmp_path, monkeypatch,
                                                    capsys):
    monkeypatch.setattr(ablation_sweep, "VARIANTS",
                        ablation_sweep.VARIANTS[:1])
    real = ablation_sweep.run_variant
    monkeypatch.setattr(
        ablation_sweep, "run_variant", lambda *a, **kw: real(
            *a, height=64, width=32, num_pids=4, backbone_layers=(1, 1, 1, 1),
            **kw))
    out = tmp_path / "ABLATION.json"
    recs = ablation_sweep.main(["8", "5", "--device", "cpu", "--out",
                                str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert recs == json.loads(out.read_text()) == [line]
    assert line["variant"] == "a_base" and line["fused_1x1"] is False
    assert line["flags"] == dict(interaction=False, attention=False,
                                 using_REM=False)
    assert len(line["losses"]) == 4 and line["triplets_per_sec"] > 0
    assert all(np.isfinite(line["losses"]))


def test_diag_train_prints_norms_of_real_steps(capsys):
    recs = diag_train.main([
        "--device", "cpu", "--steps", "3", "--diag-every", "2", "--pids",
        "4", "--imgs-per-pid", "4", "--batch", "8", "--height", "64",
        "--width", "32", "--backbone-layers", "1,1,1,1", "--variant", "base",
        "--optim", "sgd", "--lr", "0.01"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines == recs and [r["step"] for r in recs] == [0, 2]
    for r in recs:
        assert {"LossX", "lossR", "accT", "loss", "grad_norm", "logit_std_N",
                "logit_absmax_T", "g:backbone_R", "p:classifier_T",
                "g:reduce_2", "g:fc_N"} <= set(r)
        assert "LossM" not in r  # base: weight_m 0, CE only
        assert all(np.isfinite(v) for v in r.values())
        groups = sum(v * v for k, v in r.items() if k.startswith("g:"))
        assert 0 < groups <= r["grad_norm"] ** 2 * (1 + 1e-4)
        assert r["g:classifier_R"] > 0 and r["logit_std_R"] > 0
    # the parameters moved between the two diagnosed steps
    assert recs[0]["p:classifier_R"] != recs[1]["p:classifier_R"]
