"""The port's config against the JAX package's, and the port's import
boundary (it never imports jax or ieee_tpu)."""

import os
import subprocess
import sys

import pytest

from ieee_tpu.config import get_default_config as jax_default_config
from ieee_tpu.config import engine_run_kwargs as jax_engine_run_kwargs
from ieee_tpu.config import imagedata_kwargs as jax_imagedata_kwargs
from ieee_tpu.config import lr_scheduler_kwargs as jax_lr_scheduler_kwargs
from ieee_tpu.config import optimizer_kwargs as jax_optimizer_kwargs
from ieee_tpu_torch.config import (
    engine_run_kwargs,
    get_default_config,
    imagedata_kwargs,
    lr_scheduler_kwargs,
    optimizer_kwargs,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "rgbnt_ieee_part_margin.yaml")


def _loaded(factory):
    cfg = factory()
    cfg.merge_from_file(YAML)
    return cfg


def test_yaml_loads_to_the_same_values_in_both_packages():
    ours, theirs = _loaded(get_default_config), _loaded(jax_default_config)
    ours_d, theirs_d = ours.to_dict(), theirs.to_dict()
    assert ours_d.pop("cuda")["compute_dtype"] == "bfloat16"
    theirs_d.pop("tpu")
    assert ours_d == theirs_d
    assert ours.model.name == "ieee3modalPart" and ours.loss.name == "margin"
    assert ours.test.batch_size == 100 and ours.train.stepsize == [20, 40]


def test_cuda_section_defaults_and_typed_overrides():
    cfg = get_default_config()
    # off by default, as the JAX package's cfg.tpu.fused_1x1 (None: off)
    # and cfg.tpu.fused_eval (False)
    assert cfg.cuda.fused_1x1 is False and cfg.cuda.fused_eval is False
    assert cfg.cuda.block_megakernel is False
    # and cfg.tpu.int8_eval (False)
    assert cfg.cuda.int8_eval is False
    cfg.merge_from_list(["cuda.fused_eval", "True", "test.batch_size", "64"])
    assert cfg.cuda.fused_eval is True and cfg.test.batch_size == 64
    with pytest.raises(TypeError):
        cfg.merge_from_list(["cuda.fused_1x1", "ture"])
    with pytest.raises(KeyError):
        cfg.merge_from_list(["tpu.fused_eval", "True"])


def test_kwargs_adapters_match():
    ours, theirs = _loaded(get_default_config), _loaded(jax_default_config)
    assert imagedata_kwargs(ours) == jax_imagedata_kwargs(theirs)
    assert optimizer_kwargs(ours) == jax_optimizer_kwargs(theirs)
    assert lr_scheduler_kwargs(ours) == jax_lr_scheduler_kwargs(theirs)
    assert engine_run_kwargs(ours) == jax_engine_run_kwargs(theirs)
    run = engine_run_kwargs(ours)
    assert run["test_only"] is False and run["ranks"] == [1, 5, 10]


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, ieee_tpu_torch.engine, ieee_tpu_torch.main_multimodal,"
            " ieee_tpu_torch.models.fast_eval, ieee_tpu_torch.ops.kernels."
            "partpool, ieee_tpu_torch.ops.kernels.matmul_bn, "
            "ieee_tpu_torch.ops.kernels.distmat, ieee_tpu_torch.losses, "
            "ieee_tpu_torch.optim, ieee_tpu_torch.data.sampler, "
            "ieee_tpu_torch.engine.image.margin, ieee_tpu_torch.utils, "
            "ieee_tpu_torch.ops.kernels.probes, ieee_tpu_torch.tools._timing, "
            "ieee_tpu_torch.tools.bw_probe, ieee_tpu_torch.tools.bw_probe2, "
            "ieee_tpu_torch.tools.fusion_probe, "
            "ieee_tpu_torch.tools.roofline_probe, "
            "ieee_tpu_torch.tools.profile_train, "
            "ieee_tpu_torch.tools.eval_bench, "
            "ieee_tpu_torch.tools.eval_fwd_bench, "
            "ieee_tpu_torch.tools.loader_bench, ieee_tpu_torch.main, "
            "ieee_tpu_torch.models.resnet, ieee_tpu_torch.models.weights, "
            "ieee_tpu_torch.data.datasets.image.market1501, "
            "ieee_tpu_torch.data.datasets.image.market_to_rgbnt201, "
            "ieee_tpu_torch.data.datasets.image.allday, "
            "ieee_tpu_torch.data.datasets.image.uav, "
            "ieee_tpu_torch.data.datasets.image.synthetic, "
            "ieee_tpu_torch.models.int8_eval, "
            "ieee_tpu_torch.ops.kernels.conv_s8, "
            "ieee_tpu_torch.utils.feature_extractor, "
            "ieee_tpu_torch.tools.int8_probe, "
            "ieee_tpu_torch.tools.int8_e2e_eval, "
            "ieee_tpu_torch.ops.rerank, ieee_tpu_torch.ops.rerank_device, "
            "ieee_tpu_torch.ops.gnn_rerank, "
            "ieee_tpu_torch.ops.kernels.rerank, "
            "ieee_tpu_torch.tools.rerank_bench, "
            "ieee_tpu_torch.tools.gnn_rerank_cli, "
            "ieee_tpu_torch.native.ranking, ieee_tpu_torch.utils.reidtools, "
            "ieee_tpu_torch.tools.rank_speed_test, "
            "ieee_tpu_torch.tools.visualize_actmap, "
            "ieee_tpu_torch.tools.parse_test_res; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'ieee_tpu.')) or m == 'ieee_tpu']; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)


def test_no_port_source_mentions_a_jax_import():
    pkg = os.path.join(ROOT, "ieee_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            for line in open(os.path.join(dirpath, f)):
                s = line.strip()
                assert not s.startswith(("import jax", "from jax",
                                         "import ieee_tpu.",
                                         "from ieee_tpu.", "from ieee_tpu ",
                                         "import ieee_tpu ")), (f, s)
