"""The port's int8 IEEE eval step and the engine's ``int8_eval`` dispatch
against the JAX package (``ieee_tpu/models/int8_eval.py``,
``ieee_tpu/engine/engine.py:642-659``), on the CPU.

The IEEE model (``parts=2``) at ``backbone_layers=(1, 1, 1, 1)`` in f32 on
random numpy weights (non-trivial BN statistics, REM gamma 0.3), moved into
the port by ``load_jax_variables``; 64x32 images from a numpy seed. The
step matches JAX's at cosine >= 0.995 (each side calibrates its own scales
from bf16 maps that differ by rounding), and the port's own plain forward
at the JAX suite's bar, cosine > 0.97 (``tests/test_int8_eval.py:107``).
The engines on tiny ``synthetic``/``synthetic_mm`` sets take the int8 step
where the JAX engine does, before ``fused_eval``, and warn and take the
plain forward for a grouped trunk.
"""

import numpy as np
import torch

import jax.numpy as jnp

from ieee_tpu.models import build_model as jax_build_model
from ieee_tpu.models import int8_eval as jie
from ieee_tpu_torch.config import get_default_config
from ieee_tpu_torch.data import ImageDataManager
from ieee_tpu_torch.engine import (Image3MEngine, ImageSoftmaxEngine,
                                   build_engine)
from ieee_tpu_torch.models import build_model
from ieee_tpu_torch.models import int8_eval as ie
from ieee_tpu_torch.models.weights import load_jax_variables

from test_torch_int8_eval import (H, LAYERS, NUM_CLASSES, W, _cos, _images,
                                  _port_images)
from test_torch_model import _random_variables as _ieee_random_variables
from torch_threads import one_torch_thread  # noqa: F401


def test_int8_ieee_step_matches_jax():
    jm = jax_build_model("ieee3modalPart", num_classes=NUM_CLASSES,
                         loss="margin", pretrained=False,
                         backbone_layers=LAYERS, parts=2, dtype=jnp.float32)
    params, stats = _ieee_random_variables(jm.module)
    imgs = tuple(_images(seed=20 + i) for i in range(3))
    want = np.asarray(jie.build_int8_ieee_eval_step(jm)(params, stats, imgs))
    model = build_model("ieee3modalPart", NUM_CLASSES, "margin",
                        pretrained=False, dtype="float32", device="cpu",
                        backbone_layers=LAYERS, parts=2)
    load_jax_variables(model, params, stats)
    assert ie.supports_int8_eval(model)
    step = ie.build_int8_ieee_eval_step(model)
    got = step(tuple(_port_images(x) for x in imgs))
    assert tuple(got.shape) == want.shape == (2, 768)
    assert len(step.holder["scales"]) == 3
    # stem + 4 bottlenecks of cb1, conv2, cb3 and downsample per trunk
    assert all(len(s) == 17 for s in step.holder["scales"])
    c = _cos(got.numpy(), want)
    assert c.min() >= 0.995, c
    with torch.no_grad():
        plain = model(tuple(_port_images(x) for x in imgs))
    c = _cos(got.numpy(), plain.numpy())
    assert c.min() > 0.97, c


DATA = dict(height=H, width=W, batch_size_train=8, batch_size_test=8,
            workers=0, num_pids=4, imgs_per_pid=4, verbose=False, seed=0)


def test_engine_dispatches_int8_eval(capsys):
    dm = ImageDataManager(sources="synthetic", **DATA)
    model = build_model("resnet18", dm.num_train_pids, "softmax",
                        pretrained=False, device="cpu", layers=LAYERS)
    eng = ImageSoftmaxEngine(dm, model, device="cpu", int8_eval=True,
                             fused_eval=True)
    rank1 = eng.test(ranks=(1,))
    assert np.isfinite(rank1)
    assert eng._eval_step_fn.holder["scales"]  # the int8 step, calibrated
    # a grouped trunk warns and takes the plain forward
    grouped = build_model("resnext50_32x4d", dm.num_train_pids, "softmax",
                          pretrained=False, device="cpu", layers=LAYERS)
    eng = ImageSoftmaxEngine(dm, grouped, device="cpu", int8_eval=True)
    eng.extract_features(torch.zeros(2, H, W, 3, dtype=torch.uint8))
    assert not hasattr(eng._eval_step_fn, "holder")
    assert "WARN: cuda.int8_eval unsupported for ReIDResNet" in (
        capsys.readouterr().out)
    # the IEEE model through build_engine, from cfg.cuda.int8_eval
    dm3 = ImageDataManager(sources="synthetic_mm", **DATA)
    ieee = build_model("ieee3modalPart", dm3.num_train_pids, "margin",
                       pretrained=False, device="cpu",
                       backbone_layers=LAYERS, parts=2)
    cfg = get_default_config()
    cfg.merge_from_list(["loss.name", "margin", "cuda.int8_eval", "True"])
    eng = build_engine(cfg, dm3, ieee, device="cpu")
    assert isinstance(eng, Image3MEngine) and eng.int8_eval
    imgs = tuple(torch.zeros(2, H, W, 3, dtype=torch.uint8) + i
                 for i in range(3))
    f = eng.extract_features(imgs)
    assert f.shape == (2, 768) and torch.isfinite(f).all()
    assert len(eng._eval_step_fn.holder["scales"]) == 3
