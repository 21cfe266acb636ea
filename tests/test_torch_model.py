"""The port's IEEE model against the JAX package's, on the same weights.

One JAX model per module (``backbone_layers=(1, 1, 1, 1)``, f32, as
``tests/test_fast_eval.py``); its variables are random numpy arrays from a
seed (non-trivial BN running stats, REM gamma 0.3), loaded into the port with
``load_jax_variables``. Tolerances: the plain eval feature agrees to 2e-4
(the JAX suite's bound for eval features); the kernel paths round to bf16 at
the same points in both packages and are bounded as stated at each test.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from ieee_tpu.models import build_model as jax_build_model
from ieee_tpu.models.common import FastBatchNorm as JaxFastBatchNorm
from ieee_tpu.models.fast_eval import build_fast_ieee_eval as jax_fast_eval
from ieee_tpu.models.ieee_converter import convert_ieee_torch_checkpoint
from ieee_tpu.models.resnet import megakernel_vmem_ok
from ieee_tpu_torch.models import IEEE3modalPart, build_model
from ieee_tpu_torch.models.common import FastBatchNorm
from ieee_tpu_torch.models.resnet import Bottleneck
from ieee_tpu_torch.models.fast_eval import (
    build_fast_ieee_eval,
    supports_fast_eval,
)
from ieee_tpu_torch.models.weights import (
    load_jax_variables,
    load_reference_checkpoint,
)
from ieee_tpu_torch.ops import kernels

from test_ieee_converter import _fake_reference_state_dict
from torch_threads import one_torch_thread  # noqa: F401

LAYERS = (1, 1, 1, 1)
H, W = 96, 32
NUM_CLASSES = 7


def _random_variables(module, seed=0):
    """Abstract init for the tree's shapes, numpy values from ``seed``."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0),
                            tuple(jnp.zeros((2, H, W, 3)) for _ in range(3)),
                            train=True))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1])) if len(shape) != 3 else shape[1]
            v = rng.standard_normal(shape) * np.sqrt(1.0 / fan_in)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "var":
            v = np.abs(rng.standard_normal(shape)) + 0.5
        elif name == "gamma":
            v = np.full(shape, 0.3)
        else:  # bias, mean
            v = 0.1 * rng.standard_normal(shape)
        return v.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, flax.core.unfreeze(shapes))
    return tree["params"], tree["batch_stats"]


def _images(n=2, h=H, w=W, seed=3):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((n, h, w, 3)).astype(np.float32)
                 for _ in range(3))


def _to_torch(imgs):
    return tuple(torch.tensor(x).permute(0, 3, 1, 2) for x in imgs)


@pytest.fixture(scope="module")
def jax_model():
    m = jax_build_model("ieee3modalPart", num_classes=NUM_CLASSES,
                        loss="margin", pretrained=False,
                        backbone_layers=LAYERS, dtype=jnp.float32)
    params, stats = _random_variables(m.module)
    return m, params, stats


@pytest.fixture(scope="module")
def port_model(jax_model):
    _, params, stats = jax_model
    return _port(params, stats)


def _port(params, stats, **kw):
    model = build_model("ieee3modalPart", NUM_CLASSES, "margin",
                        pretrained=False, dtype="float32",
                        backbone_layers=LAYERS, device="cpu", **kw)
    load_jax_variables(model, params, stats)
    return model


def _jax_eval(module, params, stats, imgs):
    fn = jax.jit(lambda v, x: module.apply(v, x, train=False))
    return np.asarray(fn({"params": params, "batch_stats": stats}, imgs))


@pytest.mark.parametrize("h", [96, 64])
def test_plain_eval_matches_jax(jax_model, port_model, h):
    # h=96: a 6x2 layer4 map (P=6 divides it); h=64: a 4x2 map, where the
    # six part stripes overlap (AdaptiveAvgPool2d buckets)
    m, params, stats = jax_model
    imgs = _images(h=h)
    want = _jax_eval(m.module, params, stats, imgs)
    with torch.no_grad():
        got = port_model(_to_torch(imgs)).numpy()
    assert got.shape == want.shape == (2, 2304)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_fused_1x1_matches_jax_fused_1x1(jax_model):
    # both route layer4's cb1/cb3/downsample, CIM and reduce through the
    # bf16 mm_affine op (Pallas interpret mode vs the plain version here):
    # the same rounding points, but a product that differs in its last f32
    # bit can round to the neighbouring bf16 value and propagate; bound the
    # feature error by 1e-2 of the feature scale and the cosine by 0.9999
    m, params, stats = jax_model
    mf = jax_build_model("ieee3modalPart", num_classes=NUM_CLASSES,
                         loss="margin", pretrained=False,
                         backbone_layers=LAYERS, dtype=jnp.float32,
                         fused_1x1=True)
    imgs = _images()
    want = _jax_eval(mf.module, params, stats, imgs)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = _port(params, stats, fused_1x1=True)(_to_torch(imgs)).numpy()
    assert kernels.launch_counts()["mm_affine"] == 0  # CPU: plain version
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * scale)
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(want, axis=1))
    assert (cos > 0.9999).all(), cos


def test_fast_eval_matches_jax_fast_eval(jax_model, port_model):
    # folded head + partpool on both sides; bf16 rounding of the map, the
    # pooled rows and the neck product at the same points: 1e-2 of the
    # feature scale (the JAX suite bounds its own fused-vs-flax gap by 2e-2)
    m, params, stats = jax_model
    imgs = _images()
    v = {"params": params, "batch_stats": stats}
    want = np.asarray(jax_fast_eval(m, v)(imgs))
    assert supports_fast_eval(port_model)
    got = build_fast_ieee_eval(port_model)(_to_torch(imgs)).numpy()
    assert got.shape == want.shape == (2, 2304)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * scale)
    cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                 * np.linalg.norm(want, axis=1))
    assert (cos > 0.9999).all(), cos


def test_load_jax_variables_round_trips_through_the_converter(jax_model,
                                                             port_model):
    _, params, stats = jax_model
    p2, s2 = convert_ieee_torch_checkpoint(port_model.state_dict(),
                                           layers=LAYERS)
    for want, got in ((params, p2), (stats, s2)):
        assert (jax.tree_util.tree_structure(want)
                == jax.tree_util.tree_structure(got))
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_reference_checkpoint_loads_into_the_port(port_model, tmp_path):
    # the reference's format: a "state_dict" wrapper, DataParallel's
    # "module." prefix, and entries the port does not hold
    sd = {f"module.{k}": v for k, v in port_model.state_dict().items()}
    sd["module.backbone.0.fc.weight"] = torch.zeros(3, 3)
    path = tmp_path / "model.pth.tar-1"
    torch.save({"state_dict": sd, "epoch": 1}, path)
    model = build_model("ieee3modalPart", NUM_CLASSES, "margin",
                        pretrained=False, dtype="float32",
                        backbone_layers=LAYERS, seed=7, device="cpu")
    load_reference_checkpoint(model, str(path))
    for k, v in port_model.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
    del sd["module.REM.1.param"]
    torch.save({"state_dict": sd}, path)
    with pytest.raises(KeyError, match="REM.1.param"):
        load_reference_checkpoint(model, str(path))


def test_state_dict_has_the_reference_layout():
    want = {k: tuple(v.shape)
            for k, v in _fake_reference_state_dict(num_classes=7).items()}
    with torch.device("meta"):
        model = IEEE3modalPart(num_classes=7, loss="margin")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == want


def test_load_jax_variables_rejects_a_mismatched_tree(jax_model, port_model):
    _, params, stats = jax_model
    params = dict(params)
    params.pop("REM_2")
    with pytest.raises(KeyError):
        load_jax_variables(port_model, params, stats)


def test_fast_batchnorm_train_matches_flax_state():
    # flax state: biased batch variance, momentum 0.9 on the running stats
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 5, 3, 8)).astype(np.float32) * 2 + 1
    jbn = JaxFastBatchNorm(dtype=jnp.float32)
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_j, upd = jbn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    bn = FastBatchNorm(8, dtype=torch.float32).train()
    y_t = bn(torch.tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(y_t.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)


def test_training_forward_is_not_ported_yet():
    # the name predates the block path; the training forward now takes
    # cfg.cuda.block_megakernel's whole-block backward on exactly the blocks
    # the JAX gate picks (stride 1, no downsample, megakernel_vmem_ok), and
    # eval keeps the plain block
    with torch.device("meta"):
        model = IEEE3modalPart(num_classes=3, backbone_layers=(1, 2, 1, 1),
                               block_megakernel=True)  # layer2.1: stride 1
    blocks = [(n, m) for n, m in model.named_modules()
              if isinstance(m, Bottleneck)]
    picked = [n for n, m in blocks if m.megakernel]
    assert picked == [n for n, m in blocks
                      if m.stride == 1 and m.downsample is None
                      and megakernel_vmem_ok(m.conv2.out_channels)]
    assert [n.split(".", 2)[2] for n in picked] == ["layer2.1"] * 3
    imgs = tuple(torch.zeros(1, 3, 32, 16, device="meta") for _ in range(3))
    out = model.train()(imgs)
    roots = [t.grad_fn for t in jax.tree_util.tree_leaves(out)
             if isinstance(t, torch.Tensor) and t.grad_fn is not None]
    seen, block_ops = set(), 0
    while roots:
        fn = roots.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        block_ops += type(fn).__name__ == "_BottleneckTrainBackward"
        roots.extend(f for f, _ in fn.next_functions)
    assert block_ops == 3  # one per trunk
    model.eval()(imgs)  # eval takes the plain block
