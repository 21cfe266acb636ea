"""The port's single-modal ResNet family against the JAX package's.

``ReIDResNet`` at ``layers=(1, 1, 1, 1)`` in f32, for resnet18
(``BasicBlock``), resnet50, resnext50_32x4d (grouped 3x3 convs) and
resnet50_fc512 (last_stride 1 and the ``fc`` neck). Both sides run on the
same random numpy weights, moved into the port by ``load_jax_variables``:

- eval features within 2e-4 (the JAX suite's bound for eval features);
- one ``ImageSoftmaxEngine`` train step on a ``synthetic`` batch (64x32,
  batch 8, augmentation off, SGD with nesterov momentum and weight decay):
  the metrics within 1e-4, each parameter's update within 2e-2 in
  relative norm, each running statistic within 1e-4 (the port's stated
  tolerances, ``tests/test_torch_ablation_train.py``);
- the other direction: the port's own seeded weights, through the JAX
  package's ``convert_torch_zoo`` (an alignment by registration order and
  shape), give JAX variables under which the JAX model computes the port's
  features, within 2e-4: the port's ``state_dict`` has Torchreid's layout.

A two-layer neck with dropout (no registered model has one) is held to the
JAX model in eval; its training masks come from the model's own seeded
generator.
"""

import warnings

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ieee_tpu.data import ImageDataManager as JaxImageDataManager
from ieee_tpu.engine import ImageSoftmaxEngine as JaxSoftmaxEngine
from ieee_tpu.models.base import ReIDModel
from ieee_tpu.models.resnet import RESNET_SPECS as JAX_SPECS
from ieee_tpu.models.resnet import ReIDResNet as JaxReIDResNet
from ieee_tpu.models.zoo_converter import convert_torch_zoo
from ieee_tpu.optim import build_lr_scheduler as jax_build_lr_scheduler
from ieee_tpu.optim import build_optimizer as jax_build_optimizer
from ieee_tpu.parallel import make_mesh
from ieee_tpu_torch.data import ImageDataManager
from ieee_tpu_torch.engine import ImageSoftmaxEngine
from ieee_tpu_torch.engine.engine import named_units
from ieee_tpu_torch.models import _reid_resnet, build_model
from ieee_tpu_torch.models.common import FastBatchNorm
from ieee_tpu_torch.models.resnet import RESNET_SPECS, Bottleneck
from ieee_tpu_torch.models.weights import (
    _reid_resnet_to_state_dict,
    load_jax_variables,
    load_pretrained_trunks,
)
from ieee_tpu_torch.optim import build_lr_scheduler, build_optimizer, set_lr

from torch_threads import one_torch_thread  # noqa: F401

LAYERS = (1, 1, 1, 1)
H, W = 64, 32
LR = 0.01
DATA = dict(sources="synthetic", height=H, width=W, batch_size_train=8,
            batch_size_test=8, workers=0, train_sampler="RandomSampler",
            num_pids=4, imgs_per_pid=4, transforms=[], verbose=False, seed=0)
OPTIM = dict(optim="sgd", lr=LR, momentum=0.9, weight_decay=5e-4,
             sgd_nesterov=True)
# name: (JAX spec, last_stride, fc_dims), as the two registries build them
ARCHS = {
    "resnet18": ("resnet18", 2, None),
    "resnet50": ("resnet50", 2, None),
    "resnext50_32x4d": ("resnext50_32x4d", 2, None),
    "resnet50_fc512": ("resnet50", 1, [512]),
}


def _jax_module(name, num_classes):
    spec, last_stride, fc_dims = ARCHS[name]
    block, _, groups, wpg = JAX_SPECS[spec]
    return JaxReIDResNet(num_classes=num_classes, loss="softmax", block=block,
                         layers=LAYERS, groups=groups, width_per_group=wpg,
                         last_stride=last_stride, fc_dims=fc_dims,
                         dtype=jnp.float32)


def _random_variables(module, seed):
    """Abstract init for the tree's shapes, numpy values from ``seed``
    (non-trivial BN scales and running statistics)."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((2, H, W, 3)), train=True))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "var":
            v = np.abs(rng.standard_normal(shape)) + 0.5
        else:  # bias, mean
            v = 0.1 * rng.standard_normal(shape)
        return v.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, flax.core.unfreeze(shapes))
    return tree["params"], tree["batch_stats"]


def _port_model(name, num_classes, **kw):
    return build_model(name, num_classes, "softmax", pretrained=False,
                       dtype="float32", device="cpu", layers=LAYERS, **kw)


def _images(n=4, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (n, H, W, 3)).astype(np.float32)


def _jax_features(module, params, stats, imgs):
    return np.asarray(jax.jit(lambda v, x: module.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, imgs))


def _port_features(model, imgs):
    with torch.no_grad():
        return model.eval()(
            torch.tensor(imgs).permute(0, 3, 1, 2)).numpy()


def test_registry_builds_every_resnet_with_its_spec():
    assert set(RESNET_SPECS) == set(JAX_SPECS)
    for name, (block, layers, groups, wpg) in RESNET_SPECS.items():
        assert JAX_SPECS[name] == (block, layers, groups, wpg)
        with torch.device("meta"):
            m = _reid_resnet(name)(num_classes=5, loss="softmax",
                                   dtype=torch.float32)
        assert [len(getattr(m, f"layer{s}")) for s in range(1, 5)] == list(
            layers)
        assert m.feature_dim == (512 if block == "basic" else 2048)
        conv2 = m.layer1[0].conv2
        assert conv2.groups == groups
        assert conv2.out_channels == (64 if block == "basic"
                                      else int(64 * wpg / 64) * groups)
    m = _port_model("resnet50_fc512", 5)
    assert m.feature_dim == 512 and m.layer4[0].conv2.stride == (1, 1)
    assert _port_model("resnet50", 5).layer4[0].conv2.stride == (2, 2)


@pytest.fixture(scope="module", params=list(ARCHS))
def jax_ref(request):
    """The JAX model's eval features and one ImageSoftmaxEngine step (its
    own jitted ``_build_train_step``) from random weights, numpy only."""
    name = request.param
    jdm = JaxImageDataManager(**DATA)
    module = _jax_module(name, jdm.num_train_pids)
    params, stats = _random_variables(module, seed=5)
    imgs = _images()
    model = ReIDModel(module=module, name=name,
                      num_classes=jdm.num_train_pids, loss="softmax")
    eng = JaxSoftmaxEngine(
        jdm, model, optimizer=jax_build_optimizer(**OPTIM),
        scheduler=jax_build_lr_scheduler("single_step", stepsize=[20],
                                         base_lr=LR),
        variables={"params": params, "batch_stats": stats},
        mesh=make_mesh([1]), donate=False, seed=0, label_smooth=True)
    batch = next(iter(jdm.train_loader))
    s1, m1 = eng._build_train_step()(eng.state, *eng._put_batch(batch),
                                     jax.random.PRNGKey(0), LR, None)
    return dict(name=name, module=module, params=params, stats=stats,
                imgs=imgs, feats=_jax_features(module, params, stats, imgs),
                batch=batch, m1={k: float(v) for k, v in m1.items()},
                s1=jax.tree_util.tree_map(
                    np.asarray, (s1.params, s1.batch_stats)))


def test_eval_features_match_jax(jax_ref):
    model = _port_model(jax_ref["name"], DATA["num_pids"])
    load_jax_variables(model, jax_ref["params"], jax_ref["stats"])
    got = _port_features(model, jax_ref["imgs"])
    want = jax_ref["feats"]
    assert got.shape == want.shape == (4, model.feature_dim)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_softmax_train_step_matches_jax(jax_ref):
    dm = ImageDataManager(**DATA)
    assert dm.num_streams == 1
    model = _port_model(jax_ref["name"], dm.num_train_pids)
    load_jax_variables(model, jax_ref["params"], jax_ref["stats"])
    eng = ImageSoftmaxEngine(dm, model, build_optimizer(model, **OPTIM),
                             build_lr_scheduler("single_step", stepsize=[20],
                                                base_lr=LR),
                             device="cpu", seed=0)
    set_lr(eng.optimizer, LR)
    batch = next(iter(dm.train_loader))
    assert batch["impath"] == jax_ref["batch"]["impath"]
    assert batch["img"].shape == (8, H, W, 3)  # one stream, not a tuple
    old = {k: v.clone() for k, v in model.state_dict().items()}
    metrics = eng.train_step(*eng._put_batch(batch))
    assert set(metrics) == set(jax_ref["m1"]) == {"acc", "loss"}
    for k, want in jax_ref["m1"].items():
        np.testing.assert_allclose(float(metrics[k]), want, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    w_old = _reid_resnet_to_state_dict(jax_ref["params"], jax_ref["stats"])
    w_new = _reid_resnet_to_state_dict(*jax_ref["s1"])
    got = model.state_dict()
    assert set(w_new) == {k for k in got
                          if not k.endswith("num_batches_tracked")}
    params = {k for k, _ in model.named_parameters()}
    for k, want in w_new.items():
        want = np.asarray(want, np.float32)
        g = got[k].numpy()
        if k not in params:  # running statistics
            np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
            continue
        d_want = want - np.asarray(w_old[k], np.float32)
        d_got = g - old[k].numpy()
        rel = np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want)
        assert rel <= 2e-2, (k, rel)


def test_state_dict_converts_to_the_jax_model(jax_ref):
    # the port's own seeded init, BN statistics and scales made non-trivial
    model = _port_model(jax_ref["name"], DATA["num_pids"], seed=11)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, FastBatchNorm):
                c = bn.num_features
                bn.weight.add_(0.1 * torch.randn(c, generator=gen))
                bn.bias.add_(0.1 * torch.randn(c, generator=gen))
                bn.running_mean.add_(0.1 * torch.randn(c, generator=gen))
                bn.running_var.add_(torch.rand(c, generator=gen))
    sd = model.state_dict()
    assert list(sd)[:2] == ["conv1.weight", "bn1.weight"]
    assert list(sd)[-2:] == ["classifier.weight", "classifier.bias"]
    if jax_ref["name"] == "resnet50_fc512":
        assert {"fc.0.weight", "fc.1.running_var"} <= set(sd)
    # the converter aligns by the flax tree's creation order, which only
    # the module's own init keeps (a tree_map sorts the keys)
    template = jax_ref["module"].init(jax.random.PRNGKey(0),
                                      jnp.zeros((2, H, W, 3)), train=True)
    converted, skipped = convert_torch_zoo(
        sd, {k: template[k] for k in ("params", "batch_stats")})
    assert skipped == []
    want = _port_features(model, jax_ref["imgs"])
    got = _jax_features(jax_ref["module"], converted["params"],
                        converted["batch_stats"], jax_ref["imgs"])
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    # and back: load_jax_variables is the inverse, bit for bit
    again = _port_model(jax_ref["name"], DATA["num_pids"])
    load_jax_variables(again, jax.tree_util.tree_map(
        np.asarray, converted["params"]), jax.tree_util.tree_map(
        np.asarray, converted["batch_stats"]))
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(again.state_dict()[k], v), k


def test_two_layer_neck_with_dropout():
    module = JaxReIDResNet(num_classes=5, block="basic", layers=LAYERS,
                           fc_dims=[32, 16], dropout_p=0.5,
                           dtype=jnp.float32)
    params, stats = _random_variables(module, seed=2)
    imgs = _images()

    def build():
        return build_model("resnet18", 5, pretrained=False, dtype="float32",
                           device="cpu", layers=LAYERS, fc_dims=[32, 16],
                           dropout_p=0.5)

    model = build()
    load_jax_variables(model, params, stats)
    assert {"fc.0.0.weight", "fc.1.1.running_var"} <= set(model.state_dict())
    np.testing.assert_allclose(_port_features(model, imgs),
                               _jax_features(module, params, stats, imgs),
                               rtol=2e-4, atol=2e-4)
    # the masks come from the engine's generator, seeded with its seed
    dm = ImageDataManager(**DATA)
    x = torch.tensor(imgs).permute(0, 3, 1, 2)
    with torch.no_grad():
        runs = []
        for seed in (0, 0, 1):
            m = build()
            m.load_state_dict(model.state_dict())
            eng = ImageSoftmaxEngine(dm, m, device="cpu", seed=seed)
            assert m.dropout_generator is eng.generator
            runs.append(m.train()(x))
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0],
                                                             runs[2])


@pytest.mark.parametrize("flag", ["fused_1x1", "block_megakernel"])
def test_grouped_block_refuses_kernel_flags(flag):
    # the fused 1x1 and whole-block paths take ungrouped blocks only; a
    # grouped block is refused rather than quietly run plain
    with pytest.raises(ValueError, match="ungrouped"):
        Bottleneck(64, 64, groups=32, base_width=4, **{flag: True})
    Bottleneck(64, 64, **{flag: True})


def test_units_and_fixbase_follow_the_jax_top_level_names():
    # train.open_layers matches the JAX tree's top-level names: trunk,
    # fc0, classifier
    dm = ImageDataManager(**DATA)
    model = _port_model("resnet50_fc512", dm.num_train_pids)
    assert [n for n, _ in named_units(model)] == ["trunk", "fc0",
                                                  "classifier"]
    eng = ImageSoftmaxEngine(dm, model, build_optimizer(model, **OPTIM),
                             device="cpu", seed=0)
    frozen = eng._freeze(["classifier"], bn_eval=True, bn_freeze=False)
    open_now = {n for n, p in model.named_parameters() if p.requires_grad}
    assert open_now == {"classifier.weight", "classifier.bias"}
    eng._unfreeze(frozen)
    assert all(p.requires_grad for p in model.parameters())


def test_pretrained_trunk_from_a_local_torchvision_file(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    model = _port_model("resnet18", 5, seed=1)
    with pytest.warns(UserWarning, match="No local pretrained weights for "
                                         "resnet18"):
        assert not load_pretrained_trunks(model)
    # a torchvision-layout file: the trunk's keys and a 1000-way fc head
    donor = _port_model("resnet18", 5, seed=2)
    sd = {k: v for k, v in donor.state_dict().items()
          if not k.startswith("classifier.")}
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 512), torch.zeros(1000)
    hub = tmp_path / ".cache" / "torch" / "hub" / "checkpoints"
    hub.mkdir(parents=True)
    torch.save(sd, hub / "resnet18-f37072fd.pth")
    head = model.classifier.weight.clone()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert load_pretrained_trunks(model)
    for k, v in model.state_dict().items():
        if not k.startswith("classifier."):
            assert torch.equal(v, donor.state_dict()[k]), k
    assert torch.equal(model.classifier.weight, head)
