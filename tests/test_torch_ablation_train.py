"""The ablation configs' training against the JAX package: the multi-modal
softmax engine on the base variant (no CIM, CA or REM), then a fixbase
step; the fixbase rule on the fused and block sites; the refusals that
stand. The CLI runs both configs in ``tests/test_torch_ablation_cli.py``.

The JAX side is ``MultiModalImageSoftmaxEngine``'s own jitted step
(``_build_train_step``) on one device at ``backbone_layers=(1, 1, 1, 1)``
in f32, on random numpy weights (``test_torch_model._random_variables``)
moved into the port by ``load_jax_variables``; 64x32 images, batch 8 (P =
2 ids x K = 4), augmentation off, SGD with nesterov momentum and weight
decay (the configs' optimizer). Tolerances, the port's stated ones
(``tests/test_torch_train_step.py``): metrics 1e-4 relative, each
tensor's update 2e-2 in relative norm, running statistics 1e-4. Under
fixbase the frozen parameters, their SGD moments and the frozen BNs'
statistics must not move at all.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ieee_tpu.data import ImageDataManager as JaxImageDataManager
from ieee_tpu.engine import MultiModalImageSoftmaxEngine as JaxSoftmaxEngine
from ieee_tpu.models import build_model as jax_build_model
from ieee_tpu.optim import build_lr_scheduler as jax_build_lr_scheduler
from ieee_tpu.optim import build_optimizer as jax_build_optimizer
from ieee_tpu.parallel import make_mesh
from ieee_tpu_torch.config import get_default_config
from ieee_tpu_torch.data import ImageDataManager
from ieee_tpu_torch.engine import MultiModalImageSoftmaxEngine, build_engine
from ieee_tpu_torch.models import build_model, common, resnet
from ieee_tpu_torch.models.common import FastBatchNorm
from ieee_tpu_torch.models.weights import (
    _jax_to_state_dict,
    load_jax_variables,
)
from ieee_tpu_torch.optim import build_lr_scheduler, build_optimizer, set_lr

from test_torch_model import _random_variables
from torch_threads import one_torch_thread  # noqa: F401

LAYERS = (1, 1, 1, 1)
PARTS = 6
LR = 0.01
DATA = dict(sources="synthetic_mm", height=64, width=32, batch_size_train=8,
            batch_size_test=8, workers=0,
            train_sampler="RandomIdentitySampler", num_instances=4,
            num_pids=4, imgs_per_pid=4, transforms=[], verbose=False, seed=0)
OPTIM = dict(optim="sgd", lr=LR, momentum=0.9, weight_decay=5e-4,
             sgd_nesterov=True)
BASE = dict(interaction=False, attention=False, using_REM=False)
OPEN = ["classifier"]
METRICS = ("loss", "loss_R", "loss_N", "loss_T", "acc_R", "acc_N", "acc_T")


def jax_engine(flags, seed, **engine_kw):
    """A JAX softmax engine on random variables from ``seed``, and its
    first batch placed on the device."""
    k_tfm = engine_kw.pop("k_tfm", 1)
    jdm = JaxImageDataManager(**DATA, k_tfm=k_tfm)
    m = jax_build_model("ieee3modalPart", num_classes=jdm.num_train_pids,
                        loss="softmax", pretrained=False,
                        backbone_layers=LAYERS, dtype=jnp.float32, **flags)
    params, stats = _random_variables(m.module, seed=seed)
    eng = JaxSoftmaxEngine(
        jdm, m, optimizer=jax_build_optimizer(**OPTIM),
        scheduler=jax_build_lr_scheduler("multi_step", stepsize=[20, 40],
                                         base_lr=LR),
        variables={"params": params, "batch_stats": stats},
        mesh=make_mesh([1]), donate=False, seed=0, label_smooth=True,
        **engine_kw)
    batch = next(iter(jdm.train_loader))
    return eng, params, stats, batch, eng._put_batch(batch)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_engine(flags, params, stats, k_tfm=1, **engine_kw):
    dm = ImageDataManager(**DATA, k_tfm=k_tfm)
    model = build_model("ieee3modalPart", dm.num_train_pids, "softmax",
                        pretrained=False, dtype="float32",
                        backbone_layers=LAYERS, device="cpu", **flags)
    load_jax_variables(model, params, stats)
    opt = build_optimizer(model, **OPTIM)
    sched = build_lr_scheduler("multi_step", stepsize=[20, 40], base_lr=LR)
    eng = MultiModalImageSoftmaxEngine(dm, model, opt, sched, device="cpu",
                                       seed=0, **engine_kw)
    set_lr(opt, LR)
    return dm, model, eng


def port_batch(dm, eng, ref_batch):
    batch = next(iter(dm.train_loader))
    # the sampler's copy draws the same P x K batch for the same seed
    assert batch["impath"] == ref_batch["impath"]
    return eng._put_batch(batch)


def snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def assert_metrics(got, want):
    assert set(got) == set(want) == set(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def assert_step(model, old, want_old, want_new):
    """The port's step (``old`` -> its state now) against the JAX step
    (``want_old`` -> ``want_new``, flax (params, stats) pairs), in the
    port's key layout: each parameter's update within 2e-2 relative norm
    (a parameter the JAX step leaves as it was must stay bit for bit), each
    running statistic within 1e-4."""
    w_old = _jax_to_state_dict(*want_old, PARTS)
    w_new = _jax_to_state_dict(*want_new, PARTS)
    got = model.state_dict()
    assert set(w_new) == {k for k in got
                          if not k.endswith("num_batches_tracked")}
    params = {k for k, _ in model.named_parameters()}
    for k, want in w_new.items():
        want = np.asarray(want, np.float32)
        g = got[k].detach().numpy()
        if k not in params:
            np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-5,
                                       err_msg=k)
            continue
        d_want = want - np.asarray(w_old[k], np.float32)
        d_got = g - old[k].numpy()
        if not np.abs(d_want).any():
            assert not np.abs(d_got).any(), k
            continue
        rel = np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want)
        assert rel <= 2e-2, (k, rel)


@pytest.fixture(scope="module")
def jax_base():
    """A base-variant step, then a fixbase step with ``open_layers
    ['classifier']`` as ``Engine.train`` builds it (parameter and moment
    mask, the BN stats mask, the BN-eval interceptor), numpy only."""
    eng, params, stats, batch, (imgs, pids) = jax_engine(BASE, seed=5)
    step = eng._build_train_step()
    key = jax.random.PRNGKey(0)
    s1, m1 = step(eng.state, imgs, pids, key, LR, None)
    eng.state = s1
    s2, m2 = step(s1, imgs, pids, key, LR, eng._open_layers_mask(OPEN),
                  eng._open_layers_mask(OPEN, tree=s1.batch_stats), None,
                  tuple(OPEN))
    return dict(params=params, stats=stats, batch=batch,
                m1={k: float(v) for k, v in m1.items()},
                m2={k: float(v) for k, v in m2.items()},
                s1=(to_np(s1.params), to_np(s1.batch_stats)),
                s2=(to_np(s2.params), to_np(s2.batch_stats)))


def test_base_softmax_step_then_fixbase_step_match_jax(jax_base):
    ref = jax_base
    dm, model, eng = port_engine(BASE, ref["params"], ref["stats"])
    assert not hasattr(model, "convOne") and not hasattr(model, "REM")
    imgs, pids = port_batch(dm, eng, ref["batch"])
    old = snapshot(model)
    assert_metrics(eng.train_step(imgs, pids), ref["m1"])
    assert_step(model, old, (ref["params"], ref["stats"]), ref["s1"])

    # fixbase: only the classifiers train
    opt = eng.optimizer
    names = {p: n for n, p in model.named_parameters()}
    old = snapshot(model)
    moments = {names[p]: st["momentum_buffer"].clone()
               for p, st in opt.state.items()}
    assert len(moments) == len(names)
    frozen = eng._freeze(OPEN, bn_eval=True, bn_freeze=False)
    assert_metrics(eng.train_step(imgs, pids), ref["m2"])
    eng._unfreeze(frozen)
    assert_step(model, old, ref["s1"], ref["s2"])
    new = model.state_dict()
    for k, v in old.items():
        if k.startswith("classifier_"):
            if k.endswith("weight"):
                assert not torch.equal(new[k], v), k
        else:  # parameters, running statistics and their counters
            assert torch.equal(new[k], v), k
    for n, m in moments.items():
        now = opt.state[dict(model.named_parameters())[n]]["momentum_buffer"]
        assert torch.equal(now, m) != n.startswith("classifier_"), n
    # the fixbase flags are undone
    assert all(p.requires_grad for p in model.parameters())
    assert not any(b.use_running or b.pin_stats for b in model.modules()
                   if isinstance(b, FastBatchNorm))


def test_fixbase_on_the_fused_and_block_sites(monkeypatch):
    # the JAX package's rule on its kernel paths: its interceptor reaches
    # flax BN modules only, so a frozen module's fused 1x1 sites and block
    # path still normalise with batch statistics, and the stats mask keeps
    # every frozen running statistic; the plain sites normalise with the
    # running ones. Layers (1, 2, 1, 1): layer2.1 takes the block path;
    # layer4 (cb1, cb3, downsample) and reduce (twice) are fused sites
    dm = ImageDataManager(**DATA)
    model = build_model("ieee3modalPart", dm.num_train_pids, "softmax",
                        pretrained=False, backbone_layers=(1, 2, 1, 1),
                        device="cpu", seed=3, fused_1x1=True,
                        block_megakernel=True, **BASE)
    opt = build_optimizer(model, **OPTIM)
    eng = MultiModalImageSoftmaxEngine(dm, model, opt, device="cpu", seed=0)
    set_lr(opt, LR)
    imgs, pids = eng._put_batch(next(iter(dm.train_loader)))
    calls = Counter()

    def spy(mod, name):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    spy(common, "mm_bn_act_train")
    spy(common, "mm_affine_act")
    spy(resnet, "bottleneck_train")
    stem_bn = model.backbone[0].bn1
    seen = {}
    stem_bn.register_forward_hook(
        lambda m, i, o: seen.update(x=i[0].detach(), y=o.detach()))

    eng.train_step(imgs, pids)  # an open step first: moments exist
    old = snapshot(model)
    calls.clear()
    frozen = eng._freeze(OPEN, bn_eval=True, bn_freeze=False)
    eng.train_step(imgs, pids)
    eng._unfreeze(frozen)
    # 3 trunks x (layer4's 3 sites) + 3 reduce layers x 2 calls; the
    # block path once a trunk; no folded (running-statistics) 1x1 site
    assert calls == {"mm_bn_act_train": 15, "bottleneck_train": 3}
    inv, shift = stem_bn.folded()
    want = (seen["x"].to(stem_bn.dtype) * inv.to(stem_bn.dtype)[:, None, None]
            + shift.to(stem_bn.dtype)[:, None, None])
    assert torch.equal(seen["y"], want)  # running statistics at a plain site
    new = model.state_dict()
    for k, v in old.items():
        if k.startswith("classifier_"):
            assert k.endswith("bias") or not torch.equal(new[k], v), k
        else:
            assert torch.equal(new[k], v), k
    # the open step after it moves the statistics of each kind of site;
    # in two micro-batches, each runs every fused site and block
    calls.clear()
    eng.accum_steps = 2
    m = eng.train_step(imgs, pids)
    assert calls == {"mm_bn_act_train": 30, "bottleneck_train": 6}
    assert torch.isfinite(m["loss"])
    new = model.state_dict()
    for site in ("layer4.0.bn1", "bn1", "layer2.1.bn2"):
        k = f"backbone.0.{site}.running_mean"
        assert not torch.equal(new[k], old[k]), k


def test_fixbase_bn_freeze_alone_normalises_by_batch():
    # fixbase_bn_freeze without fixbase_bn_eval: batch statistics in every
    # forward, the frozen running statistics pinned
    dm = ImageDataManager(**DATA)
    model = build_model("ieee3modalPart", dm.num_train_pids, "softmax",
                        pretrained=False, backbone_layers=LAYERS,
                        device="cpu", seed=3, dtype="float32", **BASE)
    eng = MultiModalImageSoftmaxEngine(dm, model, build_optimizer(
        model, **OPTIM), device="cpu", seed=0)
    imgs, pids = eng._put_batch(next(iter(dm.train_loader)))
    old = snapshot(model)
    frozen = eng._freeze(OPEN, bn_eval=False, bn_freeze=True)
    bn = model.fc_R[0][1]
    assert (bn.use_running, bn.pin_stats) == (False, True)
    eng.train_step(imgs, pids)
    eng._unfreeze(frozen)
    new = model.state_dict()
    assert all(torch.equal(new[k], v) for k, v in old.items()
               if not k.startswith("classifier_"))


def test_accum_steps_must_divide_the_batch():
    dm = ImageDataManager(**DATA)
    model = build_model("ieee3modalPart", dm.num_train_pids, "softmax",
                        pretrained=False, backbone_layers=LAYERS,
                        device="cpu", **BASE)
    opt = build_optimizer(model, **OPTIM)
    eng = MultiModalImageSoftmaxEngine(dm, model, opt, device="cpu",
                                       accum_steps=3)
    imgs, pids = eng._put_batch(next(iter(dm.train_loader)))
    with pytest.raises(ValueError, match="not divisible by accum_steps=3"):
        eng.train_step(imgs, pids)
    with pytest.raises(ValueError, match="accum_steps must be >= 1"):
        MultiModalImageSoftmaxEngine(dm, model, opt, device="cpu",
                                     accum_steps=0)


@pytest.mark.parametrize("loss", ["triplet", "hcloss", "CMT"])
def test_build_engine_refuses_the_engines_still_missing(loss):
    cfg = get_default_config()
    cfg.loss.name = loss
    dm = ImageDataManager(**DATA)
    with pytest.raises(NotImplementedError, match="A.8"):
        build_engine(cfg, dm, None, device="cpu")
