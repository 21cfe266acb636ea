"""The port's training pieces against the JAX package, one at a time:
losses (values and input gradients), optimizers (three steps against
optax), LR schedulers, the P x K sampler's index order, the train
transform's flip, and the engine's loss.

All inputs come from numpy seeds. Tolerances: f32 on both sides, other
summation orders, 1e-5 relative unless a test says otherwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ieee_tpu.data.sampler import build_train_sampler as jax_sampler
from ieee_tpu.data.transforms import _random_flip as jax_flip
from ieee_tpu.engine.image.softmax import _deep_ce as jax_deep_ce
from ieee_tpu.losses import cross_entropy_loss as jax_ce
from ieee_tpu.losses import multi_modal_margin_loss as jax_margin
from ieee_tpu.optim import build_lr_scheduler as jax_build_lr_scheduler
from ieee_tpu.optim import build_optimizer as jax_build_optimizer
from ieee_tpu_torch.data import build_train_sampler
from ieee_tpu_torch.data.transforms import build_transforms, random_flip
from ieee_tpu_torch.engine.image.softmax import _deep_ce
from ieee_tpu_torch.losses import cross_entropy_loss, multi_modal_margin_loss
from ieee_tpu_torch.optim import build_lr_scheduler, build_optimizer, set_lr
from torch_threads import one_torch_thread  # noqa: F401


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _grad_pair(jax_fn, torch_fn, *arrays):
    """Value and gradients w.r.t. every input, on both sides."""
    jv, jg = jax.jit(jax.value_and_grad(
        jax_fn, argnums=tuple(range(len(arrays)))))(*map(jnp.asarray, arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tv = torch_fn(*ts)
    tv.backward()
    return (tv.item(), [t.grad.numpy() for t in ts],
            float(jv), [np.asarray(g) for g in jg])


@pytest.mark.parametrize("label_smooth", [True, False])
def test_deep_ce_matches_jax(label_smooth):
    # (B, P, C) part logits: P x the mean CE over B*P rows, and a (B, C) case
    pids = np.array([0, 0, 3, 3, 1, 1, 4, 4])
    for shape in ((8, 6, 5), (8, 5)):
        logits = _np(shape, 0, 3.0)
        tv, tg, jv, jg = _grad_pair(
            lambda x: jax_deep_ce(x, jnp.asarray(pids), 5, label_smooth),
            lambda x: _deep_ce(x, torch.tensor(pids), 5, label_smooth),
            logits)
        np.testing.assert_allclose(tv, jv, rtol=1e-5)
        np.testing.assert_allclose(tg[0], jg[0], rtol=1e-5, atol=1e-7)
    t = torch.tensor(_np((4, 3), 1))
    np.testing.assert_allclose(
        float(cross_entropy_loss(t, torch.tensor([0, 2, 1, 1]), eps=0.2)),
        float(jax_ce(t.numpy(), jnp.asarray([0, 2, 1, 1]), eps=0.2)),
        rtol=1e-6)


@pytest.mark.parametrize("mean_over_ids", [False, True])
def test_margin_loss_matches_jax(mean_over_ids):
    # three l2-normalised (B, D) modal features, P = 3 ids x K = 4
    feats = []
    for s in range(3):
        f = _np((12, 16), 10 + s)
        feats.append(f / np.linalg.norm(f, axis=1, keepdims=True))
    tv, tg, jv, jg = _grad_pair(
        lambda a, b, c: jax_margin(a, b, c, 4, margin=1.0,
                                   mean_over_ids=mean_over_ids),
        lambda a, b, c: multi_modal_margin_loss(
            a, b, c, 4, margin=1.0, mean_over_ids=mean_over_ids),
        *feats)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError):
        multi_modal_margin_loss(*(torch.zeros(10, 4) for _ in range(3)), 4)


@pytest.mark.parametrize("kw", [
    dict(optim="sgd", momentum=0.9, sgd_nesterov=True),
    dict(optim="sgd", momentum=0.9, sgd_nesterov=False, weight_decay=0.0),
    dict(optim="adam"),
    dict(optim="amsgrad"),
    dict(optim="rmsprop", momentum=0.9),
], ids=["sgd-nesterov", "sgd", "adam", "amsgrad", "rmsprop"])
def test_three_optimizer_steps_match_optax(kw):
    # two parameter tensors, three steps with fresh gradients, lr changed
    # between steps as the engine does per epoch
    import optax

    kw = dict(dict(lr=0.05, weight_decay=5e-4), **kw)
    shapes = [(3, 4), (5,)]
    params = [_np(s, 20 + i) for i, s in enumerate(shapes)]
    grads = [[_np(s, 30 + 10 * t + i) for i, s in enumerate(shapes)]
             for t in range(3)]
    lrs = [0.05, 0.05, 0.005]

    tx = jax_build_optimizer(**kw)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    for g, lr in zip(grads, lrs):
        state.hyperparams["learning_rate"] = lr
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)

    module = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.tensor(p)) for p in params])
    opt = build_optimizer(module, **kw)
    for g, lr in zip(grads, lrs):
        set_lr(opt, lr)
        for p, x in zip(module, g):
            p.grad = torch.tensor(x)
        opt.step()
    for p, want in zip(module, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_staged_lr_and_schedulers_match_jax():
    model = torch.nn.Module()
    model.backbone = torch.nn.Linear(2, 2)
    model.classifier_R = torch.nn.Linear(2, 2)
    opt = build_optimizer(model, optim="sgd", lr=0.1, staged_lr=True,
                          new_layers=["classifier"], base_lr_mult=0.1)
    set_lr(opt, 0.2)
    lrs = sorted(g["lr"] for g in opt.param_groups)
    np.testing.assert_allclose(lrs, [0.02, 0.2])
    for kw in (dict(lr_scheduler="multi_step", stepsize=[20, 40]),
               dict(lr_scheduler="single_step", stepsize=[7]),
               dict(lr_scheduler="cosine", max_epoch=61)):
        ours = build_lr_scheduler(base_lr=1e-3, **kw)
        theirs = jax_build_lr_scheduler(base_lr=1e-3, **kw)
        for epoch in (0, 6, 19, 20, 39, 40, 60):
            assert ours(epoch) == pytest.approx(theirs(epoch), rel=1e-12)
    with pytest.raises(NotImplementedError, match="A.12"):
        build_optimizer(model, optim="radam")


def test_identity_sampler_index_order_matches_jax():
    # 7 pids with 2..8 images each (fewer than K = 4 resamples), seed 3:
    # the same P x K index order, two epochs running
    items = [(f"p{pid}/{j}", pid, j % 2) for pid in range(7)
             for j in range(2 + pid)]
    ours = build_train_sampler(items, "RandomIdentitySampler", batch_size=8,
                               num_instances=4, seed=3)
    theirs = jax_sampler(items, "RandomIdentitySampler", batch_size=8,
                         num_instances=4, seed=3)
    for _ in range(2):
        a, b = list(ours), list(theirs)
        assert a == b and len(a) % 8 == 0
        for i in range(0, len(a), 4):  # K consecutive of one pid
            assert len({items[k][1] for k in a[i:i + 4]}) == 1
    assert len(ours) == len(theirs)


def test_flip_on_a_fixed_mask_matches_jax():
    # JAX draws the mask from its key; the port takes a mask. Feed the
    # port the mask the JAX draw made (found by comparing to the mirror)
    x = _np((6, 4, 5, 3), 40)
    want = np.asarray(jax_flip(jax.random.PRNGKey(7), jnp.asarray(x)))
    mask = np.array([np.array_equal(want[i], x[i, :, ::-1]) for i in range(6)])
    assert 0 < mask.sum() < 6
    got = random_flip(torch.tensor(x), torch.tensor(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    hand = np.array([True, False, False, True, True, False])
    got = random_flip(torch.tensor(x), torch.tensor(hand)).numpy()
    np.testing.assert_array_equal(got[hand], x[hand][:, :, ::-1])
    np.testing.assert_array_equal(got[~hand], x[~hand])


def test_train_transform_flips_from_the_generator_and_refuses_the_rest():
    batch = torch.tensor(np.random.default_rng(0).integers(
        0, 256, (64, 4, 6, 3), dtype=np.uint8))
    train_fn, test_fn = build_transforms(4, 6, transforms=["random_flip"])
    out = train_fn(batch, torch.Generator().manual_seed(0))
    plain = test_fn(batch)
    assert out.shape == plain.shape == (64, 3, 4, 6)
    flipped = torch.tensor([torch.equal(o, p.flip(2))
                            for o, p in zip(out, plain)])
    same = torch.tensor([torch.equal(o, p) for o, p in zip(out, plain)])
    assert bool((flipped | same).all()) and 16 < int(flipped.sum()) < 48
    again = train_fn(batch, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    train_fn, _ = build_transforms(4, 6, transforms=["random_flip",
                                                     "random_erase"])
    with pytest.raises(NotImplementedError, match="A.8"):
        train_fn(batch, torch.Generator())
    with pytest.raises(ValueError):
        build_transforms(4, 6, transforms=["no_such"])
