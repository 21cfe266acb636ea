"""Gradient accumulation and k_tfm against the JAX package: one
``MultiModalImageSoftmaxEngine`` step of the cim variant (CIM + CA, no
REM) with ``accum_steps=2``, and one of the full IEEE model with
``data.k_tfm 2``, each against the JAX engine's own jitted step on the
same weights and batch (``_accum_grads``; the transform's (K, B, ...)
draws and ``_fold_k_tfm``). The set-up, sizes and tolerances are those of
``tests/test_torch_ablation_train.py``: metrics 1e-4 relative, each
tensor's update 2e-2 in relative norm, running statistics 1e-4. With
augmentation off the K draws of an image are equal, so the k_tfm step
holds the fold's order and the pids' repetition to the JAX step's.
"""

import jax
import numpy as np
import pytest
import torch

from ieee_tpu_torch.data.transforms import build_transforms
from ieee_tpu_torch.engine import Engine

from test_torch_ablation_train import (
    LR, assert_metrics, assert_step, jax_engine, port_batch, port_engine,
    snapshot, to_np)
from torch_threads import one_torch_thread  # noqa: F401

CIM = dict(interaction=True, attention=True, using_REM=False)
FULL = dict(interaction=True, attention=True, using_REM=True)


def _jax_step(flags, seed, **engine_kw):
    eng, params, stats, batch, (imgs, pids) = jax_engine(flags, seed,
                                                         **engine_kw)
    state, metrics = eng._build_train_step()(
        eng.state, imgs, pids, jax.random.PRNGKey(0), LR, None)
    return dict(params=params, stats=stats, batch=batch,
                metrics={k: float(v) for k, v in metrics.items()},
                new=(to_np(state.params), to_np(state.batch_stats)))


@pytest.mark.parametrize("flags, seed, kw", [
    (CIM, 6, dict(accum_steps=2)),
    (FULL, 7, dict(k_tfm=2)),
], ids=["cim-accum_steps2", "full-k_tfm2"])
def test_step_matches_jax(flags, seed, kw):
    ref = _jax_step(flags, seed, **kw)
    dm, model, eng = port_engine(flags, ref["params"], ref["stats"], **kw)
    imgs, pids = port_batch(dm, eng, ref["batch"])
    old = snapshot(model)
    assert_metrics(eng.train_step(imgs, pids), ref["metrics"])
    assert_step(model, old, (ref["params"], ref["stats"]), ref["new"])


def test_k_tfm_draws_and_fold():
    # K independent draws per image from the generator, in order, stacked
    # (K, B, 3, H, W); the fold puts each image's draws next to each other
    # in channels_last memory
    batch = torch.tensor(np.random.default_rng(1).integers(
        0, 256, (32, 4, 6, 3), dtype=np.uint8))
    one, _ = build_transforms(4, 6, transforms=["random_flip"])
    two, _ = build_transforms(4, 6, transforms=["random_flip"], k_tfm=2)
    g = torch.Generator().manual_seed(3)
    want = torch.stack([one(batch, g), one(batch, g)])
    got = two(batch, torch.Generator().manual_seed(3))
    assert got.shape == (2, 32, 3, 4, 6) and torch.equal(got, want)
    assert not torch.equal(got[0], got[1])
    folded = Engine._fold_k_tfm(got)
    assert folded.shape == (64, 3, 4, 6)
    assert folded.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(folded[0::2], got[0]) and torch.equal(folded[1::2],
                                                             got[1])
