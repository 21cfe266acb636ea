"""Gradient accumulation and k_tfm on the card: one fused train step
(``cuda.fused_1x1``: ``mm_stats``, ``mm_bn_da`` and ``mm_bn_dw`` at the 33
fused sites of every forward) against the plain step on the same weights
and batch, with ``chip_smoke.py`` phase 7's rule: the loss within 1e-2
relative and every gradient tensor's cosine at least 0.8 (bf16 rounding
at other points; zero-by-structure tensors left out). Full depth at
256x128, batch 128 of ``synthetic_mm`` (32 ids x 4; with k_tfm 2, 64
images drawn twice), the margin engine.

Every test here needs a CUDA device and skips without one (the ``cuda``
fixture decides at run time). Run on a card with ``python -m pytest
tests/test_torch_ablation_cuda.py``.
"""

import pytest
import torch

from ieee_tpu_torch.data import ImageDataManager
from ieee_tpu_torch.engine import Image3MEngine
from ieee_tpu_torch.models import build_model
from ieee_tpu_torch.ops import kernels
from ieee_tpu_torch.optim import build_optimizer

GRAD_COS = 0.8
SITES = 33  # fused 1x1 sites of one forward of the full model


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _step(device, fused, batch, k_tfm, accum):
    dm = ImageDataManager(sources="synthetic_mm", height=256, width=128,
                          batch_size_train=batch, batch_size_test=100,
                          workers=0, train_sampler="RandomIdentitySampler",
                          num_instances=4, num_pids=171, imgs_per_pid=8,
                          verbose=False, seed=0, k_tfm=k_tfm)
    model = build_model("ieee3modalPart", 171, "margin", pretrained=False,
                        device=device, seed=1, fused_1x1=fused)
    opt = build_optimizer(model, optim="sgd", lr=0.001, momentum=0.9,
                          weight_decay=5e-4)
    eng = Image3MEngine(dm, model, opt, device=device, seed=0, margin=1.0,
                        accum_steps=accum)
    imgs, pids = eng._put_batch(next(iter(dm.train_loader)))
    kernels.reset_launch_counts()
    loss = eng.train_step(imgs, pids)["loss"].item()
    torch.cuda.synchronize(device)
    counts = {k: kernels.LAUNCHES[k] for k in ("mm_stats", "mm_bn_da",
                                                "mm_bn_dw")}
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters()}
    return loss, grads, counts


@pytest.mark.parametrize("batch, k_tfm, accum", [(128, 1, 2), (64, 2, 1)],
                         ids=["accum_steps2", "k_tfm2"])
def test_fused_step_matches_plain(cuda, batch, k_tfm, accum):
    lf, gf, counts = _step(cuda, True, batch, k_tfm, accum)
    # one forward of every fused site per micro-batch, and its backward
    assert counts == dict.fromkeys(counts, SITES * accum)
    lp, gp, counts = _step(cuda, False, batch, k_tfm, accum)
    assert counts == dict.fromkeys(counts, 0)
    assert abs(lf - lp) / abs(lp) <= 1e-2, (lf, lp)
    cos = {}
    for n, g in gp.items():
        f = gf[n]
        if n.startswith(("fc_", "REM.")) and n.endswith(
                (".0.bias", "conv_part.bias")):
            continue  # zero by structure (a train BN follows): noise
        if g.norm() == 0 and f.norm() == 0:
            continue  # REM conv_query/conv_value: outside the forward
        if n.startswith("REM.") and n.endswith(".param"):
            # REM's gamma, one element: a sum over the batch that cancels
            # to bf16 noise on both paths (measured on an H100: the plain
            # bf16 step's gammas differ in sign from the f32 step's too)
            continue
        cos[n] = ((f * g).sum() / (f.norm() * g.norm())).item()
    worst = min(cos, key=cos.get)
    assert cos[worst] >= GRAD_COS, (worst, cos[worst])
