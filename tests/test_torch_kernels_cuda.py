"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the ``cuda``
fixture decides at run time, never at import). Run on a card with
``python -m pytest tests/test_torch_kernels_cuda.py``. The same plain
versions are held to the JAX package on the CPU in
``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from ieee_tpu_torch.ops import kernels
from ieee_tpu_torch.ops.kernels.distmat import euclidean_sq, euclidean_sq_plain
from ieee_tpu_torch.ops.kernels.matmul_bn import (
    dy_plain,
    mm_affine_act,
    mm_affine_act_plain,
    mm_bn_act_train,
    mm_bn_da,
    mm_bn_da_plain,
    mm_bn_dw,
    mm_bn_dw_plain,
    mm_stats,
    mm_stats_plain,
)
from ieee_tpu_torch.ops.kernels.partpool import (
    fused_partpool_project,
    fused_partpool_project_plain,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, device, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal(shape).astype(np.float32) * scale,
                        device=device)


# distmat: full-f32 FMA against cuBLAS f32 (no TF32); the two sum K products
# in different orders, so the error is a few f32 ulps of the largest |entry|
@pytest.mark.parametrize("m,n,k", [(836, 836, 2304), (170, 340, 2304),
                                   (37, 300, 19), (1, 129, 130)])
def test_distmat_kernel_matches_plain(cuda, m, n, k):
    q = _randn((m, k), 0, cuda)
    g = _randn((n, k), 1, cuda)
    before = kernels.LAUNCHES["distmat"]
    got = euclidean_sq(q, g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["distmat"] == before + 1
    want = euclidean_sq_plain(q, g)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


# mm_affine: bf16 operands, f32 accumulation in both; the bf16 outputs may
# differ by one bf16 rounding step (2^-8 relative) where the f32 sums differ
@pytest.mark.parametrize("n,k,c,relu", [
    (12800, 1024, 512, True), (12800, 512, 2048, False),
    (1037, 2048, 768, True), (100, 2048, 768, False), (13, 24, 40, True)])
def test_mm_affine_kernel_matches_plain(cuda, n, k, c, relu):
    a = _randn((n, k), 2, cuda).to(torch.bfloat16)
    w = _randn((k, c), 3, cuda, scale=k ** -0.5)
    inv = _randn((c,), 4, cuda).abs() + 0.5
    shift = _randn((c,), 5, cuda)
    before = kernels.LAUNCHES["mm_affine"]
    got = mm_affine_act(a, w, inv, shift, relu).float()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mm_affine"] == before + 1
    want = mm_affine_act_plain(a, w, inv, shift, relu).float()
    assert got.dtype == torch.float32 and got.shape == (n, c)
    tol = 2 ** -7 * want.abs().clamp_min(1.0)
    assert ((got - want).abs() <= tol).all(), (got - want).abs().max().item()


# partpool: same rounding points; pooled rows are rounded to bf16 in both,
# so a pooled value whose f32 sum differs in the last bit may round to a
# neighbouring bf16 value: bound the error by 1e-2 of the output scale
@pytest.mark.parametrize("b,h,w,c,f,parts,dtype", [
    (100, 16, 8, 2048, 768, 6, torch.float32),
    (37, 16, 8, 2048, 768, 6, torch.bfloat16),
    (3, 6, 2, 64, 32, 6, torch.float32),
    (5, 4, 2, 32, 16, 6, torch.float32)])
def test_partpool_kernel_matches_plain(cuda, b, h, w, c, f, parts, dtype):
    x = _randn((b, h, w, c), 6, cuda).abs().to(dtype)
    wt = _randn((c, f), 7, cuda, scale=c ** -0.5)
    s = _randn((f,), 8, cuda).abs() + 0.5
    t = _randn((f,), 9, cuda)
    before = kernels.LAUNCHES["partpool"]
    got = fused_partpool_project(x, wt, s, t, parts=parts)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["partpool"] == before + 1
    want = fused_partpool_project_plain(x, wt, s, t, parts=parts)
    assert got.shape == want.shape == (b, parts + 1, f)
    err = (got - want).abs().max().item()
    assert err <= 1e-2 * max(1.0, want.abs().max().item()), err


# ------------------------------------------------------ train kernels
# The main path's (K, C) pairs: layer4 cb1 (1024->512, 2048->512), cb3
# (512->2048), downsample (1024->2048), CIM (2048->2048), reduce
# (2048->768); N = 16384 is batch 128 at 256x128, N = 48 the reduce site at
# batch 8, N = 1037 a ragged edge.
TRAIN_SHAPES = [(16384, 1024, 512, True), (1024, 2048, 2048, True),
                (48, 2048, 768, True), (1037, 512, 2048, False),
                (8, 2048, 768, True), (13, 24, 40, False)]


def _train_inputs(n, k, c, device):
    a = _randn((n, k), 10, device).to(torch.bfloat16)
    w = _randn((k, c), 11, device, scale=k ** -0.5)
    d = _randn((n, c), 12, device).to(torch.bfloat16)
    y = _randn((n, c), 13, device).to(torch.bfloat16)
    inv = _randn((c,), 14, device).abs() + 0.5
    vecs = torch.stack([inv, _randn((c,), 15, device),
                        0.1 * _randn((c,), 16, device),
                        _randn((c,), 17, device).abs() + 0.5,
                        0.1 * _randn((c,), 18, device),
                        0.1 * _randn((c,), 19, device)])
    return a, w, d, y, vecs


# mm_stats: y rounds to bf16 in both (one bf16 step, plus 1e-5 of the
# largest |y| where the f32 sums differ near zero); the f32 channel sums
# differ only by summation order: 1e-5 of sum |y| (sum y^2)
@pytest.mark.parametrize("n,k,c,relu", TRAIN_SHAPES)
def test_mm_stats_kernel_matches_plain(cuda, n, k, c, relu):
    a, w, *_ = _train_inputs(n, k, c, cuda)
    before = kernels.LAUNCHES["mm_stats"]
    y, st = mm_stats(a, w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mm_stats"] == before + 1
    y_want, st_want = mm_stats_plain(a, w)
    y, y_want = y.float(), y_want.float()
    tol = 2 ** -7 * y_want.abs() + 1e-5 * y_want.abs().max()
    assert ((y - y_want).abs() <= tol).all(), (y - y_want).abs().max().item()
    y32 = a.float() @ w.to(torch.bfloat16).float()
    bound = 1e-5 * torch.stack([y32.abs().sum(0), (y32 * y32).sum(0)])
    assert ((st - st_want).abs() <= bound).all()
    y2, st2 = mm_stats(a, w)  # deterministic: no float atomics
    assert torch.equal(st, st2) and torch.equal(y.to(torch.bfloat16), y2)


# mm_bn_da: dy is the same bf16 tensor in both (same rounding points, no
# FMA contraction), the products are summed in another order, and the bf16
# output may round to the neighbouring value: one bf16 step plus 1e-5 of
# sum |dy| |w|
@pytest.mark.parametrize("n,k,c,relu", TRAIN_SHAPES)
def test_mm_bn_da_kernel_matches_plain(cuda, n, k, c, relu):
    a, w, d, y, vecs = _train_inputs(n, k, c, cuda)
    before = kernels.LAUNCHES["mm_bn_da"]
    got = mm_bn_da(d, y, vecs, w, relu).float()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mm_bn_da"] == before + 1
    want = mm_bn_da_plain(d, y, vecs, w, relu).float()
    dy = dy_plain(d, y, vecs, relu).float()
    bound = dy.abs() @ w.to(torch.bfloat16).float().abs().t()
    tol = 2 ** -7 * want.abs() + 1e-5 * bound
    assert ((got - want).abs() <= tol).all(), (got - want).abs().max().item()


# mm_bn_dw: f32 out; the N products are summed in another order (split
# over row ranges): 1e-5 of sum |a| |dy|
@pytest.mark.parametrize("n,k,c,relu", TRAIN_SHAPES)
def test_mm_bn_dw_kernel_matches_plain(cuda, n, k, c, relu):
    a, w, d, y, vecs = _train_inputs(n, k, c, cuda)
    before = kernels.LAUNCHES["mm_bn_dw"]
    got = mm_bn_dw(a, d, y, vecs, relu)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mm_bn_dw"] == before + 1
    want = mm_bn_dw_plain(a, d, y, vecs, relu)
    dy = dy_plain(d, y, vecs, relu).float()
    bound = a.float().abs().t() @ dy.abs()
    assert ((got - want).abs() <= 1e-5 * bound + 1e-30).all(), \
        (got - want).abs().max().item()
    assert torch.equal(got, mm_bn_dw(a, d, y, vecs, relu))


# the whole op, kernels against its plain version (``plain=True``) on the
# same inputs. y may differ by one bf16 step where the f32 sums differ, and
# that moves x-hat and now and then the ReLU mask of one element, so the
# bf16 tensors (act, da, dres) and the f32 gradients (dw, dscale, dbias) are
# held to a relative Frobenius error of one bf16 step (2^-8); mean and var
# come from channel sums that differ in order only: 1e-5 of the largest var
@pytest.mark.parametrize("n,k,c,relu,res", [
    (16384, 2048, 512, True, False), (16384, 512, 2048, False, True),
    (768, 2048, 768, True, False), (1037, 1024, 2048, False, False)])
def test_mm_bn_act_train_kernels_match_plain(cuda, n, k, c, relu, res):
    a, w, d, *_ = _train_inputs(n, k, c, cuda)
    r = _randn((n, c), 20, cuda).to(torch.bfloat16) if res else None
    outs = {}
    for plain in (False, True):
        kernels.reset_launch_counts()
        leaves = [t.clone().float().requires_grad_() for t in (a, w)]
        scale = (_randn((c,), 21, cuda).abs() + 0.5).requires_grad_()
        bias = _randn((c,), 22, cuda).requires_grad_()
        rr = r.clone().requires_grad_() if res else None
        act, mean, var = mm_bn_act_train(leaves[0], leaves[1], scale, bias,
                                         rr, relu, plain=plain)
        act.backward(d)
        torch.cuda.synchronize()
        launched = [kernels.LAUNCHES[x] for x in
                    ("mm_stats", "mm_bn_da", "mm_bn_dw")]
        assert launched == ([0, 0, 0] if plain else [1, 1, 1])
        outs[plain] = dict(act=act.float(), mean=mean, var=var,
                           da=leaves[0].grad, dw=leaves[1].grad,
                           dscale=scale.grad, dbias=bias.grad,
                           dres=rr.grad.float() if res else None)
    got, want = outs[False], outs[True]
    vtol = 1e-5 * want["var"].abs().max()
    for name in ("mean", "var"):
        assert (got[name] - want[name]).abs().max() <= vtol, name
    for name in ("act", "da", "dw", "dscale", "dbias", "dres"):
        if want[name] is None:
            continue
        rel = (got[name] - want[name]).norm() / want[name].norm()
        assert rel <= 2 ** -8, (name, rel.item())
