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
    mm_affine_act,
    mm_affine_act_plain,
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
