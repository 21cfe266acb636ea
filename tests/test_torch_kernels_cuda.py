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

import torch.nn.functional as F

from ieee_tpu_torch.ops import kernels
from ieee_tpu_torch.ops.kernels import block_bwd as bb
from ieee_tpu_torch.ops.kernels.conv_s8 import conv_s8, conv_s8_plain
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
from ieee_tpu_torch.ops.kernels.probes import (
    bn_mm,
    bn_mm_plain,
    probe_mm_stats,
    probe_mm_stats_plain,
    scale_bf16,
    scale_bf16_plain,
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


# distmat: the 3xTF32 kernel (csrc/distmat.cu: x = hi + lo, three TF32
# products on the tensor cores into f32 sums) against cuBLAS f32 (no TF32);
# both carry a few f32 ulps of the largest |entry| of error, in different
# places. 170 x 340, 16 x 32 x 300, 836 x 836, 1 x 128 and 837 x 836 split
# K (2-18 parts added in order by a third launch; the last two with an odd
# m + n and an even n, the parts' float2 stores after the norms), the rest
# do not; K = 19, 130 and 300 are ragged (the split pass pads K to 32 with
# zeros), K = 0 gives zeros
@pytest.mark.parametrize("m,n,k", [(836, 836, 2304), (170, 340, 2304),
                                   (37, 300, 19), (1, 129, 130),
                                   (16, 32, 300), (3, 5, 0),
                                   (1, 128, 2304), (837, 836, 2304)])
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


def _features(shape, seed, device):
    """A ReLU'd embedding: non-negative, about half of it zeros."""
    return _randn(shape, seed, device).relu()


# against a float64 distmat, on realistic features and on near-duplicates
# (g = q + 1e-3 noise, where |q|^2 + |g|^2 - 2 q.g cancels): the kernel's
# max error at most twice the plain version's, plus 2^-23 of the largest
# |entry| so that a near-exact plain result does not make the check
# degenerate
@pytest.mark.parametrize("near", [False, True])
@pytest.mark.parametrize("m,n,k", [(836, 836, 2304), (170, 340, 2304),
                                   (37, 300, 19)])
def test_distmat_kernel_as_accurate_as_plain_against_float64(cuda, m, n, k,
                                                             near):
    q = _features((m, k), 10, cuda)
    if near:
        g = q[torch.arange(n, device=cuda) % m] + 1e-3 * _randn(
            (n, k), 11, cuda)
    else:
        g = _features((n, k), 11, cuda)
    q64, g64 = q.double(), g.double()
    ref = ((q64 * q64).sum(1)[:, None] + (g64 * g64).sum(1)[None, :]
           - 2.0 * q64 @ g64.T)
    err = (euclidean_sq(q, g).double() - ref).abs().max().item()
    plain = (euclidean_sq_plain(q, g).double() - ref).abs().max().item()
    assert err <= 2 * plain + 2 ** -23 * ref.abs().max().item(), (err,
                                                                   plain)


# two runs bit for bit the same, with a split over K (836 x 836: 5 parts;
# 16 x 32 x 300: 2 parts at a ragged K; 1 x 128 and 837 x 836: an odd
# m + n) and without (K = 19)
@pytest.mark.parametrize("m,n,k", [(836, 836, 2304), (16, 32, 300),
                                   (37, 300, 19), (1, 128, 2304),
                                   (837, 836, 2304)])
def test_distmat_kernel_runs_are_bit_identical(cuda, m, n, k):
    q, g = _features((m, k), 12, cuda), _features((n, k), 13, cuda)
    got, again = euclidean_sq(q, g), euclidean_sq(q, g)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


# the single-modal models' feature widths, K = 2048 (resnet50) and 512
# (resnet18/34), at Market-1501's 3368 x 15913 (no split), RGBNT201-sized
# 836 x 836 (5 parts of 13 steps, the last 12; at K 512, 2 parts), and M
# and N off the 128-row tile with splits of 2 to 16 parts (837 x 1001,
# 129 x 131, 1 x 77, 100 x 300): against the plain version (1e-5 of the
# largest entry), against float64 on at most 500 query rows (twice the
# plain version's error plus 2^-23 of the largest entry), and twice, bit
# for bit
@pytest.mark.parametrize("m,n,k", [(3368, 15913, 2048), (836, 836, 2048),
                                   (836, 836, 512), (837, 1001, 2048),
                                   (129, 131, 512), (1, 77, 2048),
                                   (100, 300, 512)])
def test_distmat_kernel_at_the_single_modal_widths(cuda, m, n, k):
    q, g = _features((m, k), 14, cuda), _features((n, k), 15, cuda)
    before = kernels.LAUNCHES["distmat"]
    got, again = euclidean_sq(q, g), euclidean_sq(q, g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["distmat"] == before + 2
    assert torch.equal(got, again)
    want = euclidean_sq_plain(q, g)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err
    q64, g64 = q[:500].double(), g.double()
    ref = ((q64 * q64).sum(1)[:, None] + (g64 * g64).sum(1)[None, :]
           - 2.0 * q64 @ g64.T)
    err64 = (got[:500].double() - ref).abs().max().item()
    plain64 = (want[:500].double() - ref).abs().max().item()
    assert err64 <= 2 * plain64 + 2 ** -23 * ref.abs().max().item(), (
        err64, plain64)


# the forward kernels' (csrc/mm_sm90.cuh) tiling edges: N of 1, 129 and
# 1037 (off the 128-row tile), C of 8, 264 and 768 (off the 256-wide
# tile), K of 8, 24, 40 and 264 (off the 64-deep step), and shapes that
# take each column width of the plan (`_mm_plan` on 132 SMs: 256 at
# 16384 x 264 and 1037 x 2048, 128 at 2048 x 768, 64 below)
MM_EDGES = [(1, 8, 8, True), (129, 40, 264, False), (1037, 264, 264, True),
            (1037, 24, 768, False), (2048, 264, 768, True),
            (16384, 40, 264, False), (1037, 2048, 2048, False),
            (128, 2048, 768, True), (768, 2048, 768, True)]


# mm_affine: bf16 operands, f32 accumulation in both; the bf16 outputs may
# differ by one bf16 rounding step (2^-8 relative) where the f32 sums differ
@pytest.mark.parametrize("n,k,c,relu", [
    (12800, 1024, 512, True), (12800, 512, 2048, False),
    (12800, 1024, 2048, False), (12800, 2048, 512, True),
    (1037, 2048, 768, True), (100, 2048, 768, False),
    (13, 24, 40, True)] + MM_EDGES)
def test_mm_affine_kernel_matches_plain(cuda, n, k, c, relu):
    a = _randn((n, k), 2, cuda).to(torch.bfloat16)
    w = _randn((k, c), 3, cuda, scale=k ** -0.5)
    inv = _randn((c,), 4, cuda).abs() + 0.5
    shift = _randn((c,), 5, cuda)
    before = kernels.LAUNCHES["mm_affine"]
    got = mm_affine_act(a, w, inv, shift, relu).float()
    again = mm_affine_act(a, w, inv, shift, relu).float()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mm_affine"] == before + 2
    assert torch.equal(got, again)  # deterministic
    want = mm_affine_act_plain(a, w, inv, shift, relu).float()
    assert got.dtype == torch.float32 and got.shape == (n, c)
    tol = 2 ** -7 * want.abs().clamp_min(1.0)
    assert ((got - want).abs() <= tol).all(), (got - want).abs().max().item()


# partpool: same rounding points; pooled rows are rounded to bf16 in both,
# so a pooled value whose f32 sum differs in the last bit may round to a
# neighbouring bf16 value: bound the error by 1e-2 of the output scale.
# Batches of 1, 37, 100 (the eval head's) and 129 (M = B (P+1) off the
# product's 128-row tile), f32 and bf16 maps, P of 1, 6 (overlapping
# stripes at H = 16) and 8, C of 64 and 2048 (one pooling chunk partly
# used; 16 or 8 chunks), F of 16, 40 and 768 (the product's 64-wide
# column tile partly used), H < P and a 1x1 map
@pytest.mark.parametrize("b,h,w,c,f,parts,dtype", [
    (100, 16, 8, 2048, 768, 6, torch.float32),
    (37, 16, 8, 2048, 768, 6, torch.bfloat16),
    (3, 6, 2, 64, 32, 6, torch.float32),
    (5, 4, 2, 32, 16, 6, torch.float32),
    (100, 16, 8, 2048, 768, 6, torch.bfloat16),
    (129, 16, 8, 2048, 768, 6, torch.float32),
    (1, 16, 8, 2048, 768, 6, torch.float32),
    (1, 16, 8, 64, 16, 1, torch.bfloat16),
    (37, 16, 8, 64, 40, 8, torch.float32),
    (129, 5, 3, 64, 40, 8, torch.bfloat16),
    (37, 1, 1, 2048, 768, 1, torch.float32),
    (100, 16, 8, 64, 768, 8, torch.bfloat16)])
def test_partpool_kernel_matches_plain(cuda, b, h, w, c, f, parts, dtype):
    x = _randn((b, h, w, c), 6, cuda).abs().to(dtype)
    wt = _randn((c, f), 7, cuda, scale=c ** -0.5)
    s = _randn((f,), 8, cuda).abs() + 0.5
    t = _randn((f,), 9, cuda)
    before = kernels.LAUNCHES["partpool"]
    got = fused_partpool_project(x, wt, s, t, parts=parts)
    again = fused_partpool_project(x, wt, s, t, parts=parts)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["partpool"] == before + 2
    assert torch.equal(got, again)  # sums in a fixed order
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
# the backward kernels' (csrc/mm_bn_bwd.cu) tiling edges besides: K or C of
# 8, 24, 40 and 264 (off the 64-wide reduction step and the 128/256-wide
# output tiles), N of 1 and 1037, and the rest of the step's site classes
# (layer4 cb3, downsample, layer4.1-2 cb1, CIM, both reduce sites), so that
# every branch of the dW split plan runs
BWD_SHAPES = TRAIN_SHAPES + [
    (1, 8, 8, True), (8, 24, 40, False), (1037, 264, 24, True),
    (1037, 40, 264, False), (300, 8, 2048, True), (129, 2048, 8, False),
    (16384, 512, 2048, False), (16384, 1024, 2048, False),
    (16384, 2048, 512, True), (16384, 2048, 2048, True),
    (128, 2048, 768, True), (768, 2048, 768, True)]


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
@pytest.mark.parametrize("n,k,c,relu", TRAIN_SHAPES + MM_EDGES)
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
@pytest.mark.parametrize("n,k,c,relu", BWD_SHAPES)
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
    # deterministic: a second run agrees bit for bit
    assert torch.equal(got, mm_bn_da(d, y, vecs, w, relu).float())


# mm_bn_dw: f32 out; the N products are summed in another order (split
# over row ranges): 1e-5 of sum |a| |dy|
@pytest.mark.parametrize("n,k,c,relu", BWD_SHAPES)
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


# ---------------------------------------------- block backward kernels
# (B, H, W, C, cm): the three stages the block path takes at batch 128
# (layer1 at batch 128 itself: 262144 rows, whose dW products sum chains
# long enough for the tensor cores' f32 accumulation to drift), layer4's
# width 512 (the kernels have no width limit), a ragged batch (N = 384
# rows) and an odd map (5x7x3: N = 105, taps at every border)
BLOCK_SHAPES = [(128, 64, 32, 256, 64), (8, 32, 16, 512, 128),
                (16, 16, 8, 1024, 256), (4, 16, 8, 2048, 512),
                (3, 16, 8, 256, 64), (5, 7, 3, 64, 16)]


def _block_inputs(b, h, w, c, cm, device):
    """bf16 maps and f32 rows as the block backward sees them."""
    bf16 = torch.bfloat16
    maps = {name: _randn((b, h, w, ch), seed, device).to(bf16)
            for seed, (name, ch) in enumerate(
                (("dy", c), ("y", c), ("a3", c), ("a2", cm), ("a1", cm),
                 ("x", c), ("d3", c), ("d2", cm), ("d1", cm)), start=40)}

    def rows(ch, seed, n_rows):
        r = [_randn((ch,), seed, device).abs() + 0.5,    # inv
             0.5 * _randn((ch,), seed + 1, device),      # shift / mean
             0.1 * _randn((ch,), seed + 2, device),      # mean / rstd
             _randn((ch,), seed + 3, device).abs() + 0.5,
             0.1 * _randn((ch,), seed + 4, device)]
        return torch.stack(r[:n_rows])

    vecs = dict(v3=rows(c, 50, 5), v2f=rows(cm, 55, 4), v2=rows(cm, 60, 5),
                v1f=rows(cm, 65, 4), v1=rows(cm, 70, 5))
    wts = dict(w1=_randn((c, cm), 75, device, c ** -0.5),
               w2=_randn((3, 3, cm, cm), 76, device, (9 * cm) ** -0.5),
               w3=_randn((cm, c), 77, device, cm ** -0.5))
    return maps, vecs, wts


def _bf16_close(got, want, name):
    # one bf16 step of the value, plus 1e-3 of the map's rms where f32
    # sums taken in another order round to neighbouring values near zero
    got, want = got.float(), want.float()
    tol = 2 ** -7 * want.abs() + 1e-3 * want.pow(2).mean().sqrt()
    err = (got - want).abs()
    assert bool((err <= tol).all()), (name, err.max().item())


def _sums_close(got, want, bound, name):
    # f32 sums of the same terms in another order: 1e-5 of sum |term|
    err = (got - want).abs()
    assert bool((err <= 1e-5 * bound + 1e-30).all()), (name, err.max().item())


def _taps(t):
    """The nine (N, C) views of a (B, H, W, C) map shifted by (ky - 1,
    kx - 1), zero outside each image."""
    b, h, w, c = t.shape
    p = F.pad(t, (0, 0, 1, 1, 1, 1))
    return [p[:, ky:ky + h, kx:kx + w].reshape(-1, c)
            for ky in range(3) for kx in range(3)]


def _run_twice(name, fn):
    before = kernels.LAUNCHES[name]
    got = fn()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    again = fn()  # deterministic: no float atomics
    assert all(torch.equal(a, b) for a, b in zip(got, again)), name
    return got


# reduce3 also at layer2 and layer3 of a batch-128 step, a ragged batch on
# an odd map (B = 3 at 7x5: N = 105, one short row range) at C of 8, 264
# and 1032 (a 64-channel tile mostly or partly past C), and C = 264 and
# 1032 over many row ranges (N = 16384 and 8192, the last range short)
REDUCE3_SHAPES = BLOCK_SHAPES + [
    (128, 32, 16, 512, 128), (128, 16, 8, 1024, 256), (3, 7, 5, 8, 8),
    (3, 7, 5, 264, 8), (3, 7, 5, 1032, 8), (128, 16, 8, 264, 8),
    (64, 16, 8, 1032, 8)]


@pytest.mark.parametrize("b,h,w,c,cm", REDUCE3_SHAPES)
def test_reduce3_kernel_matches_plain(cuda, b, h, w, c, cm):
    m, v, _ = _block_inputs(b, h, w, c, cm, cuda)
    mean, rstd = v["v3"][1], v["v3"][2]
    d3, s3 = _run_twice("reduce3", lambda: bb.reduce3(m["dy"], m["y"],
                                                      m["a3"], mean, rstd))
    want_d3, want_s3 = bb.reduce3_plain(m["dy"], m["y"], m["a3"], mean, rstd)
    assert torch.equal(d3, want_d3)  # a mask and a copy: exact
    # the tiles' tickets were reset: a call at another shape, then this one
    # again, gives the same sums bit for bit
    bb.reduce3(m["dy"][:1], m["y"][:1], m["a3"][:1], mean, rstd)
    _, s3_again = bb.reduce3(m["dy"], m["y"], m["a3"], mean, rstd)
    assert torch.equal(s3, s3_again)
    g = bb._rows(want_d3).float().abs()
    xh = bb._xhat(bb._rows(m["a3"]).float(), mean, rstd).abs()
    _sums_close(s3, want_s3, torch.stack([g.sum(0), (g * xh).sum(0)]), "S3")


# bn3_apply also at layer2 and layer3 of a batch-128 step, and at cm of 8
# and 24 (one 64-wide cm tile mostly zero-filled; C of 32 and 96: a
# 128-channel tile half or three quarters past C)
BN3_SHAPES = BLOCK_SHAPES + [(128, 32, 16, 512, 128), (128, 16, 8, 1024, 256),
                             (3, 16, 8, 32, 8), (5, 7, 3, 96, 24)]


@pytest.mark.parametrize("b,h,w,c,cm", BN3_SHAPES)
def test_bn3_apply_kernel_matches_plain(cuda, b, h, w, c, cm):
    m, v, wt = _block_inputs(b, h, w, c, cm, cuda)
    args = (m["d3"], m["a3"], m["a2"], wt["w3"], v["v3"], v["v2f"])
    d2, s2, dw3 = _run_twice("bn3_apply", lambda: bb.bn3_apply(*args))
    want_d2, want_s2, want_dw3 = bb.bn3_apply_plain(*args)
    _bf16_close(d2, want_d2, "d2")
    da3 = bb._bn_bwd(bb._rows(m["d3"]), bb._rows(m["a3"]), v["v3"]).float()
    a2f = bb._rows(m["a2"]).float()
    h2 = bb._relu_bn(a2f, v["v2f"])
    prod = (da3.abs() @ wt["w3"].to(torch.bfloat16).float().abs().t()) \
        * (h2 > 0)
    xh = bb._xhat(a2f, v["v2f"][2], v["v2f"][3]).abs()
    _sums_close(s2, want_s2, torch.stack([prod.sum(0), (prod * xh).sum(0)]),
                "S2")
    _sums_close(dw3, want_dw3, h2.abs().t() @ da3.abs(), "dW3")


# conv2_bwd and bn1_apply also at layer2 and layer3 of a batch-128 step,
# at cm of 8 and 24 (C of 32 and 96), and at images that do not tile the
# 128-row tiles evenly: W = 3, 5 and 7 with H*W < 64 and several images in
# one tile, H = 1 (every vertical tap leaves the image) and W = 1 (every
# horizontal one), where a shifted row inside [0, N) lands in a
# neighbouring image row or image and must read zero
CONV2_SHAPES = BLOCK_SHAPES + [(128, 32, 16, 512, 128),
                               (128, 16, 8, 1024, 256), (3, 16, 8, 32, 8),
                               (5, 7, 3, 96, 24), (12, 3, 5, 64, 8),
                               (10, 5, 7, 32, 24), (40, 1, 7, 32, 16),
                               (20, 9, 1, 32, 8)]


@pytest.mark.parametrize("b,h,w,c,cm", CONV2_SHAPES)
def test_conv2_bwd_kernel_matches_plain(cuda, b, h, w, c, cm):
    m, v, wt = _block_inputs(b, h, w, c, cm, cuda)
    args = (m["d2"], m["a2"], m["a1"], wt["w2"], v["v2"], v["v1f"])
    d1, s1, dw2 = _run_twice("conv2_bwd", lambda: bb.conv2_bwd(*args))
    want_d1, want_s1, want_dw2 = bb.conv2_bwd_plain(*args)
    _bf16_close(d1, want_d1, "d1")
    da2 = bb._bn_bwd(bb._rows(m["d2"]), bb._rows(m["a2"]), v["v2"]).float()
    a1f = bb._rows(m["a1"]).float()
    h1 = bb._relu_bn(a1f, v["v1f"])
    w2 = wt["w2"].to(torch.bfloat16).float().abs()
    # input gradient: tap (ky, kx) reads da2 shifted by (1 - ky, 1 - kx)
    da_taps = _taps(da2.abs().view(b, h, w, cm))
    prod = sum(da_taps[8 - t] @ w2[t // 3, t % 3].t() for t in range(9)) \
        * (h1 > 0)
    xh = bb._xhat(a1f, v["v1f"][2], v["v1f"][3]).abs()
    _sums_close(s1, want_s1, torch.stack([prod.sum(0), (prod * xh).sum(0)]),
                "S1")
    h_taps = _taps(h1.view(b, h, w, cm))
    bound = torch.stack([ht.t() @ da2.abs() for ht in h_taps]).view(
        3, 3, cm, cm)
    _sums_close(dw2, want_dw2, bound, "dW2")


@pytest.mark.parametrize("b,h,w,c,cm", CONV2_SHAPES)
def test_bn1_apply_kernel_matches_plain(cuda, b, h, w, c, cm):
    m, v, wt = _block_inputs(b, h, w, c, cm, cuda)
    args = (m["d1"], m["a1"], m["x"], m["d3"], wt["w1"], v["v1"])
    dx, dw1 = _run_twice("bn1_apply", lambda: bb.bn1_apply(*args))
    want_dx, want_dw1 = bb.bn1_apply_plain(*args)
    _bf16_close(dx, want_dx, "dx")
    da1 = bb._bn_bwd(bb._rows(m["d1"]), bb._rows(m["a1"]), v["v1"]).float()
    _sums_close(dw1, want_dw1,
                bb._rows(m["x"]).float().abs().t() @ da1.abs(), "dW1")


# the whole op, kernels against ``plain=True`` on the same inputs: the
# forward is the same code; in the backward the sums S3, S2, S1 differ in
# order and d2, d1 and dx by a bf16 step here and there, which moves the
# next BN backward a little: every gradient to a relative Frobenius error
# of 2^-8, one bf16 step
@pytest.mark.parametrize("b,h,w,c,cm", [(8, 64, 32, 256, 64),
                                        (16, 16, 8, 1024, 256),
                                        (3, 7, 5, 64, 16)])
def test_bottleneck_train_kernels_match_plain(cuda, b, h, w, c, cm):
    rnd = lambda shape, seed, s=1.0: _randn(shape, seed, cuda, s)  # noqa
    x = rnd((b, h, w, c), 80).to(torch.bfloat16)
    params = [rnd((1, 1, c, cm), 81, c ** -0.5), 1 + 0.1 * rnd((cm,), 82),
              0.1 * rnd((cm,), 83), rnd((3, 3, cm, cm), 84, (9 * cm) ** -0.5),
              1 + 0.1 * rnd((cm,), 85), 0.1 * rnd((cm,), 86),
              rnd((1, 1, cm, c), 87, cm ** -0.5), 1 + 0.1 * rnd((c,), 88),
              0.1 * rnd((c,), 89)]
    ct = rnd((b, h, w, c), 90)
    outs = {}
    for plain in (False, True):
        kernels.reset_launch_counts()
        leaves = [x.clone().requires_grad_()] + [
            p.clone().requires_grad_() for p in params]
        y, stats = bb.bottleneck_train(*leaves, plain=plain)
        (y.float() * ct).sum().backward()
        torch.cuda.synchronize()
        launched = [kernels.LAUNCHES[k] for k in
                    ("reduce3", "bn3_apply", "conv2_bwd", "bn1_apply")]
        assert launched == ([0] * 4 if plain else [1] * 4)
        outs[plain] = (y, stats, [t.grad.float() for t in leaves])
    (y, st, g), (y_p, st_p, g_p) = outs[False], outs[True]
    assert torch.equal(y, y_p)
    assert all(torch.equal(a, b_) for a, b_ in zip(st, st_p))
    names = "dx dk1 ds1 db1 dk2 ds2 db2 dk3 ds3 db3".split()
    for name, a, b_ in zip(names, g, g_p):
        rel = ((a - b_).norm() / b_.norm()).item()
        assert rel <= 2 ** -8, (name, rel)


# ------------------------------------------------------ probe kernels
# The tools' shapes: bw_probe's (8192, 8192) array, fusion_probe's
# 16384 x 2048 x 2048 product; plus ragged row counts and a small case.

@pytest.mark.parametrize("rows,cols", [(8192, 8192), (1037, 8200),
                                       (3, 16), (0, 16)])
@pytest.mark.parametrize("tile", [512, 2048])
def test_scale_bf16_kernel_matches_plain_bit_for_bit(cuda, rows, cols, tile):
    x = _randn((rows, cols), 30, cuda, scale=3.0).to(torch.bfloat16)
    before = kernels.LAUNCHES["scale_bf16"]
    got, again = scale_bf16(x, tile), scale_bf16(x, tile)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["scale_bf16"] == before + 2
    # a new array, every byte written
    assert x.numel() == 0 or got.data_ptr() != x.data_ptr()
    assert torch.equal(got, again)
    assert torch.equal(got, scale_bf16_plain(x, tile))
    assert torch.equal(got, x)  # bf16(1.0001) == 1


# y one bf16 step (+1e-5 of the largest |y|); m and v from the kernel's
# channel sums, 1e-5 of the summed magnitudes (per row: of mean|y| and
# mean y^2, plus what m's error moves in m^2)
@pytest.mark.parametrize("n", [16384, 1037])
def test_probe_mm_stats_kernel_matches_plain(cuda, n):
    k = c = 2048
    x = _randn((n, k), 31, cuda).to(torch.bfloat16)
    w = _randn((k, c), 32, cuda, scale=0.02).to(torch.bfloat16)
    before = kernels.LAUNCHES["mm_stats"]
    y, m, v = probe_mm_stats(x, w)
    again = probe_mm_stats(x, w)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["mm_stats"] == before + 2
    assert all(torch.equal(a, b) for a, b in zip((y, m, v), again))
    y_p, m_p, v_p = probe_mm_stats_plain(x, w)
    y32 = x.float() @ w.float()
    m_tol = 1e-5 * y32.abs().mean(0)
    v_tol = 1e-5 * (y32 * y32).mean(0) + 2 * m_p.abs() * m_tol + m_tol ** 2
    assert ((m - m_p).abs() <= m_tol).all()
    assert ((v - v_p).abs() <= v_tol).all()
    want = y_p.float()
    tol = 2 ** -7 * want.abs() + 1e-5 * want.abs().max()
    assert ((y.float() - want).abs() <= tol).all()


# h is bit for bit the plain version's; the f32 sums differ in order: one
# bf16 step of the value plus 1e-3 of the output's rms
@pytest.mark.parametrize("n,k,c", [
    (16384, 2048, 2048), (1037, 2048, 2048), (1, 2048, 2048), (13, 24, 40),
    (1037, 8, 264), (1037, 264, 24), (1, 24, 8), (1037, 8, 8),
    (1037, 264, 264)])
def test_bn_mm_kernel_matches_plain(cuda, n, k, c):
    y = _randn((n, k), 33, cuda).to(torch.bfloat16)
    inv = _randn((k,), 34, cuda).abs() + 0.5
    sh = _randn((k,), 35, cuda)
    w2 = _randn((k, c), 36, cuda, scale=k ** -0.5).to(torch.bfloat16)
    before = kernels.LAUNCHES["bn_mm"]
    got, again = bn_mm(y, inv, sh, w2), bn_mm(y, inv, sh, w2)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["bn_mm"] == before + 2
    assert got.dtype == torch.bfloat16 and got.shape == (n, c)
    assert torch.equal(got, again)
    want = bn_mm_plain(y, inv, sh, w2).float()
    tol = 2 ** -7 * want.abs() + 1e-3 * want.pow(2).mean().sqrt()
    assert ((got.float() - want).abs() <= tol).all(), (
        (got.float() - want).abs().max().item())


# The bounded mbarrier wait (csrc/sm90_gemm.cuh `mbar_wait`): a copy of the
# package, made in tmp_path, whose bn_mm expects 16 bytes more per stage
# than its TMA copies bring, so its ring can never fill. The launch must
# fail within seconds with the wait's report, not hang the card.
_TRAP_CHILD = """
import time, torch
from ieee_tpu_torch.ops import _build
_build.load_library()
from ieee_tpu_torch.ops.kernels.probes import bn_mm
y = torch.randn(1024, 256, device='cuda').bfloat16()
w = torch.randn(256, 512, device='cuda').bfloat16()
inv, sh = torch.ones(256, device='cuda'), torch.zeros(256, device='cuda')
t = time.perf_counter()
try:
    bn_mm(y, inv, sh, w)
    torch.cuda.synchronize()
except RuntimeError as e:
    print(f'launch failed after {time.perf_counter() - t:.2f} s: {e}')
    raise SystemExit(1)
print('no fault')
"""


def test_mbarrier_wait_is_bounded_and_traps(cuda, tmp_path):
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    import ieee_tpu_torch

    shutil.copytree(Path(ieee_tpu_torch.__file__).parent,
                    tmp_path / "ieee_tpu_torch",
                    ignore=shutil.ignore_patterns("_kernels", "__pycache__"))
    src = tmp_path / "ieee_tpu_torch" / "csrc" / "bn_gemm_sm90.cu"
    text = src.read_text()
    expect = "sm90::mbar_expect_tx(bar, MM_TX);"
    assert text.count(expect) == 1
    src.write_text(text.replace(expect,
                                "sm90::mbar_expect_tx(bar, MM_TX + 16);"))
    run = subprocess.run([sys.executable, "-c", _TRAP_CHILD], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    out = run.stdout + run.stderr
    assert run.returncode != 0 and "launch failed after" in out, out[-2000:]
    assert "sm90 mbarrier wait timed out" in out, out[-2000:]
    seconds = float(out.split("launch failed after ")[1].split(" s")[0])
    print(f"bn_mm with a wrong byte count failed after {seconds} s")
    assert seconds < 30, out[-2000:]


# conv_s8: the w8a8 implicit GEMM (csrc/conv_s8.cu: int8 gathered and
# quantized on load, mma.sync s8 tiles, s32 sums) against its plain version
# (the same integers through F.conv2d in float64, exact): the raw s32 sums
# equal exactly, and the bf16 output is within one bf16 step of the plain
# epilogue (both round the same f32 product and sum: equal in practice).
# Shapes (x (B, H, W, C_in), C_out, K, stride, padding, x dtype): the stem
# on the f32 image (C_in 3, K = 147 padded in the kernel), ResNet-50's 3x3
# at stride 1 and 2 and 1x1 at stride 1 and 2, layer4's 1x1 to 2048,
# resnet18's basic 3x3 at stride 2; ragged M (odd batch and maps), C_out 8
# and 72 (the 64-column tile partly used), C_in 48 and f32 on the vector
# loader, a bf16 image on the scalar one
CONV_S8_CASES = [
    ((2, 256, 128, 3), 64, 7, 2, 3, torch.float32),
    ((2, 64, 32, 64), 64, 3, 1, 1, torch.bfloat16),
    ((2, 64, 32, 128), 128, 3, 2, 1, torch.bfloat16),
    ((2, 64, 32, 256), 128, 1, 1, 0, torch.bfloat16),
    ((2, 64, 32, 256), 512, 1, 2, 0, torch.bfloat16),
    ((2, 16, 8, 512), 2048, 1, 1, 0, torch.bfloat16),
    ((2, 64, 32, 64), 128, 3, 2, 1, torch.bfloat16),
    ((3, 7, 5, 16), 8, 3, 1, 1, torch.bfloat16),
    ((3, 9, 7, 3), 72, 7, 2, 3, torch.bfloat16),
    ((1, 5, 3, 48), 136, 3, 2, 1, torch.float32),
]


def _conv_s8_operands(case, device, seed=0):
    shape, cout, k, _, _, dtype = case
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal(shape).astype(np.float32) * 2.0,
                     device=device).to(dtype)
    wq = torch.tensor(rng.integers(-127, 128, (cout, k, k, shape[-1]),
                                   dtype=np.int8), device=device)
    scale = torch.tensor(rng.uniform(1e-4, 1e-3, cout).astype(np.float32),
                         device=device)
    bias = torch.tensor(rng.standard_normal(cout).astype(np.float32),
                        device=device)
    # about the calibrated scale of this input (absmax / 127, inverted)
    inv_sx = float(np.float32(127.0 / 7.0))
    return x, wq, scale, bias, inv_sx


@pytest.mark.parametrize("case", CONV_S8_CASES)
@pytest.mark.parametrize("relu", [True, False])
def test_conv_s8_kernel_matches_plain(cuda, case, relu):
    _, _, _, stride, pad, _ = case
    x, wq, scale, bias, inv_sx = _conv_s8_operands(case, cuda)
    kernels.reset_launch_counts()
    acc = conv_s8(x, wq, None, None, stride, pad, relu, inv_sx, raw=True)
    got = conv_s8(x, wq, scale, bias, stride, pad, relu, inv_sx)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["conv_s8"] == 2
    want_acc = conv_s8_plain(x, wq, None, None, stride, pad, relu, inv_sx,
                             raw=True)
    want = conv_s8_plain(x, wq, scale, bias, stride, pad, relu, inv_sx)
    assert acc.dtype == torch.int32 and acc.shape == want_acc.shape
    assert torch.equal(acc, want_acc)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    w32 = want.float()
    ulp = torch.where(w32 == 0, torch.zeros_like(w32),
                      2.0 ** (torch.floor(torch.log2(w32.abs())) - 7))
    assert ((got.float() - w32).abs() <= ulp).all()
    if relu:
        assert (got.float() >= 0).all()
    again = conv_s8(x, wq, scale, bias, stride, pad, relu, inv_sx)
    assert torch.equal(got, again)


def test_conv_s8_kernel_saturates_and_rounds_half_to_even(cuda):
    # inputs at exact halves of the quantization step and beyond +-127
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, 200.0, -300.0]
                     + [0.0] * 8, device=cuda).reshape(1, 1, 1, 16)
    wq = torch.zeros((8, 1, 1, 16), dtype=torch.int8, device=cuda)
    for i in range(8):
        wq[i, 0, 0, i] = 1
    acc = conv_s8(x, wq, None, None, 1, 0, False, 1.0, raw=True)
    assert acc.flatten().tolist() == [0, 2, 2, 0, -2, 126, 127, -127]
