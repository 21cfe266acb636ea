"""The plain PyTorch versions of the port's three kernels against the JAX
package's Pallas kernels (interpret mode on the CPU) and plain functions.

On a CPU tensor each kernel wrapper takes its plain version, so these tests
also cover what the wrappers do around the kernel here. The kernels
themselves are held to these plain versions on a card in
``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ieee_tpu.ops.distance import euclidean_squared_distance as jax_euclid
from ieee_tpu.ops.pallas import distmat as jax_distmat_mod
from ieee_tpu.ops.pallas.matmul_bn import mm_affine_act as jax_mm_affine
from ieee_tpu.ops.pallas.partpool import _pool_matrix as jax_pool_matrix
from ieee_tpu.ops.pallas.partpool import fold_bn as jax_fold_bn
from ieee_tpu.ops.pallas.partpool import (
    fused_partpool_project as jax_partpool,
)
from ieee_tpu_torch.ops import kernels
from ieee_tpu_torch.ops.kernels.conv_s8 import conv_s8, conv_s8_plain
from ieee_tpu_torch.ops.kernels.distmat import euclidean_sq, euclidean_sq_plain
from ieee_tpu_torch.ops.kernels.matmul_bn import (
    mm_affine_act,
    mm_affine_act_plain,
)
from ieee_tpu_torch.ops.kernels.partpool import (
    POOL_POSITION_LANES,
    fold_bn,
    fused_partpool_project,
    fused_partpool_project_plain,
    pool_matrix,
)

from test_pallas_kernels import _interpret_distmat
from torch_threads import one_torch_thread  # noqa: F401


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


# ---------------------------------------------------------------- distmat

@pytest.mark.parametrize("m,n,k", [(64, 96, 32), (37, 300, 130)])
def test_distmat_plain_matches_pallas_interpret_and_jax(m, n, k):
    a, b = _np((m, k), 0), _np((n, k), 1)
    ours = euclidean_sq(torch.tensor(a), torch.tensor(b)).numpy()
    pallas = np.asarray(_interpret_distmat(jax_distmat_mod, a, b))
    plain_jax = np.asarray(jax_euclid(jnp.asarray(a), jnp.asarray(b)))
    # f32 on both sides, different summation orders: a few f32 ulps of
    # the largest entry (~2k here)
    tol = 1e-5 * np.abs(plain_jax).max()
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=tol)
    np.testing.assert_allclose(ours, plain_jax, rtol=0, atol=tol)


def _tf32_rna(x):
    """f32 rounded to TF32 (10 mantissa bits), ties away from zero: the
    split pass's ``cvt.rna.tf32.f32``."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tf32_read(x):
    """An f32 operand as the tensor cores read it in a TF32 product: its
    low 13 mantissa bits dropped (truncation)."""
    return (x.astype(np.float32).view(np.uint32)
            & np.uint32(0xFFFFE000)).view(np.float32)


def _distmat_3xtf32(a, b):
    """The distmat kernel's arithmetic (``csrc/distmat.cu``) in numpy: x =
    hi + lo, hi = TF32(x) to nearest, lo = x - hi exact in f32 and read
    truncated to TF32; a.b ~ lo_a.hi_b + hi_a.lo_b + hi_a.hi_b with f32
    sums (lo_a.lo_b dropped); f32 norms; (qn + gn) - 2 a.b."""
    parts = []
    for x in (a, b):
        hi = _tf32_rna(x)
        lo = x - hi
        assert np.array_equal(hi + lo, x)  # the split is exact in f32
        parts.append((hi, _tf32_read(lo)))
    (ah, al), (bh, bl) = parts
    prod = (al @ bh.T + ah @ bl.T) + ah @ bh.T
    return ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]) - 2 * prod


@pytest.mark.parametrize("m,n,k", [(64, 96, 32), (37, 300, 130)])
def test_distmat_3xtf32_arithmetic_matches_pallas_interpret_and_jax(m, n,
                                                                    k):
    # the arithmetic of the card's kernel, not only the card, is sound:
    # held to the JAX function and its Pallas kernel at the f32 parity
    # test's tolerance
    a, b = _np((m, k), 0), _np((n, k), 1)
    ours = _distmat_3xtf32(a, b)
    assert ours.dtype == np.float32
    pallas = np.asarray(_interpret_distmat(jax_distmat_mod, a, b))
    plain_jax = np.asarray(jax_euclid(jnp.asarray(a), jnp.asarray(b)))
    tol = 1e-5 * np.abs(plain_jax).max()
    np.testing.assert_allclose(ours, pallas, rtol=0, atol=tol)
    np.testing.assert_allclose(ours, plain_jax, rtol=0, atol=tol)
    # the hi.hi term alone (one TF32 product) is not f32-accurate here
    hi = _tf32_rna(a) @ _tf32_rna(b).T
    one = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]) - 2 * hi
    assert np.abs(one - plain_jax).max() > tol


# ------------------------------------------------------------------ partpool

@pytest.mark.parametrize("h,w,parts", [(16, 8, 6), (6, 2, 6), (4, 2, 6)])
def test_pool_matrix_matches_jax_including_overlap(h, w, parts):
    np.testing.assert_array_equal(pool_matrix(h, w, parts).numpy(),
                                  jax_pool_matrix(h, w, parts))


def test_fold_bn_matches_jax():
    sc, bi, mu, var = (_np((8,), i) for i in range(4))
    var = np.abs(var) + 0.5
    got = fold_bn(*(torch.tensor(v) for v in (sc, bi, mu, var)))
    want = jax_fold_bn(sc, bi, mu, var)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("b,dtype", [(3, jnp.float32), (9, jnp.bfloat16)])
def test_partpool_plain_matches_pallas_interpret(b, dtype):
    # H=16, P=6: the overlapping stripes of the 256x128 map; ragged B
    # (the Pallas op pads B to its tile)
    h, w, c, f, parts = 16, 8, 256, 128, 6
    x = np.abs(_np((b, h, w, c), 2))
    wt, s = _np((c, f), 3, c ** -0.5), np.abs(_np((f,), 4)) + 0.5
    t = _np((f,), 5)
    xj = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax_partpool(xj, jnp.asarray(wt), jnp.asarray(s),
                                   jnp.asarray(t), parts=parts))
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32)))
    if dtype == jnp.bfloat16:
        xt = xt.to(torch.bfloat16)
    got = fused_partpool_project(xt, torch.tensor(wt), torch.tensor(s),
                                 torch.tensor(t), parts=parts).numpy()
    assert got.shape == want.shape == (b, parts + 1, f)
    # same rounding points (bf16 map, f32 pooling, bf16 pooled rows and W,
    # f32 product); a pooled sum that differs in its last f32 bit may round
    # to the neighbouring bf16 value, one 2^-8 step of that input
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * np.abs(want).max())
    assert np.abs(got - want).mean() < 1e-4 * np.abs(want).max()


def _bf16(a):
    return torch.tensor(a).to(torch.bfloat16).float().numpy()


def _partpool_kernel_arithmetic(x, w, s, t, parts):
    """The card kernel's arithmetic (csrc/partpool.cu) in numpy: the map
    rounded to bf16; per position lane q (positions q, q + L, ...) a chain
    of f32 fused multiply-adds pool[r, i] * x + acc in position order (the
    product exact in float64, one rounding); the lanes added in order; the
    pooled rows rounded to bf16; their product with bf16(W) summed exactly
    and rounded once to f32 (the wgmma's f32 sums differ from it by their
    order only); then relu(f32(f32(acc * s) + t))."""
    b, h, wd, c = x.shape
    lanes = POOL_POSITION_LANES
    pool = pool_matrix(h, wd, parts).numpy().astype(np.float64)
    xb = _bf16(x).reshape(b, h * wd, c).astype(np.float64)
    acc = np.zeros((lanes, b, parts + 1, c), np.float32)
    for i in range(h * wd):
        q = i % lanes
        acc[q] = (pool[None, :, i, None] * xb[:, None, i, :]
                  + acc[q]).astype(np.float32)
    pooled = np.zeros((b, parts + 1, c), np.float32)
    for q in range(lanes):
        pooled = pooled + acc[q]
    proj = (_bf16(pooled).astype(np.float64)
            @ _bf16(w).astype(np.float64)).astype(np.float32)
    return np.maximum((proj * s).astype(np.float32) + t, np.float32(0))


@pytest.mark.parametrize("b,h,w,c,f", [(2, 16, 8, 128, 32),
                                       (3, 5, 3, 64, 40),
                                       (2, 1, 4, 64, 16)])
def test_partpool_kernel_arithmetic_matches_pallas_interpret(b, h, w, c, f):
    # H = 16, P = 6: the 256x128 head's overlapping stripes, 16 positions a
    # lane; H = 5 < P: every stripe one or two rows; H = 1: every stripe the
    # whole map, fewer positions than lanes
    parts = 6
    x = np.abs(_np((b, h, w, c), 20))
    wt, s = _np((c, f), 21, c ** -0.5), np.abs(_np((f,), 22)) + 0.5
    t = _np((f,), 23)
    want = np.asarray(jax_partpool(jnp.asarray(x), jnp.asarray(wt),
                                   jnp.asarray(s), jnp.asarray(t),
                                   parts=parts))
    got = _partpool_kernel_arithmetic(x, wt, s, t, parts)
    assert got.shape == want.shape == (b, parts + 1, f)
    # test_partpool_plain_matches_pallas_interpret's bounds: a pooled sum
    # taken in another order may round to the neighbouring bf16 value
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-2 * np.abs(want).max())
    assert np.abs(got - want).mean() < 1e-4 * np.abs(want).max()


# ----------------------------------------------------------------- mm_affine

@pytest.mark.parametrize("n,k,c,relu", [(200, 384, 128, True),
                                        (200, 384, 128, False),
                                        (37, 256, 384, True)])
def test_mm_affine_plain_matches_pallas_interpret(n, k, c, relu):
    # N=200 and N=37 are not multiples of the Pallas tile (512)
    a, w = _np((n, k), 6), _np((k, c), 7, k ** -0.5)
    inv, shift = np.abs(_np((c,), 8)) + 0.5, _np((c,), 9)
    want = np.asarray(jax_mm_affine(jnp.asarray(a), jnp.asarray(w),
                                    jnp.asarray(inv), jnp.asarray(shift),
                                    relu).astype(jnp.float32))
    got = mm_affine_act(torch.tensor(a), torch.tensor(w), torch.tensor(inv),
                        torch.tensor(shift), relu)
    assert got.dtype == torch.bfloat16 and got.shape == (n, c)
    got = got.float().numpy()
    # both: bf16 operands, f32 accumulation, bf16 result; sums in another
    # order may round to the neighbouring bf16 value (2^-8 relative)
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
    if relu:
        assert (got >= 0).all()


# ------------------------------------------------- wrappers on the CPU

def test_wrappers_take_the_plain_version_on_cpu_and_count_nothing():
    kernels.reset_launch_counts()
    q, g = torch.tensor(_np((5, 7), 10)), torch.tensor(_np((6, 7), 11))
    torch.testing.assert_close(euclidean_sq(q, g), euclidean_sq_plain(q, g),
                               rtol=0, atol=0)
    a, w = torch.tensor(_np((9, 16), 12)), torch.tensor(_np((16, 8), 13))
    v = torch.ones(8)
    torch.testing.assert_close(mm_affine_act(a, w, v, v, True),
                               mm_affine_act_plain(a, w, v, v, True))
    x = torch.tensor(_np((2, 4, 2, 16), 14))
    torch.testing.assert_close(fused_partpool_project(x, w, v, v),
                               fused_partpool_project_plain(x, w, v, v))
    wq = torch.ones((8, 3, 3, 16), dtype=torch.int8)
    torch.testing.assert_close(
        conv_s8(x, wq, v, v, 1, 1, True, 2.0),
        conv_s8_plain(x, wq, v, v, 1, 1, True, 2.0), rtol=0, atol=0)
    assert kernels.launch_counts() == {
        "distmat": 0, "partpool": 0, "mm_affine": 0, "mm_stats": 0,
        "mm_bn_da": 0, "mm_bn_dw": 0, "reduce3": 0, "bn3_apply": 0,
        "conv2_bwd": 0, "bn1_apply": 0, "scale_bf16": 0, "bn_mm": 0,
        "conv_s8": 0}


def test_wrappers_check_shapes_and_dtypes():
    with pytest.raises(ValueError):
        euclidean_sq(torch.zeros(3, 4), torch.zeros(3, 5))
    with pytest.raises(TypeError):
        euclidean_sq(torch.zeros(3, 4, dtype=torch.float64),
                     torch.zeros(3, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        mm_affine_act(torch.zeros(3, 4), torch.zeros(5, 8), torch.zeros(8),
                      torch.zeros(8), True)
    with pytest.raises(ValueError):
        fused_partpool_project(torch.zeros(2, 4, 2, 16), torch.zeros(16, 8),
                               torch.zeros(7), torch.zeros(8))


def test_kernel_build_needs_nvcc_and_is_not_run_at_import(monkeypatch):
    from ieee_tpu_torch.ops import _build

    assert _build.build_seconds() is None or _build._state["lib"] is not None
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
