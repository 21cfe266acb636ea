"""The plain PyTorch versions of the probes' kernels
(``ieee_tpu_torch/ops/kernels/probes.py``) against the JAX probes' Pallas
kernels in interpret mode on the CPU, on the same inputs from a numpy seed.

- ``scale_bf16`` against ``tools/bw_probe.py``'s ``kern`` (defined inside
  that tool's ``main``, so rebuilt here with its two BlockSpecs at 16- and
  32-row tiles): bit for bit.
- ``probe_mm_stats`` and ``bn_mm`` against ``tools/fusion_probe.py``'s
  module-level ``mm_stats_kernel`` and ``bn_mm_kernel`` (the tool is
  loaded by path: ``tools/`` is no package) through ``pl.pallas_call`` at
  N, K, C = 256 or 384, 256, 256 with 128-wide tiles. Both sides sum exact
  products of bf16 values in f32 in other orders: y and o agree to one
  bf16 step (2^-7 of the value), with 1e-5 of the largest |y| (1e-3 of
  o's rms) where values near zero round from f32 sums that differ in the
  last bits; the channel sums to 1e-5 of the summed magnitudes.

The kernels are held to these plain versions on a card in
``tests/test_torch_kernels_cuda.py``.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ieee_tpu_torch.ops import kernels
from ieee_tpu_torch.ops.kernels.probes import (
    SCALE,
    bn_mm,
    bn_mm_plain,
    probe_mm_stats,
    probe_mm_stats_plain,
    scale_bf16,
    scale_bf16_plain,
    scale_factor,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 128  # the Pallas tiles here (the tool's are 512)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _bf16(x):
    """numpy f32 values rounded to bf16, as (jax array, torch tensor)."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(
        torch.bfloat16)


@pytest.fixture(scope="module")
def fusion_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_fusion_probe", os.path.join(ROOT, "tools", "fusion_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ rows 11-12

def _jax_scale(x, tile):
    """``tools/bw_probe.py``'s ``kern`` with its BlockSpecs, ``tile`` rows
    a block, in interpret mode."""
    m = x.shape[1]

    def kern(x_ref, o_ref):
        o_ref[:] = x_ref[:] * jnp.bfloat16(1.0001)

    return pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        grid=(x.shape[0] // tile,),
        in_specs=[pl.BlockSpec((tile, m), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((tile, m), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        interpret=True,
    )(x)


def test_scale_factor_rounds_as_jax():
    # the trap: bf16(1.0001) is 1.0 in both frameworks
    assert scale_factor() == float(jnp.bfloat16(SCALE)) == 1.0


@pytest.mark.parametrize("tile,port_tile", [(16, 512), (32, 2048)])
def test_scale_plain_matches_pallas_bit_for_bit(tile, port_tile):
    xj, xt = _bf16(_np((64, 64), 0, 3.0))
    want = np.asarray(_jax_scale(xj, tile).astype(jnp.float32))
    kernels.reset_launch_counts()
    got = scale_bf16(xt, port_tile)
    assert sum(kernels.launch_counts().values()) == 0  # CPU: plain version
    assert got.dtype == torch.bfloat16 and got.shape == (64, 64)
    got = got.float().numpy()
    # every tile, the first and the ones after it
    for r in range(0, 64, tile):
        np.testing.assert_array_equal(got[r:r + tile], want[r:r + tile])
    np.testing.assert_array_equal(got, xt.float().numpy())


def test_scale_checks_its_arguments():
    x = torch.zeros((8, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tile_rows"):
        scale_bf16(x, 64)
    with pytest.raises(ValueError):
        scale_bf16_plain(x.float(), 512)
    with pytest.raises(ValueError):
        scale_bf16(torch.zeros(16, dtype=torch.bfloat16), 512)


# ------------------------------------------------------------ rows 13-14

def _jax_mm_stats(mod, x, w):
    """``pallas_mm_stats`` at (n, k) x (k, c) with T-wide tiles."""
    n, k = x.shape
    c = w.shape[1]
    y, st = pl.pallas_call(
        mod.mm_stats_kernel,
        grid=(c // T, n // T, k // T),
        in_specs=[
            pl.BlockSpec((T, T), lambda j, i, kk: (i, kk),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((T, T), lambda j, i, kk: (kk, j),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=[
            pl.BlockSpec((T, T), lambda j, i, kk: (i, j),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((8, T), lambda j, i, kk: (0, j),
                         memory_space=pltpu.VMEM),
        ],
        out_shape=[jax.ShapeDtypeStruct((n, c), jnp.bfloat16),
                   jax.ShapeDtypeStruct((8, c), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((T, T), jnp.float32),
                        pltpu.VMEM((8, T), jnp.float32)],
        interpret=True,
    )(x, w)
    m = st[0] / n
    return y, st[:2], m, st[1] / n - m * m


def _jax_bn_mm(mod, y, inv, sh, w2):
    """``pallas_bn_mm`` at (n, k) x (k, c) with T-wide tiles."""
    n, k = y.shape
    c = w2.shape[1]
    inv8 = jnp.broadcast_to(inv.reshape(1, -1), (8, k))
    sh8 = jnp.broadcast_to(sh.reshape(1, -1), (8, k))
    return pl.pallas_call(
        mod.bn_mm_kernel,
        grid=(n // T, c // T, k // T),
        in_specs=[
            pl.BlockSpec((T, T), lambda i, j, kk: (i, kk),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((8, T), lambda i, j, kk: (0, kk),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((8, T), lambda i, j, kk: (0, kk),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((T, T), lambda i, j, kk: (kk, j),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((T, T), lambda i, j, kk: (i, j),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n, c), jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((T, T), jnp.float32)],
        interpret=True,
    )(y, inv8, sh8, w2)


@pytest.mark.parametrize("n", [256, 384])
def test_probe_mm_stats_plain_matches_pallas(fusion_probe, n):
    k = c = 256
    xj, xt = _bf16(_np((n, k), 1))
    wj, wt = _bf16(_np((k, c), 2, 0.05))
    y_j, st_j, m_j, v_j = map(np.asarray, _jax_mm_stats(fusion_probe, xj,
                                                         wj))
    kernels.reset_launch_counts()
    y, m, v = probe_mm_stats(xt, wt)
    assert kernels.launch_counts()["mm_stats"] == 0  # CPU: plain version
    y_p, m_p, v_p = probe_mm_stats_plain(xt, wt)
    assert torch.equal(y, y_p) and torch.equal(m, m_p) and torch.equal(v,
                                                                        v_p)
    assert y.dtype == torch.bfloat16 and m.shape == v.shape == (c,)

    y_j = y_j.astype(np.float32)
    np.testing.assert_allclose(y.float().numpy(), y_j, rtol=2 ** -7,
                               atol=1e-5 * np.abs(y_j).max())
    y32 = xt.double().numpy() @ wt.double().numpy()
    s_tol = 1e-5 * np.stack([np.abs(y32).sum(0), (y32 * y32).sum(0)])
    st = np.stack([m.numpy() * n, (v + m * m).numpy() * n])
    assert np.all(np.abs(st - st_j) <= s_tol)
    # and both against the exact sums of the f32 products
    assert np.all(np.abs(st_j - np.stack([y32.sum(0), (y32 * y32).sum(0)]))
                  <= s_tol)
    np.testing.assert_allclose(m.numpy(), m_j, rtol=0, atol=s_tol[0].max() / n)


@pytest.mark.parametrize("n", [256, 384])
def test_bn_mm_plain_matches_pallas(fusion_probe, n):
    k = c = 256
    yj, yt = _bf16(_np((n, k), 3))
    w2j, w2t = _bf16(_np((k, c), 4, k ** -0.5))
    inv = np.abs(_np((k,), 5)) + 0.5
    sh = _np((k,), 6)
    want = np.asarray(_jax_bn_mm(fusion_probe, yj, jnp.asarray(inv),
                                 jnp.asarray(sh), w2j).astype(jnp.float32))
    kernels.reset_launch_counts()
    got = bn_mm(yt, torch.tensor(inv), torch.tensor(sh), w2t)
    assert kernels.launch_counts()["bn_mm"] == 0  # CPU: plain version
    assert got.dtype == torch.bfloat16 and got.shape == (n, c)
    got = got.float().numpy()
    rms = np.sqrt(np.mean(want ** 2))
    assert np.all(np.abs(got - want) <= 2 ** -7 * np.abs(want) + 1e-3 * rms)
    # the relu is live: a quarter or more of h is zero
    assert np.mean(yt.float().numpy() * inv + sh <= 0) > 0.25


def test_bn_mm_checks_its_arguments():
    y, w2 = torch.zeros(4, 8), torch.zeros(8, 16)
    with pytest.raises(ValueError):
        bn_mm(y, torch.zeros(7), torch.zeros(8), w2)
    with pytest.raises(ValueError):
        bn_mm(y, torch.zeros(8), torch.zeros(8), torch.zeros(9, 16))
    assert bn_mm_plain(y, torch.ones(8), torch.zeros(8), w2).shape == (4, 16)
