"""The plain PyTorch versions of the port's train kernels (``mm_stats``,
``mm_bn_da``, ``mm_bn_dw``), the ``mm_bn_act_train`` op around them and the
train branch of ``FusedConvBN1x1``, against the JAX package's op and module
(Pallas interpret mode on the CPU, as ``tests/test_matmul_bn.py`` runs
them).

Both sides take a and w to bf16 and accumulate in f32, at the same rounding
points, so the bf16 outputs (act, da, dres) agree to one bf16 step (2^-8
relative; 2^-7 allowed) and the f32 ones (mean, var, dw, dscale, dbias) to
f32 summation order. The kernels are held to these plain versions on a card
in ``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ieee_tpu.models.common import FusedConvBN1x1 as JaxFusedConvBN1x1
from ieee_tpu.ops.pallas.matmul_bn import mm_bn_act_train as jax_mm_bn
from ieee_tpu_torch.models.common import FastBatchNorm, FusedConvBN1x1
from ieee_tpu_torch.ops import kernels
from ieee_tpu_torch.ops.kernels.matmul_bn import (
    dy_plain,
    mm_bn_act_train,
    mm_bn_da,
    mm_bn_da_plain,
    mm_bn_dw,
    mm_bn_dw_plain,
    mm_stats,
    mm_stats_plain,
)
from torch_threads import one_torch_thread  # noqa: F401


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got, want, bf16, err_msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if bf16:
        np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=err_msg)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=err_msg)


# relu / residual / neither; N = 200 and 37 are ragged against the Pallas
# tile (512) and the CUDA tile (128)
@pytest.mark.parametrize("n,k,c,relu,has_res", [(200, 128, 256, True, False),
                                                (37, 256, 128, False, True),
                                                (48, 128, 128, False, False)])
def test_mm_bn_act_train_matches_jax(n, k, c, relu, has_res):
    a, w = _np((n, k), 0), _np((k, c), 1, k ** -0.5)
    scale, bias = 1 + 0.1 * _np((c,), 2), 0.1 * _np((c,), 3)
    res = _np((n, c), 4) if has_res else np.zeros((1, 1), np.float32)
    ct = _np((n, c), 5)  # the cotangent of act

    def loss(a, w, scale, bias, res):
        act, mean, var = jax_mm_bn(a, w, scale, bias, res, relu, has_res)
        return jnp.sum(act.astype(jnp.float32) * ct), (act, mean, var)

    (_, (act, mean, var)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
        *map(jnp.asarray, (a, w, scale, bias, res)))

    leaves = [torch.tensor(x, requires_grad=True)
              for x in (a, w, scale, bias, res)]
    kernels.reset_launch_counts()
    t_act, t_mean, t_var = mm_bn_act_train(
        *leaves[:4], leaves[4] if has_res else None, relu)
    (t_act.float() * torch.tensor(ct)).sum().backward()
    assert sum(kernels.launch_counts().values()) == 0  # CPU: plain versions
    assert t_act.dtype == torch.bfloat16 and not t_mean.requires_grad
    _close(t_act.detach().float(), jnp.asarray(act, jnp.float32), True, "act")
    _close(t_mean, mean, False, "mean")
    _close(t_var, var, False, "var")
    names = ("da", "dw", "dscale", "dbias", "dres")
    for name, t, g in zip(names, leaves, grads):
        if name == "dres" and not has_res:
            assert t.grad is None
            continue
        # da and dres are bf16 values (cast back to a's f32 here)
        _close(t.grad, g, name in ("da", "dres"), name)
    if has_res:  # the residual's gradient is the incoming cotangent
        np.testing.assert_array_equal(
            leaves[4].grad.numpy(),
            torch.tensor(ct).to(torch.bfloat16).float().numpy())


def test_kernel_plain_versions_compose_the_op():
    # each kernel's wrapper on CPU tensors is its plain version; dy rounds
    # to bf16 before both products, and the stats come from the f32 product
    n, k, c = 40, 64, 48
    a = torch.tensor(_np((n, k), 6)).to(torch.bfloat16)
    w = torch.tensor(_np((k, c), 7, 0.1))
    y, st = mm_stats(a, w)
    y32 = a.float() @ w.to(torch.bfloat16).float()
    torch.testing.assert_close(st, torch.stack([y32.sum(0),
                                                (y32 * y32).sum(0)]))
    assert y.dtype == torch.bfloat16 and torch.equal(y, y32.to(y.dtype))
    torch.testing.assert_close(mm_stats(a, w)[1], mm_stats_plain(a, w)[1])
    d = torch.tensor(_np((n, c), 8)).to(torch.bfloat16)
    vecs = torch.tensor(np.abs(_np((6, c), 9)) + 0.1)
    for relu in (False, True):
        dy = dy_plain(d, y, vecs, relu)
        assert dy.dtype == torch.bfloat16
        da = mm_bn_da(d, y, vecs, w, relu)
        assert torch.equal(da, mm_bn_da_plain(d, y, vecs, w, relu))
        torch.testing.assert_close(
            da.float(), (dy.float() @ w.to(torch.bfloat16).float().t()
                         ).to(torch.bfloat16).float())
        dw = mm_bn_dw(a, d, y, vecs, relu)
        assert dw.dtype == torch.float32
        torch.testing.assert_close(dw, mm_bn_dw_plain(a, d, y, vecs, relu))
        torch.testing.assert_close(dw, a.float().t() @ dy.float())
    with pytest.raises(ValueError):
        mm_bn_da(d, y, vecs[:5], w, True)
    with pytest.raises(ValueError):
        mm_bn_dw(a[:5], d, y, vecs, True)
    with pytest.raises(ValueError):
        mm_bn_act_train(a.float(), w, vecs[0], vecs[1], y, relu=True)


@pytest.mark.parametrize("nonlinear,residual", [("relu", False),
                                                (None, True)])
def test_fused_conv_bn_train_matches_jax_module(nonlinear, residual):
    # the module in train mode (batch stats, running-stat update with
    # momentum 0.9) on an NHWC map of 2x5x3 pixels: forward, the input's
    # and parameters' gradients and the new running stats
    b, h, w_, cin, cout = 2, 5, 3, 64, 96
    x = _np((b, h, w_, cin), 10)
    kern = _np((1, 1, cin, cout), 11, cin ** -0.5)
    scale, bias = 1 + 0.1 * _np((cout,), 12), 0.1 * _np((cout,), 13)
    r_mean, r_var = 0.1 * _np((cout,), 14), np.abs(_np((cout,), 15)) + 0.5
    res = _np((b, h, w_, cout), 16) if residual else None
    ct = _np((b, h, w_, cout), 17)
    params = {"conv": {"kernel": kern}, "bn": {"scale": scale, "bias": bias}}
    stats = {"bn": {"mean": r_mean, "var": r_var}}
    jm = JaxFusedConvBN1x1(cout, nonlinear=nonlinear, dtype=jnp.float32)

    def loss(p, x, res):
        out, upd = jm.apply({"params": p, "batch_stats": stats}, x, True,
                            residual=res, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * ct), (out, upd)

    (_, (out, upd)), (gp, gx, gres) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(x), None if res is None else jnp.asarray(res))

    m = FusedConvBN1x1(cin, cout, nonlinear, dtype=torch.float32).train()
    conv, bn = m.layers
    with torch.no_grad():
        conv.weight.copy_(torch.tensor(kern[0, 0].T[:, :, None, None]))
        bn.weight.copy_(torch.tensor(scale))
        bn.bias.copy_(torch.tensor(bias))
        bn.running_mean.copy_(torch.tensor(r_mean))
        bn.running_var.copy_(torch.tensor(r_var))
    to_nchw = lambda t: torch.tensor(t).permute(0, 3, 1, 2)  # noqa: E731
    xt = to_nchw(x).contiguous(memory_format=torch.channels_last)
    xt.requires_grad_()
    rt = to_nchw(res).requires_grad_() if residual else None
    y = m(xt, rt)
    assert isinstance(bn, FastBatchNorm) and y.dtype == torch.bfloat16
    (y.float() * to_nchw(ct)).sum().backward()
    nhwc = lambda t: t.detach().permute(0, 2, 3, 1).float()  # noqa: E731
    _close(nhwc(y), jnp.asarray(out, jnp.float32), True, "act")
    _close(nhwc(xt.grad), gx, True, "dx")
    _close(conv.weight.grad[:, :, 0, 0].T, gp["conv"]["kernel"][0, 0], False,
           "dw")
    _close(bn.weight.grad, gp["bn"]["scale"], False, "dscale")
    _close(bn.bias.grad, gp["bn"]["bias"], False, "dbias")
    if residual:
        _close(nhwc(rt.grad), gres, True, "dres")
    _close(bn.running_mean, upd["batch_stats"]["bn"]["mean"], False, "mean")
    _close(bn.running_var, upd["batch_stats"]["bn"]["var"], False, "var")
    assert int(bn.num_batches_tracked) == 1
