"""The port's whole-block backward (``ops/kernels/block_bwd.py``:
``bottleneck_train`` and the plain versions of its four kernels) and the
block path of ``Bottleneck``/``ResNetTrunk`` against the JAX package's
(``ieee_tpu/ops/pallas/block_bwd.py``, its Pallas kernels in interpret mode
on the CPU, as ``tests/test_block_megakernel.py`` runs them).

Inputs are numpy arrays from seeds, handed to both packages. Tolerances:
bf16 outputs to one bf16 step (2^-7 relative, plus 1e-5 of the largest
value near zero) where both sides sum in f32 in other orders; f32 sums and
dW to 1e-4 relative; the op's gradients in f32 to 1e-5 of the largest value
(the JAX suite's bound for its own kernels against autodiff). The kernels
are held to these plain versions on a card in
``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from ieee_tpu.models.resnet import Bottleneck as JaxBottleneck
from ieee_tpu.models.resnet import ResNetTrunk as JaxTrunk
from ieee_tpu.ops.pallas import block_bwd as jbb
from ieee_tpu.ops.pallas.matmul_bn import _vecs
from ieee_tpu_torch.models.resnet import Bottleneck, ResNetTrunk
from ieee_tpu_torch.ops import kernels
from ieee_tpu_torch.ops.kernels import block_bwd as bb

F32, BF16 = jnp.float32, jnp.bfloat16
GRADS = "dx dk1 ds1 db1 dk2 ds2 db2 dk3 ds3 db3".split()


def _np(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _close(got, want, bf16, err_msg=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=2 ** -7 if bf16 else 1e-4,
                               atol=1e-5 * np.abs(want).max(),
                               err_msg=err_msg)


def _rel(got, want):
    """Largest error over the largest value (the JAX suite's measure)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _t(a, dtype=torch.bfloat16):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _block_nodes(out) -> int:
    """How many ``bottleneck_train`` ops the autograd graph of ``out``
    holds: the blocks that took the block path."""
    seen, stack, count = set(), [out.grad_fn], 0
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        count += type(fn).__name__ == "_BottleneckTrainBackward"
        stack.extend(f for f, _ in fn.next_functions)
    return count


# ------------------------------------------------- plain kernels vs Pallas
# (B, H, W, C, cm): N = 120 rows (ragged against the CUDA 128-row tile) in
# one Pallas grid step, and N = 1152 in three (a batch tile of 3 images)
SHAPES = [(5, 6, 4, 32, 16), (9, 16, 8, 64, 16)]


def _kernel_inputs(b, h, w, c, cm):
    maps = {name: _np((b, h, w, ch), seed, shift=0.1)
            for seed, (name, ch) in enumerate(
                (("dy", c), ("y", c), ("a3", c), ("a2", cm), ("a1", cm),
                 ("x", c), ("d3", c), ("d2", cm), ("d1", cm)))}
    rows = {name: [np.abs(_np((ch,), 20 + i)) + 0.5, _np((ch,), 30 + i, 0.5),
                   _np((ch,), 40 + i, 0.1), np.abs(_np((ch,), 50 + i)) + 0.5,
                   _np((ch,), 60 + i, 0.1)][:n]
            for i, (name, ch, n) in enumerate(
                (("v3", c, 5), ("v2f", cm, 4), ("v2", cm, 5), ("v1f", cm, 4),
                 ("v1", cm, 5)))}
    wts = {"w1": _np((c, cm), 70, c ** -0.5),
           "w2": _np((3, 3, cm, cm), 71, (9 * cm) ** -0.5),
           "w3": _np((cm, c), 72, cm ** -0.5)}
    return maps, rows, wts


def _jax_args(maps, rows, wts, names, vec_names, w_name):
    j = [jnp.asarray(maps[n], BF16) for n in names]
    v = [_vecs(*map(jnp.asarray, rows[n]), c=rows[n][0].shape[0])
         for n in vec_names]
    return j, v, jnp.asarray(wts[w_name])


def _torch_args(maps, rows, wts, names, vec_names, w_name):
    return ([_t(maps[n]) for n in names],
            [torch.tensor(np.stack(rows[n])) for n in vec_names],
            torch.tensor(wts[w_name]))


@pytest.mark.parametrize("b,h,w,c,cm", SHAPES)
def test_reduce3_plain_matches_pallas(b, h, w, c, cm):
    maps, rows, _ = _kernel_inputs(b, h, w, c, cm)
    mean, rstd = rows["v3"][1], rows["v3"][2]
    d3, s3 = jbb._reduce3(*[jnp.asarray(maps[n], BF16)
                            for n in ("dy", "y", "a3")],
                          jnp.asarray(mean), jnp.asarray(rstd))
    t_d3, t_s3 = bb.reduce3(*[_t(maps[n]) for n in ("dy", "y", "a3")],
                            torch.tensor(mean), torch.tensor(rstd))
    # a mask and a copy: exact
    np.testing.assert_array_equal(t_d3.float().numpy(),
                                  np.asarray(d3, np.float32))
    _close(t_s3, np.asarray(s3)[:2], False, "S3")


@pytest.mark.parametrize("b,h,w,c,cm", SHAPES)
def test_bn3_apply_plain_matches_pallas(b, h, w, c, cm):
    args = _kernel_inputs(b, h, w, c, cm)
    names, vnames = ("d3", "a3", "a2"), ("v3", "v2f")
    j, jv, jw = _jax_args(*args, names, vnames, "w3")
    d2, s2, dw3 = jbb._bn3_apply(*j, jw, *jv)
    t, tv, tw = _torch_args(*args, names, vnames, "w3")
    t_d2, t_s2, t_dw3 = bb.bn3_apply(*t, tw, *tv)
    _close(t_d2.float(), np.asarray(d2, np.float32), True, "d2")
    _close(t_s2, np.asarray(s2)[:2], False, "S2")
    _close(t_dw3, dw3, False, "dW3")


@pytest.mark.parametrize("b,h,w,c,cm", SHAPES)
def test_conv2_bwd_plain_matches_pallas(b, h, w, c, cm):
    # non-symmetric random taps: a transposed or unflipped W2 fails here
    args = _kernel_inputs(b, h, w, c, cm)
    names, vnames = ("d2", "a2", "a1"), ("v2", "v1f")
    j, jv, jw = _jax_args(*args, names, vnames, "w2")
    d1, s1, dw2 = jbb._conv2_bwd(*j, jw, *jv)
    t, tv, tw = _torch_args(*args, names, vnames, "w2")
    t_d1, t_s1, t_dw2 = bb.conv2_bwd(*t, tw, *tv)
    _close(t_d1.float(), np.asarray(d1, np.float32), True, "d1")
    _close(t_s1, np.asarray(s1)[:2], False, "S1")
    _close(t_dw2, dw2, False, "dW2")


@pytest.mark.parametrize("b,h,w,c,cm", SHAPES)
def test_bn1_apply_plain_matches_pallas(b, h, w, c, cm):
    args = _kernel_inputs(b, h, w, c, cm)
    names, vnames = ("d1", "a1", "x", "d3"), ("v1",)
    j, jv, jw = _jax_args(*args, names, vnames, "w1")
    dx, dw1 = jbb._bn1_apply(*j, jw, *jv)
    t, tv, tw = _torch_args(*args, names, vnames, "w1")
    kernels.reset_launch_counts()
    t_dx, t_dw1 = bb.bn1_apply(*t, tw, *tv)
    assert sum(kernels.launch_counts().values()) == 0  # CPU: plain versions
    _close(t_dx.float(), np.asarray(dx, np.float32), True, "dx")
    _close(t_dw1, dw1, False, "dW1")


# ------------------------------------------------------------ the whole op

def _op_inputs(b, h, w, c, cm):
    return [_np((b, h, w, c), 0), _np((1, 1, c, cm), 1, 0.2),
            1 + _np((cm,), 2, 0.1), _np((cm,), 3, 0.1),
            _np((3, 3, cm, cm), 4, 0.2), 1 + _np((cm,), 5, 0.1),
            _np((cm,), 6, 0.1), _np((1, 1, cm, c), 7, 0.2),
            1 + _np((c,), 8, 0.1), _np((c,), 9, 0.1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bottleneck_train_matches_jax_grad(dtype):
    # the forward, its six statistics and all ten gradients of
    # sum(y * ct) against jax.grad of the JAX op (its Pallas backward)
    b, h, w, c, cm = 3, 6, 4, 32, 16
    args = _op_inputs(b, h, w, c, cm)
    ct = _np((b, h, w, c), 10)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(*a):
        y, st = jbb.bottleneck_train(*a)
        return jnp.sum(y.astype(F32) * ct), (y, st)

    # op by op, not jitted: XLA's fusions would keep the forward's bf16
    # normalise in f32, which neither package's eager program does
    (_, (y, st)), grads = jax.value_and_grad(
        loss, argnums=tuple(range(10)), has_aux=True)(
        jnp.asarray(args[0], jdt), *map(jnp.asarray, args[1:]))

    leaves = [_t(args[0], tdt).requires_grad_()] + [
        torch.tensor(a, requires_grad=True) for a in args[1:]]
    t_y, t_st = bb.bottleneck_train(*leaves)
    (t_y.float() * torch.tensor(ct)).sum().backward()
    assert t_y.dtype == tdt and not any(s.requires_grad for s in t_st)
    bf16 = dtype == "bfloat16"
    _close(t_y.detach().float(), np.asarray(y, np.float32), bf16, "y")
    for i, (a, b_) in enumerate(zip(t_st, st)):
        _close(a, b_, False, f"stat {i}")
    # f32: the JAX suite's bound; bf16: both sides take the same bf16
    # operands, and their f32 sums differ in order (measured 2e-5)
    tol = 1e-5 if not bf16 else 2 ** -8
    for name, t, g in zip(GRADS, leaves, grads):
        rel = _rel(t.grad.float(), np.asarray(g, np.float32))
        assert rel < tol, (name, rel)


# ------------------------------------------------- the model's block path

def _random_tree(module, x, seed):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x,
                                                train=True))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.standard_normal(s.shape) * np.prod(s.shape[:-1]) ** -0.5
        elif name in ("scale", "var"):
            v = np.abs(1.0 + 0.1 * rng.standard_normal(s.shape))
        else:  # bias, mean
            v = 0.1 * rng.standard_normal(s.shape)
        return v.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, flax.core.unfreeze(shapes))
    return tree["params"], tree["batch_stats"]


def _block_sd(prefix, p, s):
    """A JAX bottleneck's subtree -> the port's state-dict entries (conv
    kernels HWIO -> OIHW; ``s`` None leaves out the running stats)."""
    sd = {}

    def bn(dst, q, r):
        sd[f"{prefix}{dst}.weight"] = q["scale"]
        sd[f"{prefix}{dst}.bias"] = q["bias"]
        if r is not None:
            sd[f"{prefix}{dst}.running_mean"] = r["mean"]
            sd[f"{prefix}{dst}.running_var"] = r["var"]

    def conv(dst, k):
        sd[f"{prefix}{dst}.weight"] = np.transpose(np.asarray(k), (3, 2, 0, 1))

    for src, c_dst, b_dst in (("cb1", "conv1", "bn1"), ("cb3", "conv3", "bn3"),
                              ("downsample", "downsample.0", "downsample.1"),
                              ("stem", "conv1", "bn1")):
        if src in p:
            conv(c_dst, p[src]["conv"]["kernel"])
            bn(b_dst, p[src]["bn"], None if s is None else s[src]["bn"])
    if "conv2" in p:
        conv("conv2", p["conv2"]["kernel"])
        bn("bn2", p["bn2"], None if s is None else s["bn2"])
    return sd


def _trunk_sd(p, s):
    sd = _block_sd("", {"stem": p["stem"]},
                   None if s is None else {"stem": s["stem"]})
    for name in p:
        if name.startswith("layer"):
            stage, b = name[len("layer"):].split("_")
            sd.update(_block_sd(f"layer{stage}.{b}.", p[name],
                                None if s is None else s[name]))
    return sd


def _load(model, sd):
    own = model.state_dict()
    missing = [k for k in own if k not in sd
               and not k.endswith("num_batches_tracked")]
    assert not missing and set(sd) <= set(own), (missing, set(sd) - set(own))
    with torch.no_grad():
        for k, v in sd.items():
            own[k].copy_(torch.tensor(np.asarray(v, np.float32)))


def _port_step(tm, sd, x, ct):
    """Load ``sd``, one train-mode forward and backward of sum(out * ct):
    (out NHWC, dx NHWC, {state-dict key: gradient or updated buffer},
    blocks that took the block path)."""
    _load(tm, sd)
    tm.train()
    xt = torch.tensor(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    y = tm(xt)
    (y.float() * torch.tensor(ct).permute(0, 3, 1, 2)).sum().backward()
    own = dict(tm.named_parameters())
    got = {k: (own[k].grad if k in own else v).clone()
           for k, v in tm.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    return (y.detach().permute(0, 2, 3, 1).float(),
            xt.grad.permute(0, 2, 3, 1), got, _block_nodes(y))


def _jax_step(jm, x, seed):
    """Random variables from ``seed`` and one train-mode forward and
    backward of the flax module: (params, stats, ct, out, dx, grads,
    updated stats, blocks that took the block path)."""
    params, stats = _random_tree(jm, jnp.asarray(x), seed)
    ct = _np(jax.eval_shape(lambda: jm.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
        mutable=["batch_stats"])[0]).shape, seed + 1)

    def loss(p, x):
        out, upd = jm.apply({"params": p, "batch_stats": stats}, x,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * ct), (out, upd["batch_stats"])

    fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    (_, (out, new_stats)), (gp, gx) = fn(params, jnp.asarray(x))
    # custom-VJP calls in the forward's program: the block-path blocks
    n_blocks = str(jax.make_jaxpr(loss)(params, jnp.asarray(x))).count(
        "custom_vjp_call")
    return params, stats, ct, out, gx, gp, new_stats, n_blocks


def test_bottleneck_block_path_matches_jax_module():
    # one train step of the block alone, in f32: output, input gradient,
    # every parameter gradient and the updated running statistics to 1e-5
    # of the largest value (measured 7e-7)
    b, h, w, cm = 2, 6, 4, 16
    x = _np((b, h, w, 4 * cm), 11)
    jm = JaxBottleneck(planes=cm, dtype=F32, block_megakernel=True)
    tm = Bottleneck(4 * cm, cm, dtype=torch.float32, block_megakernel=True)
    assert tm.megakernel
    params, stats, ct, out, gx, gp, new_stats, n_jax = _jax_step(jm, x, 12)
    y, dx, got, n_port = _port_step(tm, _block_sd("", params, stats), x, ct)
    assert n_port == n_jax == 1
    assert int(tm.bn2.num_batches_tracked) == 1
    want = _block_sd("", gp, new_stats)
    errs = {"y": _rel(y, out), "dx": _rel(dx, gx),
            **{k: _rel(v, want[k]) for k, v in got.items()}}
    assert max(errs.values()) < 1e-5, errs


def test_trunk_takes_the_block_path_where_jax_does():
    # layers (2, 2, 2, 1): the second block of layers 1-3 is stride 1
    # without downsample and at most 256 wide, so it takes the block path
    # in both packages; (1, 1, 1, 1) would have none. layer4 (width 512)
    # and every first block stay plain.
    layers = (2, 2, 2, 1)
    x = _np((2, 64, 32, 3), 13)
    jm = JaxTrunk(layers=layers, last_stride=1, dtype=F32,
                  block_megakernel=True)
    params, stats, ct, out, gx, gp, new_stats, n_jax = _jax_step(jm, x, 14)
    sd = _trunk_sd(params, stats)
    runs = {}
    for mk in (True, False):
        tm = ResNetTrunk(layers, last_stride=1, dtype=torch.float32,
                         block_megakernel=mk)
        chosen = [n for n, m in tm.named_modules()
                  if isinstance(m, Bottleneck) and m.megakernel]
        assert chosen == (["layer1.1", "layer2.1", "layer3.1"] if mk else [])
        runs[mk] = _port_step(tm, sd, x, ct)
    y, dx, got, n_port = runs[True]
    assert n_port == n_jax == 3 and runs[False][3] == 0
    # the block path against the port's plain trunk on the same weights:
    # the same function summed in other orders (measured 4e-6)
    for a, b_ in zip((y, dx, *got.values()),
                     (runs[False][0], runs[False][1],
                      *runs[False][2].values())):
        assert _rel(a, b_) < 1e-5
    # against the JAX trunk: the trunks' BNs see 16-256 rows, and f32
    # differences in the forward (7e-5) flip a few ReLU masks, as on the
    # plain path; outputs and running statistics to 2e-4 of the largest
    # value (the eval features' bound), gradients to a relative norm of
    # 2e-2 (the train-step test's bound for updates; measured 1.1e-2)
    want = _trunk_sd(gp, new_stats)
    assert _rel(y, out) < 2e-4
    for k, v in got.items():
        if "running" in k:
            assert _rel(v, want[k]) < 2e-4, k
        else:
            rel = np.linalg.norm(v.numpy() - want[k]) / np.linalg.norm(want[k])
            assert rel < 2e-2, (k, rel)
