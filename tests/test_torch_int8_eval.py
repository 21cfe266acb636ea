"""The port's w8a8 int8 eval path (``ieee_tpu_torch/models/int8_eval.py``
and the ``conv_s8`` kernel's plain version) against the JAX package's
``ieee_tpu/models/int8_eval.py``, on the CPU.

Both sides run f32 parameters: ``ReIDResNet`` trunks (basic and
bottleneck) at ``layers=(1, 1, 1, 1)``, 64x32 inputs,
weights and images from a numpy seed (non-trivial BN statistics), moved
into the port by ``load_jax_variables``. Tolerances, each with its reason:

- the plain ``conv_s8``'s s32 sums equal XLA's s8 conv exactly (integer
  arithmetic), and so do the quantized activations; its bf16 output is
  within one bf16 step of JAX's epilogue (XLA may fuse the multiply and
  add);
- the quantized weights equal JAX's or differ by one in at most 0.1% of
  the entries (the BN fold's rsqrt differs by an ulp between the two CPU
  libraries, which moves a value that sits at a rounding half);
- the folded bf16 walker matches JAX's per-sample cosine > 0.999 (bf16
  rounding in two conv implementations), the calibrated scales 2e-2
  relative per site (absmaxes of those bf16 maps);
- with JAX's scales, the int8 trunk matches JAX's cosine >= 0.999 (the same
  integers up to the weight ulps above and bf16 residual adds);
- the ReID step matches JAX's cosine >= 0.995 (the scales are each
  side's own calibration); against the port's own plain forward the JAX
  suite's bar, cosine > 0.97 (``tests/test_int8_eval.py:85``).

The IEEE step and the engine's dispatch are in
``tests/test_torch_int8_engine.py``.
"""

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from ieee_tpu.models import int8_eval as jie
from ieee_tpu.models.base import ReIDModel
from ieee_tpu.models.resnet import ReIDResNet as JaxReIDResNet
from ieee_tpu_torch.models import IEEE3modalPart, _reid_resnet, build_model
from ieee_tpu_torch.models import int8_eval as ie
from ieee_tpu_torch.models.weights import load_jax_variables
from ieee_tpu_torch.ops.kernels.conv_s8 import conv_s8, quantize_act

from torch_threads import one_torch_thread  # noqa: F401

LAYERS = (1, 1, 1, 1)
H, W = 64, 32
NUM_CLASSES = 8


def _cos(a, b):
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    return (a * b).sum(-1) / np.maximum(
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-12)


def _images(n=2, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (n, H, W, 3)).astype(np.float32)


def _random_variables(module, seed=5):
    """Abstract init for the tree's shapes, numpy values from ``seed``."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.zeros((2, H, W, 3)), train=True))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "var":
            v = np.abs(rng.standard_normal(shape)) + 0.5
        else:  # bias, mean
            v = 0.1 * rng.standard_normal(shape)
        return v.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, flax.core.unfreeze(shapes))
    return tree["params"], tree["batch_stats"]


def _jax_reid(block, fc_dims=None):
    module = JaxReIDResNet(num_classes=NUM_CLASSES, loss="softmax",
                           block=block, layers=LAYERS, fc_dims=fc_dims,
                           dtype=jnp.float32)
    return ReIDModel(module=module, name=f"{block}-test",
                     num_classes=NUM_CLASSES, loss="softmax")


def _port_reid(block, params, stats, fc_dims=None):
    model = build_model("resnet18" if block == "basic" else "resnet50",
                        NUM_CLASSES, "softmax", pretrained=False,
                        dtype="float32", device="cpu", layers=LAYERS,
                        fc_dims=fc_dims)
    load_jax_variables(model, params, stats)
    return model


@pytest.fixture(scope="module", params=["basic", "bottleneck"])
def trunk(request):
    """One trunk on both sides: JAX's folded bf16 forward, its calibrated
    scales and its int8 forward, and the port's model on the same
    weights."""
    block = request.param
    jm = _jax_reid(block)
    params, stats = _random_variables(jm.module)
    x = _images()
    exec_ = jie.make_trunk_exec(block, LAYERS, 2)
    p, s = params["trunk"], stats["trunk"]
    amax = jax.jit(lambda p, s, x: jie.collect_scales(exec_, p, s, x))
    jscales = {k: float(v) for k, v in amax(p, s, x).items()}
    ref = jax.jit(lambda p, s, x: jie.trunk_forward_ref(exec_, p, s, x))
    int8 = jax.jit(lambda p, s, x: jie.trunk_forward_int8(exec_, p, s, x,
                                                          jscales))
    return dict(
        block=block, jm=jm, params=params, stats=stats, x=x, jexec=exec_,
        jref=np.asarray(ref(p, s, x), np.float32), jscales=jscales,
        jint8=np.asarray(int8(p, s, x), np.float32),
        model=_port_reid(block, params, stats))


# one conv site per case: (x shape (B, H, W, C_in), C_out, K, stride,
# padding, x on the f32 image (the stem) or bf16)
SITES = {
    "stem": ((2, 32, 16, 3), 64, 7, 2, 3, True),
    "3x3s1": ((2, 8, 6, 32), 48, 3, 1, 1, False),
    "3x3s2": ((2, 9, 7, 32), 40, 3, 2, 1, False),
    "1x1s1": ((2, 5, 4, 64), 24, 1, 1, 0, False),
    "1x1s2": ((2, 7, 5, 64), 32, 1, 2, 0, False),
}


@pytest.mark.parametrize("site", list(SITES))
def test_conv_s8_plain_matches_jax_s32_conv(site):
    shape, cout, k, stride, pad, f32 = SITES[site]
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(shape) * 2.0).astype(np.float32)
    wq = rng.integers(-127, 128, (k, k, shape[-1], cout), dtype=np.int8)
    scale = rng.uniform(1e-4, 1e-3, cout).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    jx = jnp.asarray(x) if f32 else jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.tensor(x) if f32 else torch.tensor(x).to(torch.bfloat16)
    sx, inv_sx = ie.act_scale(float(np.abs(np.asarray(
        jx, np.float32)).max()) * 0.8)  # some values clip at +-127
    # the JAX site's quantization and conv (int8_eval.py:169-172)
    jq = jnp.clip(jnp.round(jx.astype(jnp.float32) * (1.0 / sx)), -127,
                  127).astype(jnp.int8)
    want = np.asarray(jax.lax.conv_general_dilated(
        jq, jnp.asarray(wq), (stride, stride), ((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    np.testing.assert_array_equal(quantize_act(tx, inv_sx).numpy(),
                                  np.asarray(jq))
    twq = torch.tensor(wq).permute(3, 0, 1, 2).contiguous()
    acc = conv_s8(tx, twq, None, None, stride, pad, False, inv_sx, raw=True)
    assert acc.dtype == torch.int32 and acc.shape == want.shape
    np.testing.assert_array_equal(acc.numpy(), want)
    # the dequantizing epilogue (int8_eval.py:173-175): one bf16 step
    y = conv_s8(tx, twq, torch.tensor(scale), torch.tensor(bias), stride,
                pad, True, inv_sx)
    jy = jax.nn.relu((jnp.asarray(want).astype(jnp.float32)
                      * jnp.asarray(scale) + jnp.asarray(bias)).astype(
                          jnp.bfloat16))
    jy = np.asarray(jy, np.float32)
    step = np.where(jy == 0, 0, 2.0 ** (np.floor(np.log2(
        np.abs(jy) + (jy == 0))) - 7))
    assert (np.abs(y.float().numpy() - jy) <= step).all()


def _port_sites(model):
    """{site: (conv, bn)} of the port's walker."""
    sites = {}

    def conv(x, site, conv_m, bn, stride, padding, relu):
        sites[site] = (conv_m, bn)
        return ie._conv_bf16(x, conv_m, bn, stride, padding, relu)

    with torch.no_grad():
        ie._trunk_exec(model)(model, torch.zeros(1, H, W, 3), conv)
    return sites


def _jax_sites(t):
    """{site: (params, stats)} of the JAX walker, traced on shapes only:
    the callback sees the concrete parameters the walker closes over."""
    sites = {}

    def conv(x, site, p, s, strides, padding, relu):
        sites[site] = (p, s)
        w, b = jie._fold(p, s)
        return jie._conv_nhwc(x, w, strides, padding, jnp.float32) + b

    jax.eval_shape(lambda x: t["jexec"](t["params"]["trunk"],
                                        t["stats"]["trunk"], x, conv),
                   jnp.zeros((1, H, W, 3)))
    return sites


@jax.jit
def _jax_quantized_weights(sites):
    """The JAX site's weight quantization (int8_eval.py:166-168), for every
    site in one program."""
    out = {}
    for site, (p, s) in sites.items():
        w, _ = jie._fold(p, s)
        sw = jnp.maximum(jnp.max(jnp.abs(w), axis=(0, 1, 2)), 1e-8) / 127.0
        out[site] = (jnp.round(w / sw).astype(jnp.int8), sw)
    return out


def test_quantized_weights_match_jax(trunk):
    ours, theirs = _port_sites(trunk["model"]), _jax_sites(trunk)
    assert list(ours) == list(theirs)
    quantized = _jax_quantized_weights(theirs)
    diff, total = 0, 0
    for site in theirs:
        want, sw = (np.asarray(v) for v in quantized[site])
        wq, tsw, _ = ie.quantize_weights(*ours[site])
        got = wq.permute(1, 2, 3, 0).numpy()  # OHWI -> HWIO
        np.testing.assert_allclose(tsw.detach().numpy(), sw, rtol=1e-6)
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1, site
        diff += int((d > 0).sum())
        total += d.size
    print(f"{trunk['block']}: {diff} of {total} quantized weights differ "
          "by one")
    assert diff <= 1e-3 * total


def test_walker_ref_matches_jax(trunk):
    with torch.no_grad():
        got = ie.trunk_forward_ref(ie._trunk_exec(trunk["model"]),
                                   trunk["model"], torch.tensor(trunk["x"]))
    assert tuple(got.shape) == trunk["jref"].shape
    c = _cos(got.float().numpy(), trunk["jref"])
    assert c.min() > 0.999, c


def test_calibrated_scales_match_jax(trunk):
    with torch.no_grad():
        got = ie._to_floats(ie.collect_scales(
            ie._trunk_exec(trunk["model"]), trunk["model"],
            torch.tensor(trunk["x"])))
    want = trunk["jscales"]
    assert sorted(got) == sorted(want)
    for site, v in want.items():
        assert abs(got[site] - v) <= 2e-2 * v, (site, got[site], v)


def test_int8_trunk_matches_jax_with_its_scales(trunk):
    with torch.no_grad():
        got = ie.trunk_forward_int8(ie._trunk_exec(trunk["model"]),
                                    trunk["model"], torch.tensor(trunk["x"]),
                                    trunk["jscales"])
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == trunk["jint8"].shape
    c = _cos(got.float().numpy(), trunk["jint8"])
    assert c.min() >= 0.999, c


def _port_images(x):
    return torch.tensor(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("fc_dims", [None, [64]], ids=["basic", "fc64"])
def test_int8_reid_step_matches_jax(fc_dims):
    jm = _jax_reid("basic", fc_dims)
    params, stats = _random_variables(jm.module, seed=6)
    model = _port_reid("basic", params, stats, fc_dims)
    x = _images(seed=4)
    want = np.asarray(jie.build_int8_reid_eval_step(jm)(params, stats, x))
    step = ie.build_int8_reid_eval_step(model)
    got = step(_port_images(x))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (2, fc_dims[0] if fc_dims
                                              else 512)
    c = _cos(got.numpy(), want)
    assert c.min() >= 0.995, c
    # the second call reuses the calibrated scales: bit for bit
    assert torch.equal(step(_port_images(x)), got)
    with torch.no_grad():
        plain = model.eval()(_port_images(x))
    c = _cos(got.numpy(), plain.numpy())
    assert c.min() > 0.97, c


def test_supports_int8_eval_rejects_grouped_trunks():
    with torch.device("meta"):
        for name, ok in (("resnext50_32x4d", False),
                         ("resnext101_32x8d", False), ("resnet18", True),
                         ("resnet50", True)):
            m = _reid_resnet(name)(num_classes=NUM_CLASSES, loss="softmax",
                                   dtype=torch.float32)
            assert ie.supports_int8_eval(m) is ok, name
        full = IEEE3modalPart(NUM_CLASSES, "margin")
        base = IEEE3modalPart(NUM_CLASSES, "margin", interaction=False,
                              attention=False, using_REM=False)
    assert ie.supports_int8_eval(full) and not ie.supports_int8_eval(base)


def test_trunk_sites_walk_resnet50():
    sites = ie.trunk_sites("bottleneck", (3, 4, 6, 3), 1, 100, 256, 128)
    assert len(sites) == 53
    assert sites[0] == ("stem", (100, 256, 128, 3, 64, 7, 2, 3), True,
                        torch.float32)
    assert len({(s[1], s[3]) for s in sites}) == 22
    assert sites[-1] == ("layer4_2/cb3", (100, 16, 8, 512, 2048, 1, 1, 0),
                         False, torch.bfloat16)


def test_export_forward_int8_keeps_the_calibrated_scales():
    jm = _jax_reid("basic")
    params, stats = _random_variables(jm.module, seed=7)
    model = _port_reid("basic", params, stats)
    calib, other = _port_images(_images(seed=8)), _port_images(_images(
        seed=9))
    fwd = ie.export_forward_int8(model, None, calib)
    step = ie.build_int8_reid_eval_step(model)
    step(calib)  # the same calibration batch: the same scales
    assert torch.equal(fwd(other), step(other))
    assert torch.equal(fwd(calib), step(calib))
