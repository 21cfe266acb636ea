"""The port's ``FeatureExtractor`` (``ieee_tpu_torch/utils/
feature_extractor.py``) against the JAX package's, on the CPU.

resnet18 at full depth, 64x32 images, ``pretrained=False`` (no ImageNet
file is on either machine): the JAX extractor's seeded flax weights are
moved into the port's model by ``load_jax_variables``, and both get the
same uint8 batch from a numpy seed. Tolerances: the plain features agree
to a cosine > 0.999 (both compute in bf16, rounding in two conv
implementations), and so does the port's plain bf16 forward with its own
f32 forward, bit for bit from call to call (``models/common.py``
``conv2d``); the int8 features match JAX's int8 at cosine >= 0.99
(each side calibrates its own scales from those bf16 maps) and the port's
plain features at the JAX suite's bar, cosine > 0.98
(``tests/test_int8_eval.py:153``). Paths, single images and resizing go
through the same forward as a pre-batched array.
"""

import numpy as np
import pytest
import torch

from ieee_tpu.utils.feature_extractor import (
    FeatureExtractor as JaxFeatureExtractor,
)
from ieee_tpu_torch.data.transforms import build_test_transform
from ieee_tpu_torch.models import build_model
from ieee_tpu_torch.models.weights import load_jax_variables
from ieee_tpu_torch.utils.feature_extractor import FeatureExtractor

from torch_threads import one_torch_thread  # noqa: F401

SIZE = (64, 32)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.maximum(
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-12)


def _batch(n=3, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, *SIZE, 3), dtype=np.uint8)


def _port(jfe, **kw):
    fe = FeatureExtractor("resnet18", image_size=SIZE, pretrained=False,
                          device="cpu", **kw)
    load_jax_variables(fe.model, jfe.variables["params"],
                       jfe.variables["batch_stats"])
    return fe


@pytest.fixture(scope="module")
def jax_extractors():
    return (JaxFeatureExtractor("resnet18", image_size=SIZE,
                                pretrained=False),
            JaxFeatureExtractor("resnet18", image_size=SIZE,
                                pretrained=False, int8=True))


@pytest.fixture(scope="module")
def port_plain(jax_extractors):
    """The port's plain extractor on the JAX extractor's weights."""
    return _port(jax_extractors[0])


def test_plain_features_match_jax(jax_extractors, port_plain):
    jfe, _ = jax_extractors
    batch = _batch()
    want = np.asarray(jfe(batch), np.float32)
    got = port_plain(batch)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert want.shape == (3, 512)
    c = _cos(got.numpy(), want)
    assert c.min() > 0.999, c


def test_plain_bf16_forward_is_deterministic_and_near_f32(jax_extractors,
                                                          port_plain):
    jfe, fe = jax_extractors[0], port_plain
    batch = _batch()
    got = fe(batch)
    assert torch.equal(fe(batch), got)
    f32 = build_model("resnet18", 1, "softmax", pretrained=False,
                      dtype="float32", device="cpu")
    load_jax_variables(f32, jfe.variables["params"],
                       jfe.variables["batch_stats"])
    with torch.no_grad():
        want = f32(build_test_transform()(torch.from_numpy(batch)))
    c = _cos(got.numpy(), want.numpy())
    assert c.min() > 0.999, c


def test_int8_features_match_jax_and_plain(jax_extractors, port_plain):
    jfe, jfe8 = jax_extractors
    batch = _batch()
    want = np.asarray(jfe8(batch), np.float32)
    fe8 = _port(jfe, int8=True)
    got = fe8(batch).numpy()
    assert got.shape == want.shape == (3, 512)
    c = _cos(got, want)
    assert c.min() >= 0.99, c
    plain = port_plain(batch).numpy()
    c = _cos(got, plain)
    assert c.min() > 0.98, c
    # the scales stay from the first batch: a second call is bit for bit
    np.testing.assert_array_equal(fe8(batch).numpy(), got)


def test_inputs_paths_single_images_and_resize(port_plain, tmp_path,
                                               capsys):
    from PIL import Image

    fe = port_plain
    batch = _batch(n=2, seed=1)
    want = fe(batch).numpy()
    paths = []
    for i, img in enumerate(batch):
        p = tmp_path / f"{i}.png"
        Image.fromarray(img).save(p)
        paths.append(str(p))
    np.testing.assert_array_equal(fe(paths).numpy(), want)
    # one image is a batch of one: other f32 sums, then bf16 rounding
    assert _cos(fe(paths[1]).numpy(), want[1:]).min() > 0.999
    np.testing.assert_array_equal(fe(list(batch)).numpy(), want)
    # another size is resized bilinearly to image_size first
    big = np.asarray(Image.fromarray(batch[0]).resize((48, 96)))
    small = np.asarray(Image.fromarray(big).resize(
        (SIZE[1], SIZE[0]), Image.BILINEAR))
    np.testing.assert_array_equal(fe(big).numpy(), fe(small).numpy())
    with pytest.raises(TypeError):
        fe(3)
    # a grouped trunk has no int8 path: a warning, then the plain forward
    FeatureExtractor("resnext50_32x4d", image_size=SIZE, pretrained=False,
                     device="meta", int8=True)
    assert ("WARN: int8=True unsupported for resnext50_32x4d; using the "
            "plain forward") in capsys.readouterr().out


def test_model_path_loads_a_checkpoint(port_plain, tmp_path):
    src = port_plain
    path = tmp_path / "model.pth.tar-1"
    torch.save({"state_dict": src.model.state_dict(), "epoch": 1}, path)
    fe = FeatureExtractor("resnet18", model_path=str(path), image_size=SIZE,
                          pretrained=False, seed=3, device="cpu")
    batch = _batch(n=2, seed=2)
    np.testing.assert_array_equal(fe(batch).numpy(), src(batch).numpy())
