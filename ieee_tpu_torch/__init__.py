"""ieee_tpu_torch: the PyTorch/CUDA port of ``ieee_tpu`` for NVIDIA Hopper.

The JAX package ``ieee_tpu`` stays in the repository unchanged as the
reference; this package mirrors its module paths and names, imports
``torch`` and never ``jax`` or ``ieee_tpu``. Every Pallas kernel on a ported
path is a hand-written CUDA kernel (``csrc/``, built by ``ops/_build.py``)
with its plain PyTorch version beside it (``ops/kernels/``).

Ported so far: the IEEE retrieval path (config, datasets and loaders, the
test transform, ``IEEE3modalPart`` with its folded fast-eval head, the
distmat, CMC/mAP) and its training path (losses, optimizers, the P x K
sampler, the flip, ``Image3MEngine``, the softmax engines), with the CLI
(``python -m ieee_tpu_torch.main_multimodal``) for both; the single-modal
ResNet family (``ReIDResNet``) with ``python -m ieee_tpu_torch.main``; the
Market-1501, market_to_RGBNT201, AllDay and UAV datasets; and the
measurement tools (``python -m ieee_tpu_torch.tools.<name>``).
"""

__version__ = "0.1.0"
