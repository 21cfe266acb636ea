"""Squared-euclidean query x gallery distance matrix (kernel 1).

Counterpart of ``ieee_tpu/ops/pallas/distmat.py:euclidean_sq_pallas``. The
CUDA kernel (``csrc/distmat.cu``) runs for every shape and every K on a CUDA
tensor: the JAX package's ``pallas_supported`` gate is a TPU VMEM and launch
limit and has no counterpart here.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from .. import _build

__all__ = ["euclidean_sq", "euclidean_sq_plain"]


def euclidean_sq_plain(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(m, k), (n, k) f32 -> (m, n): |q|^2 + |g|^2 - 2 q.g^T in full f32
    (set ``torch.backends.cuda.matmul.allow_tf32 = False`` on a card)."""
    q = q.float()
    g = g.float()
    qn = (q * q).sum(1, keepdim=True)
    gn = (g * g).sum(1, keepdim=True)
    return qn + gn.T - 2.0 * (q @ g.T)


def _check(q: torch.Tensor, g: torch.Tensor) -> None:
    if q.ndim != 2 or g.ndim != 2 or q.shape[1] != g.shape[1]:
        raise ValueError(
            f"expected (m, k) and (n, k), got {tuple(q.shape)} and "
            f"{tuple(g.shape)}")
    if q.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"expected float32, got {q.dtype} and {g.dtype}")
    if q.device != g.device:
        raise ValueError(f"q on {q.device}, g on {g.device}")


def euclidean_sq(q: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(m, k), (n, k) float32 -> (m, n) float32 squared distances."""
    _check(q, g)
    if q.device.type == "cpu":
        return euclidean_sq_plain(q, g)
    if q.device.type != "cuda":
        raise ValueError(f"no distmat kernel for device {q.device}")
    lib = _build.load_library()
    q = q.contiguous()
    g = g.contiguous()
    m, k = q.shape
    n = g.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=q.device)
    _build.check(lib.ieee_distmat_f32(
        q.data_ptr(), g.data_ptr(), out.data_ptr(), m, n, k,
        _build.stream_ptr(q.device)), "distmat")
    LAUNCHES["distmat"] += 1
    return out
