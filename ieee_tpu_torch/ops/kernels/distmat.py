"""Squared-euclidean query x gallery distance matrix (kernel 1).

Counterpart of ``ieee_tpu/ops/pallas/distmat.py:euclidean_sq_pallas``. The
CUDA kernel (``csrc/distmat.cu``: the 3xTF32 split on the tensor cores, at
f32 accuracy) runs for every shape and every K on a CUDA tensor: the JAX
package's ``pallas_supported`` gate is a TPU VMEM and launch limit and has
no counterpart here.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from .. import _build
from .matmul_bn import _sm_count

__all__ = ["euclidean_sq", "euclidean_sq_plain"]

#: the kernel's output tile (csrc/distmat.cu): 128 q rows x 128 g rows,
#: reduced in k steps of 32 (one 128-byte row of f32)
DM_ROWS = 128
DM_COLS = 128
DM_STEP = 32
#: the fewest k steps a part of a split over K takes
DM_MIN_STEPS = 4
#: output elements whose partial sums one extra part writes and the
#: finishing pass reads back in about the time a block takes for one k step
#: (8 bytes an element at 3.35 TB/s against ~1 us a step on an H100)
DM_PART_ELEMS = 2 ** 19


def _kp(k: int) -> int:
    """K as the kernel's workspace holds it: rounded up to a whole k step
    with zeros (at least one)."""
    return max(DM_STEP, -(-k // DM_STEP) * DM_STEP)


def _distmat_plan(m: int, n: int, k: int, sms: int = 132):
    """(split, chunk): the kernel splits K into ``split`` parts of
    ``chunk`` k steps (the last may be shorter, none is empty), one block
    per 128 x 128 output tile and part, one block an SM at a time. The
    plan takes the split whose blocks finish in the fewest k steps of one
    block (waves of ``sms`` blocks times ``chunk``), plus what each extra
    part costs the finishing pass (``DM_PART_ELEMS``), with parts of at
    least ``DM_MIN_STEPS`` steps; the fewest parts on a tie. 836 x 836
    (RGBNT201's test set, 49 tiles) takes 5 parts of 15 steps: 245 blocks
    in two waves, where 3 parts (147 blocks) would also take two waves of
    24 steps. Market-1501's 3368 x 15913 (3375 tiles) takes no split."""
    tiles = -(-m // DM_ROWS) * -(-n // DM_COLS)
    steps = _kp(k) // DM_STEP
    best = None
    for parts in range(1, max(1, steps // DM_MIN_STEPS) + 1):
        chunk = -(-steps // parts)
        split = -(-steps // chunk)
        cost = (-(-tiles * split // sms) * chunk
                + (split - 1) * m * n / DM_PART_ELEMS)
        if best is None or cost < best[0]:
            best = (cost, split, chunk)
    return best[1], best[2]


def _scratch_layout(m: int, n: int, k: int, split: int):
    """(floats, norms' offset, parts' offset) of the kernel's one scratch
    allocation: the hi|lo rows of q and g, their m + n norms, then the
    parts of a split (``split`` x m x n, none unless split > 1). Each
    region starts on a 256-byte boundary: the kernel stores the parts as
    float2 where n is even, and an odd m + n norms would leave them 4
    bytes off."""
    hilo = (m + n) * 2 * _kp(k)
    part = hilo + -(-(m + n) // 64) * 64
    return part + (split * m * n if split > 1 else 0), hilo, part


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
    split, chunk = _distmat_plan(m, n, k, _sm_count(q.device.index))
    size, nrm, part = _scratch_layout(m, n, k, split)
    scratch = torch.empty(size, dtype=torch.float32, device=q.device)
    ptr = scratch.data_ptr()
    out = torch.empty((m, n), dtype=torch.float32, device=q.device)
    _build.check(lib.ieee_distmat_f32(
        q.data_ptr(), g.data_ptr(), ptr, ptr + 4 * nrm,
        ptr + 4 * part if split > 1 else None, out.data_ptr(),
        m, n, k, split, chunk, _build.stream_ptr(q.device)), "distmat")
    LAUNCHES["distmat"] += 1
    return out
