"""Fused part pooling + projection (kernel 3).

Counterpart of ``ieee_tpu/ops/pallas/partpool.py:fused_partpool_project``:
the IEEE eval head's ``global/part avgpool -> 1x1 conv -> BN -> ReLU`` chain,
``out[b, p] = relu(pool_p(x[b]) @ W * s + t)`` with row 0 the global mean
and rows 1..P the adaptive stripes. On the card one call runs
``csrc/partpool.cu``: a pooling pass over the whole card into bf16 pooled
rows, then their product with W on wgmma.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import LAUNCHES
from .. import _build
from .matmul_bn import (_check_multiple_of_8, _cuda_operands, _mm_plan,
                        _sm_count)

__all__ = ["fused_partpool_project", "fused_partpool_project_plain",
           "fold_bn", "pool_matrix"]

#: the pooling pass (csrc/partpool.cu): a block owns one sample and a
#: chunk of POOL_LANES 16-byte vectors of channels, POOL_POSITION_LANES
#: position lanes deep
POOL_LANES = 32
POOL_POSITION_LANES = 8


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """Fold BN running stats into (s, t): y = x_proj * s + t."""
    inv = scale / torch.sqrt(var + eps)
    return inv, bias - mean * inv


@functools.lru_cache(maxsize=16)
def _pool_matrix_np(h: int, w: int, parts: int) -> np.ndarray:
    m = np.zeros((parts + 1, h, w), np.float32)
    m[0] = 1.0 / (h * w)
    for p in range(parts):
        h0 = (p * h) // parts
        h1 = -(-((p + 1) * h) // parts)
        m[p + 1, h0:h1, :] = 1.0 / ((h1 - h0) * w)
    m.setflags(write=False)
    return m.reshape(parts + 1, h * w)


@functools.lru_cache(maxsize=16)
def _pool_matrix_on(h: int, w: int, parts: int, device: str) -> torch.Tensor:
    return torch.tensor(_pool_matrix_np(h, w, parts), device=device)


def pool_matrix(h: int, w: int, parts: int, device="cpu") -> torch.Tensor:
    """(parts+1, H*W) f32 pooling weights: row 0 the global mean, row 1+p the
    adaptive stripe p, covering rows [floor(p*H/P), ceil((p+1)*H/P)) as
    AdaptiveAvgPool2d does; stripes overlap when P does not divide H.
    Cached per device (read-only: callers must not write to it)."""
    return _pool_matrix_on(h, w, parts, str(torch.device(device)))


def fused_partpool_project_plain(x, w, s, t, parts: int = 6):
    """Plain PyTorch with the kernel's rounding points: bf16 map, f32
    pooling, bf16 pooled rows and W, f32 product and output."""
    b, h, wd, c = x.shape
    xb = x.to(torch.bfloat16).float().reshape(b, h * wd, c)
    pool = pool_matrix(h, wd, parts, x.device)
    pooled = torch.matmul(pool, xb)  # (B, P+1, C) f32
    proj = (pooled.to(torch.bfloat16).float()
            @ w.to(torch.bfloat16).float())  # (B, P+1, F)
    return torch.relu(proj * s.float() + t.float())


def _check(x, w, s, t, parts) -> None:
    if x.ndim != 4 or w.ndim != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"expected x (B, H, W, C) and w (C, F), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    f = w.shape[1]
    if s.shape != (f,) or t.shape != (f,):
        raise ValueError(f"s/t must be ({f},), got {tuple(s.shape)}, "
                         f"{tuple(t.shape)}")
    if not 1 <= parts <= 8:
        raise ValueError(f"parts must be in 1..8, got {parts}")
    if not (x.device == w.device == s.device == t.device):
        raise ValueError("x, w, s and t must share a device")


def _partpool_plan(b: int, parts: int, c: int, f: int, itemsize: int,
                   sms: int = 132):
    """(pooling blocks, channels a pooling block owns, rows M of the
    product, the product's column width): the pooling pass runs one block
    per sample and chunk of channels; the product is (M = b (parts + 1),
    C) @ (C, F) in 128-row tiles of ``_mm_plan``'s width."""
    chunk = POOL_LANES * (16 // itemsize)
    m = b * (parts + 1)
    return b * -(-c // chunk), chunk, m, _mm_plan(m, f, sms)


def fused_partpool_project(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                           t: torch.Tensor, parts: int = 6) -> torch.Tensor:
    """x (B, H, W, C) f32 or bf16, w (C, F), s/t (F,) -> (B, parts+1, F) f32.
    An f32 map is rounded to bf16 as it is read (the JAX op's default
    ``stream_bf16``)."""
    _check(x, w, s, t, parts)
    if x.device.type == "cpu":
        return fused_partpool_project_plain(x, w, s, t, parts)
    if x.device.type != "cuda":
        raise ValueError(f"no partpool kernel for device {x.device}")
    b, h, wd, c = x.shape
    f = w.shape[1]
    _check_multiple_of_8("partpool", C=c, F=f)
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    _, chunk, m, width = _partpool_plan(b, parts, c, f, x.element_size(),
                                        _sm_count(x.device.index))
    smem = 4 * (POOL_POSITION_LANES * chunk + (parts + 1) * h * wd)
    if smem > 227 * 1024:
        raise ValueError(f"partpool kernel: {smem} bytes of shared memory "
                         "exceed the 227 KB a block can use")
    x, w, s, t = _cuda_operands("partpool", x, w.to(torch.bfloat16),
                                s.float(), t.float())
    pool = pool_matrix(h, wd, parts, x.device)
    lib = _build.load_library()
    pooled = torch.empty((m, c), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((b, parts + 1, f), dtype=torch.float32, device=x.device)
    _build.check(lib.ieee_partpool(
        x.data_ptr(), int(x.dtype == torch.bfloat16), pool.data_ptr(),
        w.data_ptr(), s.data_ptr(), t.data_ptr(), pooled.data_ptr(),
        out.data_ptr(), b, parts + 1, h * wd, c, f, width // 64,
        _build.stream_ptr(x.device)), "partpool")
    LAUNCHES["partpool"] += 1
    return out
