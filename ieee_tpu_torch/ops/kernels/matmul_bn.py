"""Eval-mode fused 1x1 conv + folded BatchNorm [+ ReLU] (kernel 2).

Counterpart of ``ieee_tpu/ops/pallas/matmul_bn.py:mm_affine_act``:
``[relu]((a @ w) * inv + shift)`` with a and w cast to bf16, the product
accumulated in f32, and a bf16 result. The training ops of that module
(``mm_bn_act_train`` and its kernels ``_mm_stats``, ``_da``, ``_dw``) come
with the training slice.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from .. import _build

__all__ = ["mm_affine_act", "mm_affine_act_plain"]


def mm_affine_act_plain(a: torch.Tensor, w: torch.Tensor, inv: torch.Tensor,
                        shift: torch.Tensor, relu: bool) -> torch.Tensor:
    """Same contract in plain PyTorch: the bf16-rounded operands multiplied
    in f32 (exact products, f32 sums), the affine in f32, bf16 out."""
    y = a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
    y = y * inv.float() + shift.float()
    if relu:
        y = torch.relu(y)
    return y.to(torch.bfloat16)


def _check(a, w, inv, shift) -> None:
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"expected a (N, K) and w (K, C), got "
                         f"{tuple(a.shape)} and {tuple(w.shape)}")
    c = w.shape[1]
    if inv.shape != (c,) or shift.shape != (c,):
        raise ValueError(f"inv/shift must be ({c},), got {tuple(inv.shape)} "
                         f"and {tuple(shift.shape)}")
    if not (a.device == w.device == inv.device == shift.device):
        raise ValueError("a, w, inv and shift must share a device")


def mm_affine_act(a: torch.Tensor, w: torch.Tensor, inv: torch.Tensor,
                  shift: torch.Tensor, relu: bool) -> torch.Tensor:
    """a (N, K), w (K, C), inv/shift (C,) -> (N, C) bf16."""
    _check(a, w, inv, shift)
    if a.device.type == "cpu":
        return mm_affine_act_plain(a, w, inv, shift, relu)
    if a.device.type != "cuda":
        raise ValueError(f"no mm_affine kernel for device {a.device}")
    n, k = a.shape
    c = w.shape[1]
    if k % 8 or c % 8:
        raise ValueError(
            f"mm_affine kernel needs K and C divisible by 8, got K={k} C={c}")
    a = a.to(torch.bfloat16).contiguous()
    w = w.to(torch.bfloat16).contiguous()
    inv = inv.float().contiguous()
    shift = shift.float().contiguous()
    if a.data_ptr() % 16 or w.data_ptr() % 16:
        # the kernel loads 16-byte vectors; a sliced view may start anywhere
        a, w = a.clone(), w.clone()
    lib = _build.load_library()
    out = torch.empty((n, c), dtype=torch.bfloat16, device=a.device)
    _build.check(lib.ieee_mm_affine_bf16(
        a.data_ptr(), w.data_ptr(), inv.data_ptr(), shift.data_ptr(),
        out.data_ptr(), n, k, c, int(bool(relu)),
        _build.stream_ptr(a.device)), "mm_affine")
    LAUNCHES["mm_affine"] += 1
    return out
