"""The w8a8 convolution of the int8 eval path (``csrc/conv_s8.cu``).

One conv site of the JAX package's ``trunk_forward_int8``
(``ieee_tpu/models/int8_eval.py:161-177``), where XLA quantizes the input,
runs an s8 x s8 -> s32 convolution and dequantizes:

    xq  = clip(round(f32(x) * inv_sx), -127, 127)      (half to even)
    acc = conv(xq, wq)                                 (s32, exact)
    y   = bf16(f32(acc) * scale[n] + bias[n])  [ReLU]  (scale = sw * sx)

``x`` is NHWC (bf16, or f32 for the stem's image), ``wq`` the int8 weights
(C_out, KH, KW, C_in), K-major. ``raw=True`` returns the s32 sums. PyTorch
has no int8 convolution on the card, so a CUDA tensor runs the hand kernel
(an implicit GEMM on ``mma.sync`` s8 tiles that quantizes as it gathers);
a CPU tensor runs the plain version, which feeds the same integers to
``F.conv2d`` in float64 (exact: every partial sum is an integer below
127^2 * 4608 < 2^53) and applies the same epilogue in f32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import LAUNCHES
from .. import _build
from .matmul_bn import _check_multiple_of_8, _cuda_operands

__all__ = ["conv_s8", "conv_s8_plain", "quantize_act", "out_hw"]


def out_hw(h: int, w: int, kh: int, kw: int, stride: int, padding: int):
    """The output map's (Ho, Wo)."""
    return ((h + 2 * padding - kh) // stride + 1,
            (w + 2 * padding - kw) // stride + 1)


def quantize_act(x: torch.Tensor, inv_sx: float) -> torch.Tensor:
    """clip(round(f32(x) * f32(inv_sx)), -127, 127) as int8, rounding half
    to even (``jnp.round``, ``torch.round``)."""
    q = torch.round(x.float() * float(np.float32(inv_sx)))
    return q.clamp(-127, 127).to(torch.int8)


def _check(x, wq, scale, bias, stride, padding, raw) -> None:
    if x.ndim != 4 or wq.ndim != 4 or x.shape[-1] != wq.shape[-1]:
        raise ValueError(f"expected x (B, H, W, C_in) and wq (C_out, KH, KW, "
                         f"C_in), got {tuple(x.shape)} and {tuple(wq.shape)}")
    if wq.dtype != torch.int8:
        raise ValueError(f"wq must be int8, got {wq.dtype}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bf16 or f32, got {x.dtype}")
    if stride < 1 or padding < 0:
        raise ValueError(f"bad stride {stride} or padding {padding}")
    cout = wq.shape[0]
    if not raw and (scale is None or bias is None
                    or scale.shape != (cout,) or bias.shape != (cout,)):
        raise ValueError(f"scale and bias must be ({cout},)")
    ho, wo = out_hw(x.shape[1], x.shape[2], wq.shape[1], wq.shape[2], stride,
                    padding)
    if ho < 1 or wo < 1:
        raise ValueError(f"empty output map {ho}x{wo}")
    if wq.device != x.device or (not raw and not (
            scale.device == bias.device == x.device)):
        raise ValueError("x, wq, scale and bias must share a device")


def _epilogue(acc, scale, bias, relu):
    y = (acc.float() * scale.float() + bias.float()).to(torch.bfloat16)
    return torch.relu(y) if relu else y


def conv_s8_plain(x, wq, scale, bias, stride: int, padding: int,
                  relu: bool, inv_sx: float, raw: bool = False):
    """The kernel's function in plain PyTorch (see the module docstring);
    on any device."""
    _check(x, wq, scale, bias, stride, padding, raw)
    xq = quantize_act(x, inv_sx)
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                   wq.permute(0, 3, 1, 2).double(), None, stride, padding)
    # exact on the CPU; round() also absorbs the rounding of a transform
    # algorithm cuDNN may pick for float64 on the card
    acc = acc.round().permute(0, 2, 3, 1).to(torch.int32).contiguous()
    return acc if raw else _epilogue(acc, scale, bias, relu)


def conv_s8(x: torch.Tensor, wq: torch.Tensor, scale, bias, stride: int,
            padding: int, relu: bool, inv_sx: float, raw: bool = False):
    """x (B, H, W, C_in) bf16 or f32, wq (C_out, KH, KW, C_in) int8, scale
    and bias (C_out,) f32 (None with ``raw``) -> (B, Ho, Wo, C_out) bf16,
    or int32 with ``raw``. C_out % 8 == 0 on the card; there ``inv_sx`` is
    applied as an f32 (the caller's f32(1 / sx))."""
    _check(x, wq, scale, bias, stride, padding, raw)
    if x.device.type == "cpu":
        return conv_s8_plain(x, wq, scale, bias, stride, padding, relu,
                             inv_sx, raw)
    b, h, w, cin = x.shape
    cout, kh, kw, _ = wq.shape
    _check_multiple_of_8("conv_s8", C_out=cout)
    if raw:
        x, wq = _cuda_operands("conv_s8", x, wq)
        scale_p = bias_p = 0
    else:
        x, wq, scale, bias = _cuda_operands("conv_s8", x, wq, scale.float(),
                                            bias.float())
        scale_p, bias_p = scale.data_ptr(), bias.data_ptr()
    ho, wo = out_hw(h, w, kh, kw, stride, padding)
    out = torch.empty((b, ho, wo, cout),
                      dtype=torch.int32 if raw else torch.bfloat16,
                      device=x.device)
    lib = _build.load_library()
    _build.check(lib.ieee_conv_s8(
        x.data_ptr(), int(x.dtype == torch.float32), wq.data_ptr(), scale_p,
        bias_p, out.data_ptr(), b, h, w, cin, cout, kh, kw, stride, padding,
        ho, wo, float(inv_sx), int(relu), int(raw),
        # the output tile's width: 64 columns for the narrow sites (the stem
        # and layer1's C_out of 64), else 128
        64 if cout <= 64 else 128, _build.stream_ptr(x.device)), "conv_s8")
    LAUNCHES["conv_s8"] += 1
    return out
