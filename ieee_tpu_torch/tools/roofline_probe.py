"""The empirical roofline of the card: the bf16 matmul rate, elementwise
bandwidth, BN-shaped reductions, and the trunk's two conv shapes on
cuDNN, the rates perf work calibrates against.

Counterpart of ``tools/roofline_probe.py``. Each probe is one call of
eager PyTorch ops, timed as the median of single calls (CUDA events).
Convolutions run in bf16 on channels_last tensors (the trunk's layout).

Usage: python -m ieee_tpu_torch.tools.roofline_probe [--device cuda]
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from ._timing import median_ms, parse_tool_args

__all__ = ["elementwise", "bnstats", "probe", "main"]

_BF16 = torch.bfloat16


def elementwise(c: torch.Tensor, half: torch.Tensor,
                one: torch.Tensor) -> torch.Tensor:
    """c * 1.0001 + 0.5 in one pass (``half`` and ``one`` are 0-d tensors
    of c's type), as XLA fuses the JAX probe's two operations."""
    return torch.addcmul(half, c, one, value=1.0001)


def bnstats(c: torch.Tensor) -> torch.Tensor:
    """The JAX probe's BN-shaped step: f32 mean and mean square over all but
    the channel axis, folded back into c so that the work is kept."""
    xf = c.float()
    dims = tuple(range(c.ndim - 1))
    m = xf.mean(dims)
    v = (xf * xf).mean(dims)
    return c + m.to(c.dtype) * 1e-6 + v.to(c.dtype) * 1e-6


def probe(device, mm: int = 8192, ew=(8192, 8192),
          bn_shapes=((128, 16, 8, 2048), (128, 64, 32, 256)),
          conv3=(128, 64, 32, 256), conv1=(128, 16, 8, 2048, 512),
          iters: int = 20) -> dict:
    """Time each probe. ``conv3``: (B, H, W, C) of a 3x3 C -> C conv;
    ``conv1``: (B, H, W, Cin, Cout) of a 1x1 conv whose output is
    concatenated four times. Returns {name: (ms, rate)}."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    results = {}

    def randn(shape):
        return torch.randn(shape, generator=gen, device=device, dtype=_BF16)

    def report(name, fn, work, unit):
        ms = median_ms(fn, iters, device=device)
        scale = 1e9 if unit == "TFLOP/s" else 1e6
        results[name] = (ms, work / ms / scale)
        print(f"{name}: {ms:.4f} ms/iter -> {results[name][1]:.1f} {unit}",
              flush=True)

    a = randn((mm, mm))
    report(f"matmul bf16 {mm}^3", lambda: torch.matmul(a, a), 2 * mm ** 3,
           "TFLOP/s")
    del a

    x = randn(ew)
    half = torch.tensor(0.5, dtype=_BF16, device=device)
    one = torch.tensor(1.0, dtype=_BF16, device=device)
    report(f"elementwise {x.numel() * 2 >> 20}MB bf16",
           lambda: elementwise(x, half, one), 2 * x.numel() * 2, "GB/s")
    del x

    for shape in bn_shapes:
        y = randn(shape)
        report(f"bn stats+write {list(shape)}", lambda: bnstats(y),
               2 * y.numel() * 2, "GB/s")
        del y

    # NHWC maps as channels_last NCHW tensors; weights (Cout, Cin, kh, kw)
    b, h, w, ch = conv3
    xc = randn((b, h, w, ch)).permute(0, 3, 1, 2)
    wc = randn((ch, ch, 3, 3)).contiguous(memory_format=torch.channels_last)
    report(f"conv3x3 {list(conv3)}", lambda: F.conv2d(xc, wc, padding=1),
           2 * b * h * w * ch * ch * 9, "TFLOP/s")
    del xc, wc

    b, h, w, cin, cout = conv1
    x2 = randn((b, h, w, cin)).permute(0, 3, 1, 2)
    w2 = randn((cout, cin, 1, 1)).contiguous(memory_format=torch.channels_last)

    def conv_cat():
        y = F.conv2d(x2, w2)
        return torch.cat([y, y, y, y], dim=1)

    report(f"conv1x1 {cin}->{cout} [{b},{h},{w}]", conv_cat,
           2 * b * h * w * cin * cout, "TFLOP/s")
    return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    _, device = parse_tool_args(parser, argv)
    return probe(device)


if __name__ == "__main__":
    main()
