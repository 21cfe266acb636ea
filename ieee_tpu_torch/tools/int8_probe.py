"""Probe of the int8 conv path at every distinct conv site of ResNet-50
(the IEEE model's trunk: 256x128, last_stride 1): the ``conv_s8`` kernel
against cuDNN's bf16 ``conv2d`` at the same shape (a different function:
no quantization, bf16 operands) and, at the 1x1 sites, ``torch._int_mm``
on the (M, K) int8 rows already gathered (the product alone).

Counterpart of ``tools/int8_probe.py``, which asks whether XLA:TPU lowers
s8 x s8 -> s32 dots and convs to the chip's int8 rate. On the card the
question is how close the hand kernel comes to its bound (the larger of
the operations over 1,979 TOP/s and the bytes over 3.35 TB/s) and to the
bf16 library conv it takes the place of. Each line is one distinct shape
with its count in one trunk; the last lines sum the trunk (53 sites).

Usage: python -m ieee_tpu_torch.tools.int8_probe [--batch 100]
    [--iters 20] [--device cuda]
"""

from __future__ import annotations

import argparse
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from ._timing import bound_ms, median_ms, parse_tool_args

__all__ = ["distinct_sites", "site_work", "probe", "main"]


def distinct_sites(batch: int, height: int = 256, width: int = 128,
                   block: str = "bottleneck", layers=(3, 4, 6, 3),
                   last_stride: int = 1):
    """[((B, H, W, C_in, C_out, K, stride, padding), input dtype, relu,
    count in one trunk)] in the walker's order of first use."""
    from ..models.int8_eval import trunk_sites

    sites = trunk_sites(block, layers, last_stride, batch, height, width)
    counts = Counter((shape, dtype) for _, shape, _, dtype in sites)
    seen, out = set(), []
    for _, shape, relu, dtype in sites:
        if (shape, dtype) not in seen:
            seen.add((shape, dtype))
            out.append((shape, dtype, relu, counts[(shape, dtype)]))
    return out


def site_work(shape, dtype):
    """(operations, bytes) of one conv_s8 call: 2 M N K; the input read
    once in its type, the int8 weights, the bf16 output and the f32 scale
    and bias."""
    from ..ops.kernels.conv_s8 import out_hw

    b, h, w, cin, cout, k, stride, pad = shape
    ho, wo = out_hw(h, w, k, k, stride, pad)
    m, kk = b * ho * wo, k * k * cin
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = b * h * w * cin * itemsize + cout * kk + m * cout * 2 + 8 * cout
    return 2.0 * m * cout * kk, float(nbytes)


def _operands(shape, dtype, device, seed):
    b, h, w, cin, cout, k, _, _ = shape
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((b, h, w, cin), np.float32),
                     device=device).to(dtype)
    wq = torch.tensor(rng.integers(-127, 128, (cout, k, k, cin), np.int8),
                      device=device)
    scale = torch.full((cout,), 1e-3, device=device)
    bias = torch.zeros(cout, device=device)
    return x, wq, scale, bias


def probe(device="cuda", batch: int = 100, height: int = 256,
          width: int = 128, iters: int = 20, layers=(3, 4, 6, 3)) -> dict:
    """Times each distinct site; returns {shape: {"count", "conv_s8",
    "cudnn_bf16", "int_mm", "bound", "bound_by"}} (ms, int_mm None where it
    does not apply or fails) and "trunk": the count-weighted sums."""
    from ..ops.kernels.conv_s8 import conv_s8

    device = torch.device(device)
    inv_sx = 40.0
    res, total = {}, Counter()
    for i, (shape, dtype, relu, count) in enumerate(
            distinct_sites(batch, height, width, layers=layers)):
        b, h, w, cin, cout, k, stride, pad = shape
        x, wq, scale, bias = _operands(shape, dtype, device, i)
        ms = median_ms(lambda: conv_s8(x, wq, scale, bias, stride, pad, relu,
                                       inv_sx), iters, device=device)
        xc = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        wc = wq.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        cudnn_ms = median_ms(lambda: F.conv2d(xc, wc, None, stride, pad),
                             iters, device=device)
        int_mm = None
        note = "n/a (not a 1x1 site)"
        if k == 1:
            xs = x[:, ::stride, ::stride] if stride > 1 else x
            a = torch.clamp(torch.round(xs.float() * inv_sx), -127,
                            127).to(torch.int8).reshape(-1, cin)
            bt = wq.reshape(cout, cin).t()
            try:
                int_mm = median_ms(lambda: torch._int_mm(a, bt), iters,
                                   device=device)
                note = f"{int_mm:.4f} ms"
            except RuntimeError as e:  # a refused shape is a probe result
                note = f"failed: {str(e).splitlines()[0][:120]}"
        ops, nbytes = site_work(shape, dtype)
        bnd, by = bound_ms(ops, nbytes, "int8")
        print(f"site {b}x{h}x{w} {cin}->{cout} k{k} s{stride} "
              f"{str(dtype).replace('torch.', '')} (x{count}): conv_s8 "
              f"{ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s), cuDNN bf16 "
              f"{cudnn_ms:.4f} ms ({ops / cudnn_ms / 1e9:.1f} TFLOP/s), "
              f"_int_mm {note}, bound {bnd:.4f} ms ({by})", flush=True)
        res[shape] = {"count": count, "conv_s8": ms, "cudnn_bf16": cudnn_ms,
                      "int_mm": int_mm, "bound": bnd, "bound_by": by}
        total["conv_s8"] += count * ms
        total["cudnn_bf16"] += count * cudnn_ms
        total["bound"] += count * bnd
        if int_mm is not None:
            total["int_mm_1x1"] += count * int_mm
            total["conv_s8_1x1"] += count * ms
        del x, wq, xc, wc
    sites = sum(r["count"] for r in res.values())
    print(f"trunk ({sites} sites, batch {batch}): conv_s8 "
          f"{total['conv_s8']:.4f} ms, cuDNN bf16 {total['cudnn_bf16']:.4f} "
          f"ms, bound {total['bound']:.4f} ms; 1x1 sites: conv_s8 "
          f"{total['conv_s8_1x1']:.4f} ms, _int_mm "
          f"{total['int_mm_1x1']:.4f} ms", flush=True)
    res["trunk"] = dict(total)
    return res


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=100)
    parser.add_argument("--iters", type=int, default=20)
    args, device = parse_tool_args(parser, argv)
    return probe(device, args.batch, iters=args.iters)


if __name__ == "__main__":
    main()
