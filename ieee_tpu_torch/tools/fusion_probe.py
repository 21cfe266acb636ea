"""The fused-matmul-epilogue thesis at the CIM conv's shape as a matmul,
(16384, 2048) x (2048, 2048):

1. the unfused baseline: y = x @ w; the statistics and the BN+ReLU
   normalise as separate passes over y (eager PyTorch ops);
2. the producer: the ``mm_stats`` kernel, y written once with the channel
   sums taken from the f32 accumulator (``probe_mm_stats``, the port of
   ``pallas_mm_stats``), with its mean and variance errors against the
   baseline's;
3. the consumer: a matmul whose input loads apply BN+ReLU (the ``bn_mm``
   kernel, the port of ``pallas_bn_mm``) against BN+ReLU then a bf16
   ``torch.matmul``, with the largest difference of the two;
4. dW = x^T dy, the backward's product, as a bf16 ``torch.matmul``.

Counterpart of ``tools/fusion_probe.py``; times are medians of single
calls (CUDA events), TF/s counts 2 N K C operations.

Usage: python -m ieee_tpu_torch.tools.fusion_probe [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from ..ops.kernels.probes import bn_mm, probe_mm_stats
from ._timing import median_ms, parse_tool_args

__all__ = ["N", "K", "C", "baseline", "consumer", "probe", "main"]

N, K, C = 16384, 2048, 2048
_BF16 = torch.bfloat16


def baseline(x, w, scale, bias):
    """``xla_baseline``: y = bf16(x @ w), the one-pass statistics of y,
    z = bf16(relu(bn(y))); returns (z, m, v)."""
    y = torch.matmul(x, w)
    yf = y.float()
    m = yf.mean(0)
    v = (yf * yf).mean(0) - m * m
    inv = torch.rsqrt(v + 1e-5) * scale
    sh = bias - m * inv
    z = torch.relu(yf * inv + sh).to(_BF16)
    return z, m, v


def consumer(y, inv, sh, w2):
    """``xla_cons``: a = bf16(relu(y * inv + sh)), then bf16(a @ w2)."""
    a = torch.relu(y.float() * inv + sh).to(_BF16)
    return torch.matmul(a, w2)


def probe(device, n: int = N, k: int = K, c: int = C,
          iters: int = 10) -> dict:
    """Time the four steps at (n, k) x (k, c); returns {name: ms} and the
    errors."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(_BF16)

    x, w, w2 = randn((n, k)), randn((k, c), 0.02), randn((c, c), 0.02)
    scale = torch.ones(c, device=device)
    bias = torch.zeros(c, device=device)
    fl = 2 * n * k * c
    out = {}

    def report(name, fn):
        out[name] = median_ms(fn, iters, device=device)
        print(f"{name}: {out[name]:.4f} ms ({fl / out[name] / 1e9:.0f} TF/s"
              f"{'' if name == 'pure mm' else ' eq'})", flush=True)

    report("pure mm", lambda: torch.matmul(x, w))
    report("torch mm+stats+bnrelu", lambda: baseline(x, w, scale, bias))
    report("kernel mm+stats epilogue", lambda: probe_mm_stats(x, w))
    _, m, v = baseline(x, w, scale, bias)
    y2, m2, v2 = probe_mm_stats(x, w)
    out["mean_err"] = (m - m2).abs().max().item()
    out["var_err"] = (v - v2).abs().max().item()
    print(f"mean err: {out['mean_err']:.3e} var err: {out['var_err']:.3e}")

    inv = torch.rsqrt(v2 + 1e-5)
    sh = -m2 * inv
    report("torch bnrelu+mm consumer", lambda: consumer(y2, inv, sh, w2))
    report("kernel fused-affine mm consumer", lambda: bn_mm(y2, inv, sh, w2))
    a = consumer(y2, inv, sh, w2).float()
    b = bn_mm(y2, inv, sh, w2).float()
    out["consumer_err"] = (a - b).abs().max().item()
    print(f"consumer max err: {out['consumer_err']:.3e}")

    dy = randn((n, c))
    report("dW x^T@dy", lambda: torch.matmul(x.t(), dy))
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    _, device = parse_tool_args(parser, argv)
    return probe(device)


if __name__ == "__main__":
    main()
