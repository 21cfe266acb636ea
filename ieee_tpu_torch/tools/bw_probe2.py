"""Bandwidth with about 1 GB of work per call, so that launch cost is
negligible: a two-input add in f32 (1 GB arrays) and bf16 (512 MB), and
the BN statistics + normalise on a 1 GB bf16 map of the layer4 shape at a
16x batch, (2048, 16, 8, 2048).

Counterpart of ``tools/bw_probe2.py``. Each step is one call of eager
PyTorch ops, timed as the median of single calls (CUDA events), and
printed with the JAX tool's accounting (2R+1W; for the BN step the least
traffic, which eager PyTorch exceeds: it materialises the f32 map and its
square).

Usage: python -m ieee_tpu_torch.tools.bw_probe2 [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from ._timing import median_ms, parse_tool_args

__all__ = ["bn_normalize", "probe", "main"]


def bn_normalize(c: torch.Tensor) -> torch.Tensor:
    """The JAX tool's BN body: one-pass statistics over all but the channel
    axis, then (c - m) * rsqrt(v + 1e-5) in c's type."""
    xf = c.float()
    dims = tuple(range(c.ndim - 1))
    m = xf.mean(dims)
    v = (xf * xf).mean(dims) - m * m
    inv = torch.rsqrt(v + 1e-5)
    return ((xf - m) * inv).to(c.dtype)


def probe(device, n: int = 16384, bn_shape=(2048, 16, 8, 2048),
          iters: int = 8) -> dict:
    """Time the three steps; returns {name: (ms, GB/s)}."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    results = {}

    def report(name, fn, nbytes, note):
        ms = median_ms(fn, iters, device=device)
        results[name] = (ms, nbytes / ms / 1e6)
        print(f"{name}: {ms:.4f} ms/iter -> {results[name][1]:.0f} GB/s "
              f"({note})", flush=True)

    x = torch.randn((n, n), generator=gen, device=device)
    y = torch.randn((n, n), generator=gen, device=device)
    out = torch.empty_like(x)
    report(f"add2 f32 {x.numel() * 4 >> 20} MB",
           lambda: torch.add(x, y, out=out), 3 * x.numel() * 4, "2R+1W")
    xb, yb = x.to(torch.bfloat16), y.to(torch.bfloat16)
    del x, y, out
    out = torch.empty_like(xb)
    report(f"add2 bf16 {xb.numel() * 2 >> 20} MB",
           lambda: torch.add(xb, yb, out=out), 3 * xb.numel() * 2, "2R+1W")
    del xb, yb, out

    z = torch.randn(bn_shape, generator=gen, device=device,
                    dtype=torch.bfloat16)
    report(f"bn stats+normalize bf16 {z.numel() * 2 >> 20} MB map",
           lambda: bn_normalize(z), 3 * z.numel() * 2,
           "apparent, 2R+1W min")
    return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    _, device = parse_tool_args(parser, argv)
    return probe(device)


if __name__ == "__main__":
    main()
