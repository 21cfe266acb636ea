"""Time the fused 1x1 conv + BN matmul kernels at the main path's sites.

``mm_stats``, ``mm_bn_da`` and ``mm_bn_dw`` (``ops/kernels/matmul_bn.py``)
run at the 33 fused sites of a batch-128 train step at 256x128 and
``mm_affine`` at the 21 layer4 sites of an eval batch of 100 (7 per
trunk), on random bf16 operands made on the device from a seed. Per call:
the median of ``--iters`` timings of 10 calls queued back to back (CUDA
events), then each device kernel's ms per call from ``torch.profiler``
over 5 calls; then the per-step (train) and per-batch and per-trunk
(eval) totals. The sites are ``matmul_bn``'s ``TRAIN_SITES`` and
``EVAL_SITES``.

On the CPU (``--device cpu``) it times the plain versions with the host
clock (no device metric).

Usage: python -m ieee_tpu_torch.tools.mm_bench [--kernels mm_stats,...]
    [--iters 15] [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from ..ops.kernels import matmul_bn as mb
from ._timing import parse_tool_args
from .block_bench import _kernel_ms, _queued_ms, _short

__all__ = ["KERNELS", "bench", "main"]

KERNELS = ("mm_stats", "mm_affine", "mm_bn_da", "mm_bn_dw")


def bench(device, kernels=KERNELS, iters: int = 15,
          train_sites=mb.TRAIN_SITES, eval_sites=mb.EVAL_SITES) -> dict:
    """Time ``kernels`` at their sites; returns {kernel: ms per step (train)
    or per eval batch (mm_affine)}, queued calls x sites, and prints the
    per-call lines."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    totals = {}
    for name in kernels:
        sites = eval_sites if name == "mm_affine" else train_sites
        totals[name] = 0.0
        for n, k, c, relu, count in sites:
            a = rnd(n, k).to(torch.bfloat16)
            w = rnd(k, c) * k ** -0.5
            w16 = w.to(torch.bfloat16)
            inv, shift = rnd(c).abs() + 0.5, rnd(c)
            d, y = (rnd(n, c).to(torch.bfloat16) for _ in range(2))
            vecs = torch.stack([inv, shift, 0.1 * rnd(c), rnd(c).abs() + 0.5,
                                0.1 * rnd(c), 0.1 * rnd(c)])
            fn = {"mm_stats": lambda: mb.mm_stats(a, w16),
                  "mm_affine": lambda: mb.mm_affine_act(a, w16, inv, shift,
                                                        relu),
                  "mm_bn_da": lambda: mb.mm_bn_da(d, y, vecs, w16, relu),
                  "mm_bn_dw": lambda: mb.mm_bn_dw(a, d, y, vecs, relu),
                  }[name]
            ms = _queued_ms(fn, device, iters)
            totals[name] += count * ms
            line = (f"N {n} K {k} C {c} x{count}: {name} {ms:.4f} ms per "
                    f"call queued")
            if device.type == "cuda":
                line += "; " + ", ".join(
                    f"{_short(key)} {t:.4f}" for key, t in _kernel_ms(fn)[:2])
            print(line, flush=True)
    for name, t in totals.items():
        if name == "mm_affine":
            print(f"mm_affine per eval batch of 100 (21 sites), queued: "
                  f"{t:.4f} ms; per trunk (7 sites): {t / 3:.4f} ms",
                  flush=True)
        else:
            print(f"{name} per train step (33 sites), queued: {t:.4f} ms",
                  flush=True)
    return totals


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", default=",".join(KERNELS),
                        help="comma-separated subset of " + ",".join(KERNELS))
    parser.add_argument("--iters", type=int, default=15)
    args, device = parse_tool_args(parser, argv)
    kernels = tuple(args.kernels.split(","))
    if not set(kernels) <= set(KERNELS):
        parser.error(f"--kernels: unknown {set(kernels) - set(KERNELS)}")
    return bench(device, kernels, args.iters)


if __name__ == "__main__":
    main()
