"""The card's real HBM bandwidth ceiling across access patterns: dtype,
a reduction, a two-input add, and the hand-written streaming scale
kernel at its two tile heights.

Counterpart of ``tools/bw_probe.py``. Each pattern is one call of eager
PyTorch ops (or of the kernel), timed as the median of single calls
(CUDA events), and printed with the JAX tool's read/write accounting:

- reduce-1pass: the JAX scan body, the carry plus 1e-6 and the f32 sum of
  the carry (2 bytes moved per element byte: R+W carry; eager PyTorch runs
  it as two passes, the add and the sum);
- add2: x + y (2R+1W);
- the kernel ``scale_bf16`` (``ops/kernels/probes.py``, the port of
  ``pallas_scale`` and ``pallas_scale_b``) at 512- and 2048-row tiles
  (1R+1W), beside ``torch.mul`` by the same factor and ``clone`` (the copy
  ceiling).

Usage: python -m ieee_tpu_torch.tools.bw_probe [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from ..ops.kernels.probes import TILE_ROWS, scale_bf16, scale_factor
from ._timing import median_ms, parse_tool_args

__all__ = ["probe", "main"]


def _gbps(nbytes: float, ms: float) -> float:
    return nbytes / ms / 1e6


def probe(device, m: int = 8192, iters: int = 20) -> dict:
    """Time every pattern on (m, m) arrays; returns {name: (ms, GB/s)}."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    results = {}

    def report(name, ms, nbytes, note):
        results[name] = (ms, _gbps(nbytes, ms))
        print(f"{name}: {ms:.4f} ms -> {results[name][1]:.0f} GB/s ({note})",
              flush=True)

    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        x = torch.randn((m, m), generator=gen, device=device, dtype=dtype)
        y = torch.randn((m, m), generator=gen, device=device, dtype=dtype)
        out = torch.empty_like(x)
        nbytes = x.numel() * x.element_size()

        def red():
            torch.add(x, 1e-6, out=out)
            return torch.sum(x, dtype=torch.float32)

        report(f"reduce-1pass {tag} ({nbytes >> 20} MB)",
               median_ms(red, iters, device=device), 2 * nbytes,
               "R+W carry")
        report(f"add2 {tag}",
               median_ms(lambda: torch.add(x, y, out=out), iters,
                         device=device), 3 * nbytes, "2R+1W")
        del x, y, out

    x = torch.randn((m, m), generator=gen, device=device,
                    dtype=torch.bfloat16)
    nbytes = x.numel() * 2
    for tile in TILE_ROWS:
        if not torch.equal(scale_bf16(x, tile), x):  # bf16(1.0001) == 1
            raise AssertionError(f"scale_bf16 ({tile}-row tiles) changed x")
        report(f"kernel scale bf16 ({tile}-row tiles)",
               median_ms(lambda: scale_bf16(x, tile), iters, device=device),
               2 * nbytes, "1R+1W")
    c = scale_factor()
    report("torch.mul bf16 (library)",
           median_ms(lambda: torch.mul(x, c), iters, device=device),
           2 * nbytes, "1R+1W")
    report("clone bf16 (copy ceiling)",
           median_ms(lambda: x.clone(), iters, device=device), 2 * nbytes,
           "1R+1W")
    return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    _, device = parse_tool_args(parser, argv)
    return probe(device)


if __name__ == "__main__":
    main()
