"""Time the distmat, scale_bf16, reduce3 and partpool kernels three ways at
the main paths' shapes, beside their library calls or plain versions.

``distmat`` (``ops/kernels/distmat.py``) runs at RGBNT201's 836 x 836 test
set, the engine eval's 170 x 340, the CLI eval's 16 x 32 and
Market-1501's 3368 x 15913, all at K = 2304, on non-negative random
features (a ReLU'd embedding) made on the device from a seed; its library
call is the f32 ``addmm`` of the product with the norms (TF32 off).
``scale_bf16`` (``ops/kernels/probes.py``) runs on the bandwidth probe's
(8192, 8192) bf16 array at both tile heights, beside ``torch.mul`` by the
same factor and ``clone``. ``reduce3`` (``ops/kernels/block_bwd.py``) runs
at the block path's three stages of a batch-128 train step at 256x128
(layer1-3: 6, 9 and 15 blocks per step over the three trunks), and its
per-step line weighs each stage by its blocks. ``partpool``
(``ops/kernels/partpool.py``) runs at the folded eval head's call (a batch
of 100, the 16x8x2048 map in f32, F 768, P 6) and with a bf16 map. Neither
has a library call: their plain versions are printed beside them. Each is
timed per call (the median of single
calls, CUDA events: the wrapper's host time included), queued (10 calls
back to back, per call: the host time hidden where the card is slower)
and on the device (``torch.profiler``: the sum of the call's device
kernels over 5 calls), and printed with its bound: the larger of the
bytes over 3.35 TB/s and the operations over the type's peak (distmat:
both the 3xTF32 bound, three TF32 products at 495 TFLOP/s, and the f32
one at 67 TFLOP/s; reduce3: its f32 operations, partpool: bf16).

It reaches the kernels only through the wrappers' public names, so a copy
of this file (with ``_timing.py``) placed in another checkout of the port
times that checkout's kernels when run from its root: that is how a change
is compared with its parent in one run on one card.

On the CPU (``--device cpu``) it times the plain versions with the host
clock (no device metric) at the sizes given.

Usage: python -m ieee_tpu_torch.tools.kernel_bench
    [--kernels distmat,scale_bf16,reduce3,partpool] [--iters 20]
    [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from ..ops.kernels.block_bwd import reduce3, reduce3_plain
from ..ops.kernels.distmat import euclidean_sq, euclidean_sq_plain
from ..ops.kernels.partpool import (fused_partpool_project,
                                    fused_partpool_project_plain)
from ..ops.kernels.probes import TILE_ROWS, scale_bf16, scale_factor
from ._timing import (bound_ms, kernel_ms, median_ms, parse_tool_args,
                      queued_ms, short_name)

__all__ = ["KERNELS", "DISTMAT_SHAPES", "REDUCE3_STAGES", "PARTPOOL_CALL",
           "bench", "main"]

KERNELS = ("distmat", "scale_bf16", "reduce3", "partpool")
#: (m, n, K) of the distmat calls on the main paths
DISTMAT_SHAPES = ((836, 836, 2304), (170, 340, 2304), (16, 32, 2304),
                  (3368, 15913, 2304))
#: (B, H, W, C, blocks per step over the three trunks) of reduce3 on the
#: block path, layer1-3 of a batch-128 step at 256x128
REDUCE3_STAGES = ((128, 64, 32, 256, 6), (128, 32, 16, 512, 9),
                  (128, 16, 8, 1024, 15))
#: (B, H, W, C, F, parts) of the folded eval head's partpool call
PARTPOOL_CALL = (100, 16, 8, 2048, 768, 6)


def _three(fn, device, iters: int):
    """(per call, queued per call, device per call or None) in ms, and
    the device ms per call by kernel (empty on the CPU)."""
    per_call = median_ms(fn, iters, device=device)
    queued = queued_ms(fn, device, iters)
    rows = kernel_ms(fn) if device.type == "cuda" else []
    dev = sum(t for _, t in rows) if rows else None
    return (per_call, queued, dev), rows


def _fmt(name, t) -> str:
    dev = "not measured" if t[2] is None else f"{t[2]:.4f}"
    return (f"{name} {t[0]:.4f} per call, {t[1]:.4f} queued, {dev} "
            "device")


def _by_kernel(rows) -> str:
    return ", ".join(f"{short_name(key)} {t:.4f}" for key, t in rows)


def bench(device, kernels=KERNELS, iters: int = 20,
          distmat_shapes=DISTMAT_SHAPES, scale_rows: int = 8192,
          reduce3_stages=REDUCE3_STAGES,
          partpool_call=PARTPOOL_CALL) -> dict:
    """Time ``kernels``; returns {(kernel, shape): (per call, queued,
    device) ms} (reduce3 also per step) and prints a line per shape."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    out = {}
    if "distmat" in kernels:
        for m, n, k in distmat_shapes:
            q = torch.randn((m, k), generator=gen, device=device).relu()
            g = torch.randn((n, k), generator=gen, device=device).relu()
            t, rows = _three(lambda: euclidean_sq(q, g), device, iters)
            lib, _ = _three(lambda: torch.addmm(
                (q * q).sum(1)[:, None] + (g * g).sum(1)[None, :], q, g.t(),
                alpha=-2.0), device, iters)
            plain = median_ms(lambda: euclidean_sq_plain(q, g), iters,
                              device=device)
            nbytes = 4.0 * (m * k + n * k + m * n)
            tf32 = bound_ms(6.0 * m * n * k, nbytes, "tf32")
            f32 = bound_ms(2.0 * m * n * k, nbytes, "f32")
            out[("distmat", (m, n, k))] = t
            print(f"distmat {m}x{n}x{k}: {_fmt('kernel', t)}; "
                  f"{_fmt('addmm', lib)}; plain {plain:.4f} per call; "
                  f"bound {tf32[0]:.4f} (3xTF32, {tf32[1]}), {f32[0]:.4f} "
                  f"(f32, {f32[1]})", flush=True)
            if rows:
                print(f"  distmat {m}x{n}x{k} device by kernel: "
                      f"{_by_kernel(rows)}", flush=True)
            del q, g
    if "scale_bf16" in kernels:
        x = torch.randn((scale_rows, scale_rows), generator=gen,
                        device=device).to(torch.bfloat16)
        c = scale_factor()
        bound = bound_ms(1.0 * x.numel(), 4.0 * x.numel(), "bf16")
        for tile in TILE_ROWS:
            t, rows = _three(lambda: scale_bf16(x, tile), device, iters)
            out[("scale_bf16", tile)] = t
            print(f"scale_bf16 {scale_rows}^2, {tile}-row tiles: "
                  f"{_fmt('kernel', t)}; bound {bound[0]:.4f} ({bound[1]})",
                  flush=True)
        for name, fn in (("torch.mul", lambda: torch.mul(x, c)),
                         ("clone", lambda: x.clone())):
            t, _ = _three(fn, device, iters)
            out[(name, scale_rows)] = t
            print(f"{name} {scale_rows}^2: {_fmt('call', t)}", flush=True)
    if "reduce3" in kernels:
        out.update(_bench_reduce3(device, gen, iters, reduce3_stages))
    if "partpool" in kernels:
        out.update(_bench_partpool(device, gen, iters, partpool_call))
    return out


def _bench_reduce3(device, gen, iters, stages) -> dict:
    """reduce3 at each stage and per step (the stages weighed by their
    blocks)."""
    out = {}
    step = [0.0, 0.0, 0.0]
    plain_step = bound_step = 0.0
    for b, h, w, c, blocks in stages:
        dy, y, a3 = (torch.randn((b, h, w, c), generator=gen, device=device
                                 ).to(torch.bfloat16) for _ in range(3))
        mean = 0.1 * torch.randn(c, generator=gen, device=device)
        rstd = torch.randn(c, generator=gen, device=device).abs() + 0.5
        t, rows = _three(lambda: reduce3(dy, y, a3, mean, rstd), device,
                         iters)
        plain = median_ms(lambda: reduce3_plain(dy, y, a3, mean, rstd),
                          iters, device=device)
        n = b * h * w
        bound = bound_ms(7.0 * n * c, 8.0 * n * c + 16.0 * c, "f32")
        out[("reduce3", (b, h, w, c))] = t
        for i in range(3):
            step[i] = None if t[i] is None or step[i] is None \
                else step[i] + blocks * t[i]
        plain_step += blocks * plain
        bound_step += blocks * bound[0]
        print(f"reduce3 {b}x{h}x{w}x{c} x{blocks}: {_fmt('kernel', t)}; "
              f"plain {plain:.4f} per call; bound {bound[0]:.4f} "
              f"({bound[1]})", flush=True)
        if rows:
            print(f"  reduce3 {b}x{h}x{w}x{c} device by kernel: "
                  f"{_by_kernel(rows)}", flush=True)
        del dy, y, a3
    out[("reduce3", "step")] = tuple(step)
    print(f"reduce3 per step ({sum(s[-1] for s in stages)} blocks): "
          f"{_fmt('kernel', step)}; plain {plain_step:.4f}; bound "
          f"{bound_step:.4f} (bytes)", flush=True)
    return out


def _bench_partpool(device, gen, iters, call) -> dict:
    """partpool at the eval head's call, with an f32 and a bf16 map."""
    out = {}
    b, h, w, c, f, parts = call
    wt = torch.randn((c, f), generator=gen, device=device) * c ** -0.5
    s = torch.randn(f, generator=gen, device=device).abs() + 0.5
    t = torch.randn(f, generator=gen, device=device)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((b, h, w, c), generator=gen, device=device
                        ).relu().to(dtype)
        times, rows = _three(
            lambda: fused_partpool_project(x, wt, s, t, parts), device,
            iters)
        plain = median_ms(
            lambda: fused_partpool_project_plain(x, wt, s, t, parts), iters,
            device=device)
        r = parts + 1
        bound = bound_ms(2.0 * b * r * c * (h * w + f),
                         x.element_size() * x.numel()
                         + 4.0 * (c * f + 2 * f + b * r * f), "bf16")
        name = str(dtype).split(".")[-1]
        out[("partpool", name)] = times
        print(f"partpool B {b} {h}x{w}x{c} -> {f}, P {parts}, {name} map: "
              f"{_fmt('kernel', times)}; plain {plain:.4f} per call; bound "
              f"{bound[0]:.4f} ({bound[1]})", flush=True)
        if rows:
            print(f"  partpool {name} device by kernel: {_by_kernel(rows)}",
                  flush=True)
        del x
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", default=",".join(KERNELS),
                        help="comma-separated subset of " + ",".join(KERNELS))
    parser.add_argument("--iters", type=int, default=20)
    args, device = parse_tool_args(parser, argv)
    kernels = tuple(args.kernels.split(","))
    if not set(kernels) <= set(KERNELS):
        parser.error(f"--kernels: unknown {set(kernels) - set(KERNELS)}")
    return bench(device, kernels, args.iters)


if __name__ == "__main__":
    main()
