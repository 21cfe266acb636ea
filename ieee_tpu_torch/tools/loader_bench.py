"""Host decode-throughput benchmark: the train loader's batches/s at each
worker count, against a train-step rate (the input pipeline must not
starve the card: decode throughput >= step rate).

Counterpart of ``tools/loader_bench.py``: the port's ``ImageDataManager``
train loader (P x K sampler, a thread pool of ``workers`` decoders), each
batch's images copied to ``--device`` as the train loop does, host clock
over ``--batches`` - 1 batches after the first. Without ``--root`` it
reads ``synthetic_mm`` (array generation stands in for jpeg decode). The
JAX tool's decode-cache rows (``data.decode_cache``) are not ported yet
(ROADMAP A.4); the tool prints a line for each instead of a rate. With
``--step-rate`` it exits 1 when the best rate is below it.

Usage: python -m ieee_tpu_torch.tools.loader_bench [--root DIR
    --sources rgbnt201] [--batch 128] [--step-rate R] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ._timing import parse_tool_args

__all__ = ["CONFIGS", "run", "main"]

#: (workers, decode cache) rows, the JAX tool's
CONFIGS = ((0, False), (1, False), (2, False), (4, False), (0, True),
           (2, True))


def run(root: str = "", sources: str = "synthetic_mm", batch: int = 128,
        height: int = 256, width: int = 128, batches: int = 10,
        device="cuda", configs=CONFIGS, num_pids: int = 171) -> dict:
    """Batches/s of each (workers, cache) row that the port runs."""
    from ..data import ImageDataManager

    device = torch.device(device)
    results = {}
    for workers, cache in configs:
        tag = f"workers={workers}" + (" +cache" if cache else "")
        if cache:
            print(f"{tag}: not ported yet (data.decode_cache, ROADMAP A.4)")
            continue
        dm = ImageDataManager(
            root=root, sources=sources, height=height, width=width,
            batch_size_train=batch, batch_size_test=batch, workers=workers,
            train_sampler="RandomIdentitySampler", num_instances=4,
            num_pids=num_pids, imgs_per_pid=8, verbose=False, seed=0)
        it = iter(dm.train_loader)
        next(it)  # warm (thread pool spin-up)
        t0 = time.perf_counter()
        n = 0
        for _ in range(batches - 1):
            b = next(it, None)
            if b is None:
                break
            for m in b["img"]:
                torch.from_numpy(np.ascontiguousarray(m)).to(device)
            n += 1
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        rate = n / dt if dt > 0 else float("inf")
        results[tag] = rate
        print(f"{tag}: {rate:.2f} batches/s "
              f"({rate * batch:.0f} imgs-or-triplets/s)", flush=True)
    return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default="")
    parser.add_argument("--sources", default="synthetic_mm")
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--width", type=int, default=128)
    parser.add_argument("--batches", type=int, default=10)
    parser.add_argument("--step-rate", type=float, default=None,
                        help="train steps/sec to compare against")
    args, device = parse_tool_args(parser, argv)
    results = run(args.root, args.sources, args.batch, args.height,
                  args.width, args.batches, device)
    if args.step_rate is not None:
        best = max(results.values())
        ok = best >= args.step_rate
        print(f"decode {best:.2f} batches/s vs step rate "
              f"{args.step_rate:.2f}/s -> {'OK' if ok else 'STARVED'}")
        if not ok:
            raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
