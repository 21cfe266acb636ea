"""Speed and agreement of the CMC/mAP implementations.

Counterpart of ``tools/rank_speed_test.py`` (reference analog:
``torchreid/metrics/rank_cylib/test_cython.py``). The contenders are the
numpy oracle, the native C++ ranker (ctypes; its first call builds it) and
the vectorised device path on ``--device``: the distmat and the ids are put
there first, so on a card "device" times the card, not the CPU. Each
contender makes ``--repeat`` timed calls on the host clock, the last one's
result compared; the device path makes one warm-up call before them (the
host contenders have nothing to warm: the ranker is built and loaded
first), and on a card the clock is read after a synchronise. The
contenders must agree within 1e-4, as the JAX tool's check.

Usage: python -m ieee_tpu_torch.tools.rank_speed_test [--num-q 500
    --num-g 5000 --max-rank 50 --repeat 3] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..native import ranking as native
from ..ops.ranking import eval_market1501_device, eval_market1501_numpy
from ._timing import parse_tool_args

__all__ = ["run", "main"]


def run(num_q: int = 500, num_g: int = 5000, max_rank: int = 50,
        repeat: int = 3, device="cuda") -> dict:
    """-> {contender: (seconds a call, cmc, mAP)}, plus "native build s":
    the seconds this process spent building the native ranker (None if it
    loaded one built before)."""
    device = torch.device(device)
    rng = np.random.default_rng(0)
    distmat = rng.random((num_q, num_g)).astype(np.float32)
    q_pids = rng.integers(0, 100, num_q)
    g_pids = rng.integers(0, 100, num_g)
    q_camids = rng.integers(0, 5, num_q)
    g_camids = rng.integers(0, 5, num_g)
    prob = (distmat, q_pids, g_pids, q_camids, g_camids)
    on_device = tuple(torch.as_tensor(a).to(device) for a in prob)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    print(f"problem: {num_q} x {num_g}, max_rank {max_rank}\n")
    t0 = time.perf_counter()
    native.load_library()
    build = native.build_seconds()
    print(f"native C++ library: loaded in {time.perf_counter() - t0:.3f} s; "
          + ("built before, not in this process" if build is None
             else f"built in this process in {build:.3f} s"))

    results = {}
    for name, fn, args, warmup in (
            ("numpy", eval_market1501_numpy, prob, False),
            ("native C++", native.eval_market1501_native, prob, False),
            (f"device ({device.type})", eval_market1501_device, on_device,
             True)):
        if warmup:
            fn(*args, max_rank)
        sync()
        t0 = time.perf_counter()
        for _ in range(repeat):
            cmc, mAP = fn(*args, max_rank)
        sync()
        t = (time.perf_counter() - t0) / repeat
        results[name] = (t, cmc, mAP)
        print(f"{name:>12}: {t * 1000:8.1f} ms   mAP {mAP:.4f}  "
              f"R1 {cmc[0]:.4f}")

    base = results["numpy"][0]
    print()
    for name, (t, _, _) in results.items():
        print(f"{name:>12}: {base / t:6.1f}x vs numpy")

    # consistency
    ref = results["numpy"]
    for name, (_, cmc, mAP) in results.items():
        np.testing.assert_allclose(cmc, ref[1], atol=1e-4, err_msg=name)
        if not abs(mAP - ref[2]) < 1e-4:
            raise AssertionError(f"{name}: mAP {mAP} against {ref[2]}")
    print("\nall implementations agree")
    results["native build s"] = build
    return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--num-q", type=int, default=500)
    parser.add_argument("--num-g", type=int, default=5000)
    parser.add_argument("--max-rank", type=int, default=50)
    parser.add_argument("--repeat", type=int, default=3)
    args, device = parse_tool_args(parser, argv)
    return run(args.num_q, args.num_g, args.max_rank, args.repeat, device)


if __name__ == "__main__":
    main()
