"""Eval-pipeline benchmark: the query x gallery distmat and CMC/mAP, wall
clock, at Market-1501 scale with the IEEE 2304-d feature by default.

Counterpart of ``tools/eval_bench.py``: the port's
``compute_distance_matrix`` (the distmat kernel on a card) and its device
ranking (``ops/ranking.py:_device_rank``), timed together on the host
clock around calls that end in a pull of mAP and the CMC (after one
warm-up call), then the numpy oracle ``eval_market1501_numpy`` on the
first ``min(num_q, 500)`` queries, whose CMC and mAP the device ranking
must match (it raises otherwise), and the speedup over the oracle's
estimated full-scale time.

Usage: python -m ieee_tpu_torch.tools.eval_bench [--num-q 3368
    --num-g 15913 --dim 2304] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ops.distance import compute_distance_matrix
from ..ops.ranking import _device_rank, eval_market1501_numpy
from ._timing import parse_tool_args

__all__ = ["run", "main"]


def run(num_q: int = 3368, num_g: int = 15913, dim: int = 2304,
        device="cuda", n: int = 5, oracle_q: int = 500) -> dict:
    device = torch.device(device)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(0)
    qf = torch.randn((num_q, dim), generator=gen, device=device)
    gf = torch.randn((num_g, dim), generator=gen, device=device)
    ids = {k: torch.as_tensor(rng.integers(0, hi, size), device=device)
           for k, hi, size in (("q_pids", 750, num_q), ("g_pids", 750, num_g),
                               ("q_cams", 6, num_q), ("g_cams", 6, num_g))}

    def run_once(q):
        distmat = compute_distance_matrix(qf[:q], gf, "euclidean")
        cmc, m_ap, _ = _device_rank(distmat, ids["q_pids"][:q],
                                    ids["g_pids"], ids["q_cams"][:q],
                                    ids["g_cams"], 50)
        return float(m_ap), cmc.cpu().numpy()

    m_ap, cmc = run_once(num_q)  # warm-up
    t0 = time.perf_counter()
    for _ in range(n):
        m_ap, cmc = run_once(num_q)
    dt = (time.perf_counter() - t0) / n
    print(f"device distmat+CMC/mAP ({num_q}x{num_g}, {dim}-d): "
          f"{dt * 1e3:.1f} ms   mAP={m_ap:.4f} R1={cmc[0]:.4f}", flush=True)

    # the numpy oracle at reduced scale (its per-query loop takes minutes
    # at Market scale), against the device ranking of the same queries
    small = min(num_q, oracle_q)
    dm_small = compute_distance_matrix(qf[:small], gf, "euclidean")
    host = {k: v.cpu().numpy() for k, v in ids.items()}
    t0 = time.perf_counter()
    cmc_np, map_np = eval_market1501_numpy(
        dm_small.cpu().numpy(), host["q_pids"][:small], host["g_pids"],
        host["q_cams"][:small], host["g_cams"], 50)
    t_np = time.perf_counter() - t0
    map_dev, cmc_dev = run_once(small)
    cmc_err = float(np.max(np.abs(cmc_dev - cmc_np)))
    map_err = abs(map_dev - map_np)
    print(f"device vs numpy oracle ({small} queries): CMC max diff "
          f"{cmc_err:.2e}, mAP diff {map_err:.2e}")
    if cmc_err > 1e-6 or map_err > 1e-6:
        raise AssertionError("device ranking disagrees with the numpy oracle")
    est_full = t_np * num_q / small
    print(f"numpy oracle (rank only, {small} queries): {t_np * 1e3:.1f} ms "
          f"-> estimated full-scale {est_full:.1f} s")
    print(f"device speedup vs numpy ranking: ~{est_full / dt:.0f}x")
    return {"ms": dt * 1e3, "mAP": m_ap, "rank1": float(cmc[0]),
            "oracle_s": t_np, "cmc_err": cmc_err, "map_err": map_err}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--num-q", type=int, default=3368)
    parser.add_argument("--num-g", type=int, default=15913)
    parser.add_argument("--dim", type=int, default=2304)
    args, device = parse_tool_args(parser, argv)
    return run(args.num_q, args.num_g, args.dim, device)


if __name__ == "__main__":
    main()
