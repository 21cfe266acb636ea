"""Re-ranking benchmarks at Market-1501 scale on the device.

Counterpart of ``tools/rerank_bench.py``. Times (a) the device k-reciprocal
re-rank (``ops/rerank_device.py``: the engine's path for ``test.rerank
True`` on a card, its min-sum on the ``jaccard_minsum`` kernel) with the
exact f32 min-sum and with ``minsum_bf16``, and (b) the GNN re-rank scores
(``ops/gnn_rerank.py``: two ``gnn_propagate`` launches a call) with the
A + A.T propagation and the transpose-tracking one. Each is timed on the
host clock around ``--reps`` calls after one warm-up call, ending in a
synchronise on a card, with the card's peak memory of one call. The
reference's CPU loop takes about 89 s at this scale
(``GPU-Re-Ranking/gnn_reranking.py:12-16``).

Usage: python -m ieee_tpu_torch.tools.rerank_bench [--num-q 3368
    --num-g 15913 --dim 512 --k1 20 --k2 6 --reps 3] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import torch

from ..ops.distance import compute_distance_matrix
from ..ops.gnn_rerank import _gnn_rerank_scores
from ..ops.rerank_device import re_ranking_device
from ._timing import parse_tool_args

__all__ = ["run", "main"]


def _timed(fn, device, reps):
    """(seconds a call, peak device bytes of the warm-up call or None)."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    fn()
    peak = None
    if cuda:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / reps, peak


def _peak(peak):
    return "" if peak is None else f", peak {peak / 2 ** 30:.2f} GiB"


def run(num_q: int = 3368, num_g: int = 15913, dim: int = 512,
        k1: int = 20, k2: int = 6, reps: int = 3, device="cuda") -> dict:
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    qf = torch.randn((num_q, dim), generator=gen, device=device)
    gf = torch.randn((num_g, dim), generator=gen, device=device)
    qg = compute_distance_matrix(qf, gf)
    qq = compute_distance_matrix(qf, qf)
    gg = compute_distance_matrix(gf, gf)
    out = {}
    for bf16 in (False, True):
        tag = "bf16 minsum" if bf16 else "f32 exact"
        dt, peak = _timed(lambda: re_ranking_device(
            qg, qq, gg, k1=k1, k2=k2, minsum_bf16=bf16), device, reps)
        out[tag] = dt
        print(f"k-reciprocal device [{tag}] ({num_q}x{num_g}, k1={k1} "
              f"k2={k2}): {dt:.3f} s/call{_peak(peak)} (reference CPU loop: "
              f"~89 s at this scale)", flush=True)
    del qg, qq, gg

    qn = qf / qf.norm(dim=1, keepdim=True)
    gn = gf / gf.norm(dim=1, keepdim=True)
    for track in (False, True):
        tag = "transpose-free" if track else "A+A.T"
        dt, peak = _timed(lambda: _gnn_rerank_scores(qn, gn, 26, 7, track),
                          device, reps)
        out[tag] = dt
        print(f"gnn re-rank scores device [{tag}] (k1=26 k2=7): "
              f"{dt * 1e3:.1f} ms/call{_peak(peak)}", flush=True)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--num-q", type=int, default=3368)
    parser.add_argument("--num-g", type=int, default=15913)
    parser.add_argument("--dim", type=int, default=512)
    parser.add_argument("--k1", type=int, default=20)
    parser.add_argument("--k2", type=int, default=6)
    parser.add_argument("--reps", type=int, default=3)
    args, device = parse_tool_args(parser, argv)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    return run(args.num_q, args.num_g, args.dim, args.k1, args.k2,
               args.reps, device)


if __name__ == "__main__":
    main()
