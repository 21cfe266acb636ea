"""Standalone GNN re-ranking over pickled features.

Counterpart of ``tools/gnn_rerank_cli.py`` (reference analog
``torchreid/utils/GPU-Re-Ranking/main.py:52-68``): loads a pickle of query
and gallery features with their ids, L2-normalizes the features, runs GNN
re-ranking on the device (``ops/gnn_rerank.py``, its propagation on the
``gnn_propagate`` kernel on a card) and scores the re-ranked order (the
distance of a gallery item is its position) with the device CMC/mAP.

Usage:
    python -m ieee_tpu_torch.tools.gnn_rerank_cli --data features.pkl
        [--k1 26 --k2 7] [--device cuda]

The pickle holds a dict with the keys 'query_f' (Nq, D), 'gallery_f'
(Ng, D), 'query_pid', 'gallery_pid', 'query_cam', 'gallery_cam'. Loading
a pickle runs code: pass only files you wrote.
"""

from __future__ import annotations

import argparse
import pickle
import time

import numpy as np
import torch

from ..ops.gnn_rerank import gnn_reranking
from ..ops.ranking import evaluate_rank
from ._timing import parse_tool_args

__all__ = ["main"]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data", type=str, required=True,
                        help="path to pickled features")
    parser.add_argument("--k1", type=int, default=26)
    parser.add_argument("--k2", type=int, default=7)
    args, device = parse_tool_args(parser, argv)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False

    with open(args.data, "rb") as f:
        data = pickle.load(f)
    qf = torch.as_tensor(np.asarray(data["query_f"], np.float32),
                         device=device)
    gf = torch.as_tensor(np.asarray(data["gallery_f"], np.float32),
                         device=device)
    qf = qf / qf.norm(dim=1, keepdim=True).clamp_min(1e-12)
    gf = gf / gf.norm(dim=1, keepdim=True).clamp_min(1e-12)

    t0 = time.perf_counter()
    L = gnn_reranking(qf, gf, k1=args.k1, k2=args.k2)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"GNN re-ranking: {dt * 1000:.1f} ms for "
          f"{qf.shape[0]}x{gf.shape[0]}")

    # score the re-ranked order: distance = rank position
    positions = torch.arange(L.shape[1], dtype=torch.float32, device=device)
    distmat = torch.empty(L.shape, dtype=torch.float32, device=device)
    distmat.scatter_(1, L, positions.expand(L.shape))
    cmc, mAP = evaluate_rank(distmat, data["query_pid"], data["gallery_pid"],
                             data["query_cam"], data["gallery_cam"],
                             max_rank=20)
    print(f"mAP: {mAP:.1%}  Rank-1: {cmc[0]:.1%}  Rank-5: {cmc[4]:.1%}")
    return {"ms": dt * 1e3, "mAP": mAP, "cmc": cmc, "ranking": L}


if __name__ == "__main__":
    main()
