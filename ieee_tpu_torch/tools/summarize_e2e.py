"""Summarise the port's ``train_e2e`` artifacts into one table.

Counterpart of ``tools/summarize_e2e.py``; it reads JSON only. Each
artifact is written by ``python -m ieee_tpu_torch.tools.train_e2e``
(partial, ``complete: false``, when a run was cut: its trajectory up to
that point is still real). Prints the variant, the split, the depth, the
backend the run trained on, the last epoch's loss, the mAP and rank-1
trajectory's ends and completeness.

Usage: python -m ieee_tpu_torch.tools.summarize_e2e [glob ...]
    (default: log/**/E2E_*.json, where train_e2e writes; the E2E_*.json
    files at the repo's root are the JAX package's records)
"""

from __future__ import annotations

import glob
import json
import os.path as osp
import sys

__all__ = ["row", "main"]

DEFAULT_GLOB = osp.join("log", "**", "E2E_*.json")
COLUMNS = ["artifact", "variant", "split", "backbone", "backend", "epochs",
           "loss_last", "mAP_first", "mAP_last", "rank1_last", "complete"]


def row(path: str) -> dict:
    with open(path) as f:
        a = json.load(f)
    proto = a.get("protocol", {})
    losses = a.get("loss_per_epoch", {})
    evals = a.get("evals", [])
    last_ep = max((int(e) for e in losses), default=0)
    return {
        "artifact": path,
        "variant": proto.get("variant", "?"),
        # "held-out images of seen ids (closed-set)" must not shorten to
        # the open-set-looking "held-out"
        "split": ("seen-ids" if "seen ids" in proto.get("test_split", "")
                  else proto.get("test_split", "?").split(" ")[0]),
        "backbone": proto.get("backbone_layers", "?"),
        "backend": proto.get("backend", "?"),
        "epochs": f"{last_ep}/{proto.get('epochs', '?')}",
        "loss_last": (losses.get(str(last_ep)) or
                      losses.get(last_ep, {})).get("loss"),
        "mAP_first": evals[0]["mAP"] if evals else None,
        "mAP_last": evals[-1]["mAP"] if evals else None,
        "rank1_last": evals[-1]["rank1"] if evals else None,
        "complete": a.get("complete", True),
    }


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4f}"
    return str(v)


def main(argv=None) -> int:
    pats = (sys.argv[1:] if argv is None else list(argv)) or [DEFAULT_GLOB]
    paths = sorted(p for pat in pats for p in glob.glob(pat, recursive=True))
    if not paths:
        print("no artifacts found", file=sys.stderr)
        return 1
    rows = [row(p) for p in paths]
    widths = {c: max(len(c), *(len(_fmt(r[c])) for r in rows))
              for c in COLUMNS}
    print("  ".join(c.ljust(widths[c]) for c in COLUMNS))
    for r in rows:
        print("  ".join(_fmt(r[c]).ljust(widths[c]) for c in COLUMNS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
