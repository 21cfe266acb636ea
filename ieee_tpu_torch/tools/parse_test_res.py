"""Parse and average test results across split log files.

Counterpart of ``tools/parse_test_res.py`` (reference analog:
``tools/parse_test_res.py:31-103``): regex-parses the ``test.log*`` files
that the CLI writes under ``data.save_dir`` (per-split directories, found
recursively) and averages their mAP and CMC ranks. Host only.

Usage:
    python -m ieee_tpu_torch.tools.parse_test_res <directory> [--suffix test.log]
"""

from __future__ import annotations

import argparse
import glob
import os.path as osp
import re
from collections import defaultdict

import numpy as np

__all__ = ["parse_file", "main"]


def parse_file(filepath: str, regex_mAP, regex_r: dict):
    results = {}
    with open(filepath, "r") as f:
        for line in f:
            m = regex_mAP.search(line)
            if m:
                results["mAP"] = float(m.group(1))
            for name, regex in regex_r.items():
                m = regex.search(line)
                if m:
                    results[name] = float(m.group(1))
    return results


def main(argv=None) -> dict:
    """-> {metric: mean percentage over the logs found} (empty if none)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("directory", type=str, help="path to directory")
    parser.add_argument("--suffix", type=str, default="test.log",
                        help="log file name suffix")
    args = parser.parse_args(argv)

    regex_mAP = re.compile(r"mAP: ([\.\deE+-]+)%")
    ranks = [1, 5, 10, 20]
    regex_r = {
        f"r{r}": re.compile(rf"Rank-{r}\s*: ([\.\deE+-]+)%") for r in ranks
    }

    logs = sorted(glob.glob(osp.join(args.directory, "**", args.suffix + "*"),
                            recursive=True))
    if not logs:
        print(f"No {args.suffix}* files under {args.directory}")
        return {}

    metrics = defaultdict(list)
    for log in logs:
        res = parse_file(log, regex_mAP, regex_r)
        print(f"{log}: {res}")
        for k, v in res.items():
            metrics[k].append(v)

    print("\nAverage performance")
    averages = {}
    for k, vals in metrics.items():
        averages[k] = float(np.mean(vals))
        print(f"{k}: {averages[k]:.1f}% (over {len(vals)} splits)")
    return averages


if __name__ == "__main__":
    main()
