"""Console tee logger and rank-result logger.

Counterpart of ``ieee_tpu/utils/loggers.py``; reference analog:
``torchreid/utils/loggers.py:8-146``.
"""

from __future__ import annotations

import os.path as osp
import sys

from .tools import mkdir_if_missing

__all__ = ["Logger", "RankLogger"]


class Logger:
    """Tee stdout to a log file (fsync'd so the file is the artifact of record)."""

    def __init__(self, fpath: str | None = None):
        self.console = sys.stdout
        self.file = None
        if fpath is not None:
            mkdir_if_missing(osp.dirname(fpath))
            self.file = open(fpath, "w")

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def write(self, msg):
        self.console.write(msg)
        if self.file is not None:
            self.file.write(msg)

    def flush(self):
        self.console.flush()
        if self.file is not None:
            self.file.flush()
            try:
                import os

                os.fsync(self.file.fileno())
            except OSError:
                pass

    def close(self):
        if self.file is not None:
            self.console.flush()
            self.file.close()
            self.file = None

    # Logger is installed AS sys.stdout (ieee_tpu_torch/main_multimodal.py), so it
    # must answer the TextIO probes libraries make on the stream (progress
    # bars/isatty, subprocess/fileno, encoding checks) — delegate to the
    # real console.
    def isatty(self):
        try:
            return self.console.isatty()
        except Exception:
            return False

    def fileno(self):
        return self.console.fileno()

    @property
    def encoding(self):
        return getattr(self.console, "encoding", "utf-8")

    @property
    def errors(self):
        return getattr(self.console, "errors", "strict")

    def writable(self):
        return True

    def readable(self):
        return False


class RankLogger:
    """Records rank-1 at each eval epoch per dataset and prints a summary."""

    def __init__(self, sources, targets):
        self.sources = [sources] if isinstance(sources, str) else list(sources)
        self.targets = [targets] if isinstance(targets, str) else list(targets)
        self.logger = {
            name: {"epoch": [], "rank1": []} for name in self.targets
        }

    def write(self, name, epoch, rank1):
        self.logger[name]["epoch"].append(epoch)
        self.logger[name]["rank1"].append(rank1)

    def show_summary(self):
        print("=> Show performance summary")
        for name, d in self.logger.items():
            from_where = "source" if name in self.sources else "target"
            print(f"{name} ({from_where})")
            for epoch, rank1 in zip(d["epoch"], d["rank1"]):
                print(f"- epoch {epoch}\t rank1 {rank1:.1%}")
