"""Console tee logger.

Counterpart of ``ieee_tpu/utils/loggers.py``; reference analog:
``torchreid/utils/loggers.py:8-146``.
"""

from __future__ import annotations

import os.path as osp
import sys

from .tools import mkdir_if_missing

__all__ = ["Logger"]


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
