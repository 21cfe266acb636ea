"""ctypes bindings for the native C++ ranking oracle (counterpart of
``ieee_tpu/native/ranking``; the reference's Cython ``rank_cylib``).

``rank.cpp`` is built at first use with ``g++ -O3 -march=native -shared
-fPIC`` into ``ieee_tpu_torch/_kernels/rank-<hash>/librank.so``, keyed by a
hash of the source, the flags and the host CPU (``-march=native`` code runs
only where it was built), so an edited source or another CPU builds anew and
an unchanged one loads the library already built. Processes that build at
once (pytest workers) each compile to a file of their own and rename it into
place, so none loads a half-written library. A failed build raises
``OSError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

__all__ = ["eval_market1501_native", "load_library", "build_seconds"]

_SRC = Path(__file__).resolve().parent / "rank.cpp"
BUILD_ROOT = _SRC.parents[2] / "_kernels"
CXXFLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_state: dict = {"lib": None, "seconds": None}


def _host_cpu() -> str:
    """The CPU that ``-march=native`` targets: its model and flags."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f
                     if ln.startswith(("model name", "flags", "Features"))]
    except OSError:
        lines = []
    return platform.machine() + "".join(sorted(set(lines)))


def _library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    h.update(_host_cpu().encode())
    return BUILD_ROOT / f"rank-{h.hexdigest()[:16]}" / "librank.so"


def _build(lib: Path) -> None:
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".librank-", suffix=".so",
                               dir=lib.parent)
    os.close(fd)
    try:
        try:
            out = subprocess.run(["g++", *CXXFLAGS, "-o", tmp, str(_SRC)],
                                 capture_output=True, text=True)
        except FileNotFoundError as e:
            raise OSError(f"g++ not found: {e}") from e
        if out.returncode != 0:
            raise OSError(f"g++ failed on {_SRC}:\n{out.stderr}")
        os.replace(tmp, lib)  # atomic: a reader sees the whole file or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the ranker; raises ``OSError`` if it
    cannot."""
    with _lock:
        if _state["lib"] is not None:
            return _state["lib"]
        path = _library_path()
        if not path.is_file():
            t0 = time.perf_counter()
            _build(path)
            _state["seconds"] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        lib.eval_market1501.restype = ctypes.c_int
        lib.eval_market1501.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        _state["lib"] = lib
        return lib


def build_seconds():
    """Seconds this process spent building the library, or None if it
    loaded one already built (or has not loaded it yet)."""
    return _state["seconds"]


def eval_market1501_native(distmat, q_pids, g_pids, q_camids, g_camids,
                           max_rank):
    """C++ CMC/mAP on host arrays. Same semantics as
    ``ops.ranking.eval_market1501_numpy``."""
    lib = load_library()
    distmat = np.ascontiguousarray(distmat, np.float32)
    num_q, num_g = distmat.shape
    max_rank = min(int(max_rank), num_g)
    q_pids = np.ascontiguousarray(q_pids, np.int64)
    g_pids = np.ascontiguousarray(g_pids, np.int64)
    q_camids = np.ascontiguousarray(q_camids, np.int64)
    g_camids = np.ascontiguousarray(g_camids, np.int64)
    if q_pids.shape != (num_q,) or q_camids.shape != (num_q,) or (
            g_pids.shape != (num_g,) or g_camids.shape != (num_g,)):
        raise ValueError(f"ids do not match the {num_q} x {num_g} distmat")
    cmc = np.zeros(max_rank, np.float32)
    mAP = np.zeros(1, np.float32)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    valid = lib.eval_market1501(
        p(distmat, ctypes.c_float), p(q_pids, ctypes.c_int64),
        p(g_pids, ctypes.c_int64), p(q_camids, ctypes.c_int64),
        p(g_camids, ctypes.c_int64), num_q, num_g, max_rank,
        p(cmc, ctypes.c_float), p(mAP, ctypes.c_float),
    )
    if valid <= 0:
        raise ValueError("all query identities do not appear in gallery")
    return cmc, float(mAP[0])
