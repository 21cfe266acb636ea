"""Build and load the port's hand-written CUDA kernels.

Every ``ieee_tpu_torch/csrc/*.cu`` source has a plain C interface (shared
device code lives in ``csrc/*.cuh`` headers). At first use, each source is
compiled by its own ``nvcc`` process (all started together) for ``sm_90a``,
the objects are linked into one shared library, and the library is loaded
with ``ctypes``. No PyTorch header is included, so a build takes seconds.
The library lands in ``ieee_tpu_torch/_kernels/<hash>/``, keyed by a hash of
the sources, headers and flags, so an edited source rebuilds and an
unchanged one loads the library already built.

Nothing here runs at import time: the CPU tests import every kernel module on
machines without ``nvcc``.
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch

__all__ = ["load_library", "build_seconds", "build_log", "kernel_resources",
           "wait_report", "check", "stream_ptr"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu; every function returns a cudaError_t as int
# (ieee_wait_report: 1 if it wrote a report, else 0)
_SIGNATURES = {
    "ieee_distmat_f32": [_P] * 6 + [_I] * 5 + [_P],
    "ieee_mm_affine_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "ieee_partpool": [_P, _I] + [_P] * 6 + [_I] * 6 + [_P],
    "ieee_mm_stats_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "ieee_mm_bn_da_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "ieee_mm_bn_dw_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "ieee_block_reduce3": [_P] * 9 + [_I] * 4 + [_P],
    "ieee_block_bn3_apply": [_P] * 11 + [_I] * 5 + [_P],
    "ieee_block_conv2_bwd": [_P] * 13 + [_I] * 6 + [_P],
    "ieee_block_bn1_apply": [_P] * 9 + [_I] * 5 + [_P],
    "ieee_scale_bf16": [_P, _P, _F, _I, _I, _I, _I, _P],
    "ieee_bn_mm_bf16": [_P, _P, _P, _P, _I, _I, _I, _P],
    "ieee_conv_s8": [_P, _I] + [_P] * 4 + [_I] * 11 + [_F, _I, _I, _I, _P],
    "ieee_jaccard_minsum": [_P, _P, _P] + [_I] * 6 + [_P],
    "ieee_gnn_propagate": [_P] * 4 + [_I] * 4 + [_P],
    "ieee_wait_report": [ctypes.c_char_p, _I],
}

_lock = threading.Lock()
_state: dict = {"lib": None, "seconds": None}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "ieee_tpu_torch cannot be built, and a CUDA tensor has no other path")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256()
    for f in sources:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    return h.hexdigest()[:16]


def _compile(out_dir: Path, sources) -> None:
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(prefix="build-", dir=out_dir.parent))
    try:
        procs = []
        for src in sources:
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-Xptxas", "-v", "-c",
                   str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        (tmp / "build.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(
                f"nvcc failed on {failed}:\n" + "\n".join(logs))
        lib = tmp / "libieee_kernels.so"
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *[str(o) for _, o, _ in procs],
             "-o", str(lib)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        # publish atomically: a reader sees the whole directory or none
        os.replace(tmp, out_dir)
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises if it cannot."""
    with _lock:
        if _state["lib"] is not None:
            return _state["lib"]
        t0 = time.perf_counter()
        sources = _sources()
        # the headers the sources include key the build as well
        out_dir = BUILD_ROOT / _digest(sources + sorted(CSRC.glob("*.cuh")))
        if not (out_dir / "libieee_kernels.so").is_file():
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            _compile(out_dir, sources)
        lib = ctypes.CDLL(str(out_dir / "libieee_kernels.so"))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _state["lib"] = lib
        _state["seconds"] = time.perf_counter() - t0
        atexit.register(_print_wait_report)
        return lib


def build_seconds():
    """Seconds the first ``load_library`` call took (build included), or
    None before it ran."""
    return _state["seconds"]


def build_log() -> str:
    """The nvcc output (``-Xptxas -v``: registers, shared memory, spills) of
    the loaded library's build."""
    lib = load_library()
    return (Path(lib._name).parent / "build.log").read_text()


def kernel_resources(log: str) -> dict:
    """Each entry function of an ``nvcc -Xptxas -v`` log: {mangled name:
    {"registers": n, "spill_stores": bytes, "spill_loads": bytes}}. The
    spills are those ptxas lists under the entry's own "Function
    properties", not a called function's."""
    out, name, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = props = m.group(1)
            out[name] = {"registers": None, "spill_stores": None,
                         "spill_loads": None}
            continue
        if name is None:
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props == name:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def wait_report():
    """The report of a Hopper kernel's mbarrier wait that ran past its 1 s
    bound in this process (the kernel then trapped and its launch failed),
    or None. The kernels write it into host memory (``csrc/sm90_gemm.cuh``
    ``mbar_wait``; a printf in them would serialise their wgmmas), so it
    can be read after the failure."""
    lib = _state["lib"]
    if lib is None:
        return None
    buf = ctypes.create_string_buffer(256)
    return buf.value.decode() if lib.ieee_wait_report(buf, 256) else None


def _print_wait_report() -> None:
    report = wait_report()
    if report is not None:
        print(report, file=sys.stderr, flush=True)


def check(code: int, name: str) -> None:
    """Raise if a kernel launch returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def stream_ptr(device) -> int:
    """The raw handle of the current CUDA stream on ``device`` (a tensor's
    device, so its index is set), through the accessor PyTorch's compiled
    kernels use: ``current_stream()`` builds a Stream object each call."""
    return torch._C._cuda_getCurrentRawStream(device.index)
