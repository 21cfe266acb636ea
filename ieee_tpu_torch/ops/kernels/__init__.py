"""The port's hand-written Hopper kernels, one module each.

Each module holds the wrapper a caller uses and the kernel's plain PyTorch
version. The wrapper takes the plain version for a CPU tensor and launches
the CUDA kernel for a CUDA tensor (or raises); it adds one to its launch
count each time it launches the kernel, and nowhere else, so a run can show
that its path went through the kernels.
"""

from __future__ import annotations

from collections import Counter

__all__ = ["KERNEL_NAMES", "LAUNCHES", "reset_launch_counts", "launch_counts"]

#: every kernel of the port, in the order of PERF.md's tables (the Pallas
#: set, then the hand kernels beyond it)
KERNEL_NAMES = ("distmat", "partpool", "mm_affine", "mm_stats", "mm_bn_da",
                "mm_bn_dw", "reduce3", "bn3_apply", "conv2_bwd", "bn1_apply",
                "scale_bf16", "bn_mm", "conv_s8")

#: kernel name -> number of launches since the last reset
LAUNCHES: Counter = Counter()


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def launch_counts() -> dict:
    return {k: LAUNCHES[k] for k in KERNEL_NAMES}
