"""The measurement probes' kernels (``tools/bw_probe.py``,
``tools/fusion_probe.py``), driven by the port's tools
(``ieee_tpu_torch/tools/``).

- ``scale_bf16(x, tile_rows)``: ``o = x * bf16(1.0001)`` in bf16, streamed
  in tiles of 512 or 2048 rows (``pallas_scale``, ``pallas_scale_b``).
  bf16(1.0001) is exactly 1.0, so o equals x bit for bit; the kernel still
  reads and writes every byte (it is a bandwidth probe).
- ``probe_mm_stats(x, w)``: ``pallas_mm_stats``, y = bf16(x @ w) with the
  mean and the biased one-pass variance of the f32 product. Its body is the
  prototype of ``matmul_bn.py``'s ``_mm_stats``, so it runs on the port's
  ``mm_stats`` kernel (``ops/kernels/matmul_bn.py``) and derives m and v as
  the probe does.
- ``bn_mm(y, inv, sh, w2)``: ``pallas_bn_mm``, ``bf16(h @ w2)`` with
  ``h = bf16(relu(y * inv + sh))`` applied as the operand is loaded.

Each kernel wrapper takes the plain version (``*_plain``) for CPU tensors
and launches the CUDA kernel (``csrc/probes.cu``) for CUDA tensors, or
raises.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from .. import _build
from .matmul_bn import (_check_multiple_of_8, _cuda_operands, mm_stats,
                        mm_stats_plain)

__all__ = ["SCALE", "TILE_ROWS", "scale_factor", "scale_bf16",
           "scale_bf16_plain", "probe_mm_stats", "probe_mm_stats_plain",
           "bn_mm", "bn_mm_plain"]

_BF16 = torch.bfloat16

#: the bandwidth probe's factor, before its bf16 rounding
SCALE = 1.0001
#: the two block heights of ``pallas_scale`` and ``pallas_scale_b``
TILE_ROWS = (512, 2048)


def scale_factor() -> float:
    """The factor as the probe applies it: ``SCALE`` rounded to bf16 on the
    host, as ``jnp.bfloat16(1.0001)`` is (1.0)."""
    return torch.tensor(SCALE, dtype=_BF16).item()


def _check_scale(x: torch.Tensor, tile_rows: int) -> None:
    if x.ndim != 2 or x.dtype != _BF16:
        raise ValueError(f"expected a 2-D bf16 x, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if tile_rows not in TILE_ROWS:
        raise ValueError(f"tile_rows must be one of {TILE_ROWS}, got "
                         f"{tile_rows}")


def scale_bf16_plain(x: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """The bf16 product x * bf16(SCALE), rounded once per element; the
    tile height only orders the kernel's work."""
    _check_scale(x, tile_rows)
    return x * scale_factor()


def scale_bf16(x: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """x (rows, cols) bf16 -> x * bf16(SCALE), bf16; cols % 8 == 0 on the
    card."""
    _check_scale(x, tile_rows)
    if x.device.type == "cpu":
        return scale_bf16_plain(x, tile_rows)
    rows, cols = x.shape
    _check_multiple_of_8("scale_bf16", cols=cols)
    (x,) = _cuda_operands("scale_bf16", x)
    out = torch.empty_like(x)
    # 8 blocks of 256 threads per SM: a full SM, every SM on every tile
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    blocks = max(1, min(8 * sms, -(-rows * cols // (8 * 256))))
    lib = _build.load_library()
    _build.check(lib.ieee_scale_bf16(
        x.data_ptr(), out.data_ptr(), scale_factor(), rows, cols, tile_rows,
        blocks, _build.stream_ptr(x.device)), "scale_bf16")
    LAUNCHES["scale_bf16"] += 1
    return out


def _moments(y, stats):
    """(y, m, v) as ``pallas_mm_stats`` returns them: m = sum y / N and the
    one-pass v = sum y^2 / N - m^2, from the f32 sums."""
    n = y.shape[0]
    m = stats[0] / n
    return y, m, stats[1] / n - m * m


def probe_mm_stats_plain(x: torch.Tensor, w: torch.Tensor):
    return _moments(*mm_stats_plain(x, w))


def probe_mm_stats(x: torch.Tensor, w: torch.Tensor):
    """x (N, K), w (K, C) -> (y (N, C) bf16, m (C,) f32, v (C,) f32), on
    the ``mm_stats`` kernel (which counts the launch)."""
    return _moments(*mm_stats(x, w))


def _check_bn_mm(y, inv, sh, w2) -> None:
    if y.ndim != 2 or w2.ndim != 2 or y.shape[1] != w2.shape[0]:
        raise ValueError(f"expected y (N, K) and w2 (K, C), got "
                         f"{tuple(y.shape)} and {tuple(w2.shape)}")
    k = y.shape[1]
    if inv.shape != (k,) or sh.shape != (k,):
        raise ValueError(f"inv/sh must be ({k},), got {tuple(inv.shape)} "
                         f"and {tuple(sh.shape)}")
    if not (y.device == inv.device == sh.device == w2.device):
        raise ValueError("y, inv, sh and w2 must share a device")


def bn_mm_plain(y: torch.Tensor, inv: torch.Tensor, sh: torch.Tensor,
                w2: torch.Tensor) -> torch.Tensor:
    """``bn_mm_kernel``'s operations in its order: h = bf16(relu(f32(y) *
    inv + sh)), then h @ bf16(w2) with f32 sums, rounded to bf16."""
    _check_bn_mm(y, inv, sh, w2)
    h = torch.relu(y.to(_BF16).float() * inv.float() + sh.float()).to(_BF16)
    return (h.float() @ w2.to(_BF16).float()).to(_BF16)


def bn_mm(y: torch.Tensor, inv: torch.Tensor, sh: torch.Tensor,
          w2: torch.Tensor) -> torch.Tensor:
    """y (N, K), inv/sh (K,), w2 (K, C) -> (N, C) bf16."""
    _check_bn_mm(y, inv, sh, w2)
    if y.device.type == "cpu":
        return bn_mm_plain(y, inv, sh, w2)
    n, k = y.shape
    c = w2.shape[1]
    _check_multiple_of_8("bn_mm", K=k, C=c)
    y, vf, w2 = _cuda_operands(
        "bn_mm", y.to(_BF16), torch.stack([inv.float(), sh.float()]),
        w2.to(_BF16))
    lib = _build.load_library()
    out = torch.empty((n, c), dtype=_BF16, device=y.device)
    _build.check(lib.ieee_bn_mm_bf16(
        y.data_ptr(), vf.data_ptr(), w2.data_ptr(), out.data_ptr(), n, k, c,
        _build.stream_ptr(y.device)), "bn_mm")
    LAUNCHES["bn_mm"] += 1
    return out
