"""Re-ranking's two hot loops (``csrc/rerank.cu``): the k-reciprocal
Jaccard min-sum and the GNN propagation.

Neither has a Pallas counterpart; the JAX package leaves both to XLA:

- ``jaccard_minsum(vq, vg)``: ``ieee_tpu/ops/rerank_device.py:103-121``,
  ``1 - m / (2 - m)`` with ``m[i, c] = sum_k min(vq[i, k], vg[c, k])``, in
  f32 or with bf16 operands summed in f32. No library call computes it: it
  is a GEMM with min in place of the product, on the CUDA cores.
- ``gnn_propagate(c, idx, vals)``: ``ieee_tpu/ops/gnn_rerank.py:98-108``
  (the reference's ``gnn_propagate_kernel.cu``), ``sum_j vals[:, j] *
  c[idx[:, j]]`` with each row divided by ``max(its norm, 1e-12)``.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from .. import _build

__all__ = ["jaccard_minsum", "jaccard_minsum_plain", "gnn_propagate",
           "gnn_propagate_plain", "PROP_MAX_K2", "PROP_MAX_COLS"]

#: the plain min-sum's largest (rows, cols, K) broadcast intermediate, in
#: elements (512 MiB in f32); at Market-1501 one query row against the
#: whole gallery would be 1.2 GB
PLAIN_MINSUM_ELEMS = 1 << 27
#: gnn_propagate's limits (csrc/rerank.cu): neighbours a row gathers, and
#: columns of the row it keeps in shared memory (220 KiB of f32)
PROP_MAX_K2 = 64
PROP_MAX_COLS = 220 * 1024 // 4


def _check_minsum(vq: torch.Tensor, vg: torch.Tensor) -> None:
    if vq.ndim != 2 or vg.ndim != 2 or vq.shape[1] != vg.shape[1]:
        raise ValueError(f"expected (m, K) and (n, K), got {tuple(vq.shape)} "
                         f"and {tuple(vg.shape)}")
    if vq.dtype != vg.dtype or vq.dtype not in (torch.float32,
                                                torch.bfloat16):
        raise TypeError(f"expected two float32 or two bfloat16 operands, got "
                        f"{vq.dtype} and {vg.dtype}")
    if vq.device != vg.device:
        raise ValueError(f"vq on {vq.device}, vg on {vg.device}")


def _row_stride(name: str, t: torch.Tensor) -> int:
    """The elements between t's rows as the kernel reads them: any stride
    of at least K, with unit column stride."""
    rows, k = t.shape
    if (k > 1 and t.stride(1) != 1) or (rows > 1 and t.stride(0) < k):
        raise ValueError(f"{name}: rows must have unit column stride and not "
                         f"overlap (got strides {t.stride()})")
    return t.stride(0) if rows > 1 else k


def jaccard_minsum_plain(vq: torch.Tensor, vg: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: the JAX
    package's broadcast-min-sum, blocked over rows and columns so that the
    intermediate holds at most ``PLAIN_MINSUM_ELEMS`` elements."""
    _check_minsum(vq, vg)
    m, k = vq.shape
    n = vg.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=vq.device)
    cols = max(1, min(n, PLAIN_MINSUM_ELEMS // max(k, 1)))
    rows = max(1, min(m, PLAIN_MINSUM_ELEMS // (cols * max(k, 1))))
    for r in range(0, m, rows):
        a = vq[r:r + rows, None, :]
        for c in range(0, n, cols):
            s = torch.minimum(a, vg[None, c:c + cols, :]).sum(
                -1, dtype=torch.float32)
            out[r:r + rows, c:c + cols] = 1.0 - s / (2.0 - s)
    return out


def jaccard_minsum(vq: torch.Tensor, vg: torch.Tensor) -> torch.Tensor:
    """vq (m, K), vg (n, K), both float32 or both bfloat16 -> (m, n) float32
    Jaccard distances ``1 - s / (2 - s)``, ``s = sum_k min(vq[i], vg[c])``.
    On the card the operands' rows may lie any distance apart, with unit
    column stride."""
    _check_minsum(vq, vg)
    if vq.device.type == "cpu":
        return jaccard_minsum_plain(vq, vg)
    if vq.device.type != "cuda":
        raise ValueError(f"no jaccard_minsum kernel for device {vq.device}")
    lda = _row_stride("jaccard_minsum vq", vq)
    ldb = _row_stride("jaccard_minsum vg", vg)
    m, k = vq.shape
    n = vg.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=vq.device)
    lib = _build.load_library()
    _build.check(lib.ieee_jaccard_minsum(
        vq.data_ptr(), vg.data_ptr(), out.data_ptr(), m, n, k, lda, ldb,
        int(vq.dtype == torch.bfloat16),
        _build.stream_ptr(vq.device)), "jaccard_minsum")
    LAUNCHES["jaccard_minsum"] += 1
    return out


def _check_propagate(c, idx, vals) -> None:
    if c.ndim != 2 or idx.ndim != 2 or vals.shape != idx.shape:
        raise ValueError(f"expected c (r, f), idx and vals (m, k2), got "
                         f"{tuple(c.shape)}, {tuple(idx.shape)} and "
                         f"{tuple(vals.shape)}")
    if c.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError(f"c and vals must be float32, got {c.dtype} and "
                        f"{vals.dtype}")
    if idx.dtype != torch.int64:
        raise TypeError(f"idx must be int64, got {idx.dtype}")
    if not (c.device == idx.device == vals.device):
        raise ValueError("c, idx and vals must share a device")
    if idx.shape[1] < 1:
        raise ValueError("idx needs at least one neighbour a row")


def gnn_propagate_plain(c: torch.Tensor, idx: torch.Tensor,
                        vals: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: the JAX
    package's k2-term gather-sum (in j order) and row normalisation."""
    _check_propagate(c, idx, vals)
    acc = torch.zeros((idx.shape[0], c.shape[1]), dtype=torch.float32,
                      device=c.device)
    for j in range(idx.shape[1]):
        acc = acc + vals[:, j, None] * c[idx[:, j]]
    return acc / torch.linalg.norm(acc, dim=1, keepdim=True).clamp_min(1e-12)


def gnn_propagate(c: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """c (r, f) float32 (unit column stride), idx (m, k2) int64 rows of c,
    vals (m, k2) float32 -> (m, f) float32: row i is ``sum_j vals[i, j] *
    c[idx[i, j]]`` over its norm (at least 1e-12). On the card idx and vals
    are contiguous, k2 <= ``PROP_MAX_K2`` and f <= ``PROP_MAX_COLS``; idx's
    entries lie in [0, r) (checked: one synchronisation a call)."""
    _check_propagate(c, idx, vals)
    if c.device.type == "cpu":
        return gnn_propagate_plain(c, idx, vals)
    if c.device.type != "cuda":
        raise ValueError(f"no gnn_propagate kernel for device {c.device}")
    m, k2 = idx.shape
    f = c.shape[1]
    if c.stride(1) != 1 or not idx.is_contiguous() or not vals.is_contiguous():
        raise ValueError("gnn_propagate: c needs unit column stride, idx and "
                         "vals must be contiguous")
    if k2 > PROP_MAX_K2 or f > PROP_MAX_COLS:
        raise ValueError(f"gnn_propagate takes k2 <= {PROP_MAX_K2} and at "
                         f"most {PROP_MAX_COLS} columns, got {k2} and {f}")
    if bool(((idx < 0) | (idx >= c.shape[0])).any()):
        raise ValueError(f"gnn_propagate: idx outside [0, {c.shape[0]})")
    out = torch.empty((m, f), dtype=torch.float32, device=c.device)
    lib = _build.load_library()
    _build.check(lib.ieee_gnn_propagate(
        c.data_ptr(), idx.data_ptr(), vals.data_ptr(), out.data_ptr(), m, f,
        c.stride(0), k2, _build.stream_ptr(c.device)), "gnn_propagate")
    LAUNCHES["gnn_propagate"] += 1
    return out
