"""Fused 1x1 conv + BatchNorm as matmul kernels: eval (``mm_affine``) and
train (``mm_stats``, ``mm_bn_da``, ``mm_bn_dw`` under ``mm_bn_act_train``).

Counterpart of ``ieee_tpu/ops/pallas/matmul_bn.py``. Every kernel takes a
and w cast to bf16 and accumulates in f32:

- ``mm_affine_act``: ``[relu]((a @ w) * inv + shift)``, bf16 out.
- ``mm_stats``: ``y = a @ w`` as bf16 plus the per-channel ``sum y`` and
  ``sum y^2`` taken from the f32 accumulator (``_mm_stats``).
- ``mm_bn_da`` / ``mm_bn_dw``: ``dy @ w^T`` (bf16 out) and ``a^T @ dy`` (f32
  out), with dy recomputed from the cotangent, y and the six f32 rows
  ``vecs = [inv, shift, mean, rstd, S1/N, S2/N]`` (``_dy_tile``) and rounded
  to bf16 before the product (``_da``, ``_dw``).
- ``mm_bn_act_train``: the train op around them, ``_fwd_impl`` and
  ``_mm_bn_bwd`` as a ``torch.autograd.Function``.

Each kernel wrapper takes the plain version (``*_plain``) for CPU tensors
and launches the CUDA kernel (``csrc/mm_affine.cu``, ``csrc/mm_bn_train.cu``
on the mainloop of ``csrc/mm_sm90.cuh``; ``csrc/mm_bn_bwd.cu``) for CUDA
tensors, or raises.
"""

from __future__ import annotations

import functools

import torch

from . import LAUNCHES
from .. import _build

__all__ = ["mm_affine_act", "mm_affine_act_plain", "mm_stats",
           "mm_stats_plain", "mm_bn_da", "mm_bn_da_plain", "mm_bn_dw",
           "mm_bn_dw_plain", "dy_plain", "mm_bn_act_train", "EPS",
           "TRAIN_SITES", "EVAL_SITES"]

EPS = 1e-5
_BF16 = torch.bfloat16


def _bf16_as_f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(_BF16).float()


def _check_mm(a, w) -> None:
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"expected a (N, K) and w (K, C), got "
                         f"{tuple(a.shape)} and {tuple(w.shape)}")
    if a.device != w.device:
        raise ValueError("a and w must share a device")


def _cuda_operands(name, *tensors):
    """bf16/f32 tensors on the card, contiguous and 16-byte aligned, or
    raise; returns them in order."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"no {name} kernel for device {dev}")
    out = []
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: all operands must share a device")
        t = t.contiguous()
        if t.data_ptr() % 16:
            # the kernels load 16-byte vectors; a sliced view may start
            # anywhere
            t = t.clone()
        out.append(t)
    return out


#: the forward kernels' tiles (csrc/mm_sm90.cuh): 128 rows x one of these
#: column widths, the widest first
MM_ROWS = 128
MM_WIDTHS = (256, 128, 64)


def _mm_plan(n: int, c: int, sms: int = 132) -> int:
    """The column width of ``mm_stats``'s and ``mm_affine``'s output tile
    (one block a 128-row x width tile, one block an SM): the widest whose
    grid fills at least half the card's SMs, else the narrowest. The layer4
    and CIM sites of the train and eval batches take 256; the reduce sites
    and the batch-8 CIM site narrower tiles."""
    rows = -(-n // MM_ROWS)
    for width in MM_WIDTHS:
        if 2 * rows * -(-c // width) >= sms:
            return width
    return MM_WIDTHS[-1]


#: the fused 1x1 sites of one train step at batch 128 on 256x128 images
#: (N = 128*16*8 rows at the 16x8 layer4 map): (N, K, C, relu, sites per
#: step over the 3 trunks); 33 launches of each train kernel
TRAIN_SITES = (
    (16384, 1024, 512, True, 3),    # layer4.0 cb1
    (16384, 512, 2048, False, 9),   # layer4.* cb3 (+ identity)
    (16384, 1024, 2048, False, 3),  # layer4.0 downsample
    (16384, 2048, 512, True, 6),    # layer4.1-2 cb1
    (16384, 2048, 2048, True, 6),   # CIM convOne, convAvgRest
    (128, 2048, 768, True, 3),      # reduce, global rows
    (768, 2048, 768, True, 3),      # reduce, part rows (B*6)
)
#: the fused 1x1 sites of an eval batch of 100 (N = 100*16*8 rows): (N, K,
#: C, relu, sites per batch over the 3 trunks); 21 launches of mm_affine
EVAL_SITES = ((12800, 1024, 512, True, 3),    # layer4.0 cb1
              (12800, 512, 2048, False, 9),   # layer4.* cb3
              (12800, 1024, 2048, False, 3),  # layer4.0 downsample
              (12800, 2048, 512, True, 6))    # layer4.1-2 cb1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_multiple_of_8(name, **dims) -> None:
    bad = {k: v for k, v in dims.items() if v % 8}
    if bad:
        raise ValueError(f"{name} kernel needs {'/'.join(bad)} divisible by "
                         f"8, got {bad}")


# ----------------------------------------------------------------- eval

def mm_affine_act_plain(a: torch.Tensor, w: torch.Tensor, inv: torch.Tensor,
                        shift: torch.Tensor, relu: bool) -> torch.Tensor:
    """Same contract in plain PyTorch: the bf16-rounded operands multiplied
    in f32 (exact products, f32 sums), the affine in f32, bf16 out."""
    y = _bf16_as_f32(a) @ _bf16_as_f32(w)
    y = y * inv.float() + shift.float()
    if relu:
        y = torch.relu(y)
    return y.to(_BF16)


def mm_affine_act(a: torch.Tensor, w: torch.Tensor, inv: torch.Tensor,
                  shift: torch.Tensor, relu: bool) -> torch.Tensor:
    """a (N, K), w (K, C), inv/shift (C,) -> (N, C) bf16."""
    _check_mm(a, w)
    c = w.shape[1]
    if inv.shape != (c,) or shift.shape != (c,):
        raise ValueError(f"inv/shift must be ({c},), got {tuple(inv.shape)} "
                         f"and {tuple(shift.shape)}")
    if not (a.device == inv.device == shift.device):
        raise ValueError("a, w, inv and shift must share a device")
    if a.device.type == "cpu":
        return mm_affine_act_plain(a, w, inv, shift, relu)
    n, k = a.shape
    _check_multiple_of_8("mm_affine", K=k, C=c)
    a, w, inv, shift = _cuda_operands(
        "mm_affine", a.to(_BF16), w.to(_BF16), inv.float(), shift.float())
    lib = _build.load_library()
    out = torch.empty((n, c), dtype=_BF16, device=a.device)
    width = _mm_plan(n, c, _sm_count(a.device.index))
    _build.check(lib.ieee_mm_affine_bf16(
        a.data_ptr(), w.data_ptr(), inv.data_ptr(), shift.data_ptr(),
        out.data_ptr(), n, k, c, int(bool(relu)), width // 64,
        _build.stream_ptr(a.device)), "mm_affine")
    LAUNCHES["mm_affine"] += 1
    return out


# ------------------------------------------------------------ train: forward

def mm_stats_plain(a: torch.Tensor, w: torch.Tensor):
    """-> (y (N, C) bf16, stats (2, C) f32 = [sum y, sum y^2]) with the sums
    over the f32 product before its bf16 rounding."""
    y = _bf16_as_f32(a) @ _bf16_as_f32(w)
    return y.to(_BF16), torch.stack([y.sum(0), (y * y).sum(0)])


def mm_stats(a: torch.Tensor, w: torch.Tensor):
    """a (N, K), w (K, C) -> (y (N, C) bf16, stats (2, C) f32)."""
    _check_mm(a, w)
    if a.device.type == "cpu":
        return mm_stats_plain(a, w)
    n, k = a.shape
    c = w.shape[1]
    _check_multiple_of_8("mm_stats", K=k, C=c)
    a, w = _cuda_operands("mm_stats", a.to(_BF16), w.to(_BF16))
    lib = _build.load_library()
    y = torch.empty((n, c), dtype=_BF16, device=a.device)
    stats = torch.empty((2, c), dtype=torch.float32, device=a.device)
    # per-128-row-block sums, added in order by the second kernel
    part = torch.empty((max(1, -(-n // MM_ROWS)), 2, c), dtype=torch.float32,
                       device=a.device)
    width = _mm_plan(n, c, _sm_count(a.device.index))
    _build.check(lib.ieee_mm_stats_bf16(
        a.data_ptr(), w.data_ptr(), y.data_ptr(), stats.data_ptr(),
        part.data_ptr(), n, k, c, width // 64, _build.stream_ptr(a.device)),
        "mm_stats")
    LAUNCHES["mm_stats"] += 1
    return y, stats


# ----------------------------------------------------------- train: backward

def dy_plain(d_act: torch.Tensor, y: torch.Tensor, vecs: torch.Tensor,
             relu: bool) -> torch.Tensor:
    """The recomputed BN backward (JAX ``_dy_tile``): (N, C) bf16 from the
    cotangent d_act, y (both bf16) and vecs (6, C) f32 rows [inv, shift,
    mean, rstd, S1/N, S2/N]."""
    inv, shift, mean, rstd, s1, s2 = vecs.float()
    yf = y.float()
    g = d_act.float()
    if relu:
        g = torch.where(yf * inv + shift > 0, g, torch.zeros_like(g))
    xhat = (yf - mean) * rstd
    return (inv * (g - s1 - xhat * s2)).to(_BF16)


def mm_bn_da_plain(d_act, y, vecs, w, relu: bool) -> torch.Tensor:
    """dA = dy @ w^T -> (N, K) bf16."""
    dy = dy_plain(d_act, y, vecs, relu)
    return (dy.float() @ _bf16_as_f32(w).t()).to(_BF16)


def mm_bn_dw_plain(a, d_act, y, vecs, relu: bool) -> torch.Tensor:
    """dW = a^T @ dy -> (K, C) f32."""
    dy = dy_plain(d_act, y, vecs, relu)
    return _bf16_as_f32(a).t() @ dy.float()


def _check_bwd(d_act, y, vecs) -> None:
    if d_act.ndim != 2 or d_act.shape != y.shape:
        raise ValueError(f"d_act and y must be the same (N, C), got "
                         f"{tuple(d_act.shape)} and {tuple(y.shape)}")
    if vecs.shape != (6, y.shape[1]):
        raise ValueError(f"vecs must be (6, {y.shape[1]}), got "
                         f"{tuple(vecs.shape)}")
    if not (d_act.device == y.device == vecs.device):
        raise ValueError("d_act, y and vecs must share a device")


def mm_bn_da(d_act: torch.Tensor, y: torch.Tensor, vecs: torch.Tensor,
             w: torch.Tensor, relu: bool) -> torch.Tensor:
    """d_act, y (N, C), vecs (6, C), w (K, C) -> dA (N, K) bf16."""
    _check_bwd(d_act, y, vecs)
    if w.ndim != 2 or w.shape[1] != y.shape[1] or w.device != y.device:
        raise ValueError(f"w must be (K, {y.shape[1]}) on {y.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    if y.device.type == "cpu":
        return mm_bn_da_plain(d_act, y, vecs, w, relu)
    n, c = y.shape
    k = w.shape[0]
    _check_multiple_of_8("mm_bn_da", K=k, C=c)
    d_act, y, vecs, w = _cuda_operands(
        "mm_bn_da", d_act.to(_BF16), y.to(_BF16), vecs.float(), w.to(_BF16))
    lib = _build.load_library()
    out = torch.empty((n, k), dtype=_BF16, device=y.device)
    _build.check(lib.ieee_mm_bn_da_bf16(
        d_act.data_ptr(), y.data_ptr(), vecs.data_ptr(), w.data_ptr(),
        out.data_ptr(), n, k, c, int(bool(relu)),
        _build.stream_ptr(y.device)), "mm_bn_da")
    LAUNCHES["mm_bn_da"] += 1
    return out


#: the dW kernel's tiling (csrc/mm_bn_bwd.cu): a block owns 128 channels x
#: 256 columns of K and walks its rows of N in steps of 64
DW_TILE = (128, 256)
DW_ROW_STEP = 64
#: fewest rows a split range takes, so that a partial's write and read
#: stay small against its product
DW_MIN_ROWS = 512


def _dw_plan(n: int, k: int, c: int, sms: int = 132):
    """(splits, rows): the dW kernel reduces N in ``splits`` contiguous
    ranges of ``rows`` rows each (a multiple of the 64-row step; the last
    range may be short, none is empty), in parallel over grid z. The ranges
    fill one wave of the card's SMs (one ~199 KB block per SM) with the
    output tiles, and none is shorter than DW_MIN_ROWS unless N is."""
    tiles = -(-c // DW_TILE[0]) * -(-k // DW_TILE[1])
    splits = max(1, min(sms // tiles, n // DW_MIN_ROWS))
    rows = max(DW_ROW_STEP, -(-n // (splits * DW_ROW_STEP)) * DW_ROW_STEP)
    return max(1, -(-n // rows)), rows


def mm_bn_dw(a: torch.Tensor, d_act: torch.Tensor, y: torch.Tensor,
             vecs: torch.Tensor, relu: bool) -> torch.Tensor:
    """a (N, K), d_act, y (N, C), vecs (6, C) -> dW (K, C) f32."""
    _check_bwd(d_act, y, vecs)
    if a.ndim != 2 or a.shape[0] != y.shape[0] or a.device != y.device:
        raise ValueError(f"a must be ({y.shape[0]}, K) on {y.device}, got "
                         f"{tuple(a.shape)} on {a.device}")
    if y.device.type == "cpu":
        return mm_bn_dw_plain(a, d_act, y, vecs, relu)
    n, c = y.shape
    k = a.shape[1]
    _check_multiple_of_8("mm_bn_dw", K=k, C=c)
    a, d_act, y, vecs = _cuda_operands(
        "mm_bn_dw", a.to(_BF16), d_act.to(_BF16), y.to(_BF16), vecs.float())
    splits, rows = _dw_plan(n, k, c)
    lib = _build.load_library()
    out = torch.empty((k, c), dtype=torch.float32, device=y.device)
    part = (torch.empty((splits, k, c), dtype=torch.float32, device=y.device)
            if splits > 1 else None)
    _build.check(lib.ieee_mm_bn_dw_bf16(
        a.data_ptr(), d_act.data_ptr(), y.data_ptr(), vecs.data_ptr(),
        out.data_ptr(), 0 if part is None else part.data_ptr(), n, k, c,
        int(bool(relu)), splits, rows, _build.stream_ptr(y.device)),
        "mm_bn_dw")
    LAUNCHES["mm_bn_dw"] += 1
    return out


# ------------------------------------------------------------- the train op

def _fold(mean, var, scale, bias):
    rstd = torch.rsqrt(var + EPS)
    inv = rstd * scale
    return rstd, inv, bias - mean * inv


class _MMBNActTrain(torch.autograd.Function):
    """``ieee_tpu``'s ``mm_bn_act_train`` custom VJP (``_fwd_impl``,
    ``_mm_bn_bwd``)."""

    @staticmethod
    def forward(ctx, a, w, scale, bias, res, relu, has_res, plain):
        n = a.shape[0]
        a16 = a.to(_BF16)
        y, st = (mm_stats_plain if plain else mm_stats)(a16, w)
        mean = st[0] / n
        var = st[1] / n - mean * mean  # no clamp, as the JAX op
        _, inv, shift = _fold(mean, var, scale, bias)
        # normalise, residual and relu stay plain elementwise ops, as they
        # are plain XLA in the JAX op
        act = y.float() * inv + shift
        if has_res:
            act = act + res.float()
        if relu:
            act = torch.relu(act)
        ctx.save_for_backward(a16, w, scale, bias, y, mean, var)
        ctx.relu, ctx.has_res, ctx.plain = relu, has_res, plain
        ctx.a_dtype = a.dtype
        ctx.mark_non_differentiable(mean, var)
        return act.to(_BF16), mean, var

    @staticmethod
    def backward(ctx, d_act, _d_mean, _d_var):
        a16, w, scale, bias, y, mean, var = ctx.saved_tensors
        relu = ctx.relu
        d_act = d_act.to(_BF16)  # mean/var carry no gradient
        n, c = y.shape
        rstd, inv, shift = _fold(mean, var, scale, bias)
        yf = y.float()
        g = d_act.float()
        if relu:
            g = torch.where(yf * inv + shift > 0, g, torch.zeros_like(g))
        xhat = (yf - mean) * rstd
        dbias = g.sum(0)
        dscale = (g * xhat).sum(0)
        vecs = torch.stack([inv, shift, mean, rstd, dbias / n, dscale / n])
        da_fn, dw_fn = ((mm_bn_da_plain, mm_bn_dw_plain) if ctx.plain
                        else (mm_bn_da, mm_bn_dw))
        da = da_fn(d_act, y, vecs, w, relu)
        dw = dw_fn(a16, d_act, y, vecs, relu)
        dres = d_act if ctx.has_res else None
        return (da.to(ctx.a_dtype), dw.to(w.dtype), dscale, dbias, dres,
                None, None, None)


def mm_bn_act_train(a: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, res=None, relu: bool = False,
                    plain: bool = False):
    """Fused train-mode 1x1 conv + BN [+ residual] [+ ReLU].

    a (N, K); w (K, C) f32 master; scale/bias (C,) f32; res (N, C) or None.
    relu and a residual are mutually exclusive (the residual block applies
    relu outside, so the residual's gradient is the incoming cotangent).
    Returns (act (N, C) bf16, mean (C,) f32, var (C,) f32); mean and var
    (biased, one-pass) feed the running statistics and carry no gradient.
    ``plain`` computes the op with the kernels' plain versions on any
    device (the reference the kernels are held to on the card).
    """
    has_res = res is not None
    if relu and has_res:
        raise ValueError("residual variant applies relu outside")
    return _MMBNActTrain.apply(a, w, scale, bias, res, bool(relu), has_res,
                               bool(plain))
