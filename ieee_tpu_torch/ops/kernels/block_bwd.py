"""Whole-block backward of the stride-1 bottleneck without downsample:
``bottleneck_train`` and its four kernels (``cfg.cuda.block_megakernel``).

Counterpart of ``ieee_tpu/ops/pallas/block_bwd.py``. The forward
(``_fwd_full``) is plain PyTorch, the program the plain block runs:

    a1 = x @ W1 ;           h1 = relu(bn1(a1))
    a2 = conv3x3(h1, W2) ;  h2 = relu(bn2(a2))
    a3 = h2 @ W3 ;          y  = relu(bn3(a3) + x)

with the convolutions in x's dtype and ``_bn_train``'s one-pass f32
statistics (E[a^2] - m^2, not clipped), eps 1e-5. The backward chains four
kernels (the BN batch statistics force the order: each BN's input gradient
needs two channel sums of its incoming cotangent):

- ``reduce3`` (``_reduce3``): d3 = dy * [y > 0]; S3 = [sum d3, sum d3*xhat3].
- ``bn3_apply`` (``_bn3_apply``): da3 = bn3_bwd(d3); dW3 = h2^T @ da3 with h2
  recomputed from a2; d2 = (da3 @ W3^T) * [h2 > 0]; S2.
- ``conv2_bwd`` (``_conv2_bwd``): da2 = bn2_bwd(d2); dW2[ky, kx] =
  shift(h1)^T @ da2 with h1 recomputed from a1; d1 = (3x3 SAME input
  gradient of da2) * [h1 > 0]; S1.
- ``bn1_apply`` (``_bn1_apply``): da1 = bn1_bwd(d1); dW1 = x^T @ da1;
  dx = da1 @ W1^T + d3.

Layouts are the JAX package's: activations (B, H, W, C) (the NHWC view of a
channels_last map, read as (B*H*W, C) rows), weights k1 (1, 1, cin, cm),
k2 (3, 3, cm_in, cm_out), k3 (1, 1, cm, C) as f32 masters cast to the
activations' dtype in the op. Per-channel f32 rows: ``v`` = [inv, mean,
rstd, S1/N, S2/N] for a BN backward, ``vf`` = [inv, shift, mean, rstd] for
the recomputed h = relu(a*inv + shift) and its x-hat.

Rounding points (each plain version follows the JAX kernel body, and the
CUDA kernels follow the plain versions): masks compare in f32; x-hat =
(a - mean)*rstd; da = round(inv*((d - S1/N) - x-hat*S2/N)); h rounds to the
dtype as a product operand, but its mask comes from the f32 value; d3, d2
and d1 round to the dtype after their sums are taken from the f32 values;
dx = round(f32(da1 @ W1^T) + f32(d3)). Products take operands in the
dtype and sum in f32; dW and the sums are f32.

Each wrapper takes its plain version (``*_plain``) for CPU tensors and
launches its kernel for CUDA tensors (bf16 only), or raises: ``reduce3`` in
``csrc/block_bwd.cu``, ``bn3_apply`` in ``csrc/bn_gemm_sm90.cu``,
``conv2_bwd`` and ``bn1_apply`` in ``csrc/block_bwd_sm90.cu``; the three
product kernels share two Hopper kernel bodies (``csrc/bn_gemm_sm90.cuh``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import LAUNCHES
from .. import _build
from .matmul_bn import (EPS, _check_multiple_of_8, _cuda_operands,
                        _sm_count)

__all__ = ["reduce3", "reduce3_plain", "bn3_apply", "bn3_apply_plain",
           "conv2_bwd", "conv2_bwd_plain", "bn1_apply", "bn1_apply_plain",
           "bottleneck_train"]

_BF16 = torch.bfloat16
_TILE = 128  # rows of one tile of the product kernels (channel sums)

#: the dW kernels of bn3_apply, conv2_bwd and bn1_apply
#: (csrc/bn_gemm_sm90.cuh ``bn_dw_sm90``): a block owns 128 channels of the
#: BN-backward operand and a tile of the other's columns, and walks its rows
#: of N in steps of 64
BN3_ROW_STEP = 64
#: fewest rows a split range takes, so that a partial's write and read stay
#: small against its product
BN3_MIN_ROWS = 512
#: longest range at a 256-wide column tile (bn3_apply at cm > 128), whose
#: accumulators have no registers left for f32 totals (narrower tiles add
#: theirs into totals every 128 rows): the tensor cores' f32 sums drift over
#: long same-signed chains
BN3_MAX_UNFLUSHED_ROWS = 1024
#: longest range of conv2_bwd's dW2 kernel: a block keeps one bit a row of
#: its range in shared memory (the rows whose tap reads inside the image)
CONV2_MAX_ROWS = 32768


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B*H*W, C)."""
    return t.reshape(-1, t.shape[-1])


def _xhat(af, mean, rstd):
    return (af - mean) * rstd


def _bn_bwd(d, a, v):
    """The BN backward of rows d at pre-BN rows a, in d's dtype; v rows
    [inv, mean, rstd, S1/N, S2/N]."""
    inv, mean, rstd, s1, s2 = v.float()
    return (inv * (d.float() - s1 - _xhat(a.float(), mean, rstd) * s2)
            ).to(d.dtype)


def _relu_bn(af, vf):
    """h = relu(a*inv + shift) in f32 from f32 rows af; vf rows [inv,
    shift, mean, rstd]."""
    return torch.relu(af * vf[0] + vf[1])


def _sums(d, af, mean, rstd):
    """(2, C) f32: [sum d, sum d*x-hat] over the rows."""
    return torch.stack([d.sum(0), (d * _xhat(af, mean, rstd)).sum(0)])


# ------------------------------------------------------------ plain versions

def reduce3_plain(dy, y, a3, mean3, rstd3):
    """-> (d3 (B, H, W, C) in dy's dtype, S3 (2, C) f32)."""
    g = _rows(dy).float()
    g = torch.where(_rows(y).float() > 0, g, torch.zeros_like(g))
    return (g.to(dy.dtype).view(dy.shape),
            _sums(g, _rows(a3).float(), mean3, rstd3))


def bn3_apply_plain(d3, a3, a2, w3, v3, v2f):
    """w3 (cm, C) -> (d2 (B, H, W, cm), S2 (2, cm) f32, dW3 (cm, C) f32)."""
    dt = d3.dtype
    da3 = _bn_bwd(_rows(d3), _rows(a3), v3).float()
    a2f = _rows(a2).float()
    h2 = _relu_bn(a2f, v2f)
    dw3 = h2.to(dt).float().t() @ da3
    dh2 = da3 @ w3.to(dt).float().t()
    d2 = torch.where(h2 > 0, dh2, torch.zeros_like(dh2))
    return (d2.to(dt).view(a2.shape), _sums(d2, a2f, v2f[2], v2f[3]), dw3)


def conv2_bwd_plain(d2, a2, a1, w2, v2, v1f):
    """w2 (3, 3, cm_in, cm_out) -> (d1 (B, H, W, cm), S1 (2, cm) f32,
    dW2 (3, 3, cm, cm) f32): nine shifted products each way over
    zero-padded images, as the JAX kernel's padded scratch."""
    b, h, w, cm = d2.shape
    dt = d2.dtype
    da2 = _bn_bwd(_rows(d2), _rows(a2), v2).view(b, h, w, cm)
    a1f = _rows(a1).float()
    h1 = _relu_bn(a1f, v1f)
    pad = (0, 0, 1, 1, 1, 1)  # W and H of (B, H, W, C)
    h1p = F.pad(h1.to(dt).view(b, h, w, cm), pad).float()
    dap = F.pad(da2, pad).float()
    da2f = _rows(da2).float()
    w2f = w2.to(dt).float()
    dw2 = torch.empty((3, 3, cm, cm), dtype=torch.float32, device=d2.device)
    dh1 = torch.zeros_like(a1f)
    for ky in range(3):
        for kx in range(3):
            hs = h1p[:, ky:ky + h, kx:kx + w].reshape(-1, cm)
            dw2[ky, kx] = hs.t() @ da2f
            ds = dap[:, 2 - ky:2 - ky + h, 2 - kx:2 - kx + w].reshape(-1, cm)
            dh1 += ds @ w2f[ky, kx].t()
    d1 = torch.where(h1 > 0, dh1, torch.zeros_like(dh1))
    return (d1.to(dt).view(a1.shape), _sums(d1, a1f, v1f[2], v1f[3]), dw2)


def bn1_apply_plain(d1, a1, x, d3, w1, v1):
    """w1 (cin, cm) -> (dx (B, H, W, cin) in x's dtype, dW1 (cin, cm) f32)."""
    da1 = _bn_bwd(_rows(d1), _rows(a1), v1).float()
    dw1 = _rows(x).float().t() @ da1
    dx = da1 @ w1.to(d1.dtype).float().t() + _rows(d3).float()
    return dx.to(x.dtype).view(x.shape), dw1


# ---------------------------------------------------------------- wrappers

def _check_maps(name, **maps):
    """Every map (B, H, W, *) with the same B, H, W and device."""
    first = next(iter(maps.values()))
    lead, dev = first.shape[:3], first.device
    if any(v.ndim != 4 or v.shape[:3] != lead or v.device != dev
           for v in maps.values()):
        shapes = {k: tuple(v.shape) for k, v in maps.items()}
        raise ValueError(f"{name}: maps must be (B, H, W, C) on one device "
                         f"with the same B, H, W, got {shapes}")


def _check_rows(name, c, **vecs):
    for k, v in vecs.items():
        if v.ndim != 2 or v.shape[1] != c:
            raise ValueError(f"{name}: {k} must be (rows, {c}), got "
                             f"{tuple(v.shape)}")


def _kernel_operands(name, maps, vecs, weights):
    """Maps (bf16 only: the kernels read 16-byte bf16 vectors), f32 rows
    and bf16 weights, contiguous on the card, or raise."""
    bad = [t.dtype for t in maps if t.dtype != _BF16]
    if bad:
        raise ValueError(f"{name} kernel takes bf16 maps, got {bad}")
    ops = _cuda_operands(name, *maps, *[v.float() for v in vecs],
                         *[w.to(_BF16) for w in weights])
    return ops, _build.load_library(), _build.stream_ptr(ops[0].device)


def _bn3_width(cm: int) -> int:
    """Columns of cm one bn3_apply block owns: 64, 128 or 256."""
    return 64 if cm <= 64 else 128 if cm <= 128 else 256


def _dw_width(cols: int) -> int:
    """Columns of the non-BN operand (h1 of conv2_bwd, x of bn1_apply) one
    block of their dW kernels owns: 64 or 128 (always flushed)."""
    return 64 if cols <= 64 else 128


def _dw_ranges(n: int, tiles: int, width: int, sms: int,
               max_rows: int | None = None):
    """(splits, rows): a dW kernel reduces N in ``splits`` contiguous
    ranges of ``rows`` rows each (a multiple of the 64-row step; the last
    range may be short, none is empty), in parallel over grid z. The ranges
    fill one wave of the card's SMs (one block per SM) with the ``tiles``
    output tiles, none is shorter than BN3_MIN_ROWS unless N is, at the
    256-wide column tile none is longer than BN3_MAX_UNFLUSHED_ROWS, and
    none is longer than ``max_rows``."""
    splits = max(1, min(sms // tiles, n // BN3_MIN_ROWS))
    rows = max(BN3_ROW_STEP,
               -(-n // (splits * BN3_ROW_STEP)) * BN3_ROW_STEP)
    if width == 256:
        rows = min(rows, BN3_MAX_UNFLUSHED_ROWS)
    if max_rows is not None:
        rows = min(rows, max_rows)
    return max(1, -(-n // rows)), rows


def _bn3_plan(n: int, c: int, cm: int, sms: int = 132):
    """bn3_apply's dW3 ranges (``_dw_ranges``) over its (C / 128) x
    (cm / width) output tiles."""
    width = _bn3_width(cm)
    return _dw_ranges(n, -(-c // 128) * -(-cm // width), width, sms)


def _conv2_plan(n: int, cm: int, sms: int = 132):
    """conv2_bwd's dW2 ranges over its (cm_out / 128) x 9 taps x (cm_in /
    width) output tiles (always flushed), none longer than
    CONV2_MAX_ROWS."""
    width = _dw_width(cm)
    return _dw_ranges(n, -(-cm // 128) * 9 * -(-cm // width), width, sms,
                      CONV2_MAX_ROWS)


def _bn1_plan(n: int, cin: int, cm: int, sms: int = 132):
    """bn1_apply's dW1 ranges over its (cm / 128) x (cin / width) output
    tiles."""
    width = _dw_width(cin)
    return _dw_ranges(n, -(-cm // 128) * -(-cin // width), width, sms)


#: reduce3 (csrc/block_bwd.cu): a block owns one range of rows of a tile
#: of R3_TILE channels, R3_BLOCKS_PER_SM blocks an SM fill the card in one
#: wave, and a range is at least R3_MIN_ROWS rows (one round of each
#: thread's 4 rows in flight over the block's 16 row lanes)
R3_TILE = 128
R3_BLOCKS_PER_SM = 2
R3_MIN_ROWS = 64


def _reduce3_plan(n: int, c: int, sms: int = 132):
    """(tiles, ranges, rows): reduce3's grid is ``tiles`` channel tiles x
    ``ranges`` contiguous ranges of ``rows`` rows (the last may be short,
    none is empty), one wave of R3_BLOCKS_PER_SM blocks an SM where the
    tiles allow it."""
    tiles = -(-c // R3_TILE)
    ranges = max(1, sms * R3_BLOCKS_PER_SM // tiles)
    rows = max(R3_MIN_ROWS, -(-n // ranges))
    return tiles, -(-n // rows), rows


#: (device index, stream) -> (partials, tickets) of reduce3: its last
#: block of a tile resets the tile's ticket, so the scratch is kept (the
#: calls on one stream are ordered) and grows with the largest call
_R3_SCRATCH: dict = {}


def _reduce3_scratch(dev, stream: int, floats: int, tiles: int):
    key = (dev.index, stream)
    part, tickets = _R3_SCRATCH.get(key, (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty(floats, dtype=torch.float32, device=dev)
    if tickets is None or tickets.numel() < tiles:
        tickets = torch.zeros(tiles, dtype=torch.int32, device=dev)
    _R3_SCRATCH[key] = part, tickets
    return part, tickets


def _f32(*shape, device):
    return torch.empty(shape, dtype=torch.float32, device=device)


def reduce3(dy, y, a3, mean3, rstd3):
    """dy, y, a3 (B, H, W, C); mean3, rstd3 (C,) -> (d3, S3 (2, C) f32)."""
    _check_maps("reduce3", dy=dy, y=y, a3=a3)
    c = dy.shape[-1]
    if mean3.shape != (c,) or rstd3.shape != (c,):
        raise ValueError(f"reduce3: mean3 and rstd3 must be ({c},), got "
                         f"{tuple(mean3.shape)} and {tuple(rstd3.shape)}")
    if dy.device.type == "cpu":
        return reduce3_plain(dy, y, a3, mean3, rstd3)
    _check_multiple_of_8("reduce3", C=c)
    (dy, y, a3, mean3, rstd3), lib, stream = _kernel_operands(
        "reduce3", (dy, y, a3), (mean3, rstd3), ())
    n = dy.numel() // c
    dev = dy.device
    tiles, ranges, rows = _reduce3_plan(n, c, _sm_count(dev.index))
    part, tickets = _reduce3_scratch(dev, stream, ranges * 2 * c, tiles)
    d3 = torch.empty_like(dy)
    s3 = _f32(2, c, device=dev)
    _build.check(lib.ieee_block_reduce3(
        dy.data_ptr(), y.data_ptr(), a3.data_ptr(), mean3.data_ptr(),
        rstd3.data_ptr(), d3.data_ptr(), s3.data_ptr(), part.data_ptr(),
        tickets.data_ptr(), n, c, ranges, rows, stream), "reduce3")
    LAUNCHES["reduce3"] += 1
    return d3, s3


def bn3_apply(d3, a3, a2, w3, v3, v2f):
    """d3, a3 (B, H, W, C), a2 (B, H, W, cm), w3 (cm, C), v3 (5, C),
    v2f (4, cm) -> (d2 (B, H, W, cm), S2 (2, cm) f32, dW3 (cm, C) f32)."""
    _check_maps("bn3_apply", d3=d3, a3=a3, a2=a2)
    c, cm = d3.shape[-1], a2.shape[-1]
    if a3.shape[-1] != c or tuple(w3.shape) != (cm, c):
        raise ValueError(f"bn3_apply: a3 (..., {c}) and w3 ({cm}, {c}) "
                         f"expected, got {tuple(a3.shape)}, "
                         f"{tuple(w3.shape)}")
    _check_rows("bn3_apply", c, v3=v3)
    _check_rows("bn3_apply", cm, v2f=v2f)
    if d3.device.type == "cpu":
        return bn3_apply_plain(d3, a3, a2, w3, v3, v2f)
    _check_multiple_of_8("bn3_apply", C=c, cm=cm)
    (d3, a3, a2, v3, v2f, w3), lib, stream = _kernel_operands(
        "bn3_apply", (d3, a3, a2), (v3, v2f), (w3,))
    n = d3.numel() // c
    dev = d3.device
    d2 = torch.empty_like(a2)
    s2, dw3 = _f32(2, cm, device=dev), _f32(cm, c, device=dev)
    spart = _f32(max(1, -(-n // _TILE)), 2, cm, device=dev)
    splits, rows = _bn3_plan(n, c, cm)
    wpart = _f32(splits, cm, c, device=dev) if splits > 1 else None
    _build.check(lib.ieee_block_bn3_apply(
        d3.data_ptr(), a3.data_ptr(), a2.data_ptr(), w3.data_ptr(),
        v3.data_ptr(), v2f.data_ptr(), d2.data_ptr(), s2.data_ptr(),
        dw3.data_ptr(), spart.data_ptr(),
        0 if wpart is None else wpart.data_ptr(), n, c, cm, splits, rows,
        stream), "bn3_apply")
    LAUNCHES["bn3_apply"] += 1
    return d2, s2, dw3


def conv2_bwd(d2, a2, a1, w2, v2, v1f):
    """d2, a2, a1 (B, H, W, cm), w2 (3, 3, cm, cm) (in, out), v2 (5, cm),
    v1f (4, cm) -> (d1 (B, H, W, cm), S1 (2, cm) f32, dW2 (3, 3, cm, cm)
    f32)."""
    _check_maps("conv2_bwd", d2=d2, a2=a2, a1=a1)
    b, h, w, cm = d2.shape
    if a2.shape != d2.shape or a1.shape != d2.shape \
            or tuple(w2.shape) != (3, 3, cm, cm):
        raise ValueError(f"conv2_bwd: maps (..., {cm}) and w2 (3, 3, {cm}, "
                         f"{cm}) expected, got {tuple(a1.shape)}, "
                         f"{tuple(w2.shape)}")
    _check_rows("conv2_bwd", cm, v2=v2, v1f=v1f)
    if d2.device.type == "cpu":
        return conv2_bwd_plain(d2, a2, a1, w2, v2, v1f)
    _check_multiple_of_8("conv2_bwd", cm=cm)
    (d2, a2, a1, v2, v1f, w2), lib, stream = _kernel_operands(
        "conv2_bwd", (d2, a2, a1), (v2, v1f), (w2,))
    n = b * h * w
    dev = d2.device
    d1 = torch.empty_like(a1)
    s1, dw2 = _f32(2, cm, device=dev), _f32(3, 3, cm, cm, device=dev)
    spart = _f32(max(1, -(-n // _TILE)), 2, cm, device=dev)
    splits, rows = _conv2_plan(n, cm)
    wpart = _f32(splits, 9 * cm, cm, device=dev) if splits > 1 else None
    # da2 and h1 as bf16 rows, written once and read by both products
    da2, h1 = torch.empty_like(d2), torch.empty_like(a1)
    _build.check(lib.ieee_block_conv2_bwd(
        d2.data_ptr(), a2.data_ptr(), a1.data_ptr(), w2.data_ptr(),
        v2.data_ptr(), v1f.data_ptr(), d1.data_ptr(), s1.data_ptr(),
        dw2.data_ptr(), spart.data_ptr(),
        0 if wpart is None else wpart.data_ptr(), da2.data_ptr(),
        h1.data_ptr(), b, h, w, cm, splits, rows, stream), "conv2_bwd")
    LAUNCHES["conv2_bwd"] += 1
    return d1, s1, dw2


def bn1_apply(d1, a1, x, d3, w1, v1):
    """d1, a1 (B, H, W, cm), x, d3 (B, H, W, cin), w1 (cin, cm), v1 (5, cm)
    -> (dx (B, H, W, cin), dW1 (cin, cm) f32)."""
    _check_maps("bn1_apply", d1=d1, a1=a1, x=x, d3=d3)
    cm, cin = d1.shape[-1], x.shape[-1]
    if a1.shape != d1.shape or d3.shape != x.shape \
            or tuple(w1.shape) != (cin, cm):
        raise ValueError(f"bn1_apply: a1 like d1, d3 like x and w1 ({cin}, "
                         f"{cm}) expected, got {tuple(a1.shape)}, "
                         f"{tuple(d3.shape)}, {tuple(w1.shape)}")
    _check_rows("bn1_apply", cm, v1=v1)
    if d1.device.type == "cpu":
        return bn1_apply_plain(d1, a1, x, d3, w1, v1)
    _check_multiple_of_8("bn1_apply", cin=cin, cm=cm)
    (d1, a1, x, d3, v1, w1), lib, stream = _kernel_operands(
        "bn1_apply", (d1, a1, x, d3), (v1,), (w1,))
    n = d1.numel() // cm
    dev = d1.device
    dx = torch.empty_like(x)
    dw1 = _f32(cin, cm, device=dev)
    splits, rows = _bn1_plan(n, cin, cm)
    wpart = _f32(splits, cin, cm, device=dev) if splits > 1 else None
    _build.check(lib.ieee_block_bn1_apply(
        d1.data_ptr(), a1.data_ptr(), x.data_ptr(), d3.data_ptr(),
        w1.data_ptr(), v1.data_ptr(), dx.data_ptr(), dw1.data_ptr(),
        0 if wpart is None else wpart.data_ptr(), n, cin, cm, splits, rows,
        stream), "bn1_apply")
    LAUNCHES["bn1_apply"] += 1
    return dx, dw1


# ----------------------------------------------------------------- forward

def _conv(x, k, padding=0):
    """(B, H, W, cin) x (kh, kw, cin, cout) -> (B, H, W, cout), the kernel
    cast to x's dtype; the NCHW view of an NHWC map is channels_last, so
    the convolution reads and writes it in place."""
    y = F.conv2d(x.permute(0, 3, 1, 2), k.to(x.dtype).permute(3, 2, 0, 1),
                 padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def _bn_train(a, scale, bias):
    """FastBatchNorm's train forward on (B, H, W, C): (out, mean, var,
    rstd) with f32 one-pass statistics and the normalisation in a's
    dtype."""
    af = a.float()
    mean = af.mean((0, 1, 2))
    var = (af * af).mean((0, 1, 2)) - mean * mean
    rstd = torch.rsqrt(var + EPS)
    inv = rstd * scale
    shift = bias - mean * inv
    return a * inv.to(a.dtype) + shift.to(a.dtype), mean, var, rstd


def _fwd_full(x, k1, s1, b1, k2, s2, b2, k3, s3, b3):
    """The train-mode forward, JAX ``_fwd_full``: (y, (mu1, var1, mu2,
    var2, mu3, var3), (a1, a2, a3), (rstd1, rstd2, rstd3)) with biased
    one-pass variances."""
    a1 = _conv(x, k1)
    o1, mu1, var1, r1 = _bn_train(a1, s1, b1)
    a2 = _conv(torch.relu(o1), k2, padding=1)
    o2, mu2, var2, r2 = _bn_train(a2, s2, b2)
    a3 = _conv(torch.relu(o2), k3)
    o3, mu3, var3, r3 = _bn_train(a3, s3, b3)
    y = torch.relu(o3 + x)
    return y, (mu1, var1, mu2, var2, mu3, var3), (a1, a2, a3), (r1, r2, r3)


# -------------------------------------------------------------- the train op

class _BottleneckTrain(torch.autograd.Function):
    """``ieee_tpu``'s ``bottleneck_train`` custom VJP (``_fwd``, ``_bwd``)."""

    @staticmethod
    def forward(ctx, x, k1, s1, b1, k2, s2, b2, k3, s3, b3, plain):
        y, stats, acts, rstds = _fwd_full(x, k1, s1, b1, k2, s2, b2, k3, s3,
                                          b3)
        mu1, _, mu2, _, mu3, _ = stats
        ctx.save_for_backward(x, *acts, y, k1, s1, b1, k2, s2, b2, k3, s3,
                              b3, mu1, rstds[0], mu2, rstds[1], mu3,
                              rstds[2])
        ctx.plain = plain
        ctx.mark_non_differentiable(*stats)
        return (y, *stats)

    @staticmethod
    def backward(ctx, dy, *_stat_cts):
        (x, a1, a2, a3, y, k1, s1, b1, k2, s2, b2, k3, s3, b3,
         mu1, rstd1, mu2, rstd2, mu3, rstd3) = ctx.saved_tensors
        fns = ((reduce3_plain, bn3_apply_plain, conv2_bwd_plain,
                bn1_apply_plain) if ctx.plain
               else (reduce3, bn3_apply, conv2_bwd, bn1_apply))
        k_reduce3, k_bn3, k_conv2, k_bn1 = fns
        dy = dy.to(x.dtype)  # the statistics carry no gradient
        n = x.numel() // x.shape[-1]
        inv1, inv2, inv3 = rstd1 * s1, rstd2 * s2, rstd3 * s3
        shift1, shift2 = b1 - mu1 * inv1, b2 - mu2 * inv2

        d3, sum3 = k_reduce3(dy, y, a3, mu3, rstd3)
        v3 = torch.stack([inv3, mu3, rstd3, sum3[0] / n, sum3[1] / n])
        v2f = torch.stack([inv2, shift2, mu2, rstd2])
        d2, sum2, dw3 = k_bn3(d3, a3, a2, k3[0, 0], v3, v2f)
        v2 = torch.stack([inv2, mu2, rstd2, sum2[0] / n, sum2[1] / n])
        v1f = torch.stack([inv1, shift1, mu1, rstd1])
        d1, sum1, dw2 = k_conv2(d2, a2, a1, k2, v2, v1f)
        v1 = torch.stack([inv1, mu1, rstd1, sum1[0] / n, sum1[1] / n])
        dx, dw1 = k_bn1(d1, a1, x, d3, k1[0, 0], v1)
        return (dx, dw1[None, None].to(k1.dtype), sum1[1], sum1[0],
                dw2.to(k2.dtype), sum2[1], sum2[0],
                dw3[None, None].to(k3.dtype), sum3[1], sum3[0], None)


def bottleneck_train(x, k1, s1, b1, k2, s2, b2, k3, s3, b3,
                     plain: bool = False):
    """Train-mode stride-1 bottleneck without downsample, whose backward is
    the four block kernels.

    x (B, H, W, cin) in the compute dtype (cin = C, the block's output
    width); k1 (1, 1, cin, cm), k2 (3, 3, cm, cm), k3 (1, 1, cm, C) f32
    masters; scales and biases (cm,) or (C,) f32. Returns (y (B, H, W, C),
    (mu1, var1, mu2, var2, mu3, var3)); the statistics feed the running
    averages and carry no gradient. ``plain`` runs the backward on the
    kernels' plain versions on any device (the reference the kernels are
    held to on the card).
    """
    y, *stats = _BottleneckTrain.apply(x, k1, s1, b1, k2, s2, b2, k3, s3,
                                       b3, bool(plain))
    return y, tuple(stats)
