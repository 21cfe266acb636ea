"""Eval-forward benchmark: the plain eval forward of the IEEE model
against the fused folded-BN head with the partpool kernel
(``models/fast_eval.py``, ``cfg.cuda.fused_eval``) and the w8a8 path with
the conv_s8 kernel (``models/int8_eval.py``, ``cfg.cuda.int8_eval``), on
one batch of uint8 triplets at 256x128 already on the device, random
weights.

Counterpart of ``tools/eval_fwd_bench.py``. Both paths run the same model
after the test transform, built as the JAX tool builds it: without
``fused_1x1`` (the config's default, ``cuda.fused_1x1``, off as in the JAX
package). So the "plain" line is the plain forward, the JAX tool's "plain
flax" line, and the "fused" line is the folded head with ``partpool``,
whose trunks launch no ``mm_affine``. ``--fused`` builds the model with
``fused_1x1=True``: both paths' layer4 1x1 sites then run the ``mm_affine``
kernel. The "int8 PTQ" line calibrates its activation scales on the
batch in its first (warm-up) call, then runs every trunk conv on conv_s8
and the head as the fused line. Each path is timed as the median of single
calls (CUDA events) after warm-up, then the features are compared: fused
against plain (max relative deviation), int8 against plain (cosine).

Usage: python -m ieee_tpu_torch.tools.eval_fwd_bench [batch] [--fused]
    [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ._timing import median_ms, parse_tool_args
from .profile_train import build_ieee

__all__ = ["run", "main"]


def run(batch: int = 100, device="cuda", height: int = 256,
        width: int = 128, backbone_layers=None, iters: int = 10,
        fused: bool = False) -> dict:
    from ..data.transforms import build_transforms
    from ..models.fast_eval import build_fast_ieee_eval_step
    from ..models.int8_eval import build_int8_ieee_eval_step

    device = torch.device(device)
    model = build_ieee(device, fused, 171, backbone_layers)
    print(f"trunks: fused_1x1={fused}", flush=True)
    _, tfm_te = build_transforms(height, width, transforms=None)
    rng = np.random.default_rng(0)
    imgs = tuple(torch.from_numpy(rng.integers(
        0, 256, (batch, height, width, 3), dtype=np.uint8)).to(device)
        for _ in range(3))

    fast = build_fast_ieee_eval_step(model, transform=tfm_te)
    int8 = build_int8_ieee_eval_step(model, transform=tfm_te)

    @torch.inference_mode()
    def plain(imgs):
        return model(tuple(tfm_te(m) for m in imgs))

    out = {}
    for name, fn in (("plain", plain), ("fused", fast), ("int8 PTQ", int8)):
        ms = median_ms(lambda: fn(imgs), iters, device=device)
        out[name] = ms
        print(f"{name}: {ms:.1f} ms/batch ({batch / ms * 1e3:.0f} "
              "triplets/s)", flush=True)
    a = plain(imgs).float()
    b = fast(imgs).float()
    q = int8(imgs).float()
    err = ((a - b).abs().max() / a.abs().max().clamp_min(1e-6)).item()
    print(f"max rel deviation fused vs plain: {err:.4f}")
    cos = (a * q).sum(-1) / (a.norm(dim=-1) * q.norm(dim=-1)).clamp_min(
        1e-12)
    print(f"int8 vs plain feature cosine: min {cos.min().item():.4f} "
          f"mean {cos.mean().item():.4f}")
    if not all(torch.isfinite(f).all() for f in (a, b, q)):
        raise AssertionError("eval features not finite")
    out["rel_dev"] = err
    out["int8_cos_min"] = cos.min().item()
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("batch", nargs="?", type=int, default=100)
    parser.add_argument("--fused", action="store_true",
                        help="build the model with fused_1x1 (layer4's 1x1 "
                             "sites on mm_affine in both paths; off by "
                             "default, as in the JAX tool)")
    args, device = parse_tool_args(parser, argv)
    return run(args.batch, device, fused=args.fused)


if __name__ == "__main__":
    main()
