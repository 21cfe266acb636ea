"""Eval-forward benchmark: the plain eval forward of the IEEE model
against the fused folded-BN head with the partpool kernel
(``models/fast_eval.py``, ``cfg.cuda.fused_eval``), on one batch of
uint8 triplets at 256x128 already on the device, random weights.

Counterpart of ``tools/eval_fwd_bench.py``. Both paths run the same model
after the test transform, built as the JAX tool builds it: without
``fused_1x1`` (the config's default, ``cuda.fused_1x1``, off as in the JAX
package). So the "plain" line is the plain forward, the JAX tool's "plain
flax" line, and the "fused" line is the folded head with ``partpool``,
whose trunks launch no ``mm_affine``. ``--fused`` builds the model with
``fused_1x1=True``: both paths' layer4 1x1 sites then run the ``mm_affine``
kernel. Each path is timed as the median of single calls (CUDA events)
after warm-up, then the two features are compared. The JAX tool's third
path, the int8 PTQ eval (``models/int8_eval.py``), is not ported yet
(ROADMAP A.7); the tool says so on a line of its own.

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

    device = torch.device(device)
    model = build_ieee(device, fused, 171, backbone_layers)
    print(f"trunks: fused_1x1={fused}", flush=True)
    _, tfm_te = build_transforms(height, width, transforms=None)
    rng = np.random.default_rng(0)
    imgs = tuple(torch.from_numpy(rng.integers(
        0, 256, (batch, height, width, 3), dtype=np.uint8)).to(device)
        for _ in range(3))

    fast = build_fast_ieee_eval_step(model, transform=tfm_te)

    @torch.inference_mode()
    def plain(imgs):
        return model(tuple(tfm_te(m) for m in imgs))

    out = {}
    for name, fn in (("plain", plain), ("fused", fast)):
        ms = median_ms(lambda: fn(imgs), iters, device=device)
        out[name] = ms
        print(f"{name}: {ms:.1f} ms/batch ({batch / ms * 1e3:.0f} "
              "triplets/s)", flush=True)
    print("int8 PTQ: not ported yet (ROADMAP A.7)")
    a = plain(imgs).float()
    b = fast(imgs).float()
    err = ((a - b).abs().max() / a.abs().max().clamp_min(1e-6)).item()
    print(f"max rel deviation fused vs plain: {err:.4f}")
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("eval features not finite")
    out["rel_dev"] = err
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
