"""Eval-forward benchmark: the plain eval forward of the IEEE model
against the fused folded-BN head with the partpool kernel
(``models/fast_eval.py``, ``cfg.cuda.fused_eval``), on one batch of
uint8 triplets at 256x128 already on the device, random weights.

Counterpart of ``tools/eval_fwd_bench.py``. Both paths run the same model
(built with ``fused_1x1``: its layer4 1x1 sites on the ``mm_affine``
kernel, which the config leaves off by default, ``cuda.fused_1x1``) after
the test transform; each is timed as the median of single calls (CUDA
events) after warm-up, then the two features are compared. The JAX tool's
third path, the int8 PTQ eval (``models/int8_eval.py``), is not ported yet
(ROADMAP A.7); the tool says so on a line of its own.

Usage: python -m ieee_tpu_torch.tools.eval_fwd_bench [batch]
    [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ._timing import median_ms, parse_tool_args

__all__ = ["run", "main"]


def run(batch: int = 100, device="cuda", height: int = 256,
        width: int = 128, backbone_layers=None, iters: int = 10) -> dict:
    from ..data.transforms import build_transforms
    from ..models import build_model
    from ..models.fast_eval import build_fast_ieee_eval_step

    device = torch.device(device)
    extra = {} if backbone_layers is None else {
        "backbone_layers": tuple(backbone_layers)}
    model = build_model("ieee3modalPart", 171, "margin", pretrained=False,
                        device=device, seed=0, fused_1x1=True, **extra)
    _, tfm_te = build_transforms(height, width, transforms=None)
    rng = np.random.default_rng(0)
    imgs = tuple(torch.from_numpy(rng.integers(
        0, 256, (batch, height, width, 3), dtype=np.uint8)).to(device)
        for _ in range(3))

    fused = build_fast_ieee_eval_step(model, transform=tfm_te)

    @torch.inference_mode()
    def plain(imgs):
        return model(tuple(tfm_te(m) for m in imgs))

    out = {}
    for name, fn in (("plain", plain), ("fused", fused)):
        ms = median_ms(lambda: fn(imgs), iters, device=device)
        out[name] = ms
        print(f"{name}: {ms:.1f} ms/batch ({batch / ms * 1e3:.0f} "
              "triplets/s)", flush=True)
    print("int8 PTQ: not ported yet (ROADMAP A.7)")
    a = plain(imgs).float()
    b = fused(imgs).float()
    err = ((a - b).abs().max() / a.abs().max().clamp_min(1e-6)).item()
    print(f"max rel deviation fused vs plain: {err:.4f}")
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("eval features not finite")
    out["rel_dev"] = err
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("batch", nargs="?", type=int, default=100)
    args, device = parse_tool_args(parser, argv)
    return run(args.batch, device)


if __name__ == "__main__":
    main()
