"""IEEE ablation sweep: a few train steps of each ablation variant.

Counterpart of ``tools/ablation_sweep.py`` (the paper's Table 3): trains
(a) the 3-branch base, (b) +CIM and (d) the full IEEE (+CIM+CA+REM) for a
few steps each on one fixed batch of ``synthetic_mm`` at 256x128 (171
pids, 4 instances, SGD lr 0.001, momentum 0.9, wd 5e-4; the margin engine
with weight_m 1, as the JAX tool: ablation (c), +CIM+3M, is how (b) trains
here too) and records triplets/s and the loss trajectory of each: 3
warm-up steps, then ``steps`` timed ones (host clock, ending in a sync),
the loss every 5. The model is built as the JAX tool builds it, without
``fused_1x1`` (the reference's plain path); ``--fused`` builds it with
the fused 1x1 train kernels instead. One JSON line per variant goes to
stdout, and the list to ``--out`` (``log/ABLATION.json``; the JAX tool
writes ``ABLATION.json`` in the working directory, the JAX package's
record).

Usage: python -m ieee_tpu_torch.tools.ablation_sweep [batch] [steps]
    [--fused] [--out PATH] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time

import torch

from ..data import ImageDataManager
from ..engine import Image3MEngine
from ..models import build_model
from ..optim import build_lr_scheduler, build_optimizer
from ._timing import parse_tool_args

__all__ = ["VARIANTS", "run_variant", "main"]

VARIANTS = (
    ("a_base", dict(interaction=False, attention=False, using_REM=False)),
    ("b_cim", dict(interaction=True, attention=True, using_REM=False)),
    ("d_full", dict(interaction=True, attention=True, using_REM=True)),
)


def run_variant(name, batch, steps, device="cuda", fused=False,
                height=256, width=128, num_pids=171, backbone_layers=None,
                **model_flags) -> dict:
    """Time ``steps`` train steps of one variant after 3 warm-up steps;
    returns (and prints) its record."""
    device = torch.device(device)
    dm = ImageDataManager(
        sources="synthetic_mm", height=height, width=width,
        batch_size_train=batch, batch_size_test=100, workers=0,
        train_sampler="RandomIdentitySampler", num_instances=4,
        num_pids=num_pids, imgs_per_pid=8, verbose=False, seed=0)
    extra = {} if backbone_layers is None else {
        "backbone_layers": tuple(backbone_layers)}
    model = build_model("ieee3modalPart", num_classes=num_pids,
                        loss="margin", pretrained=False, device=device,
                        seed=0, fused_1x1=fused, **model_flags, **extra)
    opt = build_optimizer(model, optim="sgd", lr=0.001, momentum=0.9,
                          weight_decay=5e-4)
    sched = build_lr_scheduler("multi_step", stepsize=[20, 40],
                               base_lr=0.001)
    eng = Image3MEngine(dm, model, opt, sched, device=device, margin=1.0,
                        seed=0)
    imgs, pids = eng._put_batch(next(iter(dm.train_loader)))

    losses = []
    for _ in range(3):  # warm-up
        losses.append(eng.train_step(imgs, pids)["loss"].item())
    t0 = time.perf_counter()
    for i in range(steps):
        m = eng.train_step(imgs, pids)
        if (i + 1) % 5 == 0:
            losses.append(m["loss"].item())
    m["loss"].item()  # syncs on the last step
    dt = time.perf_counter() - t0
    rec = {
        "variant": name,
        "flags": model_flags,
        "fused_1x1": bool(fused),
        "triplets_per_sec": round(steps * batch / dt, 1),
        "ms_per_step": round(dt / steps * 1e3, 1),
        "loss_first": round(losses[0], 4),
        "loss_last": round(losses[-1], 4),
        "losses": [round(x, 4) for x in losses],
    }
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("batch", nargs="?", type=int, default=128)
    parser.add_argument("steps", nargs="?", type=int, default=15)
    parser.add_argument("--fused", action="store_true",
                        help="build the models with fused_1x1 (the fused "
                             "train kernels; off by default, as in the JAX "
                             "tool)")
    parser.add_argument("--out", default=osp.join("log", "ABLATION.json"))
    args, device = parse_tool_args(parser, argv)
    out = []
    for name, flags in VARIANTS:
        out.append(run_variant(name, args.batch, args.steps, device,
                               args.fused, **flags))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if osp.dirname(args.out):
        os.makedirs(osp.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
