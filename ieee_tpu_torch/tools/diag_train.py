"""Training-dynamics diagnostic: per-module gradient and parameter norms
and logit statistics, on real engine train steps.

Counterpart of ``tools/diag_train.py``. Every ``--diag-every`` steps it
prints one JSON line for the step about to be taken, from that step's own
forward and backward (the JAX tool runs a separate jitted pass on the same
batch, parameters and augmentation key, which gives the same numbers): the
loss terms, the global gradient norm, each modality's logit std and
largest |logit|, and the gradient and parameter norms of each top-level
module of the classifier, fc, backbone and reduce families (their JAX
names: ``classifier_R``, ``fc_R``, ``backbone_R``, ``reduce_0``, ...),
taken before the optimizer's update. It tells "the CE gradient vanishes
into the classifier" (classifier gradients ~ 0, logits ~ 0) from "the CE
gradient is healthy but the trunk ignores it".

The JAX tool's flags and defaults carry over; ``--device`` (default cuda;
``cpu`` runs the plain PyTorch versions) takes the place of ``--cpu``. Its
decode cache is not ported yet (ROADMAP A.4): the loader decodes every
batch, which changes the speed and nothing that is printed.

Usage: python -m ieee_tpu_torch.tools.diag_train [--steps 200]
    [--diag-every 25] [--pids 48 --imgs-per-pid 32] [--variant full]
    [--backbone-layers 1,1,1,1] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import torch

from ..data import ImageDataManager
from ..engine import Image3MEngine
from ..engine.engine import named_units
from ..models import build_model
from ..optim import build_lr_scheduler, build_optimizer, set_lr
from ._timing import parse_tool_args
from .train_e2e import VARIANTS

__all__ = ["main"]

_FAMILIES = ("classifier", "fc", "backbone", "reduce")


def _norm(tensors) -> float:
    sq = [t.detach().float().square().sum() for t in tensors]
    return torch.stack(sq).sum().sqrt().item() if sq else 0.0


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--diag-every", type=int, default=25)
    ap.add_argument("--pids", type=int, default=48)
    ap.add_argument("--imgs-per-pid", type=int, default=32)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--backbone-layers", type=str, default="")
    ap.add_argument("--optim", type=str, default="amsgrad")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--weight-m", type=float, default=1.0)
    ap.add_argument("--variant", type=str, default="full",
                    choices=sorted(VARIANTS))
    args, device = parse_tool_args(ap, argv)

    model_kw, keep_m = VARIANTS[args.variant]
    model_kw = dict(model_kw)
    if not keep_m:
        args.weight_m = 0.0
    if args.backbone_layers:
        model_kw["backbone_layers"] = tuple(
            int(x) for x in args.backbone_layers.split(","))
    dm = ImageDataManager(
        sources="synthetic_mm", height=args.height, width=args.width,
        batch_size_train=args.batch, batch_size_test=100, workers=2,
        train_sampler="RandomIdentitySampler", num_instances=4,
        num_pids=args.pids, imgs_per_pid=args.imgs_per_pid, correlated=True,
        verbose=False, seed=0, transforms=["random_flip"])
    model = build_model("ieee3modalPart", num_classes=args.pids,
                        loss="margin", pretrained=False, device=device,
                        seed=0, **model_kw)
    opt = build_optimizer(model, optim=args.optim, lr=args.lr, momentum=0.9,
                          weight_decay=5e-4)
    sched = build_lr_scheduler("multi_step", stepsize=[10 ** 6],
                               base_lr=args.lr)
    eng = Image3MEngine(dm, model, opt, sched, device=device, margin=1.0,
                        weight_m=args.weight_m, seed=0)
    set_lr(opt, args.lr)
    groups = [(n, list(u.parameters())) for n, u in named_units(model)
              if n.split("_")[0] in _FAMILIES]

    seen = {}
    model.register_forward_hook(
        lambda mod, inp, out: seen.update(out=out) if seen.get("on") else None)
    real_step = opt.step

    def step_with_norms(*a, **kw):
        # the gradients and parameters of this step, before the update
        if seen.get("on"):
            seen["grad_norm"] = _norm(p.grad for p in model.parameters())
            seen["g"] = {n: _norm(p.grad for p in ps) for n, ps in groups}
            seen["p"] = {n: _norm(ps) for n, ps in groups}
        return real_step(*a, **kw)

    opt.step = step_with_norms
    records, step = [], 0
    while step < args.steps:
        for data in dm.train_loader:
            if step >= args.steps:
                break
            seen.clear()
            seen["on"] = step % args.diag_every == 0
            metrics = eng.train_step(*eng._put_batch(data))
            if seen["on"]:
                rec = {"step": step,
                       **{k: round(float(v), 4) for k, v in metrics.items()
                          if k != "loss"},
                       "loss": round(float(metrics["loss"]), 5),
                       "grad_norm": round(seen["grad_norm"], 5)}
                for m in "RNT":
                    lg = seen["out"][f"logits_{m}"].detach().float()
                    rec[f"logit_std_{m}"] = round(lg.std(unbiased=False)
                                                  .item(), 5)
                    rec[f"logit_absmax_{m}"] = round(lg.abs().max().item(),
                                                     5)
                for n in sorted(seen["g"]):
                    rec[f"g:{n}"] = round(seen["g"][n], 6)
                    rec[f"p:{n}"] = round(seen["p"][n], 4)
                print(json.dumps(rec), flush=True)
                records.append(rec)
            step += 1
    return records


if __name__ == "__main__":
    main()
