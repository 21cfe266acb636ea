"""Optimizers and LR schedulers on ``torch.optim``.

Counterpart of ``ieee_tpu/optim/__init__.py`` (reference
``torchreid/optim/optimizer.py:11-157``, ``lr_scheduler.py:7-68``), with the
JAX package's optax semantics:

- weight decay is L2 into the gradient before the moments (torch's own
  SGD/Adam convention and optax's ``add_decayed_weights`` first in the
  chain), on every parameter;
- sgd is ``torch.optim.SGD`` (its momentum buffer starts at the first
  gradient, as optax's ``trace`` starting from zeros; nesterov alike); adam
  is ``torch.optim.Adam``;
- amsgrad and rmsprop follow optax where ``torch.optim`` differs: optax's
  amsgrad keeps the running maximum of the BIAS-CORRECTED second moment, and
  its ``scale_by_rms`` divides by ``sqrt(nu + eps)`` from a zero start;
- the learning rate is set per epoch by the engine from
  ``build_lr_scheduler``'s ``lr(epoch)``; with ``staged_lr`` each param
  group carries its ``lr_mult``.

radam comes later (ROADMAP A.8).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
from torch import nn

AVAI_OPTIMS = ["adam", "amsgrad", "sgd", "rmsprop", "radam"]
AVAI_SCH = ["single_step", "multi_step", "cosine"]

__all__ = ["build_optimizer", "build_lr_scheduler", "set_lr", "AMSGrad",
           "RMSprop", "AVAI_OPTIMS", "AVAI_SCH"]


class AMSGrad(torch.optim.Optimizer):
    """optax ``add_decayed_weights`` + ``scale_by_amsgrad``: the running
    maximum is taken over the bias-corrected second moment."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g.add(p, alpha=group["weight_decay"])
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                    st["nu_max"] = torch.zeros_like(p)
                st["step"] += 1
                t = st["step"]
                st["mu"].mul_(b1).add_(g, alpha=1 - b1)
                st["nu"].mul_(b2).addcmul_(g, g, value=1 - b2)
                torch.maximum(st["nu_max"], st["nu"] / (1 - b2 ** t),
                              out=st["nu_max"])
                upd = (st["mu"] / (1 - b1 ** t)) / (
                    st["nu_max"].sqrt() + group["eps"])
                p.add_(upd, alpha=-group["lr"])


class RMSprop(torch.optim.Optimizer):
    """optax ``add_decayed_weights`` + ``scale_by_rms`` (eps inside the
    square root, second moment from 0) [+ ``trace`` momentum]."""

    def __init__(self, params, lr, alpha=0.99, eps=1e-8, momentum=0.0,
                 weight_decay=0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps,
                                      momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if group["weight_decay"]:
                    g = g.add(p, alpha=group["weight_decay"])
                st = self.state[p]
                if not st:
                    st["nu"] = torch.zeros_like(p)
                    if group["momentum"]:
                        st["trace"] = torch.zeros_like(p)
                a = group["alpha"]
                st["nu"].mul_(a).addcmul_(g, g, value=1 - a)
                upd = g / (st["nu"] + group["eps"]).sqrt()
                if group["momentum"]:
                    upd = st["trace"].mul_(group["momentum"]).add_(upd)
                p.add_(upd, alpha=-group["lr"])


def _param_groups(model: nn.Module, staged_lr, new_layers, base_lr_mult):
    """All parameters in one group, or with ``staged_lr`` two: parameters
    under a top-level module whose name contains one of ``new_layers`` at
    the full rate, the rest at ``base_lr_mult`` of it (reference
    ``optimizer.py:78-145``; the JAX package matches the same names)."""
    if not staged_lr:
        return [{"params": list(model.parameters()), "lr_mult": 1.0}]
    new_layers = ([new_layers] if isinstance(new_layers, str)
                  else list(new_layers))
    new, base = [], []
    for name, p in model.named_parameters():
        top = name.split(".", 1)[0]
        (new if any(nl in top for nl in new_layers) else base).append(p)
    return [{"params": new, "lr_mult": 1.0},
            {"params": base, "lr_mult": float(base_lr_mult)}]


def build_optimizer(model: nn.Module, optim: str = "adam",
                    lr: float = 0.0003, weight_decay: float = 5e-4,
                    momentum: float = 0.9, sgd_dampening: float = 0.0,
                    sgd_nesterov: bool = False, rmsprop_alpha: float = 0.99,
                    adam_beta1: float = 0.9, adam_beta2: float = 0.999,
                    staged_lr: bool = False,
                    new_layers: Sequence[str] = ("classifier",),
                    base_lr_mult: float = 0.1,
                    **kwargs) -> torch.optim.Optimizer:
    """A ``torch.optim`` optimizer over ``model``'s parameters, with the
    JAX package's ``build_optimizer`` keywords (``optimizer_kwargs``)."""
    if optim not in AVAI_OPTIMS:
        raise ValueError(f"Unsupported optimizer: {optim} (one of "
                         f"{AVAI_OPTIMS})")
    groups = _param_groups(model, staged_lr, new_layers, base_lr_mult)
    for g in groups:
        g["lr"] = lr * g["lr_mult"]
    wd = weight_decay or 0.0
    betas = (adam_beta1, adam_beta2)
    if optim == "sgd":
        if sgd_dampening:
            # as the JAX package (optax.trace has no dampening)
            raise NotImplementedError("sgd dampening != 0 not supported")
        return torch.optim.SGD(groups, lr=lr, momentum=momentum or 0.0,
                               nesterov=bool(sgd_nesterov and momentum),
                               weight_decay=wd)
    if optim == "adam":
        return torch.optim.Adam(groups, lr=lr, betas=betas, eps=1e-8,
                                weight_decay=wd)
    if optim == "amsgrad":
        return AMSGrad(groups, lr=lr, betas=betas, eps=1e-8, weight_decay=wd)
    if optim == "rmsprop":
        return RMSprop(groups, lr=lr, alpha=rmsprop_alpha, eps=1e-8,
                       momentum=momentum or 0.0, weight_decay=wd)
    raise NotImplementedError(
        "optim radam (ieee_tpu/optim/radam.py) is not ported yet: "
        "ROADMAP A.8")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the epoch's rate on every param group (times its ``lr_mult``)."""
    for g in optimizer.param_groups:
        g["lr"] = lr * g.get("lr_mult", 1.0)


def build_lr_scheduler(lr_scheduler: str = "single_step", stepsize=1,
                       gamma: float = 0.1, max_epoch: int = 1,
                       base_lr: float = 0.0003,
                       **kwargs) -> Callable[[int], float]:
    """Returns ``lr(epoch) -> float`` (reference ``lr_scheduler.py:38-68``),
    stepped per epoch."""
    if lr_scheduler not in AVAI_SCH:
        raise ValueError(f"Unsupported scheduler: {lr_scheduler} (one of "
                         f"{AVAI_SCH})")
    if lr_scheduler == "single_step":
        if isinstance(stepsize, (list, tuple)):
            stepsize = stepsize[-1]
        if not isinstance(stepsize, int):
            raise TypeError(f"stepsize must be an int, got {type(stepsize)}")
        step = int(stepsize)
        return lambda epoch: base_lr * (gamma ** (epoch // step))
    if lr_scheduler == "multi_step":
        if not isinstance(stepsize, (list, tuple)):
            raise TypeError(f"stepsize must be a list, got {type(stepsize)}")
        milestones = sorted(int(s) for s in stepsize)
        return lambda epoch: base_lr * (
            gamma ** sum(1 for m in milestones if epoch >= m))
    return lambda epoch: 0.5 * base_lr * (
        1 + math.cos(math.pi * epoch / max_epoch))
