"""Profile the IEEE train step and print the device time by kernel.

Counterpart of ``tools/profile_train.py``, at bench.py's protocol: batch
128 of ``synthetic_mm`` at 256x128 (171 pids, 4 instances), one fixed
batch already on the device, SGD (lr 0.001, momentum 0.9, wd 5e-4), the
model built as the JAX tool builds it: without ``fused_1x1``, the config's
default (``cuda.fused_1x1``, off as in the JAX package), so every 1x1
conv+BN site runs through cuDNN and BatchNorm. ``--fused`` builds it with
``fused_1x1=True`` instead: layer4's 1x1 sites, CIM and the reduce layer
then run the fused train kernels (``mm_stats``, ``mm_bn_da``,
``mm_bn_dw``; 33 launches of each per step). It prints wall-clock
steps/s over ``--steps`` steps after 3 warm-up steps (host clock around
steps ending in a sync), then the ``torch.profiler`` table over 3 more
steps: device ms per step, the busy
share of the profiled wall time, and the top ``--top`` kernels by device
time. ``--trace-dir`` also writes the profiled steps as a Chrome trace
(none by default). The JAX tool's ``--option`` (XLA compiler flags) has no
CUDA meaning and is not taken.

On the CPU (``--device cpu``) the table holds CPU operator times, not
device kernels.

Usage: python -m ieee_tpu_torch.tools.profile_train [batch] [--steps N]
    [--top N] [--trace-dir DIR] [--fused] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ._timing import parse_tool_args

__all__ = ["build_ieee", "profile_steps", "run", "main"]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build_ieee(device, fused: bool = False, num_pids: int = 171,
               backbone_layers=None):
    """The tools' IEEE3modalPart (margin loss, random weights from seed 0)
    on ``device``, with ``fused_1x1=fused``; ``backbone_layers`` cuts the
    trunks' depth (the tests' small model)."""
    from ..models import build_model

    extra = {} if backbone_layers is None else {
        "backbone_layers": tuple(backbone_layers)}
    return build_model("ieee3modalPart", num_pids, "margin",
                       pretrained=False, device=device, seed=0,
                       fused_1x1=fused, **extra)


def profile_steps(step, n: int = 2, top: int = 12, device="cuda",
                  trace_dir: str = ""):
    """torch.profiler over ``n`` calls of ``step``: (device ms per step, the
    busy share of the profiled wall time, the top ``top`` rows as (name,
    launches per step, ms per step)). On the CPU the rows are CPU
    operators. ``trace_dir`` also writes a Chrome trace there."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    kind = (torch.autograd.DeviceType.CUDA if cuda
            else torch.autograd.DeviceType.CPU)
    _sync(device)
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        for _ in range(n):
            step()
        _sync(device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

    def self_us(e):
        return e.self_device_time_total if cuda else e.self_cpu_time_total

    # user-annotated ranges (the optimizer's step) span kernels that are
    # counted on their own
    rows = [e for e in prof.key_averages() if e.device_type == kind
            and not getattr(e, "is_user_annotation", False)]
    dev = sum(self_us(e) for e in rows) / 1e3  # us -> ms
    rows.sort(key=lambda e: -self_us(e))
    table = [(e.key, e.count // n, self_us(e) / 1e3 / n) for e in rows[:top]]
    return dev / n, dev / wall_ms, table


def run(batch: int = 128, steps: int = 10, top: int = 60,
        trace_dir: str = "", device="cuda", height: int = 256,
        width: int = 128, num_pids: int = 171, backbone_layers=None,
        profile_n: int = 3, fused: bool = False) -> dict:
    """Build the model (``build_ieee``) and engine, time ``steps`` train
    steps after 3 warm-up steps, then profile ``profile_n`` steps and print
    the table."""
    from ..data import ImageDataManager
    from ..engine import Image3MEngine
    from ..optim import build_lr_scheduler, build_optimizer

    device = torch.device(device)
    dm = ImageDataManager(
        sources="synthetic_mm", height=height, width=width,
        batch_size_train=batch, batch_size_test=100, workers=0,
        train_sampler="RandomIdentitySampler", num_instances=4,
        num_pids=num_pids, imgs_per_pid=8, verbose=False, seed=0)
    model = build_ieee(device, fused, num_pids, backbone_layers)
    opt = build_optimizer(model, optim="sgd", lr=0.001, momentum=0.9,
                          weight_decay=5e-4)
    sched = build_lr_scheduler("multi_step", stepsize=[20, 40],
                               base_lr=0.001)
    eng = Image3MEngine(dm, model, opt, sched, device=device, seed=0,
                        margin=1.0)
    imgs, pids = eng._put_batch(next(iter(dm.train_loader)))

    def step():
        return eng.train_step(imgs, pids)

    print(f"path: {'fused' if fused else 'plain'} (fused_1x1={fused}); "
          "warming up ...", flush=True)
    for _ in range(3):
        step()
    _sync(device)
    print("warm; timing ...", flush=True)
    t0 = time.perf_counter()
    for _ in range(steps):
        m = step()
    loss = m["loss"].item()  # syncs on the last step
    dt = time.perf_counter() - t0
    print(f"steady state: {steps / dt:.3f} steps/s, "
          f"{steps * batch / dt:.1f} triplets/s, "
          f"{dt / steps * 1e3:.1f} ms/step, last loss {loss:.4f}",
          flush=True)

    dev_ms, busy, table = profile_steps(step, profile_n, top, device,
                                        trace_dir)
    what = "device" if device.type == "cuda" else "cpu operator"
    print(f"\n{what} total over the profile: {dev_ms * profile_n:.1f} ms "
          f"({dev_ms:.1f} ms/step), busy {busy:.3f} of the profiled wall "
          "time")
    print(f"{'kernel' if device.type == 'cuda' else 'op':<72} "
          f"{'ms/step':>9} {'count':>6} {'avg_us':>9}")
    for name, count, ms in table:
        print(f"{name[:72]:<72} {ms:>9.3f} {count:>6} "
              f"{ms * 1e3 / max(count, 1):>9.1f}")
    if device.type == "cuda":  # the fused 1x1 sites' kernels, by name
        for name, count, ms in table:
            if any(k in name for k in ("mm_stats", "mm_bn_da", "mm_bn_dw")):
                short = name.replace("(anonymous namespace)::", "")
                print(f"fused 1x1 kernel {short.split('(')[0]}: {ms:.3f} "
                      f"ms/step over {count} launches")
    return {"steps_per_s": steps / dt, "triplets_per_s": steps * batch / dt,
            "loss": loss, "ms_per_step": dev_ms, "busy": busy,
            "table": table}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("batch", nargs="?", type=int, default=128)
    parser.add_argument("--trace-dir", default="",
                        help="write a Chrome trace of the profiled steps "
                             "here (none by default)")
    parser.add_argument("--top", type=int, default=60)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--fused", action="store_true",
                        help="build the model with fused_1x1 (the fused "
                             "train kernels; off by default, as in the JAX "
                             "tool)")
    args, device = parse_tool_args(parser, argv)
    return run(batch=args.batch, steps=args.steps, top=args.top,
               trace_dir=args.trace_dir, device=device, fused=args.fused)


if __name__ == "__main__":
    main()
