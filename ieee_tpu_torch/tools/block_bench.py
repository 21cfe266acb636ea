"""Time the block backward's three product kernels at the block path's
stages and, with ``--step``, the fused+block train step's device time.

``conv2_bwd``, ``bn1_apply`` and ``bn3_apply`` (``ops/kernels/block_bwd.py``)
run at layer1-3 of a batch-128 step at 256x128 (6, 9 and 15 blocks per
step over the three trunks) on random bf16 maps made on the device from a
seed. Per call: the median of ``--iters`` timings of 10 calls queued back
to back (CUDA events), then each device kernel's ms per call from
``torch.profiler`` over 5 calls; then the per-step totals. With
``--step``: the train step at bench.py's protocol with ``cuda.fused_1x1``
and ``cuda.block_megakernel`` on (``chip_smoke.py`` phase 7's setup),
device ms per step from two profiles of 2 steps after 3 warm-up steps,
with the block kernels' rows and the ``mm_stats`` kernel's.

It reaches the kernels only through the wrappers' public names, so a copy
of this file placed in another checkout of the port (the parent commit's,
say) times that checkout's kernels when run from its root: that is how a
change is compared with its parent in one run on one card.

On the CPU (``--device cpu``) it times the plain versions with the host
clock (no device metric) at ``--batch`` images; ``--step`` needs a card.

Usage: python -m ieee_tpu_torch.tools.block_bench [--batch 128]
    [--iters 15] [--step] [--device cuda]
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from ..ops.kernels import block_bwd as bb
from ._timing import parse_tool_args

__all__ = ["STAGES", "bench", "step_profile", "main"]

#: (H, W, C, cm, blocks per step over the three trunks) of layer1-3
STAGES = ((64, 32, 256, 64, 6), (32, 16, 512, 128, 9),
          (16, 8, 1024, 256, 15))
# the block kernels' rows in a profile, old and new names, and the fused
# 1x1 forward's (mm_stats_kernel, mm_stats_sm90)
_BLOCK_KEYS = ("Bn3Op", "Conv2Op", "conv2_prep", "Bn1Op", "bn3_d2",
               "bn3_dw", "tgemm_kernel", "rows_gemm_kernel", "reduce3",
               "mm_stats")


def _queued_ms(fn, device, iters: int) -> float:
    """Median ms per call of 10 calls queued back to back (CUDA events),
    or of single calls by the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    torch.cuda.synchronize(device)
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 10)
    return statistics.median(times)


def _kernel_ms(fn, calls: int = 5):
    """[(device kernel, ms per call)] by torch.profiler, largest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / calls)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def _short(key: str) -> str:
    return key.replace("(anonymous namespace)::", "").replace(
        "void ", "").split("(")[0]


def bench(device, batch: int = 128, iters: int = 15) -> dict:
    """Time the three kernels at each stage; returns {kernel: ms per step}
    (queued calls x blocks) and prints the per-call lines."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    def vrows(ch, k):
        return torch.stack([rnd(ch).abs() + 0.5, 0.5 * rnd(ch),
                            0.1 * rnd(ch), rnd(ch).abs() + 0.5,
                            0.1 * rnd(ch)][:k])

    totals = {"conv2_bwd": 0.0, "bn1_apply": 0.0, "bn3_apply": 0.0}
    for h, w, c, cm, blocks in STAGES:
        bf16 = torch.bfloat16
        d2, a2, a1, d1 = (rnd(batch, h, w, cm).to(bf16) for _ in range(4))
        x, d3, a3 = (rnd(batch, h, w, c).to(bf16) for _ in range(3))
        v, vf, v3 = vrows(cm, 5), vrows(cm, 4), vrows(c, 5)
        w2 = rnd(3, 3, cm, cm) * (9 * cm) ** -0.5
        w1, w3 = rnd(c, cm) * c ** -0.5, rnd(cm, c) * cm ** -0.5
        calls = {
            "conv2_bwd": lambda: bb.conv2_bwd(d2, a2, a1, w2, v, vf),
            "bn1_apply": lambda: bb.bn1_apply(d1, a1, x, d3, w1, v),
            "bn3_apply": lambda: bb.bn3_apply(d3, a3, a2, w3, v3, vf)}
        for name, fn in calls.items():
            ms = _queued_ms(fn, device, iters)
            totals[name] += blocks * ms
            line = (f"{h}x{w} C {c} cm {cm} x{blocks}: {name} {ms:.4f} "
                    f"ms per call queued")
            if device.type == "cuda":
                line += "; " + ", ".join(
                    f"{_short(k)} {t:.4f}" for k, t in _kernel_ms(fn)[:4])
            print(line, flush=True)
    print("per step (30 blocks), queued: " + ", ".join(
        f"{k} {t:.4f} ms" for k, t in totals.items()), flush=True)
    return totals


def step_profile(device, profiles: int = 2) -> list:
    """The fused+block train step at batch 128 (chip_smoke.py phase 7's
    setup): [(device ms per step, {block kernel key: ms per step})], one
    per profile of 2 steps."""
    from ..data import ImageDataManager
    from ..engine import Image3MEngine
    from ..models import build_model
    from ..optim import build_lr_scheduler, build_optimizer
    from .profile_train import profile_steps

    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("--step measures device time: it needs a card")
    dm = ImageDataManager(
        sources="synthetic_mm", height=256, width=128, batch_size_train=128,
        batch_size_test=100, workers=4, train_sampler="RandomIdentitySampler",
        num_instances=4, num_pids=171, imgs_per_pid=8, verbose=False,
        seed=0)
    model = build_model("ieee3modalPart", 171, "margin", pretrained=False,
                        dtype="bfloat16", seed=1, fused_1x1=True,
                        block_megakernel=True)
    opt = build_optimizer(model, optim="sgd", lr=0.001, momentum=0.9,
                          weight_decay=5e-4)
    sched = build_lr_scheduler("multi_step", stepsize=[20, 40],
                               base_lr=0.001)
    eng = Image3MEngine(dm, model, opt, sched, device="cuda", seed=0,
                        margin=1.0)
    imgs, pids = eng._put_batch(next(iter(dm.train_loader)))
    for _ in range(3):
        eng.train_step(imgs, pids)
    torch.cuda.synchronize()
    out = []
    for _ in range(profiles):
        dev_ms, busy, rows = profile_steps(
            lambda: eng.train_step(imgs, pids), top=1000)
        blk = {}
        for key, _, ms in rows:
            for k in _BLOCK_KEYS:
                if k in key:
                    blk[k] = blk.get(k, 0.0) + ms
        print(f"fused+block step: {dev_ms:.3f} device ms per step, busy "
              f"{busy:.3f}; " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in blk.items()),
              flush=True)
        out.append((dev_ms, blk))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--iters", type=int, default=15)
    parser.add_argument("--step", action="store_true",
                        help="also profile the fused+block train step")
    args, device = parse_tool_args(parser, argv)
    bench(device, args.batch, args.iters)
    if args.step:
        step_profile(device)


if __name__ == "__main__":
    main()
