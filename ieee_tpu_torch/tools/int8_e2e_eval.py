"""End-to-end int8 eval measurement: the engine's whole eval pipeline,
plain bf16 forward against the w8a8 path (``models/int8_eval.py``,
``cfg.cuda.int8_eval``: every trunk conv on the conv_s8 kernel), on the
same weights and the same ``synthetic_mm`` heldout split, through
``Engine._evaluate`` (threaded loader -> transform on the device ->
features -> distmat -> CMC/mAP). Records each path's wall time, the
forward ms per batch at the eval batch size (one batch already on the
device, CUDA events) and the mAP delta, and writes them to ``--out``.

Counterpart of ``tools/int8_e2e_eval.py`` with its arguments, except the
default ``--variant``: the int8 step covers the IEEE model with the full
head only (``supports_int8_eval``), so this tool runs ``full`` by default,
where the JAX tool's ``base`` takes the plain fallback on both rows. The
artifact says which path each row ran (``int8_path``). With
``--init-from`` (a port checkpoint: ``model.pth.tar-<n>`` or a state dict)
the mAP delta is measured on learned features; without it the mAP is near
chance (flagged in the artifact).

Usage: python -m ieee_tpu_torch.tools.int8_e2e_eval [--init-from PATH]
    [--pids 48] [--variant full] [--out log/int8_e2e/INT8_EVAL.json]
    [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import time

import numpy as np
import torch

from ._timing import device_line, median_ms, parse_tool_args

__all__ = ["run", "main"]

VARIANTS = {
    "base": dict(interaction=False, attention=False, using_REM=False),
    "cim": dict(interaction=True, attention=True, using_REM=False),
    "cim3m": dict(interaction=True, attention=True, using_REM=False),
    "full": {},
}


def run(device="cuda", init_from: str = "", pids: int = 48,
        imgs_per_pid: int = 32, variant: str = "full", batch: int = 100,
        fwd_iters: int = 10, out: str = "log/int8_e2e/INT8_EVAL.json",
        height: int = 256, width: int = 128, backbone_layers=None,
        workers: int = 2) -> dict:
    from ..data import ImageDataManager
    from ..engine import Image3MEngine
    from ..models import build_model
    from ..utils.checkpoint import load_pretrained_weights

    device = torch.device(device)
    dm = ImageDataManager(
        sources="synthetic_mm", height=height, width=width,
        batch_size_train=32, batch_size_test=batch, workers=workers,
        train_sampler="RandomIdentitySampler", num_instances=4,
        num_pids=pids, imgs_per_pid=imgs_per_pid, correlated=True,
        heldout_test=True, verbose=False, seed=0,
        transforms=["random_flip"])
    model_kw = dict(VARIANTS[variant])
    if backbone_layers is not None:
        model_kw["backbone_layers"] = tuple(backbone_layers)
    model = build_model("ieee3modalPart", num_classes=pids, loss="margin",
                        pretrained=False, device=device, **model_kw)
    if init_from:
        load_pretrained_weights(model, init_from)
    q = dm.test_loader["synthetic_mm"]["query"]
    g = dm.test_loader["synthetic_mm"]["gallery"]
    rng = np.random.default_rng(0)
    imgs = tuple(torch.from_numpy(rng.integers(
        0, 256, (batch, height, width, 3), dtype=np.uint8)).to(device)
        for _ in range(3))

    results = {}
    for tag, int8 in (("bf16", False), ("int8", True)):
        eng = Image3MEngine(dm, model, device=device, seed=0,
                            int8_eval=int8)
        # warm-up (the int8 step calibrates on its first batch), then time
        with contextlib.redirect_stdout(io.StringIO()):
            eng._evaluate(dataset_name="synthetic_mm", query_loader=q,
                          gallery_loader=g, ranks=(1, 5, 10))
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cmc, mAP = eng._evaluate(dataset_name="synthetic_mm",
                                     query_loader=q, gallery_loader=g,
                                     ranks=(1, 5, 10))
        pipeline_s = time.perf_counter() - t0
        # the forward alone at the eval batch size, loader excluded
        fwd_ms = median_ms(lambda: eng.extract_features(imgs), fwd_iters,
                           device=device)
        results[tag] = {
            "pipeline_wall_s": pipeline_s,
            "fwd_ms_per_batch": fwd_ms,
            "imgs_per_s": batch / (fwd_ms / 1e3),
            "mAP": float(mAP),
            "rank1": float(cmc[0]),
            "int8_path": hasattr(eng._eval_step_fn, "holder"),
        }
        print(tag, results[tag], flush=True)

    artifact = {
        "protocol": {
            "dataset": "synthetic_mm(correlated=True, heldout ids)",
            "pids": pids, "imgs_per_pid": imgs_per_pid,
            "eval_batch": batch, "variant": variant, "hw": [height, width],
            "backbone_layers": list(backbone_layers or (3, 4, 6, 3)),
            "init_from": init_from or "RANDOM INIT (mAP near chance)",
            "device": device_line(device),
            "pipeline": "Engine._evaluate: loader -> features -> device "
                        "distmat -> device CMC/mAP",
        },
        "trained_weights": bool(init_from),
        "bf16": results["bf16"],
        "int8": results["int8"],
        "fwd_speedup": (results["bf16"]["fwd_ms_per_batch"]
                        / results["int8"]["fwd_ms_per_batch"]),
        "pipeline_speedup": (results["bf16"]["pipeline_wall_s"]
                             / results["int8"]["pipeline_wall_s"]),
        "mAP_delta": results["int8"]["mAP"] - results["bf16"]["mAP"],
    }
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as fo:
            json.dump(artifact, fo, indent=1)
    print(json.dumps({k: artifact[k] for k in
                      ("fwd_speedup", "pipeline_speedup", "mAP_delta")}))
    return artifact


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--init-from", type=str, default="")
    ap.add_argument("--pids", type=int, default=48)
    ap.add_argument("--imgs-per-pid", type=int, default=32)
    ap.add_argument("--variant", type=str, default="full",
                    choices=sorted(VARIANTS),
                    help="must match the checkpoint's architecture; only "
                         "full takes the int8 path")
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--fwd-iters", type=int, default=10)
    ap.add_argument("--out", type=str, default="log/int8_e2e/INT8_EVAL.json")
    args, device = parse_tool_args(ap, argv)
    return run(device, args.init_from, args.pids, args.imgs_per_pid,
               args.variant, args.batch, args.fwd_iters, args.out)


if __name__ == "__main__":
    main()
