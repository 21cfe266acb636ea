#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ieee_tpu_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and ``nvcc``; it imports nothing of JAX or ``ieee_tpu``.

Phases (any failure raises and exits non-zero):

1. The card's name and power limit; the kernels' build (``nvcc`` for
   ``sm_90a``, one process per source) and its time.
2. Each kernel at the main path's shapes, plus ragged edges, against its
   plain PyTorch version on the same inputs (stated tolerance), with the
   median time of each over repeated launches (CUDA events).
3. The main path through the CLI, ``ieee_tpu_torch.main_multimodal``, with
   ``test.evaluate True`` on ``synthetic_mm`` at 256x128, batch 100,
   random weights: the launch counts are set to 0 just before and read
   just after, and every kernel must have launched.
4. The engine API at the benchmark's scale (171 pids: 170 query x 340
   gallery triplets), fused (kernels) and plain: eval triplets/s of each and
   the cosine between their features (>= 0.999).
5. The distmat at RGBNT201's 836 x 836 test size and at Market-1501 scale
   (3368 x 15913 x 2304).

The line before the last is the JSON list of kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "rgbnt_ieee_part_margin.yaml")

KERNELS = {
    "distmat": ("ieee_tpu_torch/csrc/distmat.cu",
                "ieee_tpu/ops/pallas/distmat.py:62"),
    "partpool": ("ieee_tpu_torch/csrc/partpool.cu",
                 "ieee_tpu/ops/pallas/partpool.py:84"),
    "mm_affine": ("ieee_tpu_torch/csrc/mm_affine.cu",
                  "ieee_tpu/ops/pallas/matmul_bn.py:346"),
}


def die(msg: str, code: int = 2):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(code)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def randn(shape, seed, scale=1.0):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal(shape, np.float32) * scale,
                        device="cuda")


def check_kernels(results):
    """Phase 2: every kernel at the main path's shapes vs its plain version."""
    import torch

    from ieee_tpu_torch.ops.kernels.distmat import (
        euclidean_sq, euclidean_sq_plain)
    from ieee_tpu_torch.ops.kernels.matmul_bn import (
        mm_affine_act, mm_affine_act_plain)
    from ieee_tpu_torch.ops.kernels.partpool import (
        fused_partpool_project, fused_partpool_project_plain)

    def record(name, shape, got, want, tol, ms, plain_ms):
        """``tol``: the allowed |got - want|, a number or a tensor."""
        diff = (got - want).abs()
        err = diff.max().item()
        ok = bool((diff <= tol).all())
        tol_s = (f"{tol:.3e}" if isinstance(tol, float)
                 else f"{tol.max().item():.3e} at most, elementwise")
        print(f"kernel {name} {shape}: max_abs_err {err:.3e} (tol {tol_s}) "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms"
              + ("" if ok else "  MISMATCH"))
        if not ok:
            raise AssertionError(f"{name} {shape} disagrees with its plain "
                                 f"version: max error {err}")
        r = results.setdefault(name, {"max_abs_err": 0.0, "cases": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["cases"].append({"shape": shape, "ms": ms, "plain_ms": plain_ms,
                           "max_abs_err": err})

    # distmat: full f32 against cuBLAS f32 (TF32 off); tolerance a few f32
    # ulps of the largest entry (the two sum K products in other orders)
    for m, n, k in ((836, 836, 2304), (170, 340, 2304), (37, 300, 19)):
        q, g = randn((m, k), 1).abs(), randn((n, k), 2).abs()
        got, want = euclidean_sq(q, g), euclidean_sq_plain(q, g)
        torch.cuda.synchronize()
        record("distmat", [m, n, k], got, want,
               1e-5 * want.abs().max().item(),
               median_ms(lambda: euclidean_sq(q, g)),
               median_ms(lambda: euclidean_sq_plain(q, g)))

    # partpool: the eval head's call (B=100, 16x8x2048 f32 map, P=6 with
    # overlapping stripes, 2048->768), a bf16 map and a ragged batch; the
    # pooled rows round to bf16 in both, so allow 1e-2 of the output scale
    for b, dtype in ((100, torch.float32), (100, torch.bfloat16),
                     (37, torch.float32)):
        x = randn((b, 16, 8, 2048), 3).abs().to(dtype)
        w = randn((2048, 768), 4, 2048 ** -0.5)
        s, t = randn((768,), 5).abs() + 0.5, randn((768,), 6)
        got = fused_partpool_project(x, w, s, t, parts=6)
        want = fused_partpool_project_plain(x, w, s, t, parts=6)
        torch.cuda.synchronize()
        record("partpool", [b, 16, 8, 2048, 768, str(dtype)[6:]], got, want,
               1e-2 * max(1.0, want.abs().max().item()),
               median_ms(lambda: fused_partpool_project(x, w, s, t, 6)),
               median_ms(lambda: fused_partpool_project_plain(x, w, s, t, 6)))

    # mm_affine: layer4's seven sites per trunk at batch 100 (16x8 map),
    # CIM and reduce (plain-head sites) and a ragged N; bf16 outputs may
    # differ by one bf16 step (2^-8 relative) where f32 sums differ
    n = 100 * 16 * 8
    for rows, k, c, relu in ((n, 1024, 512, True), (n, 512, 2048, False),
                             (n, 1024, 2048, False), (n, 2048, 512, True),
                             (n, 2048, 2048, True), (600, 2048, 768, True),
                             (1037, 2048, 768, True)):
        a = randn((rows, k), 7).to(torch.bfloat16)
        w = randn((k, c), 8, k ** -0.5)
        inv, shift = randn((c,), 9).abs() + 0.5, randn((c,), 10)
        got = mm_affine_act(a, w, inv, shift, relu).float()
        want = mm_affine_act_plain(a, w, inv, shift, relu).float()
        torch.cuda.synchronize()
        record("mm_affine", [rows, k, c, relu], got, want,
               2 ** -7 * want.abs().clamp_min(1.0),
               median_ms(lambda: mm_affine_act(a, w, inv, shift, relu)),
               median_ms(lambda: mm_affine_act_plain(a, w, inv, shift, relu)))


def main_path():
    """Phase 3: the CLI eval; returns the launch counts of its run."""
    from ieee_tpu_torch import main_multimodal
    from ieee_tpu_torch.ops import kernels

    argv = ["--config-file", CONFIG, "--device", "cuda",
            "model.pretrained", "False",
            "data.sources", "['synthetic_mm']",
            "data.targets", "['synthetic_mm']",
            "data.height", "256", "data.width", "128",
            "data.save_dir", os.path.join(ROOT, "log", "chip_smoke"),
            "test.evaluate", "True", "test.batch_size", "100"]
    kernels.reset_launch_counts()
    rank1 = main_multimodal.main(argv)
    counts = kernels.launch_counts()
    print(f"main path: rank1 {rank1:.4f}, launches {counts}")
    if not 0.0 <= rank1 <= 1.0:
        raise AssertionError(f"rank-1 {rank1} outside [0, 1]")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    return counts


def engine_eval():
    """Phase 4: fused vs plain eval at the benchmark's scale."""
    import torch

    from ieee_tpu_torch.data import ImageDataManager
    from ieee_tpu_torch.engine import Engine
    from ieee_tpu_torch.models import build_model
    from ieee_tpu_torch.ops import kernels
    from ieee_tpu_torch.ops.ranking import evaluate_rank
    from ieee_tpu_torch.ops.distance import compute_distance_matrix

    dm = ImageDataManager(sources="synthetic_mm", height=256, width=128,
                          batch_size_test=100, workers=4, num_pids=171,
                          imgs_per_pid=8, verbose=False)
    loaders = dm.test_loader["synthetic_mm"]
    feats, rates = {}, {}
    for name, fused in (("fused", True), ("plain", False)):
        model = build_model("ieee3modalPart", dm.num_train_pids, "margin",
                            pretrained=False, dtype="bfloat16", seed=1,
                            fused_1x1=fused).cuda()
        eng = Engine(dm, model, device="cuda", fused_eval=fused)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        qf, q_pids, q_cams = eng._feature_extraction(loaders["query"])
        gf, g_pids, g_cams = eng._feature_extraction(loaders["gallery"])
        host_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        # device rate: one batch of 100 already on the card, steady state
        batch = next(iter(loaders["gallery"]))["img"]
        imgs = tuple(torch.from_numpy(m).cuda() for m in batch)
        ms = median_ms(lambda: eng.extract_features(imgs), iters=10)
        rates[name] = 100 / (ms / 1e3)
        distmat = compute_distance_matrix(qf, gf)
        cmc, mAP = evaluate_rank(distmat, q_pids, g_pids, q_cams, g_cams)
        f = torch.cat([qf, gf])
        if not torch.isfinite(f).all() or f.shape != (510, 2304):
            raise AssertionError(f"{name} features bad: {tuple(f.shape)}")
        feats[name] = f
        print(f"engine eval {name}: {rates[name]:.1f} triplets/s on the card "
              f"(batch 100, {ms:.3f} ms/batch); 510 triplets incl. host "
              f"decode {host_s:.3f} s; mAP {mAP:.4f} rank1 {cmc[0]:.4f}; "
              f"launches {counts}")
        del model, eng
        torch.cuda.empty_cache()
    a, b = feats["fused"], feats["plain"]
    cos = (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1)).clamp_min(1e-12)
    print(f"engine eval fused vs plain: min cosine {cos.min().item():.6f}, "
          f"mean {cos.mean().item():.6f}")
    if cos.min().item() < 0.999:
        raise AssertionError(f"fused and plain features disagree: cosine "
                             f"{cos.min().item()}")


def distmat_scale(results):
    """Phase 5: the distmat at Market-1501 scale."""
    import torch

    from ieee_tpu_torch.ops.kernels.distmat import (
        euclidean_sq, euclidean_sq_plain)

    q, g = randn((3368, 2304), 11).abs(), randn((15913, 2304), 12).abs()
    got, want = euclidean_sq(q, g), euclidean_sq_plain(q, g)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 1e-5 * want.abs().max().item()
    ms = median_ms(lambda: euclidean_sq(q, g), iters=5)
    plain_ms = median_ms(lambda: euclidean_sq_plain(q, g), iters=5)
    print(f"kernel distmat [3368, 15913, 2304]: max_abs_err {err:.3e} (tol "
          f"{tol:.3e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    if err > tol:
        raise AssertionError(f"distmat at Market scale: {err} > {tol}")
    results["distmat"]["cases"].append(
        {"shape": [3368, 15913, 2304], "ms": ms, "plain_ms": plain_ms,
         "max_abs_err": err})


def main():
    try:
        import torch
    except ImportError:
        die("torch is not installed")
    if not torch.cuda.is_available():
        die("no CUDA device: this smoke runs the port on a card only")
    sys.path.insert(0, ROOT)
    try:
        import ieee_tpu_torch
    except ImportError:
        ieee_tpu_torch = None
    if ieee_tpu_torch is None or not os.path.abspath(
            ieee_tpu_torch.__file__).startswith(ROOT + os.sep):
        die(f"ieee_tpu_torch not found next to {__file__}: run from the root "
            "of a checkout")
    from ieee_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    _build.load_library()
    print(f"kernel build: {_build.build_seconds():.2f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or line.startswith("=="):
            print("  " + line.strip())

    results: dict = {}
    t0 = time.perf_counter()
    check_kernels(results)
    print(f"phase kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = main_path()
    print(f"phase main path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    engine_eval()
    print(f"phase engine eval: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    distmat_scale(results)
    print(f"phase distmat scale: {time.perf_counter() - t0:.1f} s")

    # the reported time of each kernel: distmat at 836x836 (RGBNT201 test),
    # partpool at the head's f32 call, mm_affine summed over the seven
    # layer4 calls of one trunk at batch 100
    def main_case(name):
        cases = results[name]["cases"]
        if name == "mm_affine":
            per_trunk = [c for c in cases if c["shape"][0] == 12800
                         and c["shape"][1:3] != [2048, 2048]]
            weight = {(1024, 512): 1, (512, 2048): 3, (1024, 2048): 1,
                      (2048, 512): 2}
            ms = sum(weight[tuple(c["shape"][1:3])] * c["ms"]
                     for c in per_trunk)
            plain = sum(weight[tuple(c["shape"][1:3])] * c["plain_ms"]
                        for c in per_trunk)
            return ms, plain
        return cases[0]["ms"], cases[0]["plain_ms"]

    line = {"kernels": []}
    for name, (source, replaces) in KERNELS.items():
        ms, plain_ms = main_case(name)
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": results[name]["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms})
    print(card_line())
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
