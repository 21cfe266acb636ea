#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ieee_tpu_torch``) on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and ``nvcc``; it imports nothing of JAX or ``ieee_tpu``.

Phases (any failure raises and exits non-zero):

1. The card's name and power limit; the kernels' build (``nvcc`` for
   ``sm_90a``, one process per source) and its time, each kernel's
   registers, and the registers, spills and ptxas warnings of each
   instance of the Hopper kernels (``csrc/mm_bn_train.cu`` and
   ``csrc/mm_affine.cu`` on ``csrc/mm_sm90.cuh``, ``csrc/mm_bn_bwd.cu``,
   ``csrc/bn_gemm_sm90.cu``, ``csrc/block_bwd_sm90.cu``; names demangled
   where ``c++filt`` is found), spilling instances named once more, and
   each distinct ptxas performance note with its count.
2. Each kernel at the main paths' shapes, plus ragged edges, against its
   plain PyTorch version on the same inputs (stated tolerance), with the
   median time of each over repeated launches (CUDA events), the time of
   the PyTorch library call that computes the same product, and the
   least time the card could take (bytes over 3.35 TB/s or operations over
   the type's peak, whichever is larger). ``distmat`` runs at RGBNT201's
   836 x 836, the engine eval's 170 x 340 and the CLI eval's 16 x 32 (K
   2304), a ragged K, and splits over K with an odd m + n (1 x 128, 837 x
   836), each twice (bit for bit), also queued, with its
   3xTF32 bound (the kernel's three TF32 products) and the f32-core one.
   ``partpool`` runs at the eval head's call (a batch of 100, the
   16x8x2048 map in f32, P 6, F 768), with a bf16 map, at batches of 37,
   129 and 1, and on a 5x3 map with P 8, C 64 and F 40, each twice (bit
   for bit), the first two also queued. ``mm_affine`` runs at the 21
   layer4 sites of an eval batch of 100 (7 per trunk), the CIM and reduce
   shapes, a ragged N and a ragged N, K and C, each twice (bit for bit),
   the batch's sites also with 10 calls queued, with a table of its times
   per site class of the batch and its per-trunk line. The train kernels
   run at the 33 fused sites of one train step at batch 128 (layer4, CIM,
   reduce), the CIM site at batch 8, the reduce site at N = 8 and 48, a
   ragged N and a ragged N, K and C, each twice (bit for bit), the step's
   sites also queued, with a table of each one's times per site class of
   the step beside the library call and the bound and ``mm_stats``'s
   per-step line; then the whole ``mm_bn_act_train`` op, forward and
   backward, against its plain version. The four block kernels run at the
   three stages the block path takes in a batch-128 step (layer1-3: 6, 9
   and 15 blocks per step over the three trunks), at layer4's width 512
   and at a ragged batch (``reduce3`` also at a ragged batch on a 7x5 map
   at C 8, 264 and 1032, and at C 264 over 16384 rows), the three product
   kernels (``bn3_apply``,
   ``conv2_bwd``, ``bn1_apply``) also with 10 calls queued, with a table
   of their times per stage and their per-step lines; then the whole
   ``bottleneck_train`` op against ``plain=True``.
   The probes' kernels run at the tools' shapes: ``scale_bf16`` on an
   (8192, 8192) bf16 array at both tile heights and a ragged one (bit for
   bit, also queued), ``probe_mm_stats`` (the ``mm_stats`` kernel) and
   ``bn_mm`` at 16384 x 2048 x 2048 and a ragged N, ``bn_mm`` also queued.
3. The eval path through the CLI, ``ieee_tpu_torch.main_multimodal``, with
   ``test.evaluate True`` on ``synthetic_mm`` at 256x128, batch 100,
   random weights: the launch counts are set to 0 just before and read
   just after, and every eval kernel must have launched.
4. The engine's eval at the benchmark's scale (171 pids: 170 query x 340
   gallery triplets), fused (kernels) and plain: eval triplets/s of each and
   the cosine between their features (>= 0.999).
5. The distmat at Market-1501 scale (3368 x 15913 x 2304): against its
   plain version, and on q's first 500 rows both against float64 (the
   kernel's error at most twice the plain version's plus 2^-23 of the
   largest entry); the kernel's, the plain version's and ``addmm``'s times
   beside the 3xTF32 and f32-core bounds; the mAP and CMC of the rankings
   by the kernel's and the plain distmat (printed).
6. The training path through the CLI: the headline config trains one epoch
   on ``synthetic_mm`` at 256x128, batch 8 (the config's), random weights,
   then evaluates. Counts set to 0 just before, read just after: the six
   kernels of that path must launch, the train kernels a multiple of 33
   times, no block kernel, and the epoch's loss must be finite. Then the
   same with ``cuda.block_megakernel True``: the block kernels 30 times
   per step, the train kernels 33.
7. The engine's train step at ``bench.py``'s protocol (batch 128, 171 pids,
   one fixed batch on the card, 3 warm-up and 20 timed steps), fused
   (kernels, 33 launches of each train kernel per step), fused+block (the
   same with ``block_megakernel``: also 30 launches of each block kernel)
   and plain: train triplets/s, peak device memory and a
   ``torch.profiler`` summary by kernel (both fused paths: also the
   ``mm_stats`` kernel's device ms by name; fused+block: ``reduce3``'s
   device ms and those of the product kernels of each of ``bn3_apply``,
   ``conv2_bwd`` (with its operand pass) and ``bn1_apply``); and the
   first step of each kernel path, from the same weights and batch, must
   agree with the plain one (loss, and every gradient tensor's cosine).
8. The measurement tools (``ieee_tpu_torch/tools/``), each tool's
   ``main()`` in-process at its defaults on the card (``profile_train``
   with ``--steps 3``), and ``profile_train`` and ``eval_fwd_bench`` also
   with ``--fused``, launch counts set to 0 just before each and read
   just after: ``bw_probe`` must launch ``scale_bf16``, ``fusion_probe``
   ``mm_stats`` and ``bn_mm``, ``profile_train`` no train kernel at its
   default (the reference's plain path) and the train kernels (33 per
   step) with ``--fused``, ``eval_bench`` the distmat, ``eval_fwd_bench``
   partpool and no mm_affine at its default, both with ``--fused``,
   ``block_bench`` the three block product kernels, ``mm_bench`` the
   four 1x1 kernels, ``kernel_bench`` the distmat, ``scale_bf16``,
   ``reduce3`` and ``partpool`` (per call, queued and device times),
   ``rerank_bench`` (``--reps 1``, Market-1501 scale) the distmat,
   ``jaccard_minsum`` and ``gnn_propagate``. They print the bandwidth and
   matmul rates the card reaches.
9. Ablation train: the ablation configs through the CLI at 256x128 and
   full depth with ``cuda.fused_1x1 True``, on ``synthetic_mm`` cut to 8
   ids x 4 images (4 steps of batch 8 an epoch), random weights. Counts
   set to 0 before each run and read after it, and read around each
   epoch: ``configs/rgbnt_base_softmax.yaml`` (no CIM, CA or REM; the
   softmax engine) for 2 epochs with ``train.fixbase_epoch 1`` (its
   ``open_layers``, the classifiers): over the fixbase epoch every frozen
   parameter and every frozen BN's running statistics, the fused sites'
   among them, must stay bit for bit and no frozen parameter may gain an
   SGD moment; each epoch's train-kernel launches must equal what the
   code implies (``fused_sites``: the model's fused 1x1 sites per forward,
   times the steps and micro-batches; no backward reaches a fused site
   while only the classifiers are open). Then a resume of that run from
   its last checkpoint for one more epoch: it must start at epoch 3 from
   the checkpoint's weights and optimizer state. Then
   ``configs/rgbnt_cim_softmax.yaml`` for 1 epoch with ``data.k_tfm 2
   train.accum_steps 2`` (two micro-batches of 8 a step). Last,
   ``ablation_sweep --fused`` at batch 128 with 5 timed steps a variant:
   each variant's triplets/s, and the launches its sites imply.
10. Single-modal and Market configs, counts set to 0 just before the
   phase: ``configs/market1501_softmax_r50.yaml`` through
   ``python -m ieee_tpu_torch.main``'s ``main()`` at full width and depth
   (resnet50, 256x128, batch 32, adam) on ``synthetic`` (Market-1501 is not
   on the machine), one epoch of 4 steps and its eval: the single-modal
   engine, ``distmat`` launched at K = 2048, no fused 1x1, partpool or
   block kernel; its train step timed at phase 7's protocol (one fixed
   batch of 32 on the card, 3 warm-up and 20 timed steps, host clock
   ending in a sync): images/s, peak memory and a ``torch.profiler``
   summary (device ms a step, busy share, top kernels). Then
   ``configs/market_mm_margin.yaml`` through the CLI with
   ``cuda.fused_1x1 True cuda.fused_eval True`` on a
   ``market1501_to_RGBNT201`` tree of jpegs written from a seed (8 ids x 4
   images a split: 4 steps of batch 8), then its eval: the six kernels as
   in phase 6 (33 launches of each train kernel a step, no block
   kernel). Last, the distmat as in phase 5 at Market-1501's 3368 x 15913
   with resnet50's K = 2048 and at 836 x 836 with resnet18's K = 512; the
   rankings by the kernel's and the plain distmat may differ in at most
   two queries (mAP and each CMC rank within 2 / m).

11. The int8 eval path (``cuda.int8_eval``), counts set to 0 just before
   each run and read just after. (a) ``conv_s8`` at every distinct conv
   site of ResNet-50 at 256x128 (last_stride 1, batch 100: the IEEE
   trunk's 22 shapes, weighted by their count in one trunk's 53 sites),
   at the shapes the feature extractor's resnet50 (last_stride 2, batch
   32) adds and at resnet18's basic-block shapes (batch 4): the raw s32
   sums must equal the plain version's exactly and the bf16 output be
   within one bf16 step of it; the kernel's, the plain version's and cuDNN's
   bf16 ``conv2d`` times (a different function: the yardstick) beside the
   bound (operations over 1,979 TOP/s or bytes over 3.35 TB/s), and
   ``torch._int_mm``'s at the 1x1 sites. (b) The engine's eval of the
   full-width IEEE model (seeded weights built once) on phase 4's
   ``synthetic_mm``, plain, fused and int8 at batch 100: finite int8
   features; a per-row cosine of at least 0.999 against the same int8
   path on ``conv_s8``'s plain version with the same scales; the cosine and
   the mAP against the plain path (printed); one steady batch launches 159
   ``conv_s8`` (53 sites x 3 trunks) and 6 ``partpool`` kernels and no
   cuDNN conv (no ``F.conv2d`` call, no conv kernel in its profile); the
   three paths' ms a batch (phase 4's way). (c) ``FeatureExtractor
   ("resnet50", int8=True)`` at batch 32 against its plain path: finite,
   53 ``conv_s8`` launches, the cosine printed. (d) ``int8_probe`` and
   ``int8_e2e_eval`` at small iteration counts, each launching
   ``conv_s8``.
12. Re-ranking. (a) The headline config's eval through the CLI as in
   phase 3 (no fused flag) with ``test.rerank True``, counts set to 0 just
   before and read just after: 3 ``distmat`` and 1 ``jaccard_minsum``
   launches and no other kernel, the device path taken (n = 48 > k1 + 1),
   and the re-ranked distmat within rtol 1e-4, atol 1e-5 of the numpy
   oracle on the same distmats pulled to the host. (b) k-reciprocal
   re-ranking at Market-1501 scale (3368 x 15913) on seeded 2304-d
   features clustered by 750 ids: f32 and bf16 min-sum timed (host clock
   ending in a sync), one ``jaccard_minsum`` launch a call, the peak memory
   above the distmats, mAP and rank-1 before and after, a profile of one
   call; ``jaccard_minsum`` on that call's membership vectors against its
   plain version (1e-5; bf16 on 256 query rows), twice bit for bit, with
   the kernel's and the plain version's times beside the bound (the bytes,
   and the dense form's (min, add) pairs at 16.75e12 a second). (c) GNN
   re-ranking at Market-1501 scale (k1 26, k2 7, 512-d): the GNN CLI
   (``tools/gnn_rerank_cli``) on a pickle of seeded features, counts set to
   0 just before and read just after: 2 ``gnn_propagate`` launches and no
   other kernel, each row of the ranking a permutation; both propagation
   forms timed, a profile of one call; ``gnn_propagate`` at the call's
   shape against its plain version (1e-6), twice bit for bit, with its
   times beside the bound.
13. Eval reporting, on a ``market1501_to_RGBNT201`` tree written as in
   phase 10. (a) ``configs/market_mm_margin.yaml``'s eval through the CLI
   (no fused flag) with ``test.visrank True test.visrank_topk 5`` at full
   width and depth, counts set to 0 just before and read just after:
   ``distmat`` launched and no other kernel; one strip per query entry, of
   the size ``visualize_ranked_results`` implies; the t-SNE scatter
   written, or skipped and why (matplotlib and scikit-learn are
   optional). Then the same eval with ``cuhk03.use_metric_cuhk03 True``:
   its CMC finite, non-decreasing and within [0, 1], its mAP within [0, 1].
   (b) The eval's distmat, on the card, through ``evaluate_rank`` on the
   device, numpy and native (C++) paths: all three within 1e-6. (c)
   ``tools/visualize_actmap``'s ``main()`` on the card for RGB, NI and TI:
   one PNG per query image, ``height x (3 * width + 20) x 3``, the model's
   parameters on the card. (d) ``tools/rank_speed_test`` at Market-1501's
   3368 x 15913 (one call each): its times and the native build's seconds;
   the three within 1e-6. (e) ``tools/parse_test_res`` on (a)'s log
   directory reads back the mAP and rank-1 that (a) printed.

Each phase prints its seconds, and the run its total. The line before the
last is the JSON list of kernels; the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "rgbnt_ieee_part_margin.yaml")
# phase 10: the single-modal baseline and the multi-modal Market config
MARKET_R50 = os.path.join(ROOT, "configs", "market1501_softmax_r50.yaml")
MARKET_MM = os.path.join(ROOT, "configs", "market_mm_margin.yaml")

KERNELS = {
    "distmat": ("ieee_tpu_torch/csrc/distmat.cu",
                "ieee_tpu/ops/pallas/distmat.py:62"),
    "partpool": ("ieee_tpu_torch/csrc/partpool.cu",
                 "ieee_tpu/ops/pallas/partpool.py:84"),
    "mm_affine": ("ieee_tpu_torch/csrc/mm_affine.cu",
                  "ieee_tpu/ops/pallas/matmul_bn.py:346"),
    "mm_stats": ("ieee_tpu_torch/csrc/mm_bn_train.cu",
                 "ieee_tpu/ops/pallas/matmul_bn.py:107"),
    "mm_bn_da": ("ieee_tpu_torch/csrc/mm_bn_bwd.cu",
                 "ieee_tpu/ops/pallas/matmul_bn.py:180"),
    "mm_bn_dw": ("ieee_tpu_torch/csrc/mm_bn_bwd.cu",
                 "ieee_tpu/ops/pallas/matmul_bn.py:223"),
    "reduce3": ("ieee_tpu_torch/csrc/block_bwd.cu",
                "ieee_tpu/ops/pallas/block_bwd.py:316"),
    "bn3_apply": ("ieee_tpu_torch/csrc/bn_gemm_sm90.cu",
                  "ieee_tpu/ops/pallas/block_bwd.py:332"),
    "conv2_bwd": ("ieee_tpu_torch/csrc/block_bwd_sm90.cu",
                  "ieee_tpu/ops/pallas/block_bwd.py:351"),
    "bn1_apply": ("ieee_tpu_torch/csrc/block_bwd_sm90.cu",
                  "ieee_tpu/ops/pallas/block_bwd.py:371"),
    # one kernel, the probe's body at its two block heights
    "scale_bf16": ("ieee_tpu_torch/csrc/probes.cu",
                   "tools/bw_probe.py:66, tools/bw_probe.py:89"),
    "bn_mm": ("ieee_tpu_torch/csrc/bn_gemm_sm90.cu",
              "tools/fusion_probe.py:129"),
    # no Pallas kernel: the JAX int8 path's s8 conv is XLA's (_conv_nhwc)
    "conv_s8": ("ieee_tpu_torch/csrc/conv_s8.cu",
                "ieee_tpu/models/int8_eval.py:122"),
    # no Pallas kernels: XLA runs the JAX re-rankers' min-sum and gather-sum
    "jaccard_minsum": ("ieee_tpu_torch/csrc/rerank.cu",
                       "ieee_tpu/ops/rerank_device.py:109"),
    "gnn_propagate": ("ieee_tpu_torch/csrc/rerank.cu",
                      "ieee_tpu/ops/gnn_rerank.py:98"),
}
EVAL_KERNELS = ("distmat", "partpool", "mm_affine")
TRAIN_KERNELS = ("mm_stats", "mm_bn_da", "mm_bn_dw")
BLOCK_KERNELS = ("reduce3", "bn3_apply", "conv2_bwd", "bn1_apply")
# the block kernels whose two products run on the shared Hopper bodies
# (csrc/bn_gemm_sm90.cuh), with what names their device kernels in a
# profile: the Op of their product instances, and conv2_bwd's operand pass
# (not the small in-order sum kernels)
BLOCK_PRODUCTS = (("bn3_apply", ("Bn3Op",)),
                  ("conv2_bwd", ("Conv2Op", "conv2_prep")),
                  ("bn1_apply", ("Bn1Op",)))
# phase 8: each tool's arguments (besides --device cuda), the kernels it
# must launch and those it must not (fusion_probe's probe_mm_stats runs on
# mm_stats: PERF.md row 13 is row 4's kernel). profile_train and
# eval_fwd_bench measure the reference's plain path by default (no fused
# 1x1 site: no train kernel, no mm_affine) and the fused one with --fused
TOOLS = (("bw_probe", [], ("scale_bf16",), ()),
         ("fusion_probe", [], ("mm_stats", "bn_mm"), ()),
         ("bw_probe2", [], (), ()),
         ("roofline_probe", [], (), ()),
         ("profile_train", ["--steps", "3"], (), TRAIN_KERNELS),
         ("profile_train", ["--steps", "3", "--fused"], TRAIN_KERNELS, ()),
         ("eval_bench", [], ("distmat",), ()),
         ("eval_fwd_bench", [], ("partpool",), ("mm_affine",)),
         ("eval_fwd_bench", ["--fused"], ("partpool", "mm_affine"), ()),
         ("loader_bench", [], (), ()),
         ("block_bench", [], ("conv2_bwd", "bn1_apply", "bn3_apply"), ()),
         ("mm_bench", ["--iters", "3"], ("mm_stats", "mm_affine",
                                        "mm_bn_da", "mm_bn_dw"), ()),
         ("kernel_bench", ["--iters", "10"], ("distmat", "scale_bf16",
                                              "reduce3", "partpool"), ()),
         ("rerank_bench", ["--reps", "1"], ("distmat", "jaccard_minsum",
                                            "gnn_propagate"), ()))
# blocks on the block path per train step (10 per trunk, 3 trunks)
BLOCKS_PER_STEP = 30
# phase 11: conv sites of one ResNet-50 trunk, and the two int8 tools with
# their arguments (besides --device cuda) and the kernels they must launch
INT8_SITES = 53
INT8_TOOLS = (("int8_probe", ["--iters", "3"], ("conv_s8",), ()),
              ("int8_e2e_eval", ["--pids", "16", "--imgs-per-pid", "4",
                                 "--fwd-iters", "3", "--out",
                                 os.path.join(ROOT, "log", "chip_smoke_int8",
                                              "INT8_EVAL.json")],
               ("conv_s8", "partpool", "distmat"), ()))
# phase 12: Market-1501's test split (query, gallery, test ids) and the
# re-rankers' settings (the engine's k-reciprocal defaults, GNN's)
MARKET_Q, MARKET_G, MARKET_IDS = 3368, 15913, 750
RERANK_K1, RERANK_K2 = 20, 6
GNN_K1, GNN_K2 = 26, 7
# phase 13: the strips' depth, and the activation maps' modalities
VISRANK_TOPK = 5
ACTMAP_MODALS = ("RGB", "NI", "TI")
# phase 9: the ablation configs, and the short synthetic set they train on
# (8 ids x 4 images: 4 steps of the configs' batch 8 an epoch)
ABLATION = {name: os.path.join(ROOT, "configs", f"rgbnt_{name}_softmax.yaml")
            for name in ("base", "cim")}
ABLATION_DATA = {"num_pids": 8, "imgs_per_pid": 4}
# least cosine between a fused and a plain step's gradient tensor (phase
# 7): bf16 rounding noise in the early trunk layers' gradients at batch 128
# (measured on an H100: 0.84 fused vs plain; each bf16 path against the f32
# step is printed beside it)
GRAD_COS = 0.8

# the fused 1x1 sites of one train step at batch 128 and of an eval batch
# of 100 (N, K, C, relu, sites) are TRAIN_SITES and EVAL_SITES of
# ieee_tpu_torch/ops/kernels/matmul_bn.py
# checked but outside the per-step sums: CIM and reduce at the config's
# batch 8, a ragged N, and a ragged N, K and C (off the forward kernels'
# 128-row tile, 64-deep step and 256-wide tile)
TRAIN_EXTRA = ((1024, 2048, 2048, True, 0), (8, 2048, 768, True, 0),
               (48, 2048, 768, True, 0), (1037, 1024, 2048, False, 0),
               (1037, 264, 264, True, 0))
# checked but outside the per-batch sums: the CIM and reduce shapes; the
# layer4 cb1 sites of phase 3's CLI eval (query and gallery batches of 16
# and 32 images: N = 2048 and 4096, the 64- and 128-wide tiles); CIM and
# reduce at the config's batch 8; a ragged N, and a ragged N, K and C
EVAL_EXTRA = ((12800, 2048, 2048, True, 0), (600, 2048, 768, True, 0),
              (4096, 1024, 512, True, 0), (4096, 2048, 512, True, 0),
              (2048, 1024, 512, True, 0), (2048, 2048, 512, True, 0),
              (1024, 2048, 2048, True, 0), (8, 2048, 768, True, 0),
              (48, 2048, 768, True, 0), (1037, 2048, 768, True, 0),
              (129, 40, 264, False, 0))
# the block path's stages in one train step at batch 128 (256x128 input):
# (B, H, W, C, cm, blocks per step over the three trunks)
BLOCK_SITES = ((128, 64, 32, 256, 64, 6),    # layer1.1-2
               (128, 32, 16, 512, 128, 9),   # layer2.1-3
               (128, 16, 8, 1024, 256, 15))  # layer3.1-5
# checked but outside the per-step sums: layer4's width 512 (not selected;
# the kernels have no width limit) and a ragged batch
BLOCK_EXTRA = ((128, 16, 8, 2048, 512, 0), (3, 16, 8, 256, 64, 0))
# reduce3 also at (B, H, W, C): a ragged batch on an odd map (B = 3 at 7x5:
# N = 105, one short row range) at C of 8, 264 and 1032, and C = 264 over
# many row ranges (N = 16384, the last short)
REDUCE3_EXTRA = ((3, 7, 5, 8), (3, 7, 5, 264), (3, 7, 5, 1032),
                 (128, 16, 8, 264))


def die(msg: str, code: int = 2):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(code)


# the timing helpers of the checkout's package
# (ieee_tpu_torch/tools/_timing.py), bound by main() once it has found it
card_line = median_ms = bound_ms = short_name = kernel_ms = None


def demangle(name: str) -> str:
    """A kernel's C++ name through ``c++filt`` where the machine has it,
    else the mangled name (display only)."""
    import shutil
    import subprocess

    tool = shutil.which("c++filt")
    if tool is None:
        return name
    out = subprocess.run([tool, name], capture_output=True, text=True)
    return out.stdout.strip() or name


def randn(shape, seed, scale=1.0):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal(shape, np.float32) * scale,
                        device="cuda")


def check_kernels(results):
    """Phase 2: every kernel at the main paths' shapes vs its plain
    version; times of the kernel, the plain version and the library call."""
    import torch

    from ieee_tpu_torch.ops.kernels.distmat import (
        euclidean_sq, euclidean_sq_plain)
    from ieee_tpu_torch.ops.kernels.matmul_bn import (
        EVAL_SITES, mm_affine_act, mm_affine_act_plain)
    from ieee_tpu_torch.ops.kernels.partpool import (
        fused_partpool_project, fused_partpool_project_plain)

    def record(name, shape, got, want, tol, fn, plain_fn, library_fn,
               bound, weight=0, iters=20, queued=False):
        """``tol``: the allowed |got - want|, a number or a tensor;
        ``bound``: (ms, bound_by); ``weight``: how many times the case
        counts in the kernel's reported time; ``queued``: also time 10
        calls queued back to back (per call), which hides the wrapper's
        host time behind the card's unless the card is the faster."""
        diff = (got - want).abs()
        err = diff.max().item()
        ok = bool((diff <= tol).all())
        tol_s = (f"{tol:.3e}" if isinstance(tol, float)
                 else f"{tol.max().item():.3e} at most, elementwise")
        ms, plain_ms = median_ms(fn, iters), median_ms(plain_fn, iters)
        lib_ms = None if library_fn is None else median_ms(library_fn, iters)
        lib_s = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"kernel {name} {shape}: max_abs_err {err:.3e} (tol {tol_s}) "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library {lib_s} "
              f"bound {bound[0]:.4f} ms ({bound[1]})"
              + ("" if ok else "  MISMATCH"))
        if not ok:
            raise AssertionError(f"{name} {shape} disagrees with its plain "
                                 f"version: max error {err}")
        r = results.setdefault(name, {"max_abs_err": 0.0, "cases": []})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["cases"].append({"shape": shape, "ms": ms, "plain_ms": plain_ms,
                           "library_ms": lib_ms, "bound_ms": bound[0],
                           "bound_by": bound[1], "max_abs_err": err,
                           "weight": weight})
        if queued:
            r["cases"][-1]["queued_ms"] = median_ms(
                lambda: [fn() for _ in range(10)], iters) / 10
            print(f"  {name} {shape}: queued "
                  f"{r['cases'][-1]['queued_ms']:.4f} ms per call")

    # distmat: the 3xTF32 kernel (three TF32 products into f32 sums)
    # against cuBLAS f32 (TF32 off); tolerance a few f32 ulps of the
    # largest entry (the two sum K products in other orders); twice, bit
    # for bit. Shapes: RGBNT201's test set (a split over K in 5), the
    # engine eval's 170 x 340 and the CLI eval's 16 x 32 (split in 18), a
    # ragged K, and splits with an odd m + n and an even n (one query
    # against 128 gallery rows, 837 x 836). Library call: the f32 product
    # with the norms, as one addmm. Bound: the kernel's three TF32 products
    # (the f32-core bound printed)
    for i, (m, n, k) in enumerate(((836, 836, 2304), (170, 340, 2304),
                                   (16, 32, 2304), (37, 300, 19),
                                   (1, 128, 2304), (837, 836, 2304))):
        q, g = randn((m, k), 1).abs(), randn((n, k), 2).abs()
        got, again = euclidean_sq(q, g), euclidean_sq(q, g)
        want = euclidean_sq_plain(q, g)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"distmat {[m, n, k]}: two runs differ")
        nbytes = 4.0 * (m * k + n * k + m * n)
        record("distmat", [m, n, k], got, want,
               1e-5 * want.abs().max().item(),
               lambda: euclidean_sq(q, g), lambda: euclidean_sq_plain(q, g),
               lambda: torch.addmm((q * q).sum(1)[:, None]
                                   + (g * g).sum(1)[None, :], q, g.t(),
                                   alpha=-2.0),
               bound_ms(6.0 * m * n * k, nbytes, "tf32"),
               weight=int(i == 0), queued=True)
        f32 = bound_ms(2.0 * m * n * k, nbytes, "f32")
        print(f"  distmat {[m, n, k]}: bound 3xTF32 "
              f"{results['distmat']['cases'][-1]['bound_ms']:.4f} ms, f32 "
              f"cores {f32[0]:.4f} ms ({f32[1]})")

    # partpool: the eval head's call (B=100, 16x8x2048 f32 map, P=6 with
    # overlapping stripes, 2048->768), a bf16 map, ragged batches (37, 129:
    # M = B (P+1) off the product's 128-row tile; 1), and a small map with
    # H < P, P = 8, C = 64 and F = 40 (a pooling chunk and a column tile
    # partly used), each twice (bit for bit); the pooled rows round to bf16
    # in both, so allow 1e-2 of the output scale. No single PyTorch call
    # pools stripes and projects
    for i, (b, h, w, c, f, parts, dtype) in enumerate((
            (100, 16, 8, 2048, 768, 6, torch.float32),
            (100, 16, 8, 2048, 768, 6, torch.bfloat16),
            (37, 16, 8, 2048, 768, 6, torch.float32),
            (129, 16, 8, 2048, 768, 6, torch.float32),
            (1, 16, 8, 2048, 768, 6, torch.bfloat16),
            (37, 5, 3, 64, 40, 8, torch.float32))):
        x = randn((b, h, w, c), 3).abs().to(dtype)
        wt = randn((c, f), 4, c ** -0.5)
        s, t = randn((f,), 5).abs() + 0.5, randn((f,), 6)
        got = fused_partpool_project(x, wt, s, t, parts=parts)
        again = fused_partpool_project(x, wt, s, t, parts=parts)
        want = fused_partpool_project_plain(x, wt, s, t, parts=parts)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"partpool {[b, h, w, c, f]}: two runs "
                                 "differ")
        r = parts + 1
        flops = 2.0 * b * r * h * w * c + 2.0 * b * r * c * f
        nbytes = x.element_size() * x.numel() + 4 * (c * f + 2 * f
                                                     + b * r * f)
        record("partpool", [b, h, w, c, f, parts, str(dtype)[6:]], got,
               want, 1e-2 * max(1.0, want.abs().max().item()),
               lambda: fused_partpool_project(x, wt, s, t, parts),
               lambda: fused_partpool_project_plain(x, wt, s, t, parts),
               None, bound_ms(flops, nbytes, "bf16"), weight=int(i == 0),
               queued=i < 2)

    # mm_affine: layer4's sites of an eval batch of 100 (16x8 map) and
    # EVAL_EXTRA's, each twice (bit for bit); bf16 outputs may differ by
    # one bf16 step (2^-7 relative allowed) where f32 sums differ. Library
    # call: the bf16 torch.matmul of the same operands. The weight counts a
    # case per trunk (7 calls), the site table per batch (x3)
    for rows, k, c, relu, sites in EVAL_SITES + EVAL_EXTRA:
        a = randn((rows, k), 7).to(torch.bfloat16)
        w = randn((k, c), 8, k ** -0.5)
        w16 = w.to(torch.bfloat16)
        inv, shift = randn((c,), 9).abs() + 0.5, randn((c,), 10)
        got = mm_affine_act(a, w, inv, shift, relu).float()
        again = mm_affine_act(a, w, inv, shift, relu).float()
        if not torch.equal(got, again):
            raise AssertionError(f"mm_affine {[rows, k, c]}: two runs differ")
        want = mm_affine_act_plain(a, w, inv, shift, relu).float()
        torch.cuda.synchronize()
        record("mm_affine", [rows, k, c, relu], got, want,
               2 ** -7 * want.abs().clamp_min(1.0),
               lambda: mm_affine_act(a, w, inv, shift, relu),
               lambda: mm_affine_act_plain(a, w, inv, shift, relu),
               lambda: torch.matmul(a, w16),
               bound_ms(2.0 * rows * k * c,
                        2.0 * (rows * k + k * c + rows * c) + 8.0 * c,
                        "bf16"),
               weight=sites // 3, queued=bool(sites))
    check_widths("mm_affine", EVAL_SITES + EVAL_EXTRA)
    site_table(results, "mm_affine", "batch", 3)
    unit_line(results, "mm_affine", "trunk (7 layer4 calls)")

    check_train_kernels(record, results)
    check_probe_kernels(record)
    unit_line(results, "bn_mm", "16384 x 2048 x 2048 call")


def check_train_kernels(record, results):
    """Phase 2, train kernels: mm_stats, mm_bn_da and mm_bn_dw at every
    fused site of one batch-128 train step, and the extra cases. Library
    call: the bf16 torch.matmul of the same product (y = a @ w;
    dy @ w^T; a^T @ dy), without the statistics or the dy recompute."""
    import torch

    from ieee_tpu_torch.ops.kernels.matmul_bn import (
        TRAIN_SITES, dy_plain, mm_bn_da, mm_bn_da_plain, mm_bn_dw,
        mm_bn_dw_plain, mm_stats, mm_stats_plain)

    for n, k, c, relu, sites in TRAIN_SITES + TRAIN_EXTRA:
        iters = 10 if n >= 16384 else 20
        a = randn((n, k), 20).to(torch.bfloat16)
        w = randn((k, c), 21, k ** -0.5)
        w16 = w.to(torch.bfloat16)
        d = randn((n, c), 22).to(torch.bfloat16)
        y = randn((n, c), 23).to(torch.bfloat16)
        vecs = torch.stack([randn((c,), 24).abs() + 0.5, randn((c,), 25),
                            0.1 * randn((c,), 26), randn((c,), 27).abs() + 0.5,
                            0.1 * randn((c,), 28), 0.1 * randn((c,), 29)])
        shape = [n, k, c, relu]
        flops = 2.0 * n * k * c

        # mm_stats: y one bf16 step (+1e-5 of the largest |y| where the f32
        # sums differ near zero); sums 1e-5 of sum|y| and sum y^2
        got_y, got_st = mm_stats(a, w)
        again = mm_stats(a, w)
        want_y, want_st = mm_stats_plain(a, w)
        torch.cuda.synchronize()
        if not (torch.equal(got_y, again[0])
                and torch.equal(got_st, again[1])):
            raise AssertionError(f"mm_stats {shape}: two runs differ")
        del again
        y32 = a.float() @ w16.float()
        st_tol = 1e-5 * torch.stack([y32.abs().sum(0), (y32 * y32).sum(0)])
        if not bool(((got_st - want_st).abs() <= st_tol).all()):
            raise AssertionError(f"mm_stats {shape}: channel sums disagree: "
                                 f"{(got_st - want_st).abs().max().item()}")
        del y32
        want_y = want_y.float()
        record("mm_stats", shape, got_y.float(), want_y,
               2 ** -7 * want_y.abs() + 1e-5 * want_y.abs().max(),
               lambda: mm_stats(a, w), lambda: mm_stats_plain(a, w),
               lambda: torch.matmul(a, w16),
               bound_ms(flops, 2.0 * (n * k + k * c + n * c) + 8.0 * c,
                        "bf16"), weight=sites, iters=iters,
               queued=bool(sites))

        # mm_bn_da: dy is bit-identical; one bf16 step + 1e-5 sum|dy||w|
        dy = dy_plain(d, y, vecs, relu)
        got = mm_bn_da(d, y, vecs, w, relu).float()
        want = mm_bn_da_plain(d, y, vecs, w, relu).float()
        torch.cuda.synchronize()
        tol = 2 ** -7 * want.abs() + 1e-5 * (dy.float().abs()
                                             @ w16.float().abs().t())
        if not torch.equal(got, mm_bn_da(d, y, vecs, w, relu).float()):
            raise AssertionError(f"mm_bn_da {shape}: two runs differ")
        record("mm_bn_da", shape, got, want, tol,
               lambda: mm_bn_da(d, y, vecs, w, relu),
               lambda: mm_bn_da_plain(d, y, vecs, w, relu),
               lambda: torch.matmul(dy, w16.t()),
               bound_ms(flops, 2.0 * (2 * n * c + k * c + n * k) + 24.0 * c,
                        "bf16"), weight=sites, iters=iters, queued=True)

        # mm_bn_dw: f32 out, N products in another order: 1e-5 sum|a||dy|
        got = mm_bn_dw(a, d, y, vecs, relu)
        want = mm_bn_dw_plain(a, d, y, vecs, relu)
        torch.cuda.synchronize()
        tol = 1e-5 * (a.float().abs().t() @ dy.float().abs()) + 1e-30
        if not torch.equal(got, mm_bn_dw(a, d, y, vecs, relu)):
            raise AssertionError(f"mm_bn_dw {shape}: two runs differ")
        record("mm_bn_dw", shape, got, want, tol,
               lambda: mm_bn_dw(a, d, y, vecs, relu),
               lambda: mm_bn_dw_plain(a, d, y, vecs, relu),
               lambda: torch.matmul(a.t(), dy),
               bound_ms(flops, 2.0 * (n * k + 2 * n * c) + 24.0 * c
                        + 4.0 * k * c, "bf16"), weight=sites, iters=iters,
               queued=True)
        del a, w, w16, d, y, dy, got, want, tol
    check_widths("mm_stats", TRAIN_SITES + TRAIN_EXTRA)
    for name in TRAIN_KERNELS:
        site_table(results, name, "step", 1)
    unit_line(results, "mm_stats", "train step (33 sites)")
    check_train_op()
    check_block_kernels(record)
    stage_table(results)
    for name, _ in BLOCK_PRODUCTS:
        unit_line(results, name, "train step (30 blocks)")
    check_block_op()


def check_widths(name, shapes):
    """Phase 2: the column tiles (``_mm_plan``) that ``name``'s checked
    shapes ran at must include every width of its kernel."""
    import torch

    from ieee_tpu_torch.ops.kernels.matmul_bn import (
        MM_WIDTHS, _mm_plan, _sm_count)

    sms = _sm_count(torch.cuda.current_device())
    seen = sorted({_mm_plan(n, c, sms) for n, _, c, _, _ in shapes})
    print(f"{name}: checked at column tiles {seen} of {list(MM_WIDTHS)}")
    if set(seen) != set(MM_WIDTHS):
        raise AssertionError(f"{name}: no case at column tile "
                             f"{sorted(set(MM_WIDTHS) - set(seen))}")


def site_table(results, name, unit, per_weight):
    """Phase 2: a 1x1 kernel per site class (N, K, C) of its unit (a
    batch-128 train step, or an eval batch of 100): ms per call and per
    unit (x sites, ``per_weight`` sites for each unit of a case's weight),
    the library call and the bound, so the launch-bound reduce sites and
    the tensor-core-bound layer4/CIM sites read apart. "kernel" times one
    wrapper call between two events, as every row of the kernel line;
    "queued" 10 calls back to back, per call."""
    print(f"site classes of {name} (ms per call; per {unit} = x sites):")
    totals = [0.0, 0.0]
    for case in results[name]["cases"]:
        if not case["weight"]:
            continue
        n, k, c, _ = case["shape"]
        lib = case["library_ms"]
        w = case["weight"] * per_weight
        totals[0] += w * case["ms"]
        totals[1] += w * case["queued_ms"]
        print(f"  N {n:5d} K {k:4d} C {c:4d} x{w}: kernel "
              f"{case['ms']:.4f} queued {case['queued_ms']:.4f} library "
              f"{lib:.4f} bound {case['bound_ms']:.4f} "
              f"({case['ms'] / lib:.2f}x library, "
              f"{case['queued_ms'] / lib:.2f}x queued, "
              f"{case['ms'] / case['bound_ms']:.2f}x bound); per {unit} "
              f"{w * case['ms']:.4f} ms")
    print(f"  per {unit}: kernel {totals[0]:.4f} ms, queued "
          f"{totals[1]:.4f} ms")


def stage_table(results):
    """Phase 2: the block path's product kernels per stage of one
    batch-128 train step: ms per call ("kernel": one wrapper call between
    two events; "queued": 10 calls back to back, per call), the library
    call and the bound, and per step (x blocks)."""
    for name, _ in BLOCK_PRODUCTS:
        print(f"stages of {name} (ms per call; per step = x blocks):")
        for case in results[name]["cases"]:
            if not case["weight"]:
                continue
            b, h, w, c, cm = case["shape"]
            lib, bound = case["library_ms"], case["bound_ms"]
            print(f"  {h:2d}x{w:2d} C {c:4d} cm {cm:3d} x{case['weight']}: "
                  f"kernel {case['ms']:.4f} queued {case['queued_ms']:.4f} "
                  f"library {lib:.4f} bound {bound:.4f} "
                  f"({case['queued_ms'] / lib:.2f}x library, "
                  f"{case['queued_ms'] / bound:.2f}x bound, queued); per "
                  f"step {case['weight'] * case['ms']:.4f} ms")


def unit_line(results, name, unit):
    """Phase 2: a kernel's weighted cases summed over its reported unit,
    one call per timing and 10 queued (per call), beside the library call
    and the bound."""
    cases = [c for c in results[name]["cases"] if c["weight"]]
    tot = {key: sum(c["weight"] * c[key] for c in cases)
           for key in ("ms", "queued_ms", "library_ms", "bound_ms")}
    ratio = tot["queued_ms"] / tot["library_ms"]
    print(f"{name} per {unit}: kernel {tot['ms']:.4f} ms, queued "
          f"{tot['queued_ms']:.4f} ms, library {tot['library_ms']:.4f} ms, "
          f"bound {tot['bound_ms']:.4f} ms ({ratio:.2f}x library queued)")


def check_train_op():
    """Phase 2, the whole op: mm_bn_act_train forward and backward through
    the kernels against ``plain=True`` on the same inputs. y may differ by
    one bf16 step, which moves x-hat and rarely a ReLU mask: the bf16
    outputs and the f32 gradients agree to relative Frobenius 2^-8, mean
    and var to 1e-5 of the largest var."""
    import torch

    from ieee_tpu_torch.ops import kernels
    from ieee_tpu_torch.ops.kernels.matmul_bn import mm_bn_act_train

    for n, k, c, relu, res in ((16384, 2048, 512, True, False),
                               (16384, 512, 2048, False, True),
                               (16384, 2048, 2048, True, False),
                               (768, 2048, 768, True, False),
                               (1037, 1024, 2048, False, False)):
        a = randn((n, k), 30).to(torch.bfloat16)
        w = randn((k, c), 31, k ** -0.5)
        d = randn((n, c), 32).to(torch.bfloat16)
        r = randn((n, c), 33).to(torch.bfloat16) if res else None
        outs = {}
        for plain in (False, True):
            kernels.reset_launch_counts()
            leaves = [t.clone().float().requires_grad_() for t in (a, w)]
            scale = (randn((c,), 34).abs() + 0.5).requires_grad_()
            bias = randn((c,), 35).requires_grad_()
            rr = r.clone().requires_grad_() if res else None
            act, mean, var = mm_bn_act_train(leaves[0], leaves[1], scale,
                                             bias, rr, relu, plain=plain)
            act.backward(d)
            torch.cuda.synchronize()
            launched = [kernels.LAUNCHES[x] for x in TRAIN_KERNELS]
            if launched != ([0, 0, 0] if plain else [1, 1, 1]):
                raise AssertionError(f"op launches {launched} (plain={plain})")
            outs[plain] = dict(act=act.float(), mean=mean, var=var,
                               da=leaves[0].grad, dw=leaves[1].grad,
                               dscale=scale.grad, dbias=bias.grad,
                               dres=rr.grad.float() if res else None)
        got, want = outs[False], outs[True]
        vtol = 1e-5 * want["var"].abs().max().item()
        errs = {}
        for name in ("mean", "var"):
            errs[name] = (got[name] - want[name]).abs().max().item()
            if errs[name] > vtol:
                raise AssertionError(f"op {name} {[n, k, c]}: {errs[name]}")
        for name in ("act", "da", "dw", "dscale", "dbias", "dres"):
            if want[name] is None:
                continue
            errs[name] = ((got[name] - want[name]).norm()
                          / want[name].norm()).item()
            if errs[name] > 2 ** -8:
                raise AssertionError(f"op {name} {[n, k, c]}: relative "
                                     f"{errs[name]}")
        print(f"op mm_bn_act_train {[n, k, c, relu, res]}: "
              + " ".join(f"{x} {v:.2e}" for x, v in errs.items())
              + f" (mean/var abs tol {vtol:.2e}, rest relative 2^-8)")


def check_block_kernels(record):
    """Phase 2, block kernels: reduce3, bn3_apply, conv2_bwd and bn1_apply
    at the block path's three stages of a batch-128 step, at width 512 and
    at a ragged batch, each launched twice (bit-identical: no float
    atomics). Tolerances: d3 exact (a mask and a copy); bf16 outputs one
    bf16 step of the value plus 1e-3 of the map's rms, where f32 sums taken
    in another order round to neighbouring values near zero; the f32
    channel sums and dW 1e-5 of the sum of |terms|. Library calls: none for
    reduce3 (no single PyTorch call masks and sums); the two bf16
    torch.matmul products (dW, and the input gradient) for bn3_apply and
    bn1_apply; cuDNN's conv2d_input and conv2d_weight for conv2_bwd. None
    of them recomputes the BN backward or the masks."""
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_input, conv2d_weight

    from ieee_tpu_torch.ops.kernels import block_bwd as bb

    bf16 = torch.bfloat16
    rows_of = bb._rows

    def twice(name, fn):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{name}: two runs differ")
        return a

    def bf16_tol(want):
        return 2 ** -7 * want.abs() + 1e-3 * want.pow(2).mean().sqrt()

    def sums_close(name, shape, what, got, want, terms):
        err = (got - want).abs()
        if not bool((err <= 1e-5 * terms + 1e-30).all()):
            raise AssertionError(f"{name} {shape} {what}: {err.max().item()}")

    def taps(t):  # the nine shifted (N, C) views of a (B, H, W, C) map
        b, h, w, c = t.shape
        p = F.pad(t, (0, 0, 1, 1, 1, 1))
        return [p[:, ky:ky + h, kx:kx + w].reshape(-1, c)
                for ky in range(3) for kx in range(3)]

    for b, h, w, c, cm, blocks in BLOCK_SITES + BLOCK_EXTRA:
        n = b * h * w
        iters = 10 if n >= 16384 else 20
        shape = [b, h, w, c, cm]

        def amap(ch, seed):
            return randn((b, h, w, ch), seed).to(bf16)

        def vrows(ch, seed, k):
            return torch.stack([randn((ch,), seed).abs() + 0.5,
                                0.5 * randn((ch,), seed + 1),
                                0.1 * randn((ch,), seed + 2),
                                randn((ch,), seed + 3).abs() + 0.5,
                                0.1 * randn((ch,), seed + 4)][:k])

        dy, y, a3, x, d3 = (amap(c, s) for s in (40, 41, 42, 43, 44))
        a2, a1, d2, d1 = (amap(cm, s) for s in (45, 46, 47, 48))
        v3, v2f, v2 = vrows(c, 50, 5), vrows(cm, 55, 4), vrows(cm, 60, 5)
        v1f, v1 = vrows(cm, 65, 4), vrows(cm, 70, 5)
        w1 = randn((c, cm), 75, c ** -0.5)
        w2 = randn((3, 3, cm, cm), 76, (9 * cm) ** -0.5)
        w3 = randn((cm, c), 77, cm ** -0.5)
        w1b, w2b, w3b = w1.to(bf16), w2.to(bf16), w3.to(bf16)

        # reduce3: no products; ~7 f32 operations per element
        mean, rstd = v3[1], v3[2]
        args = (dy, y, a3, mean, rstd)
        got = twice("reduce3", lambda: bb.reduce3(*args))
        want = bb.reduce3_plain(*args)
        g = rows_of(want[0]).float().abs()
        xh = bb._xhat(rows_of(a3).float(), mean, rstd).abs()
        sums_close("reduce3", shape, "S3", got[1], want[1],
                   torch.stack([g.sum(0), (g * xh).sum(0)]))
        record("reduce3", shape, got[0].float(), want[0].float(), 0.0,
               lambda: bb.reduce3(*args), lambda: bb.reduce3_plain(*args),
               None, bound_ms(7.0 * n * c, 8.0 * n * c + 16.0 * c, "f32"),
               weight=blocks, iters=iters)
        del g, xh

        # bn3_apply: dW3 = h2^T da3 and dh2 = da3 W3^T
        args = (d3, a3, a2, w3, v3, v2f)
        got = twice("bn3_apply", lambda: bb.bn3_apply(*args))
        want = bb.bn3_apply_plain(*args)
        da3 = bb._bn_bwd(rows_of(d3), rows_of(a3), v3)
        a2f = rows_of(a2).float()
        h2 = bb._relu_bn(a2f, v2f)
        prod = (da3.float().abs() @ w3b.float().abs().t()) * (h2 > 0)
        xh = bb._xhat(a2f, v2f[2], v2f[3]).abs()
        sums_close("bn3_apply", shape, "S2", got[1], want[1],
                   torch.stack([prod.sum(0), (prod * xh).sum(0)]))
        sums_close("bn3_apply", shape, "dW3", got[2], want[2],
                   h2.t() @ da3.float().abs())
        h2b = h2.to(bf16)
        want_d2 = want[0].float()
        record("bn3_apply", shape, got[0].float(), want_d2,
               bf16_tol(want_d2), lambda: bb.bn3_apply(*args),
               lambda: bb.bn3_apply_plain(*args),
               lambda: (torch.matmul(h2b.t(), da3),
                        torch.matmul(da3, w3b.t())),
               bound_ms(4.0 * n * c * cm, 4.0 * n * c + 4.0 * n * cm
                        + 6.0 * cm * c + 20.0 * c + 24.0 * cm, "bf16"),
               weight=blocks, iters=iters, queued=True)
        del da3, a2f, h2, h2b, prod, xh, want_d2

        # conv2_bwd: the 3x3 input and weight gradients of da2
        args = (d2, a2, a1, w2, v2, v1f)
        got = twice("conv2_bwd", lambda: bb.conv2_bwd(*args))
        want = bb.conv2_bwd_plain(*args)
        da2 = bb._bn_bwd(rows_of(d2), rows_of(a2), v2)
        a1f = rows_of(a1).float()
        h1 = bb._relu_bn(a1f, v1f)
        w2a = w2b.float().abs()
        da_taps = taps(da2.float().abs().view(b, h, w, cm))
        # the input gradient's tap (ky, kx) reads da2 at (1 - ky, 1 - kx)
        prod = sum(da_taps[8 - t] @ w2a[t // 3, t % 3].t()
                   for t in range(9)) * (h1 > 0)
        del da_taps
        xh = bb._xhat(a1f, v1f[2], v1f[3]).abs()
        sums_close("conv2_bwd", shape, "S1", got[1], want[1],
                   torch.stack([prod.sum(0), (prod * xh).sum(0)]))
        terms = torch.stack([t.t() @ da2.float().abs()
                             for t in taps(h1.view(b, h, w, cm))])
        sums_close("conv2_bwd", shape, "dW2", got[2], want[2],
                   terms.view(3, 3, cm, cm))
        del prod, xh, terms, a1f
        da2n = da2.view(b, h, w, cm).permute(0, 3, 1, 2)
        h1n = h1.to(bf16).view(b, h, w, cm).permute(0, 3, 1, 2)
        w2o = w2b.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        want_d1 = want[0].float()
        record("conv2_bwd", shape, got[0].float(), want_d1,
               bf16_tol(want_d1), lambda: bb.conv2_bwd(*args),
               lambda: bb.conv2_bwd_plain(*args),
               lambda: (conv2d_input(h1n.shape, w2o, da2n, padding=1),
                        conv2d_weight(h1n, w2o.shape, da2n, padding=1)),
               bound_ms(36.0 * n * cm * cm, 8.0 * n * cm + 54.0 * cm * cm
                        + 44.0 * cm, "bf16"), weight=blocks, iters=iters,
               queued=True)
        del da2, h1, da2n, h1n, w2o, want_d1

        # bn1_apply: dW1 = x^T da1 and dx = da1 W1^T + d3
        args = (d1, a1, x, d3, w1, v1)
        got = twice("bn1_apply", lambda: bb.bn1_apply(*args))
        want = bb.bn1_apply_plain(*args)
        da1 = bb._bn_bwd(rows_of(d1), rows_of(a1), v1)
        xr = rows_of(x)
        sums_close("bn1_apply", shape, "dW1", got[1], want[1],
                   xr.float().abs().t() @ da1.float().abs())
        want_dx = want[0].float()
        record("bn1_apply", shape, got[0].float(), want_dx,
               bf16_tol(want_dx), lambda: bb.bn1_apply(*args),
               lambda: bb.bn1_apply_plain(*args),
               lambda: (torch.matmul(xr.t(), da1),
                        torch.matmul(da1, w1b.t())),
               bound_ms(4.0 * n * c * cm, 6.0 * n * c + 4.0 * n * cm
                        + 6.0 * c * cm + 20.0 * cm, "bf16"),
               weight=blocks, iters=iters, queued=True)
        del got, want, da1, xr, want_dx
        torch.cuda.empty_cache()

    # reduce3 alone at REDUCE3_EXTRA: ragged batches on an odd map and
    # channel counts off its 128-channel tile, twice (bit for bit)
    for b, h, w, c in REDUCE3_EXTRA:
        dy, y, a3 = (randn((b, h, w, c), s).to(bf16) for s in (40, 41, 42))
        mean, rstd = 0.1 * randn((c,), 52), randn((c,), 53).abs() + 0.5
        args = (dy, y, a3, mean, rstd)
        got = twice("reduce3", lambda: bb.reduce3(*args))
        want = bb.reduce3_plain(*args)
        g = rows_of(want[0]).float().abs()
        xh = bb._xhat(rows_of(a3).float(), mean, rstd).abs()
        sums_close("reduce3", [b, h, w, c], "S3", got[1], want[1],
                   torch.stack([g.sum(0), (g * xh).sum(0)]))
        n = b * h * w
        record("reduce3", [b, h, w, c], got[0].float(), want[0].float(),
               0.0, lambda: bb.reduce3(*args),
               lambda: bb.reduce3_plain(*args), None,
               bound_ms(7.0 * n * c, 8.0 * n * c + 16.0 * c, "f32"))


def check_block_op():
    """Phase 2, the whole op: bottleneck_train forward and backward through
    the block kernels against ``plain=True`` on the same inputs. The forward
    is the same code (y and the statistics equal); in the backward the sums
    S3, S2, S1 differ in order and d2, d1, dx by a bf16 step here and there,
    which moves the next BN backward a little: all ten gradients to a
    relative Frobenius error of 2^-8, one bf16 step."""
    import torch

    from ieee_tpu_torch.ops import kernels
    from ieee_tpu_torch.ops.kernels.block_bwd import bottleneck_train

    for b, h, w, c, cm in ((128, 64, 32, 256, 64), (128, 16, 8, 1024, 256),
                           (3, 7, 5, 64, 16)):
        x = randn((b, h, w, c), 80).to(torch.bfloat16)
        params = [randn((1, 1, c, cm), 81, c ** -0.5),
                  1 + 0.1 * randn((cm,), 82), 0.1 * randn((cm,), 83),
                  randn((3, 3, cm, cm), 84, (9 * cm) ** -0.5),
                  1 + 0.1 * randn((cm,), 85), 0.1 * randn((cm,), 86),
                  randn((1, 1, cm, c), 87, cm ** -0.5),
                  1 + 0.1 * randn((c,), 88), 0.1 * randn((c,), 89)]
        ct = randn((b, h, w, c), 90).to(torch.bfloat16)
        outs = {}
        for plain in (False, True):
            kernels.reset_launch_counts()
            leaves = [x.clone().requires_grad_()] + [
                p.clone().requires_grad_() for p in params]
            y, stats = bottleneck_train(*leaves, plain=plain)
            y.backward(ct)
            torch.cuda.synchronize()
            launched = [kernels.LAUNCHES[k] for k in BLOCK_KERNELS]
            if launched != ([0] * 4 if plain else [1] * 4):
                raise AssertionError(f"op launches {launched} "
                                     f"(plain={plain})")
            outs[plain] = (y, stats, [t.grad.float() for t in leaves])
        (y, st, g), (y_p, st_p, g_p) = outs[False], outs[True]
        if not (torch.equal(y, y_p)
                and all(torch.equal(a, b_) for a, b_ in zip(st, st_p))):
            raise AssertionError(f"op forward {[b, h, w, c, cm]} differs")
        errs = {}
        for name, a, b_ in zip("dx dk1 ds1 db1 dk2 ds2 db2 dk3 ds3 db3"
                               .split(), g, g_p):
            errs[name] = ((a - b_).norm() / b_.norm()).item()
            if errs[name] > 2 ** -8:
                raise AssertionError(f"op {name} {[b, h, w, c, cm]}: "
                                     f"relative {errs[name]}")
        print(f"op bottleneck_train {[b, h, w, c, cm]}: "
              + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + " (relative 2^-8)")


def check_probe_kernels(record):
    """Phase 2, the probes' kernels at the tools' shapes, each launched
    twice (bit-identical). scale_bf16: bit for bit its plain version and
    its input (the factor rounds to 1.0 in bf16); library call torch.mul,
    and clone's time printed as the copy ceiling. probe_mm_stats: y as
    mm_stats (one bf16 step + 1e-5 of the largest |y|), m to 1e-5 of
    mean|y| and v to 1e-5 of mean y^2 plus what m's error moves in m^2;
    library call the bf16 torch.matmul without the statistics. bn_mm: one
    bf16 step of the value plus 1e-3 of the output's rms (h is bit for bit
    the plain version's; the f32 sums differ in order); library call the
    bf16 torch.matmul of the product alone (no call applies the BN on
    load)."""
    import torch

    from ieee_tpu_torch.ops.kernels.probes import (
        TILE_ROWS, bn_mm, bn_mm_plain, probe_mm_stats, probe_mm_stats_plain,
        scale_bf16, scale_bf16_plain, scale_factor)

    bf16 = torch.bfloat16

    def twice(name, fn):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{name}: two runs differ")
        return a

    def randn(shape, seed, scale=1.0):  # made on the card: large arrays
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(shape, generator=gen, device="cuda") * scale

    # rows 11-12: the probe's (8192, 8192) array at both tile heights (one
    # call each per unit), and a ragged array
    c = scale_factor()
    for rows, cols, weight in ((8192, 8192, 1), (1037, 8200, 0)):
        x = randn((rows, cols), 100).to(bf16)
        nbytes = 4.0 * rows * cols
        for tile in TILE_ROWS:
            (got,) = twice("scale_bf16", lambda: (scale_bf16(x, tile),))
            if not torch.equal(got, x):
                raise AssertionError(f"scale_bf16 {tile}: output != input")
            record("scale_bf16", [rows, cols, tile], got.float(),
                   scale_bf16_plain(x, tile).float(), 0.0,
                   lambda: scale_bf16(x, tile),
                   lambda: scale_bf16_plain(x, tile),
                   lambda: torch.mul(x, c),
                   bound_ms(1.0 * rows * cols, nbytes, "bf16"),
                   weight=weight, queued=True)
        print(f"clone {[rows, cols]} (copy ceiling): "
              f"{median_ms(lambda: x.clone()):.4f} ms")
        del x, got

    # row 13 (the mm_stats kernel) and row 14 at fusion_probe's CIM shape,
    # and a ragged N
    for n, k, cc, weight in ((16384, 2048, 2048, 1), (1037, 2048, 2048, 0)):
        shape = [n, k, cc]
        flops = 2.0 * n * k * cc
        x = randn((n, k), 101).to(bf16)
        w = randn((k, cc), 102, 0.02).to(bf16)
        got = twice("probe_mm_stats", lambda: probe_mm_stats(x, w))
        want = probe_mm_stats_plain(x, w)
        y32 = x.float() @ w.float()
        m_tol = 1e-5 * y32.abs().mean(0)
        v_tol = 1e-5 * (y32 * y32).mean(0) + 2 * want[1].abs() * m_tol \
            + m_tol * m_tol
        del y32
        for what, i, tol in (("m", 1, m_tol), ("v", 2, v_tol)):
            err = (got[i] - want[i]).abs()
            if not bool((err <= tol).all()):
                raise AssertionError(f"probe_mm_stats {shape} {what}: "
                                     f"{err.max().item()}")
        want_y = want[0].float()
        record("probe_mm_stats", shape, got[0].float(), want_y,
               2 ** -7 * want_y.abs() + 1e-5 * want_y.abs().max(),
               lambda: probe_mm_stats(x, w),
               lambda: probe_mm_stats_plain(x, w),
               lambda: torch.matmul(x, w),
               bound_ms(flops, 2.0 * (n * k + k * cc + n * cc) + 8.0 * cc,
                        "bf16"), weight=weight, iters=10)
        print(f"probe_mm_stats {shape}: m err "
              f"{(got[1] - want[1]).abs().max().item():.3e}, v err "
              f"{(got[2] - want[2]).abs().max().item():.3e}")
        del got, want, want_y

        inv = randn((k,), 103).abs() + 0.5
        sh = randn((k,), 104)
        w2 = randn((k, cc), 105, k ** -0.5).to(bf16)
        (got,) = twice("bn_mm", lambda: (bn_mm(x, inv, sh, w2),))
        want = bn_mm_plain(x, inv, sh, w2).float()
        h = torch.relu(x.float() * inv + sh).to(bf16)
        record("bn_mm", shape, got.float(), want,
               2 ** -7 * want.abs() + 1e-3 * want.pow(2).mean().sqrt(),
               lambda: bn_mm(x, inv, sh, w2),
               lambda: bn_mm_plain(x, inv, sh, w2),
               lambda: torch.matmul(h, w2),
               bound_ms(flops, 2.0 * (n * k + k * cc + n * cc) + 8.0 * k,
                        "bf16"), weight=weight, iters=10, queued=True)
        del x, w, w2, h, got, want
        torch.cuda.empty_cache()


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
            "test.evaluate", "True", "test.batch_size", "100",
            # the kernels are opt-in, as in the JAX package
            "cuda.fused_1x1", "True", "cuda.fused_eval", "True"]
    kernels.reset_launch_counts()
    rank1 = main_multimodal.main(argv)
    counts = kernels.launch_counts()
    print(f"main path: rank1 {rank1:.4f}, launches {counts}")
    if not 0.0 <= rank1 <= 1.0:
        raise AssertionError(f"rank-1 {rank1} outside [0, 1]")
    missing = [k for k in EVAL_KERNELS if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the eval path: "
                             f"{missing}")
    if any(counts[k] for k in TRAIN_KERNELS + BLOCK_KERNELS):
        raise AssertionError(f"train kernels launched in eval: {counts}")
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


def distmat_scale(results, m=3368, n=15913, k=2304, check_ranks=False):
    """Phase 5 (and 10 at other widths): the distmat at Market-1501 scale:
    the kernel against its plain version (1e-5 of the largest entry); on
    q's first 500 rows both against a float64 distmat (the kernel's error
    at most twice the plain version's, plus 2^-23 of the largest |entry|);
    the times of the kernel, the plain version and addmm beside the 3xTF32
    and f32-core bounds; and the mAP and CMC of the rankings by the two
    distmats, with random ids as eval_bench makes them (printed; with
    ``check_ranks`` they may differ in at most two of the m queries)."""
    import numpy as np
    import torch

    from ieee_tpu_torch.ops.kernels.distmat import (
        euclidean_sq, euclidean_sq_plain)
    from ieee_tpu_torch.ops.ranking import _device_rank

    q, g = randn((m, k), 11).abs(), randn((n, k), 12).abs()
    got, want = euclidean_sq(q, g), euclidean_sq_plain(q, g)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 1e-5 * want.abs().max().item()
    ms = median_ms(lambda: euclidean_sq(q, g), iters=5)
    plain_ms = median_ms(lambda: euclidean_sq_plain(q, g), iters=5)
    lib_ms = median_ms(lambda: torch.addmm(
        (q * q).sum(1)[:, None] + (g * g).sum(1)[None, :], q, g.t(),
        alpha=-2.0), iters=5)
    nbytes = 4.0 * (m * k + n * k + m * n)
    tf32 = bound_ms(6.0 * m * n * k, nbytes, "tf32")
    f32 = bound_ms(2.0 * m * n * k, nbytes, "f32")
    print(f"kernel distmat {[m, n, k]}: max_abs_err {err:.3e} (tol "
          f"{tol:.3e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms library "
          f"{lib_ms:.4f} ms (addmm) bound {tf32[0]:.4f} ms (3xTF32, "
          f"{tf32[1]}), f32 cores {f32[0]:.4f} ms ({f32[1]})")
    if err > tol:
        raise AssertionError(f"distmat at Market scale: {err} > {tol}")
    q64, g64 = q[:500].double(), g.double()
    ref = ((q64 * q64).sum(1)[:, None] + (g64 * g64).sum(1)[None, :]
           - 2.0 * q64 @ g64.T)
    err64 = (got[:500].double() - ref).abs().max().item()
    plain64 = (want[:500].double() - ref).abs().max().item()
    allow = 2 * plain64 + 2 ** -23 * ref.abs().max().item()
    print(f"distmat vs float64 (500 x {n}): kernel {err64:.3e}, plain "
          f"{plain64:.3e}, allowed {allow:.3e}")
    if err64 > allow:
        raise AssertionError(f"distmat less accurate than twice the plain "
                             f"version's error: {err64} > {allow}")
    del q64, g64, ref
    rng = np.random.default_rng(0)
    ids = [torch.as_tensor(rng.integers(0, hi, size), device="cuda")
           for hi, size in ((750, m), (750, n), (6, m), (6, n))]
    ranks = [_device_rank(d, *ids, 50) for d in (got, want)]
    cmc_diff = (ranks[0][0] - ranks[1][0]).abs().max().item()
    map_diff = abs(float(ranks[0][1]) - float(ranks[1][1]))
    print(f"rankings by the kernel's and the plain distmat ({m} x {n} x "
          f"{k}): mAP {float(ranks[0][1]):.6f} and {float(ranks[1][1]):.6f} "
          f"(diff {map_diff:.3e}), CMC max diff {cmc_diff:.3e}")
    if check_ranks and max(cmc_diff, map_diff) > 2.0 / m:
        raise AssertionError(f"the kernel's ranking differs from the plain "
                             f"one in more than two queries: CMC "
                             f"{cmc_diff}, mAP {map_diff}")
    results["distmat"]["cases"].append(
        {"shape": [m, n, k], "ms": ms, "plain_ms": plain_ms,
         "library_ms": lib_ms, "bound_ms": tf32[0], "bound_by": tf32[1],
         "max_abs_err": err, "weight": 0})
    del got, want, q, g
    torch.cuda.empty_cache()


def train_path(block: bool = False):
    """Phase 6: the CLI trains one epoch of the headline config, then
    evaluates; with ``block``, with ``cuda.block_megakernel True``. Returns
    the launch counts of its run."""
    import torch

    from ieee_tpu_torch import main_multimodal
    from ieee_tpu_torch.ops import kernels

    save_dir = os.path.join(ROOT, "log", "chip_smoke_train"
                            + ("_block" if block else ""))
    metrics = os.path.join(save_dir, "metrics.jsonl")
    if os.path.exists(metrics):
        os.remove(metrics)
    argv = ["--config-file", CONFIG, "--device", "cuda",
            "model.pretrained", "False",
            "data.sources", "['synthetic_mm']",
            "data.targets", "['synthetic_mm']",
            "data.height", "256", "data.width", "128",
            "data.save_dir", save_dir, "train.max_epoch", "1",
            "train.print_freq", "4", "cuda.block_megakernel", str(block),
            "cuda.fused_1x1", "True", "cuda.fused_eval", "True"]
    kernels.reset_launch_counts()
    rank1 = main_multimodal.main(argv)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    with open(metrics) as f:
        records = [json.loads(line) for line in f]
    epoch = next(r for r in records if r["kind"] == "train_epoch")
    steps = counts["mm_stats"] // 33
    print(f"train path{' (block)' if block else ''}: 1 epoch, loss "
          f"{epoch['loss']:.4f}, rank1 {rank1:.4f}, launches {counts} "
          f"({steps} steps of 33 per train kernel"
          + (f", {BLOCKS_PER_STEP} per block kernel)" if block else ")"))
    if not math.isfinite(epoch["loss"]):
        raise AssertionError(f"train loss not finite: {epoch['loss']}")
    if not 0.0 <= rank1 <= 1.0:
        raise AssertionError(f"rank-1 {rank1} outside [0, 1]")
    missing = [k for k in EVAL_KERNELS + TRAIN_KERNELS
               + (BLOCK_KERNELS if block else ()) if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the train path: "
                             f"{missing}")
    train = {counts[k] for k in TRAIN_KERNELS}
    if len(train) != 1 or counts["mm_stats"] % 33:
        raise AssertionError(f"train kernels not 33 per step: {counts}")
    want = steps * BLOCKS_PER_STEP if block else 0
    if any(counts[k] != want for k in BLOCK_KERNELS):
        raise AssertionError(f"block kernels not {want}: {counts}")
    return counts


def engine_train():
    """Phase 7: the train step at bench.py's protocol: fused, fused+block
    and plain."""
    import torch

    from ieee_tpu_torch.data import ImageDataManager
    from ieee_tpu_torch.engine import Image3MEngine
    from ieee_tpu_torch.models import build_model
    from ieee_tpu_torch.ops import kernels
    from ieee_tpu_torch.optim import build_lr_scheduler, build_optimizer
    from ieee_tpu_torch.tools.profile_train import profile_steps

    batch, num_pids = 128, 171
    dm = ImageDataManager(sources="synthetic_mm", height=256, width=128,
                          batch_size_train=batch, batch_size_test=100,
                          workers=4, train_sampler="RandomIdentitySampler",
                          num_instances=4, num_pids=num_pids, imgs_per_pid=8,
                          verbose=False, seed=0)
    data = next(iter(dm.train_loader))
    first, rates = {}, {}
    # fused, fused+block and plain in bf16 (timed), then one plain step in
    # f32 as the yardstick of bf16 rounding noise in the gradients
    for name, fused, block, dtype in (
            ("fused", True, False, "bfloat16"),
            ("fused+block", True, True, "bfloat16"),
            ("plain", False, False, "bfloat16"),
            ("f32", False, False, "float32")):
        model = build_model("ieee3modalPart", num_pids, "margin",
                            pretrained=False, dtype=dtype, seed=1,
                            fused_1x1=fused, block_megakernel=block)
        opt = build_optimizer(model, optim="sgd", lr=0.001, momentum=0.9,
                              weight_decay=5e-4)
        sched = build_lr_scheduler("multi_step", stepsize=[20, 40],
                                   base_lr=0.001)
        eng = Image3MEngine(dm, model, opt, sched, device="cuda", seed=0,
                            margin=1.0)
        imgs, pids = eng._put_batch(data)
        # the first step, from the seed's weights: launches and gradients
        kernels.reset_launch_counts()
        m = eng.train_step(imgs, pids)
        torch.cuda.synchronize()
        launched = {k: kernels.LAUNCHES[k]
                    for k in TRAIN_KERNELS + BLOCK_KERNELS}
        want = {k: (33 if fused else 0) if k in TRAIN_KERNELS
                else (BLOCKS_PER_STEP if block else 0) for k in launched}
        if launched != want:
            raise AssertionError(f"{name} step launched {launched}, want "
                                 f"{want}")
        first[name] = (m["loss"].item(),
                       {n: p.grad.detach().float().clone()
                        for n, p in model.named_parameters()})
        if name == "f32":
            break
        for _ in range(2):  # warm-up: 3 steps with the first
            eng.train_step(imgs, pids)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(20):
            m = eng.train_step(imgs, pids)
        loss = m["loss"].item()  # syncs on the last step
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rates[name] = 20 * batch / dt
        dev_ms, busy, rows = profile_steps(
            lambda: eng.train_step(imgs, pids), top=1000)
        print(f"engine train {name}: {rates[name]:.1f} triplets/s "
              f"({dt / 20 * 1e3:.3f} ms/step, batch {batch}); last loss "
              f"{loss:.4f}; peak memory {peak:.2f} GiB; launches of the "
              f"first step {launched}; profiler: {dev_ms:.3f} device ms "
              f"per step, busy {busy:.3f}")
        for key, cnt, ms in rows[:12]:
            print(f"  {ms:8.3f} ms/step {cnt:4d}x {key[:70]}")
        if fused:  # the mm_stats kernel's instances, by name
            for key, cnt, ms in rows:
                if "mm_stats" in key:
                    short = key.replace("(anonymous namespace)::", "")
                    print(f"  mm_stats: {ms:.3f} device ms/step over {cnt} "
                          f"launches of {short.split('(')[0]}")
        if block:  # reduce3, and each block kernel's products (not its
            # sum kernels)
            r3 = [(cnt, ms) for key, cnt, ms in rows if "reduce3" in key]
            print(f"  reduce3: {sum(r[1] for r in r3):.3f} device ms/step "
                  f"over {sum(r[0] for r in r3)} launches")
            for kname, keys in BLOCK_PRODUCTS:
                prods = [(cnt, ms) for key, cnt, ms in rows
                         if any(k in key for k in keys)]
                print(f"  {kname} products: "
                      f"{sum(r[1] for r in prods):.3f} device ms/step over "
                      f"{sum(r[0] for r in prods)} launches")
        if not math.isfinite(loss):
            raise AssertionError(f"{name} train loss not finite: {loss}")
        del model, opt, eng, m
        torch.cuda.empty_cache()

    # the first steps, from the same weights and batch: fused against
    # plain (both bf16, rounding at other points: y, act, dy, da in the
    # fused sites), and each against the f32 step
    def cosines(a, b):
        out = {}
        for n, g in first[b][1].items():
            f = first[a][1][n]
            if n.startswith(("fc_", "REM.")) and n.endswith(
                    (".0.bias", "conv_part.bias")):
                continue  # zero by structure (a train BN follows): noise
            if g.norm() == 0 and f.norm() == 0:
                continue  # REM conv_query/conv_value: outside the forward
            out[n] = ((f * g).sum() / (f.norm() * g.norm())).item()
        return sorted(out.items(), key=lambda kv: kv[1])

    lp, l32 = first["plain"][0], first["f32"][0]
    for a in ("fused", "fused+block", "plain"):
        cs = cosines(a, "f32")
        print(f"engine train {a} vs f32, first step: loss relative "
              f"{abs(first[a][0] - l32) / abs(l32):.2e}; gradient cosine "
              f"min {cs[0][1]:.6f}, median {cs[len(cs) // 2][1]:.6f}")
    for a in ("fused", "fused+block"):
        lf = first[a][0]
        rel = abs(lf - lp) / abs(lp)
        cs = cosines(a, "plain")
        print(f"engine train {a} vs plain, first step: loss {lf:.6f} vs "
              f"{lp:.6f} (relative {rel:.2e}, tol 1e-2); gradient cosine "
              f"min {cs[0][1]:.6f}, median {cs[len(cs) // 2][1]:.6f} over "
              f"{len(cs)} tensors (bound {GRAD_COS}); lowest {cs[:3]}")
        if rel > 1e-2 or cs[0][1] < GRAD_COS:
            raise AssertionError(f"{a} and plain train steps disagree")


def fused_sites(model):
    """(forward, backward): the fused 1x1 sites one train step of
    ``model`` runs forward, and those whose backward runs, by the code's
    own gates: per Bottleneck (``models/resnet.py``) cb1 when ``fuse_cb1``,
    cb3 and the downsample when ``fuse_cb3``, unless the block takes the
    block path; in the head (``models/ieee3modal.py``) each fused convOne
    and convAvgRest once and each fused reduce layer twice (the global
    feature, then the parts). The global feature reaches the loss only
    through REM: without REM no gradient reaches that call."""
    from ieee_tpu_torch.models.common import FusedConvBN1x1
    from ieee_tpu_torch.models.resnet import Bottleneck

    n = 0
    for m in model.modules():
        if isinstance(m, Bottleneck) and not m.megakernel:
            n += m.fuse_cb1 + m.fuse_cb3 * (1 + (m.downsample is not None))
    for attr in ("convOne", "convAvgRest"):
        n += sum(isinstance(m, FusedConvBN1x1)
                 for m in getattr(model, attr, ()))
    reduce = sum(isinstance(m, FusedConvBN1x1) for m in model.reduce_layer)
    return n + 2 * reduce, n + (2 if model.using_REM else 1) * reduce


def fused_site_bns(model) -> set:
    """The BatchNorms of those sites (``fused_sites``), by id."""
    from ieee_tpu_torch.models.common import FusedConvBN1x1
    from ieee_tpu_torch.models.resnet import Bottleneck

    out = set()
    for m in model.modules():
        if isinstance(m, Bottleneck) and not m.megakernel:
            out.update(id(bn) for bn, on in (
                (m.bn1, m.fuse_cb1), (m.bn3, m.fuse_cb3),
                (m.downsample and m.downsample[1], m.fuse_cb3)) if on and bn)
        elif isinstance(m, FusedConvBN1x1):
            out.add(id(m.layers[1]))
    return out


def ablation_train():
    """Phase 9: the ablation configs through the CLI (fixbase, resume,
    k_tfm and accumulation), then ``ablation_sweep``."""
    import shutil

    import torch

    from ieee_tpu_torch import main_multimodal
    from ieee_tpu_torch.engine import Engine
    from ieee_tpu_torch.engine.engine import is_open, named_units
    from ieee_tpu_torch.models import IEEE3modalPart
    from ieee_tpu_torch.ops import kernels
    from ieee_tpu_torch.tools import ablation_sweep

    save_dir = os.path.join(ROOT, "log", "chip_smoke_ablation")
    shutil.rmtree(save_dir, ignore_errors=True)
    epochs, first = [], {}
    real_train = Engine.train

    def train(self, fixbase_epoch=0, open_layers=None, **kw):
        # around each epoch: its launches, and under fixbase the frozen
        # units' state and moments
        model, opt = self.model, self.optimizer
        fixbase = self.epoch < fixbase_epoch and bool(open_layers)
        if not epochs:  # the run's first epoch: what it starts from
            first["epoch"] = self.epoch
            first["state"] = {k: v.detach().cpu().clone()
                              for k, v in model.state_dict().items()}
            first["moments"] = len(opt.state)
        frozen = {name: {k: v.clone() for k, v in unit.state_dict().items()}
                  for name, unit in named_units(model)
                  if fixbase and not is_open(name, open_layers)}
        before = kernels.launch_counts()
        real_train(self, fixbase_epoch=fixbase_epoch,
                   open_layers=open_layers, **kw)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        fwd, bwd = (n * self.accum_steps * len(self.train_loader)
                    for n in fused_sites(model))
        # the fused sites all lie before fc_* and classifier_*: a backward
        # reaches them only when one of their units, or one before, is open
        upstream = [n for n, _ in named_units(model)
                    if not n.startswith(("fc_", "classifier_"))]
        if fixbase and not any(is_open(n, open_layers) for n in upstream):
            bwd = 0
        want = {"mm_stats": fwd, "mm_bn_da": bwd, "mm_bn_dw": bwd}
        got = {k: after[k] - before[k] for k in TRAIN_KERNELS}
        rec = {"epoch": self.epoch + 1, "fixbase": fixbase,
               "steps": len(self.train_loader), "got": got, "want": want}
        if frozen:
            params = {id(p) for n in frozen
                      for p in dict(named_units(model))[n].parameters()}
            now = {name: dict(named_units(model))[name].state_dict()
                   for name in frozen}
            moved = [f"{n}.{k}" for n, sd in frozen.items()
                     for k, v in sd.items() if not torch.equal(now[n][k], v)]
            fused_bn = sum(id(m) in fused_site_bns(model)
                           for n in frozen
                           for m in dict(named_units(model))[n].modules())
            rec.update(frozen_units=len(frozen), frozen_moved=moved,
                       fused_site_bns_checked=fused_bn,
                       frozen_moments=sum(id(p) in params
                                          for p in opt.state))
        epochs.append(rec)
        print(f"ablation epoch: {rec}", flush=True)

    orig_kwargs = main_multimodal.imagedata_kwargs

    def cli(name, *opts):
        kernels.reset_launch_counts()
        epochs.clear()
        first.clear()
        rank1 = main_multimodal.main([
            "--config-file", ABLATION[name], "--device", "cuda",
            "model.pretrained", "False",
            "data.sources", "['synthetic_mm']",
            "data.targets", "['synthetic_mm']",
            "data.height", "256", "data.width", "128",
            "data.save_dir", os.path.join(save_dir, name),
            "train.print_freq", "4", "cuda.fused_1x1", "True", *opts])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        print(f"ablation {name} {' '.join(opts)}: rank1 {rank1:.4f}, "
              f"launches {counts}", flush=True)
        bad = [r for r in epochs if r["got"] != r["want"]
               or r.get("frozen_moved") or r.get("frozen_moments")]
        if bad or not 0.0 <= rank1 <= 1.0:
            raise AssertionError(f"ablation {name}: {bad or rank1}")
        missing = [k for k in TRAIN_KERNELS + ("mm_affine", "distmat")
                   if counts[k] <= 0]
        if missing:
            raise AssertionError(f"ablation {name}: kernels not launched: "
                                 f"{missing}")
        return [dict(r) for r in epochs], dict(first)

    Engine.train = train
    main_multimodal.imagedata_kwargs = lambda cfg: {**orig_kwargs(cfg),
                                                    **ABLATION_DATA}
    try:
        base, _ = cli("base", "train.max_epoch", "2",
                      "train.fixbase_epoch", "1")
        fix = base[0]
        if not (fix["fixbase"] and fix["frozen_units"]
                and fix["fused_site_bns_checked"] and not base[1]["fixbase"]):
            raise AssertionError(f"fixbase epoch not checked: {base}")
        ckpt = os.path.join(save_dir, "base", "model", "model.pth.tar-2")
        saved = torch.load(ckpt, map_location="cpu", weights_only=False)
        resumed, start = cli("base", "train.max_epoch", "3",
                             "model.resume", ckpt)
        same = all(torch.equal(start["state"][k], v)
                   for k, v in saved["state_dict"].items())
        print(f"ablation resume: starts at epoch {start['epoch'] + 1}, "
              f"weights as saved {same}, {start['moments']} SGD moments "
              f"(saved {len(saved['optimizer']['state'])})")
        if (start["epoch"] != 2 or not same or [r["epoch"] for r in resumed]
                != [3] or start["moments"] != len(
                    saved["optimizer"]["state"])):
            raise AssertionError("resume did not restore epoch 2's state")
        cli("cim", "train.max_epoch", "1", "data.k_tfm", "2",
            "train.accum_steps", "2")
    finally:
        Engine.train = real_train
        main_multimodal.imagedata_kwargs = orig_kwargs

    # the sweep at batch 128: 3 warm-up and 5 timed steps a variant
    kernels.reset_launch_counts()
    recs = ablation_sweep.main(["128", "5", "--fused", "--device", "cuda",
                                "--out", os.path.join(save_dir,
                                                      "ABLATION.json")])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    with torch.device("meta"):
        sites = [fused_sites(IEEE3modalPart(fused_1x1=True, **flags))
                 for _, flags in ablation_sweep.VARIANTS]
    for r in recs:
        print(f"ablation_sweep {r['variant']}: {r['triplets_per_sec']} "
              f"triplets/s ({r['ms_per_step']} ms/step, batch 128, fused), "
              f"loss {r['loss_first']} -> {r['loss_last']}")
    fwd, bwd = (8 * sum(s[i] for s in sites) for i in (0, 1))
    want = {"mm_stats": fwd, "mm_bn_da": bwd, "mm_bn_dw": bwd}
    got = {k: counts[k] for k in TRAIN_KERNELS}
    if got != want or not all(math.isfinite(r["loss_last"]) for r in recs):
        raise AssertionError(f"ablation_sweep launched {got}, want {want}")
    shutil.rmtree(save_dir, ignore_errors=True)  # 5 GB of checkpoints


def write_market_mm_tree(root, pids=8, imgs=4):
    """A ``market1501_to_RGBNT201`` tree of 256x128 jpegs from a seed:
    ``pids`` ids x ``imgs`` images in train, query and gallery (test ids
    apart from train ids), each in RGB, NI and TI under one name."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    for split, first in (("train", 1), ("query", 101), ("gallery", 101)):
        for p in range(first, first + pids):
            for j in range(imgs):
                cam = 1 + (j + (split == "gallery")) % 6
                name = f"{p:04d}_c{cam}s1_{j:06d}_00.jpg"
                for modal in ("RGB", "NI", "TI"):
                    d = os.path.join(root, "market1501_to_RGBNT201", split,
                                     modal)
                    os.makedirs(d, exist_ok=True)
                    Image.fromarray(rng.integers(
                        0, 256, (256, 128, 3), np.uint8)).save(
                            os.path.join(d, name))


def single_modal_market(results):
    """Phase 10: configs[0] through the single-modal CLI and its train step
    timed, configs[4] through the CLI on a Market tree, the distmat at the
    single-modal widths."""
    import shutil

    import torch

    from ieee_tpu_torch import main as single_main
    from ieee_tpu_torch import main_multimodal
    from ieee_tpu_torch.data import ImageDataManager
    from ieee_tpu_torch.engine import ImageSoftmaxEngine
    from ieee_tpu_torch.models import build_model
    from ieee_tpu_torch.ops import distance, kernels
    from ieee_tpu_torch.optim import build_optimizer
    from ieee_tpu_torch.tools.profile_train import profile_steps

    save_dir = os.path.join(ROOT, "log", "chip_smoke_market")
    shutil.rmtree(save_dir, ignore_errors=True)
    # the distmat calls' shapes, seen at the one name the eval goes through
    shapes = []
    real_sq = distance.euclidean_sq

    def spy(q, g):
        shapes.append((q.shape[0], g.shape[0], q.shape[1]))
        return real_sq(q, g)

    distance.euclidean_sq = spy
    try:
        kernels.reset_launch_counts()
        rank1 = single_main.main([
            "--config-file", MARKET_R50, "--device", "cuda",
            "model.pretrained", "False",
            "data.sources", "['synthetic']", "data.targets", "['synthetic']",
            "data.save_dir", os.path.join(save_dir, "r50"),
            "train.max_epoch", "1", "train.print_freq", "1"])
        torch.cuda.synchronize()
    finally:
        distance.euclidean_sq = real_sq
    counts = kernels.launch_counts()
    print(f"single-modal CLI (market1501_softmax_r50.yaml on synthetic): "
          f"rank1 {rank1:.4f}, distmat calls {shapes}, launches {counts}")
    if not 0.0 <= rank1 <= 1.0:
        raise AssertionError(f"rank-1 {rank1} outside [0, 1]")
    if not shapes or any(s[2] != 2048 for s in shapes) or (
            counts["distmat"] != len(shapes)):
        raise AssertionError(f"distmat not launched at K = 2048: {shapes}, "
                             f"{counts}")
    if any(v for k, v in counts.items() if k != "distmat"):
        raise AssertionError(f"the single-modal path launched other "
                             f"kernels: {counts}")

    # configs[0]'s train step at phase 7's protocol: batch 32, adam
    dm = ImageDataManager(sources="synthetic", height=256, width=128,
                          batch_size_train=32, workers=4, verbose=False,
                          seed=0)
    model = build_model("resnet50", dm.num_train_pids, "softmax",
                        pretrained=False, seed=1)
    opt = build_optimizer(model, optim="adam", lr=3e-4, weight_decay=5e-4)
    eng = ImageSoftmaxEngine(dm, model, opt, device="cuda", seed=0)
    imgs, pids = eng._put_batch(next(iter(dm.train_loader)))
    for _ in range(3):
        eng.train_step(imgs, pids)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(20):
        m = eng.train_step(imgs, pids)
    loss = m["loss"].item()  # syncs on the last step
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"single-modal train step (resnet50, batch 32, 256x128, adam, "
          f"bf16): {20 * 32 / dt:.1f} images/s ({dt / 20 * 1e3:.3f} "
          f"ms/step); last loss {loss:.4f}; peak memory {peak:.2f} GiB; "
          f"{card_line()}")
    dev_ms, busy, rows = profile_steps(lambda: eng.train_step(imgs, pids))
    print(f"  profiler: {dev_ms:.3f} device ms per step, busy {busy:.3f}")
    for key, cnt, ms in rows[:8]:
        print(f"  {ms:8.3f} ms/step {cnt:4d}x {key[:70]}")
    if not math.isfinite(loss):
        raise AssertionError(f"single-modal train loss not finite: {loss}")
    del model, opt, eng, m
    torch.cuda.empty_cache()

    # configs[4] through the CLI on a market1501_to_RGBNT201 tree
    write_market_mm_tree(os.path.join(save_dir, "data"))
    kernels.reset_launch_counts()
    rank1 = main_multimodal.main([
        "--config-file", MARKET_MM, "--device", "cuda",
        "--root", os.path.join(save_dir, "data"), "model.pretrained", "False",
        "data.save_dir", os.path.join(save_dir, "mm"),
        "train.max_epoch", "1", "train.print_freq", "1",
        "cuda.fused_1x1", "True", "cuda.fused_eval", "True"])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    print(f"market_mm_margin.yaml CLI (market1501_to_RGBNT201 tree, 8 ids x "
          f"4 images): rank1 {rank1:.4f}, launches {counts}")
    missing = [k for k in EVAL_KERNELS + TRAIN_KERNELS if counts[k] <= 0]
    if missing or not 0.0 <= rank1 <= 1.0:
        raise AssertionError(f"market_mm: kernels not launched {missing}, "
                             f"rank-1 {rank1}")
    if (len({counts[k] for k in TRAIN_KERNELS}) != 1
            or counts["mm_stats"] != 4 * 33
            or any(counts[k] for k in BLOCK_KERNELS)):
        raise AssertionError(f"market_mm: not 33 launches of each train "
                             f"kernel in each of 4 steps: {counts}")
    shutil.rmtree(save_dir, ignore_errors=True)

    # the distmat at the single-modal widths
    distmat_scale(results, 3368, 15913, 2048, check_ranks=True)
    distmat_scale(results, 836, 836, 512, check_ranks=True)


def _cos_rows(a, b):
    return (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1)).clamp_min(1e-12)


def check_conv_s8(results):
    """Phase 11 (a): conv_s8 at every distinct site shape against its plain
    version, with the times of the kernel, the plain version, cuDNN's bf16
    conv2d and (1x1 sites) torch._int_mm beside the bound."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ieee_tpu_torch.ops.kernels.conv_s8 import conv_s8, conv_s8_plain
    from ieee_tpu_torch.tools.int8_probe import distinct_sites, site_work

    # (shape, x dtype, relu, weight): the IEEE trunk's sites at the engine
    # eval's batch weighted by their count in one trunk (the reported unit);
    # the feature extractor's resnet50 and resnet18's basic blocks add the
    # shapes not seen yet, outside the unit
    cases, seen = [], set()
    for spec, weighted in (((100, 256, 128, "bottleneck", (3, 4, 6, 3), 1),
                            True),
                           ((32, 256, 128, "bottleneck", (3, 4, 6, 3), 2),
                            False),
                           ((4, 256, 128, "basic", (2, 2, 2, 2), 2), False)):
        b, h, w, block, layers, last_stride = spec
        for shape, dtype, relu, count in distinct_sites(
                b, h, w, block, layers, last_stride):
            if (shape[1:], dtype) in seen:
                continue
            seen.add((shape[1:], dtype))
            cases.append((shape, dtype, relu, count if weighted else 0))
    r = results.setdefault("conv_s8", {"max_abs_err": 0.0, "cases": []})
    total = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    for i, (shape, dtype, relu, weight) in enumerate(cases):
        b, h, w, cin, cout, k, stride, pad = shape
        rng = np.random.default_rng(100 + i)
        x = torch.tensor(rng.standard_normal((b, h, w, cin), np.float32),
                         device="cuda").to(dtype)
        wq = torch.tensor(rng.integers(-127, 128, (cout, k, k, cin),
                                       dtype=np.int8), device="cuda")
        scale = torch.tensor(rng.uniform(1e-4, 1e-3, cout).astype(
            np.float32), device="cuda")
        bias = torch.tensor(rng.standard_normal(cout).astype(np.float32),
                            device="cuda")
        # the calibrated scale of this input: absmax / 127, inverted in f32
        inv_sx = float(np.float32(127.0 / x.float().abs().max().item()))
        args = (stride, pad, relu, inv_sx)
        acc = conv_s8(x, wq, None, None, *args, raw=True)
        want_acc = conv_s8_plain(x, wq, None, None, *args, raw=True)
        got = conv_s8(x, wq, scale, bias, *args)
        want = conv_s8_plain(x, wq, scale, bias, *args)
        torch.cuda.synchronize()
        w32 = want.float()
        ulp = torch.where(w32 == 0, torch.zeros_like(w32),
                          2.0 ** (torch.floor(torch.log2(w32.abs())) - 7))
        diff = (got.float() - w32).abs()
        err = diff.max().item()
        exact = torch.equal(acc, want_acc)
        if not exact or not bool((diff <= ulp).all()):
            raise AssertionError(f"conv_s8 {shape} disagrees with its plain "
                                 f"version: s32 equal {exact}, bf16 max "
                                 f"error {err}")
        ms = median_ms(lambda: conv_s8(x, wq, scale, bias, *args), 10)
        plain_ms = median_ms(
            lambda: conv_s8_plain(x, wq, scale, bias, *args), 3, warmup=1)
        xc = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        wc = wq.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        lib_ms = median_ms(lambda: F.conv2d(xc, wc, None, stride, pad), 10)
        int_mm = ""
        if k == 1:
            # the product alone on the gathered, quantized rows
            xs = x[:, ::stride, ::stride] if stride > 1 else x
            rows = torch.clamp(torch.round(xs.float() * inv_sx), -127,
                               127).to(torch.int8).reshape(-1, cin)
            bt = wq.reshape(cout, cin).t()
            mm_ms = median_ms(lambda: torch._int_mm(rows, bt), 10)
            int_mm = f" _int_mm {mm_ms:.4f} ms (product only)"
        ops, nbytes = site_work(shape, dtype)
        bound = bound_ms(ops, nbytes, "int8")
        print(f"kernel conv_s8 {list(shape)} {str(dtype)[6:]} (x{weight}): "
              f"s32 equal, bf16 max_abs_err {err:.3e} (tol one bf16 step) "
              f"kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s) plain "
              f"{plain_ms:.4f} ms library {lib_ms:.4f} ms (cuDNN bf16 "
              f"conv2d){int_mm} bound {bound[0]:.4f} ms ({bound[1]})")
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["cases"].append({"shape": list(shape), "ms": ms,
                           "plain_ms": plain_ms, "library_ms": lib_ms,
                           "bound_ms": bound[0], "bound_by": bound[1],
                           "max_abs_err": err, "weight": weight})
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms), ("bound_ms", bound[0])):
            total[key] += weight * v
        del x, wq, acc, want_acc, got, want, xc, wc
    torch.cuda.empty_cache()
    print(f"conv_s8 per trunk ({INT8_SITES} sites, batch 100): kernel "
          f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, cuDNN "
          f"bf16 {total['library_ms']:.4f} ms, bound "
          f"{total['bound_ms']:.4f} ms")


def int8_engine_eval():
    """Phase 11 (b): the engine's eval, plain, fused and int8, on one
    model; returns the launch counts of the int8 run (the main path)."""
    import torch
    import torch.nn.functional as F

    from ieee_tpu_torch.data import ImageDataManager
    from ieee_tpu_torch.engine import Engine
    from ieee_tpu_torch.models import build_model
    from ieee_tpu_torch.models import int8_eval as ie
    from ieee_tpu_torch.models.fast_eval import head_from_maps
    from ieee_tpu_torch.ops import kernels
    from ieee_tpu_torch.ops.distance import compute_distance_matrix
    from ieee_tpu_torch.ops.kernels.conv_s8 import conv_s8_plain
    from ieee_tpu_torch.ops.ranking import evaluate_rank
    from torch.profiler import ProfilerActivity, profile

    dm = ImageDataManager(sources="synthetic_mm", height=256, width=128,
                          batch_size_test=100, workers=4, num_pids=171,
                          imgs_per_pid=8, verbose=False)
    loaders = dm.test_loader["synthetic_mm"]
    model = build_model("ieee3modalPart", dm.num_train_pids, "margin",
                        pretrained=False, seed=1)
    batch = next(iter(loaders["gallery"]))["img"]
    imgs = tuple(torch.from_numpy(m).cuda() for m in batch)

    def features(eng):
        qf, q_pids, q_cams = eng._feature_extraction(loaders["query"])
        gf, g_pids, g_cams = eng._feature_extraction(loaders["gallery"])
        cmc, mAP = evaluate_rank(compute_distance_matrix(qf, gf), q_pids,
                                 g_pids, q_cams, g_cams)
        return torch.cat([qf, gf]), float(mAP), float(cmc[0])

    engines, feats, ms, counts = {}, {}, {}, {}
    for name, kw in (("plain", {}), ("fused", {"fused_eval": True}),
                     ("int8", {"int8_eval": True})):
        eng = engines[name] = Engine(dm, model, device="cuda", **kw)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        feats[name] = features(eng)
        torch.cuda.synchronize()
        counts[name] = kernels.launch_counts()
        host_s = time.perf_counter() - t0
        ms[name] = median_ms(lambda: eng.extract_features(imgs), iters=10)
        f, mAP, rank1 = feats[name]
        print(f"int8 phase, engine eval {name}: {ms[name]:.3f} ms/batch "
              f"(batch 100, {100 / ms[name] * 1e3:.1f} triplets/s); 510 "
              f"triplets incl. host decode {host_s:.3f} s; mAP {mAP:.4f} "
              f"rank1 {rank1:.4f}; launches "
              f"{ {k: v for k, v in counts[name].items() if v} }")
        if not torch.isfinite(f).all() or f.shape != (510, 2304):
            raise AssertionError(f"{name} features bad: {tuple(f.shape)}")
    batches = -(-170 // 100) + -(-340 // 100)
    if counts["int8"]["conv_s8"] != batches * 3 * INT8_SITES:
        raise AssertionError(f"int8 eval: not {3 * INT8_SITES} conv_s8 "
                             f"launches in each of {batches} batches: "
                             f"{counts['int8']}")
    q8 = feats["int8"][0]
    cos = _cos_rows(q8, feats["plain"][0])
    print(f"int8 vs plain (bf16) features: min cosine {cos.min().item():.6f}"
          f", mean {cos.mean().item():.6f}; mAP {feats['int8'][1]:.4f} vs "
          f"{feats['plain'][1]:.4f}")

    # the same int8 path with every conv on conv_s8's plain version and the
    # scales the engine's step calibrated: the kernel, not the quantization
    step = engines["int8"]._eval_step_fn
    scales, tfm = step.holder["scales"], dm.transform_te
    execs = [ie.make_trunk_exec(t.block, t.layers, t.last_stride)
             for t in model.backbone]

    @torch.inference_mode()
    def ref_step(imgs):
        xs = [tfm(m).permute(0, 2, 3, 1).contiguous() for m in imgs]
        maps = [ie.trunk_forward_int8(execs[i], model.backbone[i], xs[i],
                                      scales[i], conv_fn=conv_s8_plain)
                for i in range(3)]
        return head_from_maps(model, [m.permute(0, 3, 1, 2) for m in maps])

    ref = Engine(dm, model, device="cuda")
    ref._eval_step_fn = ref_step
    t0 = time.perf_counter()
    want = features(ref)[0]
    cos = _cos_rows(q8, want)
    print(f"int8 features vs the plain conv's with the same scales: min "
          f"cosine {cos.min().item():.8f}, max |diff| "
          f"{(q8 - want).abs().max().item():.3e} "
          f"({time.perf_counter() - t0:.1f} s)")
    if cos.min().item() < 0.999:
        raise AssertionError(f"int8 features disagree with the plain "
                             f"conv's: cosine {cos.min().item()}")

    # one steady batch: the kernels it launches, no F.conv2d call and no
    # cuDNN conv kernel in its profile
    calls = []
    conv2d = F.conv2d

    def counting(*args, **kw):
        calls.append(1)
        return conv2d(*args, **kw)

    F.conv2d = counting
    try:
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            engines["int8"].extract_features(imgs)
            torch.cuda.synchronize()
        steady = kernels.launch_counts()
    finally:
        F.conv2d = conv2d
    rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), key=lambda r: -r[2])
    convs = [k for k, _, _ in rows if "conv_s8" not in k and any(
        t in k.lower() for t in ("conv", "fprop", "cudnn", "dgrad"))]
    s8 = sum(n for k, n, _ in rows if "conv_s8" in k)
    print(f"int8 steady batch: launches "
          f"{ {k: v for k, v in steady.items() if v} }, F.conv2d calls "
          f"{len(calls)}, profiled conv_s8 kernels {s8}, other conv kernels "
          f"{convs}; device {sum(r[2] for r in rows):.3f} ms in "
          f"{sum(r[1] for r in rows)} kernels, top:")
    for key, n, dev_ms in rows[:8]:
        print(f"  {dev_ms:9.3f} ms ({n}) {short_name(key)[:90]}")
    want_counts = dict.fromkeys(steady, 0)
    want_counts.update(conv_s8=3 * INT8_SITES, partpool=6)
    if steady != want_counts or calls or convs:
        raise AssertionError(f"int8 steady batch: launches {steady}, "
                             f"F.conv2d calls {len(calls)}, conv kernels "
                             f"{convs}")
    print(f"int8 eval at batch 100: {ms['int8']:.3f} ms/batch, plain "
          f"{ms['plain']:.3f}, fused {ms['fused']:.3f}")
    del engines, ref, model
    torch.cuda.empty_cache()
    return counts["int8"]


def int8_feature_extractor():
    """Phase 11 (c): FeatureExtractor("resnet50", int8=True) at batch 32
    against its plain path."""
    import numpy as np
    import torch

    from ieee_tpu_torch.ops import kernels
    from ieee_tpu_torch.utils.feature_extractor import FeatureExtractor

    batch = np.random.default_rng(7).integers(0, 256, (32, 256, 128, 3),
                                              dtype=np.uint8)
    fe8 = FeatureExtractor("resnet50", pretrained=False, int8=True)
    fe = FeatureExtractor("resnet50", pretrained=False)
    fe8(batch)  # calibrates
    kernels.reset_launch_counts()
    f8 = fe8(batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    f = fe(batch)
    cos = _cos_rows(f8, f)
    print(f"feature extractor resnet50 int8 vs plain (batch 32): min cosine "
          f"{cos.min().item():.6f}, mean {cos.mean().item():.6f}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if (f8.shape != (32, 2048) or not torch.isfinite(f8).all()
            or counts["conv_s8"] != INT8_SITES):
        raise AssertionError(f"feature extractor int8: {tuple(f8.shape)}, "
                             f"launches {counts}")
    del fe8, fe
    torch.cuda.empty_cache()


def _market_split(dim, seed, noise):
    """Seeded Market-1501-sized query and gallery features (``dim``-d, each
    its id's centre plus gaussian noise of std ``noise``, 750 ids, so that
    neighbour sets follow identities as on trained features), with their
    ids and cameras, on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    centres = torch.randn((MARKET_IDS, dim), generator=gen, device="cuda")
    out = []
    for num in (MARKET_Q, MARKET_G):
        ids = torch.randint(0, MARKET_IDS, (num,), generator=gen,
                            device="cuda")
        out.append((centres[ids] + noise * torch.randn(
            (num, dim), generator=gen, device="cuda"), ids,
            torch.randint(0, 6, (num,), generator=gen, device="cuda")))
    (qf, q_ids, q_cams), (gf, g_ids, g_cams) = out
    return qf, gf, q_ids, g_ids, q_cams, g_cams


def rerank_cli_eval():
    """Phase 12 (a): the headline config's eval through the CLI with
    ``test.rerank True``; returns the launch counts of its run."""
    import numpy as np
    import torch

    from ieee_tpu_torch import main_multimodal
    from ieee_tpu_torch.engine import engine as engine_mod
    from ieee_tpu_torch.ops import kernels
    from ieee_tpu_torch.ops.rerank import re_ranking

    # the re-rank's operands and result, seen at the name the engine calls
    seen = []
    real = engine_mod.re_ranking_device

    def spy(qg, qq, gg, **kw):
        out = real(qg, qq, gg, **kw)
        seen.append([t.cpu().numpy() for t in (qg, qq, gg, out)])
        return out

    engine_mod.re_ranking_device = spy
    try:
        kernels.reset_launch_counts()
        rank1 = main_multimodal.main([
            "--config-file", CONFIG, "--device", "cuda",
            "model.pretrained", "False",
            "data.sources", "['synthetic_mm']",
            "data.targets", "['synthetic_mm']",
            "data.height", "256", "data.width", "128",
            "data.save_dir", os.path.join(ROOT, "log", "chip_smoke_rerank"),
            "test.evaluate", "True", "test.batch_size", "100",
            "test.rerank", "True"])
        torch.cuda.synchronize()
    finally:
        engine_mod.re_ranking_device = real
    counts = kernels.launch_counts()
    if len(seen) != 1:
        raise AssertionError(f"{len(seen)} re-ranks in one evaluation")
    qg, qq, gg, out = seen[0]
    n = qq.shape[0] + gg.shape[0]
    want = re_ranking(qg, qq, gg)
    err = float(np.abs(out - want).max())
    ok = np.allclose(out, want, rtol=1e-4, atol=1e-5)
    print(f"re-ranked CLI eval ({qq.shape[0]} query x {gg.shape[0]} gallery, "
          f"n {n} > k1 + 1 = {RERANK_K1 + 1}): rank1 {rank1:.4f}, launches "
          f"{ {k: v for k, v in counts.items() if v} }; against the numpy "
          f"oracle on the same distmats: max_abs_err {err:.3e} (rtol 1e-4, "
          f"atol 1e-5)")
    if not 0.0 <= rank1 <= 1.0 or out.shape != qg.shape:
        raise AssertionError(f"re-ranked eval: rank-1 {rank1}, "
                             f"{out.shape} vs {qg.shape}")
    if n <= RERANK_K1 + 1 or counts["distmat"] != 3 or (
            counts["jaccard_minsum"] != 1):
        raise AssertionError(f"re-ranked eval off the device path: n {n}, "
                             f"launches {counts}")
    if any(v for k, v in counts.items()
           if k not in ("distmat", "jaccard_minsum")):
        raise AssertionError(f"re-ranked eval launched other kernels: "
                             f"{counts}")
    if not ok:
        raise AssertionError(f"device re-rank disagrees with the oracle: "
                             f"{err}")
    return counts


def rerank_market(results):
    """Phase 12 (b): k-reciprocal re-ranking at Market-1501 scale on seeded
    2304-d features: the device re-rank timed, f32 and bf16, with its peak
    memory; ``jaccard_minsum`` against its plain version on the call's
    membership vectors, with the kernel's, the plain version's and the
    bound's times."""
    import torch

    from ieee_tpu_torch.ops import kernels
    from ieee_tpu_torch.ops.distance import compute_distance_matrix
    from ieee_tpu_torch.ops.kernels.rerank import (
        jaccard_minsum, jaccard_minsum_plain)
    from ieee_tpu_torch.ops.ranking import _device_rank
    from ieee_tpu_torch.ops.rerank_device import (
        _membership, re_ranking_device)

    qf, gf, q_ids, g_ids, q_cams, g_cams = _market_split(2304, 31, 4.0)
    qg = compute_distance_matrix(qf, gf)
    qq = compute_distance_matrix(qf, qf)
    gg = compute_distance_matrix(gf, gf)
    del qf, gf
    torch.cuda.synchronize()
    times = {}
    for bf16 in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = re_ranking_device(qg, qq, gg, RERANK_K1, RERANK_K2,
                                minsum_bf16=bf16)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        if kernels.launch_counts()["jaccard_minsum"] != 1:
            raise AssertionError("re_ranking_device: not one jaccard_minsum "
                                 "launch")
        t0 = time.perf_counter()
        for _ in range(2):
            out = re_ranking_device(qg, qq, gg, RERANK_K1, RERANK_K2,
                                    minsum_bf16=bf16)
        torch.cuda.synchronize()
        times[bf16] = (time.perf_counter() - t0) / 2
        if not torch.isfinite(out).all() or out.shape != qg.shape:
            raise AssertionError(f"re-ranked distmat bad: {out.shape}")
        ranks = [_device_rank(d, q_ids, g_ids, q_cams, g_cams, 50)
                 for d in (qg, out)]
        print(f"k-reciprocal at Market scale ({MARKET_Q} x {MARKET_G}, "
              f"2304-d, k1 {RERANK_K1} k2 {RERANK_K2}, "
              f"{'bf16' if bf16 else 'f32'} min-sum): {times[bf16]:.4f} s a "
              f"call (first {first:.4f} s), peak memory {peak:.2f} GiB above "
              f"the distmats; mAP {float(ranks[0][1]):.4f} -> "
              f"{float(ranks[1][1]):.4f}, rank-1 {float(ranks[0][0][0]):.4f} "
              f"-> {float(ranks[1][0][0]):.4f}; {card_line()}")
        del out
    print("  profiler, one f32 re-rank call (device ms by kernel):")
    for key, ms in kernel_ms(lambda: re_ranking_device(
            qg, qq, gg, RERANK_K1, RERANK_K2), calls=1)[:8]:
        print(f"  {ms:9.3f} ms {short_name(key)[:70]}")

    # the kernel alone on this call's membership vectors
    V, _ = _membership(qg, qq, gg, RERANK_K1, RERANK_K2)
    del qg, qq, gg
    vq, vg = V[:MARKET_Q], V[MARKET_Q:]
    n = V.shape[1]
    got = jaccard_minsum(vq, vg)
    again = jaccard_minsum(vq, vg)
    t0 = time.perf_counter()
    want = jaccard_minsum_plain(vq, vg)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(got, again):
        raise AssertionError("jaccard_minsum: two runs differ")
    err = (got - want).abs().max().item()
    del want, again
    ms = median_ms(lambda: jaccard_minsum(vq, vg), iters=3, warmup=1)
    # work: the dense form's (min, add) pairs, and the pairs this V needs
    # (both operands non-zero); bytes: V read once, the output written once
    dense = float(MARKET_Q) * MARKET_G * n
    nz = (V != 0)
    sparse = float((nz[:MARKET_Q].sum(0).double()
                    * nz[MARKET_Q:].sum(0).double()).sum())
    del nz
    nbytes = 4.0 * (MARKET_Q + MARKET_G) * n + 4.0 * MARKET_Q * MARKET_G
    bound = bound_ms(sparse, nbytes, "minadd")
    dense_bound = bound_ms(dense, nbytes, "minadd")
    print(f"kernel jaccard_minsum {[MARKET_Q, MARKET_G, n]} f32: "
          f"max_abs_err {err:.3e} (tol 1e-5) kernel {ms:.4f} ms plain "
          f"{plain_ms:.4f} ms (one call) library none bound {bound[0]:.4f} "
          f"ms ({bound[1]}; the data's {sparse:.4e} non-zero pairs) dense "
          f"form's bound {dense_bound[0]:.4f} ms ({dense_bound[1]}, "
          f"{dense:.4e} pairs at 16.75e12 a second)")
    if err > 1e-5:
        raise AssertionError(f"jaccard_minsum disagrees with its plain "
                             f"version: {err}")
    results["jaccard_minsum"] = {"max_abs_err": err, "cases": [
        {"shape": [MARKET_Q, MARKET_G, n], "ms": ms, "plain_ms": plain_ms,
         "library_ms": None, "bound_ms": bound[0], "bound_by": bound[1],
         "max_abs_err": err, "weight": 1}]}
    del got
    # bf16 staging on the first 256 query rows
    Vb = V.to(torch.bfloat16)
    del V, vq, vg
    got = jaccard_minsum(Vb[:256], Vb[MARKET_Q:])
    want = jaccard_minsum_plain(Vb[:256], Vb[MARKET_Q:])
    err_b = (got - want).abs().max().item()
    ms_b = median_ms(lambda: jaccard_minsum(Vb[:MARKET_Q], Vb[MARKET_Q:]),
                     iters=3, warmup=1)
    print(f"kernel jaccard_minsum bf16 V: max_abs_err {err_b:.3e} on 256 "
          f"query rows (tol 1e-5), kernel {ms_b:.4f} ms at "
          f"{[MARKET_Q, MARKET_G, n]}")
    if err_b > 1e-5:
        raise AssertionError(f"jaccard_minsum bf16 disagrees with its plain "
                             f"version: {err_b}")
    results["jaccard_minsum"]["max_abs_err"] = max(err, err_b)
    del Vb, got, want
    torch.cuda.empty_cache()
    print(f"re-rank times: f32 {times[False]:.4f} s, bf16 {times[True]:.4f} s")


def gnn_market(results):
    """Phase 12 (c): GNN re-ranking at Market-1501 scale (k1 26, k2 7,
    512-d): the GNN CLI on a pickle of seeded features (launch counts set
    to 0 just before, read just after: 2 ``gnn_propagate``), both
    propagation forms timed, and ``gnn_propagate`` against its plain
    version at the call's shape; returns the CLI run's launch counts."""
    import pickle
    import shutil

    import torch

    from ieee_tpu_torch.ops import kernels
    from ieee_tpu_torch.ops.gnn_rerank import _gnn_graph, _gnn_rerank_scores
    from ieee_tpu_torch.ops.kernels.rerank import (
        gnn_propagate, gnn_propagate_plain)
    from ieee_tpu_torch.tools import gnn_rerank_cli

    qf, gf, q_ids, g_ids, q_cams, g_cams = _market_split(512, 41, 3.0)
    save_dir = os.path.join(ROOT, "log", "chip_smoke_gnn")
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "features.pkl")
    with open(path, "wb") as f:
        pickle.dump({"query_f": qf.cpu().numpy(), "gallery_f":
                     gf.cpu().numpy(), "query_pid": q_ids.cpu().numpy(),
                     "gallery_pid": g_ids.cpu().numpy(), "query_cam":
                     q_cams.cpu().numpy(), "gallery_cam":
                     g_cams.cpu().numpy()}, f)
    kernels.reset_launch_counts()
    res = gnn_rerank_cli.main(["--data", path, "--device", "cuda", "--k1",
                               str(GNN_K1), "--k2", str(GNN_K2)])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    shutil.rmtree(save_dir, ignore_errors=True)
    print(f"GNN CLI at Market scale: {res['ms']:.1f} ms (first call), mAP "
          f"{res['mAP']:.4f}, launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if counts["gnn_propagate"] != 2 or any(
            v for k, v in counts.items() if k != "gnn_propagate"):
        raise AssertionError(f"GNN CLI: not two gnn_propagate launches: "
                             f"{counts}")
    L = res["ranking"]
    if L.shape != (MARKET_Q, MARKET_G) or not bool((L.sort(1).values == (
            torch.arange(MARKET_G, device="cuda"))).all()):
        raise AssertionError(f"GNN ranking bad: {tuple(L.shape)}")
    del res, L

    qn = qf / qf.norm(dim=1, keepdim=True)
    gn = gf / gf.norm(dim=1, keepdim=True)
    for track in (False, True):
        kernels.reset_launch_counts()
        ms = median_ms(lambda: _gnn_rerank_scores(qn, gn, GNN_K1, GNN_K2,
                                                  track), iters=2, warmup=1)
        if kernels.launch_counts()["gnn_propagate"] != 2 * 3:
            raise AssertionError("GNN scores: not two gnn_propagate "
                                 "launches a call")
        print(f"GNN scores at Market scale "
              f"[{'transpose-free' if track else 'A+A.T'}]: {ms:.3f} ms a "
              f"call")
    print("  profiler, one A+A.T GNN scores call (device ms by kernel):")
    for key, ms in kernel_ms(lambda: _gnn_rerank_scores(
            qn, gn, GNN_K1, GNN_K2), calls=1)[:8]:
        print(f"  {ms:9.3f} ms {short_name(key)[:70]}")

    A, S, rank = _gnn_graph(qn, gn, GNN_K1)
    C = A + A.T
    del A
    idx = rank[:, :GNN_K2].contiguous()
    vals = S[:, :GNN_K2].contiguous()
    n = C.shape[0]
    got = gnn_propagate(C, idx, vals)
    again = gnn_propagate(C, idx, vals)
    want = gnn_propagate_plain(C, idx, vals)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("gnn_propagate: two runs differ")
    err = (got - want).abs().max().item()
    del got, again, want
    ms = median_ms(lambda: gnn_propagate(C, idx, vals), iters=10)
    plain_ms = median_ms(lambda: gnn_propagate_plain(C, idx, vals), iters=3,
                         warmup=1)
    # bytes: the rows of C some output row gathers, each read once, and the
    # output written once; operations: k2 multiply-adds an element
    rows = idx.unique().numel()
    nbytes = 4.0 * rows * n + 4.0 * n * n + 12.0 * idx.numel()
    bound = bound_ms(2.0 * GNN_K2 * n * n, nbytes, "f32")
    every = bound_ms(0.0, 4.0 * (GNN_K2 + 1) * n * n, "f32")
    print(f"kernel gnn_propagate [{n}, {n}, k2 {GNN_K2}]: max_abs_err "
          f"{err:.3e} (tol 1e-6) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
          f"library none bound {bound[0]:.4f} ms ({bound[1]}; {rows} distinct "
          f"rows gathered) every gathered row from HBM {every[0]:.4f} ms")
    if err > 1e-6:
        raise AssertionError(f"gnn_propagate disagrees with its plain "
                             f"version: {err}")
    results["gnn_propagate"] = {"max_abs_err": err, "cases": [
        {"shape": [n, n, GNN_K2], "ms": ms, "plain_ms": plain_ms,
         "library_ms": None, "bound_ms": bound[0], "bound_by": bound[1],
         "max_abs_err": err, "weight": 1}]}
    del C, idx, vals, S, rank
    torch.cuda.empty_cache()
    return counts


def rerank_phase(results):
    """Phase 12: re-ranking; returns the launch counts of the main paths'
    runs (the re-ranked CLI eval's jaccard_minsum, the GNN CLI's
    gnn_propagate)."""
    counts = rerank_cli_eval()
    rerank_market(results)
    gnn_counts = gnn_market(results)
    return {"jaccard_minsum": counts["jaccard_minsum"],
            "gnn_propagate": gnn_counts["gnn_propagate"]}


def _visrank_cli(data_root, save_dir, *opts):
    """One eval of ``market_mm_margin.yaml`` through the CLI with
    ``test.visrank``; returns (rank-1, launch counts, the engine's one
    ranking as (distmat, ids, keywords, (cmc, mAP)))."""
    import torch

    from ieee_tpu_torch import main_multimodal
    from ieee_tpu_torch.engine import engine as engine_mod
    from ieee_tpu_torch.ops import kernels

    seen = []
    real = engine_mod.evaluate_rank

    def spy(distmat, *ids, **kw):
        out = real(distmat, *ids, **kw)
        seen.append((distmat, ids, kw, out))
        return out

    engine_mod.evaluate_rank = spy
    try:
        kernels.reset_launch_counts()
        rank1 = main_multimodal.main([
            "--config-file", MARKET_MM, "--device", "cuda",
            "--root", data_root, "model.pretrained", "False",
            "data.save_dir", save_dir, "test.evaluate", "True",
            "test.visrank", "True", "test.visrank_topk", str(VISRANK_TOPK),
            *opts])
        torch.cuda.synchronize()
    finally:
        engine_mod.evaluate_rank = real
    counts = kernels.launch_counts()
    if len(seen) != 1:
        raise AssertionError(f"{len(seen)} rankings in one evaluation")
    if counts["distmat"] < 1 or any(
            v for k, v in counts.items() if k != "distmat"):
        raise AssertionError(f"visrank eval: distmat not launched, or "
                             f"other kernels: {counts}")
    return rank1, counts, seen[0]


def eval_report():
    """Phase 13: visrank and the CUHK03 metric through the CLI, the three
    rankers on the eval's distmat, the activation maps, the rank speed at
    Market-1501 scale and ``parse_test_res``."""
    import shutil
    import warnings

    import numpy as np
    import torch
    from PIL import Image

    from ieee_tpu_torch.ops.ranking import evaluate_rank
    from ieee_tpu_torch.tools import (parse_test_res, rank_speed_test,
                                      visualize_actmap)
    from ieee_tpu_torch.utils.reidtools import (BW, GRID_SPACING,
                                                QUERY_EXTRA_SPACING)

    save_dir = os.path.join(ROOT, "log", "chip_smoke_report")
    shutil.rmtree(save_dir, ignore_errors=True)
    data = os.path.join(save_dir, "data")
    write_market_mm_tree(data)
    height, width = 256, 128  # market_mm_margin.yaml's

    # (a) visrank through the CLI: one strip per query entry
    t0 = time.perf_counter()
    rank1, counts, (distmat, ids, _, (cmc, mAP)) = _visrank_cli(
        data, os.path.join(save_dir, "visrank"))
    strips_dir = os.path.join(save_dir, "visrank", "visrank_market_to_RGBNT201")
    strips = sorted(os.listdir(strips_dir))
    num_q = distmat.shape[0]
    want = (height + 2 * BW, (width + 2 * BW) * (VISRANK_TOPK + 1)
            + QUERY_EXTRA_SPACING + GRID_SPACING * (VISRANK_TOPK - 1), 3)
    shapes = {np.asarray(Image.open(os.path.join(strips_dir, f))).shape
              for f in strips}
    print(f"visrank CLI eval (market_mm_margin.yaml, {num_q} query x "
          f"{distmat.shape[1]} gallery, top {VISRANK_TOPK}): rank1 "
          f"{rank1:.4f}, mAP {mAP:.4f}, launches "
          f"{ {k: v for k, v in counts.items() if v} }; {len(strips)} strips "
          f"of {sorted(shapes)}; {time.perf_counter() - t0:.1f} s")
    if len(strips) != num_q or shapes != {want}:
        raise AssertionError(f"visrank: {len(strips)} strips of {shapes}, "
                             f"want {num_q} of {want}")
    tsne = os.path.join(save_dir, "visrank", "tsne_market_to_RGBNT201.png")
    if os.path.isfile(tsne):
        print(f"t-SNE scatter written: {tsne}")
    else:
        missing = []
        for mod in ("matplotlib", "sklearn"):
            try:
                __import__(mod)
            except ImportError:
                missing.append(mod)
        if not missing:
            raise AssertionError("t-SNE scatter not written, and "
                                 "matplotlib and sklearn import")
        print(f"t-SNE scatter skipped: {', '.join(missing)} not installed "
              "(both optional)")

    # the same eval with the CUHK03 metric
    t0 = time.perf_counter()
    _, counts3, (_, _, kw3, (cmc3, mAP3)) = _visrank_cli(
        data, os.path.join(save_dir, "cuhk03"),
        "cuhk03.use_metric_cuhk03", "True")
    cmc3 = np.asarray(cmc3, np.float64)
    print(f"CUHK03 metric CLI eval: mAP {mAP3:.4f}, CMC "
          f"{np.round(cmc3[:10], 4).tolist()}, launches "
          f"{ {k: v for k, v in counts3.items() if v} }; "
          f"{time.perf_counter() - t0:.1f} s")
    if not (kw3.get("use_metric_cuhk03") and np.isfinite(cmc3).all()
            and np.all(np.diff(cmc3) >= 0) and 0 <= cmc3.min()
            and cmc3.max() <= 1 and 0.0 <= mAP3 <= 1.0):
        raise AssertionError(f"CUHK03 metric: {kw3}, CMC {cmc3}, mAP {mAP3}")

    # (b) the three rankers on the eval's distmat, on the card
    if distmat.device.type != "cuda":
        raise AssertionError(f"the eval's distmat is on {distmat.device}")
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        # a native ranker that cannot load warns and takes the device
        # path: fail instead
        warnings.simplefilter("error")
        rankers = {"device": evaluate_rank(distmat, *ids, use_device=True),
                   "numpy": evaluate_rank(distmat, *ids, use_device=False),
                   "native": evaluate_rank(distmat, *ids, use_cython=True)}
    errs = {name: max(float(np.abs(c - rankers["numpy"][0]).max()),
                      abs(m - rankers["numpy"][1]))
            for name, (c, m) in rankers.items()}
    print(f"rankers on the eval's distmat: mAP "
          f"{ {k: round(v[1], 6) for k, v in rankers.items()} }, max "
          f"|diff| against numpy {errs} (1e-6); "
          f"{time.perf_counter() - t0:.1f} s")
    if max(errs.values()) > 1e-6:
        raise AssertionError(f"rankers disagree: {errs}")

    # (c) activation maps of each modality, the model on the card
    t0 = time.perf_counter()
    models = []
    real = visualize_actmap.visactmap

    def spy(model, *args, **kw):
        models.append(model)
        return real(model, *args, **kw)

    visualize_actmap.visactmap = spy
    try:
        for modal in ACTMAP_MODALS:
            out = os.path.join(save_dir, "actmap", modal)
            written = visualize_actmap.main([
                "--config-file", MARKET_MM, "--root", data,
                "--save-dir", out, "--modal", modal, "--device", "cuda",
                "model.pretrained", "False"])
            shapes = {np.asarray(Image.open(p)).shape for p in written}
            on = {p.device.type for m in models[-1:] for p in m.parameters()}
            print(f"actmap {modal}: {len(written)} PNGs of {sorted(shapes)}, "
                  f"parameters on {sorted(on)}")
            if len(written) != num_q or shapes != {(height, 3 * width + 20,
                                                    3)}:
                raise AssertionError(f"actmap {modal}: {len(written)} of "
                                     f"{shapes}")
            if on != {"cuda"}:
                raise AssertionError(f"actmap {modal}: parameters on {on}")
            del written
            models.clear()
            torch.cuda.empty_cache()
    finally:
        visualize_actmap.visactmap = real
    print(f"actmaps: {time.perf_counter() - t0:.1f} s")

    # (d) rank speed at Market-1501's test split; the tool checks 1e-4,
    # and the three must agree to 1e-6
    t0 = time.perf_counter()
    res = rank_speed_test.main(["--device", "cuda", "--num-q", str(MARKET_Q),
                                "--num-g", str(MARKET_G), "--repeat", "1"])
    ref = res["numpy"]
    errs = {name: max(float(np.abs(r[1] - ref[1]).max()), abs(r[2] - ref[2]))
            for name, r in res.items() if name != "native build s"}
    build = res["native build s"]
    print(f"rank speed ({MARKET_Q} x {MARKET_G}, max_rank 50, one call "
          f"each, the device's after one warm-up): "
          + ", ".join(f"{name} {res[name][0] * 1e3:.3f} ms"
                      for name in errs)
          + f"; native build {'none (built before)' if build is None else f'{build:.3f} s'}"
          f"; max |diff| against numpy {errs}; {card_line()}; "
          f"{time.perf_counter() - t0:.1f} s")
    if max(errs.values()) > 1e-6:
        raise AssertionError(f"rank speed: rankers disagree: {errs}")

    # (e) parse_test_res reads back what (a) printed
    avg = parse_test_res.main([os.path.join(save_dir, "visrank")])
    printed = {"mAP": float(f"{mAP * 100:.1f}"),
               "r1": float(f"{cmc[0] * 100:.1f}")}
    print(f"parse_test_res on (a)'s log: {avg}, printed {printed}")
    if any(not abs(avg.get(k, math.nan) - v) <= 1e-9
           for k, v in printed.items()):
        raise AssertionError(f"parse_test_res read {avg}, want {printed}")
    shutil.rmtree(save_dir, ignore_errors=True)


def run_tools(tools=TOOLS):
    """Phase 8 (and 11's int8 tools): each measurement tool's ``main()`` on
    the card; returns the launch counts of each run, by the tool's name and
    arguments."""
    import importlib

    import torch

    from ieee_tpu_torch.ops import kernels

    launches = {}
    for name, argv, must, must_not in tools:
        tool = importlib.import_module(f"ieee_tpu_torch.tools.{name}")
        run = " ".join([name] + argv)
        print(f"tool {run}", flush=True)
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        tool.main(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        launches[run] = counts
        print(f"tool {name}: {time.perf_counter() - t0:.1f} s, launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        missing = [k for k in must if counts[k] <= 0]
        if missing:
            raise AssertionError(f"tool {run} launched none of {missing}")
        extra = [k for k in must_not if counts[k]]
        if extra:
            raise AssertionError(f"tool {run} launched {extra} on the "
                                 "plain path")
        if must == TRAIN_KERNELS and (
                len({counts[k] for k in TRAIN_KERNELS}) != 1
                or counts["mm_stats"] % 33):
            raise AssertionError(f"{run}: train kernels not 33 per "
                                 f"step: {counts}")
        torch.cuda.empty_cache()
    return launches


def main():
    t_start = time.perf_counter()
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
    global card_line, median_ms, bound_ms, short_name, kernel_ms
    from ieee_tpu_torch.ops import _build
    from ieee_tpu_torch.tools._timing import (bound_ms, card_line, kernel_ms,
                                              median_ms, short_name)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    _build.load_library()
    print(f"kernel build: {_build.build_seconds():.2f} s")
    log = _build.build_log()
    for line in log.splitlines():
        if "registers" in line or line.startswith("=="):
            print("  " + line.strip())
    spilling = []
    for name, res in _build.kernel_resources(log).items():
        if "_sm90" in name:
            name = demangle(name)
            print(f"  {name}: {res['registers']} registers, spill stores "
                  f"{res['spill_stores']} B, spill loads {res['spill_loads']} "
                  f"B")
            if res["spill_stores"] or res["spill_loads"]:
                spilling.append(name)
    for name in spilling:
        print(f"  SPILLS: {name}")
    # ptxas warnings, and each distinct performance note once with its
    # count (ptxas prints them after a unit's last entry function, so the
    # kernel a note is about is not known)
    notes: dict = {}
    for line in log.splitlines():
        if "warning" in line.lower():
            print("  " + line.strip())
        elif "Performance Loss" in line:
            note = line.split("Potential Performance Loss:")[1].strip()
            notes[note] = notes.get(note, 0) + 1
    for note, count in notes.items():
        print(f"  ptxas performance note (x{count}): {note}")

    results: dict = {}
    t0 = time.perf_counter()
    check_kernels(results)
    print(f"phase kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    main_path()
    print(f"phase eval path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    engine_eval()
    print(f"phase engine eval: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    distmat_scale(results)
    print(f"phase distmat scale: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts = train_path()
    print(f"phase train path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    block_counts = train_path(block=True)
    print(f"phase train path, block: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    engine_train()
    print(f"phase engine train: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tool_counts = run_tools()
    print(f"phase tools: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ablation_train()
    print(f"phase ablation train: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    single_modal_market(results)
    print(f"phase single-modal and Market configs: "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    check_conv_s8(results)
    int8_counts = int8_engine_eval()
    int8_feature_extractor()
    run_tools(INT8_TOOLS)
    print(f"phase int8 eval: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rerank_counts = rerank_phase(results)
    print(f"phase re-ranking: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eval_report()
    print(f"phase eval reporting: {time.perf_counter() - t0:.1f} s")

    # each kernel's reported numbers: the weighted sum of its cases, where
    # the weight is how often the case runs in the reported unit: distmat
    # at 836x836 (RGBNT201 test), partpool at the head's f32 call,
    # mm_affine over the seven layer4 calls of one trunk at batch 100, each
    # train kernel over the 33 fused sites of one train step at batch 128,
    # each block kernel over the 30 blocks of one train step at batch 128,
    # scale_bf16 over one (8192, 8192) call at each tile height, bn_mm one
    # 16384 x 2048 x 2048 call. launches: the train path's runs (phase 6),
    # the default one for the first six kernels and the block one for the
    # block kernels; the probe kernels' from their tools' runs (phase 8),
    # and mm_stats adds fusion_probe's calls to the train path's; conv_s8
    # over the 53 sites of one trunk at batch 100, its launches from the
    # int8 engine eval (phase 11); jaccard_minsum and gnn_propagate over one
    # call at Market-1501 scale, their launches from the re-ranked CLI eval
    # and the GNN CLI's run (phase 12)
    launches = {name: (block_counts if name in BLOCK_KERNELS
                       else counts)[name] for name in KERNELS}
    launches["conv_s8"] = int8_counts["conv_s8"]
    for name in ("jaccard_minsum", "gnn_propagate"):
        launches[name] = rerank_counts[name]
    launches["scale_bf16"] = tool_counts["bw_probe"]["scale_bf16"]
    for name in ("mm_stats", "bn_mm"):
        launches[name] += tool_counts["fusion_probe"][name]
    print(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
    line = {"kernels": []}
    for name, (source, replaces) in KERNELS.items():
        cases = [c for c in results[name]["cases"] if c["weight"]]

        def total(key):
            if any(c[key] is None for c in cases):
                return None
            return sum(c["weight"] * c[key] for c in cases)

        ops_ms = sum(c["weight"] * c["bound_ms"] for c in cases
                     if c["bound_by"] == "operations")
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": results[name]["max_abs_err"],
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("operations" if ops_ms >= total("bound_ms") / 2
                         else "bytes"),
            "library_ms": total("library_ms")})
    print(card_line())
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
