"""End-to-end IEEE convergence run on learnable synthetic data.

Counterpart of ``tools/train_e2e.py``: trains the full-depth
ieee3modalPart through the port's product surface (``Engine.run``: loader
-> transforms on the device -> train step -> checkpoint -> eval on the
device) on the pid-correlated synthetic 3-modal set, and records the
per-epoch loss and the mAP/CMC trajectory in ONE JSON artifact.

``--variant`` picks the paper's Table-3 ablation, as the JAX tool does:
base (no CIM, CA or REM; weight_m 0), cim (CIM + CA; weight_m 0), cim3m
(CIM + CA with the 3M loss), full. The JAX tool's flags keep their
defaults; ``--device`` (default cuda; ``cpu`` runs the plain PyTorch
versions) takes the place of ``--cpu``. The artifact and the checkpoints
go under ``log/`` by default (the JAX tool writes ``E2E_TRAIN_r03.json``
in the working directory, the JAX package's record). A TERM still
distils the artifact (marked ``complete: false``), and a thread writes a
partial artifact every 60 s. ``--decode-cache`` and ``--device-cache``
are not ported yet (ROADMAP A.4).

Usage:
    python -m ieee_tpu_torch.tools.train_e2e [--variant full] [--epochs 30]
        [--batch 128] [--pids 171] [--imgs-per-pid 8] [--eval-freq 10]
        [--out log/e2e_train/E2E_TRAIN.json] [--save-dir log/e2e_train]
        [--resume] [--init-from CKPT] [--device cuda]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import os.path as osp
import signal
import subprocess
import sys
import threading
import time

import torch

from ..data import ImageDataManager
from ..engine import Image3MEngine
from ..models import build_model
from ..optim import build_lr_scheduler, build_optimizer
from ..utils.checkpoint import list_checkpoints, load_pretrained_weights

__all__ = ["VARIANTS", "params_fingerprint", "distill", "main"]

#: the paper's Table-3 variants: model switches, and whether the 3M loss
#: keeps its weight (base and cim train CE only)
VARIANTS = {
    "base": (dict(interaction=False, attention=False, using_REM=False),
             False),
    "cim": (dict(interaction=True, attention=True, using_REM=False), False),
    "cim3m": (dict(interaction=True, attention=True, using_REM=False), True),
    "full": ({}, True),
}


def _provenance(protocol: dict) -> dict:
    """The git commit of the checkout and a hash of the protocol block."""
    root = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
    try:
        commit = subprocess.run(
            ["git", "-C", root, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10).stdout.strip()
    except Exception:  # noqa: BLE001 - no git, no checkout: still write
        commit = "unknown"
    blob = json.dumps(protocol, sort_keys=True).encode()
    return {"git_commit": commit or "unknown",
            "protocol_hash": hashlib.md5(blob).hexdigest()[:12]}


def params_fingerprint(state_dict) -> str:
    """Order-stable fingerprint of a ``state_dict``: blake2b over the
    (key, float32 L2 norm) pairs of every entry, so two trained
    checkpoints that report the same metrics can be told apart."""
    h = hashlib.blake2b(digest_size=10)
    for k in sorted(state_dict):
        n = torch.linalg.vector_norm(state_dict[k].detach().float()).item()
        h.update(f"{k}:{n:.6e};".encode())
    return h.hexdigest()


def distill(save_dir: str, out: str, protocol: dict, final_rank1,
            wall: float, complete: bool, quiet: bool = False,
            extra: dict | None = None) -> dict:
    """metrics.jsonl -> the artifact: the losses and accuracies per epoch
    (no timing meters) and the evaluations, deduplicated by epoch (a
    resume re-runs epochs; the last record wins). Partial runs write
    ``complete: false``."""
    evals_by_epoch, losses = {}, {}
    path = osp.join(save_dir, "metrics.jsonl")
    if osp.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # a torn tail line (the snapshot raced it)
                if rec.get("kind") == "eval":
                    evals_by_epoch[rec.get("epoch")] = {
                        k: rec[k] for k in rec
                        if k in ("epoch", "mAP", "rank1", "rank5",
                                 "rank10", "rank20")}
                elif rec.get("kind") == "train_epoch":
                    losses[rec["epoch"]] = {
                        k: round(v, 4) for k, v in rec.items()
                        if isinstance(v, float) and k not in
                        ("lr", "batch_time_avg", "data_time_avg")}
    evals = [evals_by_epoch[e] for e in sorted(evals_by_epoch)]
    artifact = {
        "protocol": protocol,
        **_provenance(protocol),
        **(extra or {}),
        "complete": bool(complete),
        "loss_per_epoch": losses,
        "evals": evals,
        "final_rank1": None if final_rank1 is None else float(final_rank1),
        "wall_s": round(wall, 1),
    }
    if osp.dirname(out):
        os.makedirs(osp.dirname(out), exist_ok=True)
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(artifact, f, indent=1)
    os.replace(tmp, out)  # a killed snapshot never leaves torn JSON
    if not quiet:
        print(json.dumps({"complete": bool(complete),
                          "final_rank1": artifact["final_rank1"],
                          "final_mAP": evals[-1]["mAP"] if evals else None,
                          "wall_s": round(wall, 1)}))
    return artifact


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--pids", type=int, default=171)
    ap.add_argument("--imgs-per-pid", type=int, default=8)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--eval-freq", type=int, default=10)
    ap.add_argument("--backbone-layers", type=str, default="",
                    help="e.g. 1,1,1,1 for the shallow CPU-testable stack")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--optim", type=str, default="sgd")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--weight-m", type=float, default=1.0)
    ap.add_argument("--weight-m-warmup", type=int, default=0)
    ap.add_argument("--margin-mean", action="store_true")
    ap.add_argument("--stepsize", type=str, default="20,40")
    ap.add_argument("--variant", type=str, default="full",
                    choices=sorted(VARIANTS),
                    help="paper Table-3 ablation: base (no CIM/CA/REM), "
                         "cim (+CIM+CA, no 3M), cim3m (+CIM+CA+3M), full")
    ap.add_argument("--decode-cache", action="store_true")
    ap.add_argument("--device-cache", action="store_true")
    ap.add_argument("--cross-modal", action="store_true",
                    help="the synthetic-x1 benchmark: identity information "
                         "factorised across the modalities")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--heldout-test", action="store_true",
                    help="query/gallery identities disjoint from train")
    ap.add_argument("--out", type=str,
                    default=osp.join("log", "e2e_train", "E2E_TRAIN.json"))
    ap.add_argument("--save-dir", type=str,
                    default=osp.join("log", "e2e_train"))
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint in save-dir "
                         "(fresh run if none)")
    ap.add_argument("--save-freq", type=int, default=100,
                    help="checkpoint every N epochs and at the last; 0 = "
                         "at every eval")
    ap.add_argument("--init-from", type=str, default="",
                    help="warm-start the model from a checkpoint (tolerant "
                         "partial load); --resume takes precedence")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device to run on (cuda, cuda:N or cpu)")
    ap.add_argument("--distill-only", action="store_true",
                    help="skip training: distil save-dir/metrics.jsonl "
                         "into --out (marked partial) and exit")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    if args.decode_cache or args.device_cache:
        raise NotImplementedError(
            "--decode-cache and --device-cache are not ported yet "
            "(ROADMAP A.4)")
    model_kw, keep_m = VARIANTS[args.variant]
    model_kw = dict(model_kw)
    if not keep_m:
        args.weight_m = 0.0
    if args.backbone_layers:
        model_kw["backbone_layers"] = tuple(
            int(x) for x in args.backbone_layers.split(","))
    lr = args.lr if args.lr is not None else (
        0.001 if args.optim == "sgd" else 3e-4)
    stepsize = [int(x) for x in args.stepsize.split(",")]
    protocol = {
        "dataset": ("synthetic_mm(cross_modal=x1)" if args.cross_modal
                    else "synthetic_mm(correlated=True)"),
        "seed": args.seed,
        "test_split": ("heldout ids (open-set)" if args.heldout_test
                       else "held-out images of seen ids (closed-set)"),
        "pids": args.pids, "imgs_per_pid": args.imgs_per_pid,
        "hw": [args.height, args.width], "batch": args.batch,
        "epochs": args.epochs,
        "optim": (f"{args.optim} lr {lr} wd 5e-4, "
                  f"multi_step {stepsize}, weight_m {args.weight_m}"
                  + (f" warmup {args.weight_m_warmup}"
                     if args.weight_m_warmup else "")
                  + (" margin_mean_over_ids" if args.margin_mean else "")),
        "backbone_layers": args.backbone_layers or "full (3,4,6,3)",
        "variant": args.variant,
    }
    if args.distill_only:
        protocol["backend"] = "unknown (distill-only)"
        return distill(args.save_dir, args.out, protocol, None, 0.0,
                       complete=False)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device} but CUDA is not available; pass "
            "--device cpu to run the plain PyTorch path on the CPU")
    dm = ImageDataManager(
        sources="synthetic_mm", height=args.height, width=args.width,
        batch_size_train=args.batch, batch_size_test=100,
        workers=args.workers, train_sampler="RandomIdentitySampler",
        num_instances=4, num_pids=args.pids,
        imgs_per_pid=args.imgs_per_pid, correlated=True,
        cross_modal=args.cross_modal, verbose=False, seed=args.seed,
        transforms=["random_flip"], heldout_test=args.heldout_test)
    model = build_model("ieee3modalPart", num_classes=args.pids,
                        loss="margin", pretrained=False, device=device,
                        seed=args.seed, **model_kw)
    opt = build_optimizer(model, optim=args.optim, lr=lr, momentum=0.9,
                          weight_decay=5e-4)
    sched = build_lr_scheduler("multi_step", stepsize=stepsize, base_lr=lr)
    eng = Image3MEngine(dm, model, opt, sched, device=device, margin=1.0,
                        weight_m=args.weight_m, seed=args.seed,
                        weight_m_warmup=args.weight_m_warmup,
                        margin_mean_over_ids=args.margin_mean)

    model_dir = osp.join(args.save_dir, "model")
    resume_path = ""
    if args.resume:
        cands = list_checkpoints(model_dir)
        if cands:
            resume_path = cands[-1][1]
            print(f"resuming from {resume_path}")
    if args.init_from and not resume_path:
        load_pretrained_weights(model, args.init_from)
    if args.init_from:
        protocol["init_from"] = args.init_from

    # metrics.jsonl is appended to: a fresh run starts it anew, a resumed
    # one continues its trajectory
    stale = osp.join(args.save_dir, "metrics.jsonl")
    if osp.exists(stale) and not resume_path:
        os.remove(stale)
    protocol["backend"] = device.type

    # a TERM (a timeout's, a scheduler's) must still reach the final
    # distil below
    prev_term = signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    t0 = time.time()
    stop_snap = threading.Event()

    def prune(keep: int = 2):
        # the newest `keep` epoch files cover resume; model-best is apart
        for _, path in list_checkpoints(model_dir)[:-keep]:
            for f in (path, path + ".json"):
                try:
                    os.remove(f)
                except OSError:
                    pass

    def snapshot():
        # signal delivery during native compute is not a reliable cleanup
        # path, so a partial artifact lands every 60 s
        while not stop_snap.wait(60.0):
            try:
                distill(args.save_dir, args.out, protocol, None,
                        time.time() - t0, complete=False, quiet=True)
                prune()
            except Exception:  # noqa: BLE001 - the next snapshot retries
                pass

    snap_thread = threading.Thread(target=snapshot, daemon=True)
    snap_thread.start()
    final_rank1, complete, extra = None, False, {}
    try:
        final_rank1 = eng.run(save_dir=args.save_dir, max_epoch=args.epochs,
                              eval_freq=args.eval_freq, print_freq=5,
                              save_freq=args.save_freq, save_best=False,
                              resume=resume_path)
        complete = True
    finally:
        try:
            extra["params_fingerprint"] = params_fingerprint(
                model.state_dict())
        except Exception:  # noqa: BLE001 - a failed run still distils
            pass
        # stop and join the snapshotter first: both write out + '.tmp'
        stop_snap.set()
        snap_thread.join(timeout=30.0)
        artifact = distill(args.save_dir, args.out, protocol, final_rank1,
                           time.time() - t0, complete, extra=extra)
        prune()  # the last save lands after the snapshots' last prune
        signal.signal(signal.SIGTERM, prev_term)
    return artifact


if __name__ == "__main__":
    main()
