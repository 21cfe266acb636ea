"""Multi-modal train/eval entry point of the port.

Counterpart of ``scripts/main_multimodal.py`` (reference
``scripts/mainMultiModal.py:150-241``): parse args -> merge config -> seed ->
Logger tee -> datamanager -> model -> weights -> optimizer and scheduler ->
engine -> ``engine.run``, which trains (evaluating at ``test.eval_freq``
and at the last epoch; from the checkpoint ``model.resume`` names, when it
names one) or, with ``test.evaluate True``, evaluates only.

Usage:
    python -m ieee_tpu_torch.main_multimodal \
        --config-file configs/rgbnt_ieee_part_margin.yaml --root DATA \
        [--device cuda] [--seed N] [key value ...]
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys
import time

import torch

from .config import (
    engine_run_kwargs,
    get_default_config,
    imagedata_kwargs,
    lr_scheduler_kwargs,
    optimizer_kwargs,
)
from .data import ImageDataManager
from .engine import build_engine
from .models import build_model
from .models.weights import load_reference_checkpoint
from .optim import build_lr_scheduler, build_optimizer
from .utils import Logger, set_random_seed


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--config-file", type=str, default="",
                        help="path to config file")
    parser.add_argument("--root", type=str, default="",
                        help="path to data root")
    parser.add_argument("--seed", type=int, default=1, help="random seed")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cuda, cuda:N or cpu)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER,
                        help="modify config options using the command-line")
    return parser.parse_args(argv)


def main(argv=None) -> float:
    """Run the CLI; returns the engine's result (rank-1 of the last
    target, after training unless ``test.evaluate``)."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device} but CUDA is not available; pass "
            "--device cpu to run the plain PyTorch path on the CPU")

    cfg = get_default_config()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.root:
        cfg.data.root = args.root
    cfg.train.seed = args.seed
    if args.opts:
        cfg.merge_from_list(args.opts)
    if cfg.data.type != "image":
        raise NotImplementedError("video data is not ported yet")

    set_random_seed(cfg.train.seed)
    if device.type == "cuda":
        # f32 products (distmat, CIM, REM) in full f32, as the JAX package's
        # HIGHEST precision; bf16 convs are unaffected
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    log_name = "test.log" if cfg.test.evaluate else "train.log"
    log_name += time.strftime("-%Y-%m-%d-%H-%M-%S")
    stdout = sys.stdout
    sys.stdout = Logger(osp.join(cfg.data.save_dir, log_name))
    try:
        print(f"Show configuration\n{cfg.dump()}")
        print(f"torch {torch.__version__}, device {device}"
              + (f" ({torch.cuda.get_device_name(device)})"
                 if device.type == "cuda" else ""))

        datamanager = ImageDataManager(**imagedata_kwargs(cfg))

        print(f"Building model: {cfg.model.name}")
        extra = {}
        if cfg.model.name == "ieee3modalPart":
            extra = dict(interaction=cfg.model.interaction,
                         attention=cfg.model.attention,
                         using_REM=cfg.model.using_REM,
                         fused_1x1=cfg.cuda.fused_1x1,
                         block_megakernel=cfg.cuda.block_megakernel)
        model = build_model(
            cfg.model.name, num_classes=datamanager.num_train_pids,
            loss=cfg.loss.name, pretrained=cfg.model.pretrained,
            dtype=cfg.cuda.compute_dtype, device=device,
            seed=cfg.train.seed, **extra)
        if cfg.model.load_weights:
            load_reference_checkpoint(model, cfg.model.load_weights)
            print(f'Loaded reference checkpoint "{cfg.model.load_weights}"')

        optimizer = build_optimizer(model, **optimizer_kwargs(cfg))
        scheduler = build_lr_scheduler(base_lr=cfg.train.lr,
                                       **lr_scheduler_kwargs(cfg))
        print(f"Building {cfg.loss.name}-engine for {cfg.data.type}-reid")
        engine = build_engine(cfg, datamanager, model, optimizer, scheduler,
                              device=device)
        run_kwargs = engine_run_kwargs(cfg)
        if cfg.model.resume:
            run_kwargs["resume"] = cfg.model.resume
        return engine.run(**run_kwargs)
    finally:
        log, sys.stdout = sys.stdout, stdout
        log.close()


if __name__ == "__main__":
    main()
