"""Engine base: run / train / test / evaluate.

Counterpart of ``ieee_tpu/engine/engine.py`` (reference
``torchreid/engine/engine.py:126-529``). Batches arrive as uint8 numpy
arrays, go to the device, and are transformed there.

- Training (``train_step``): transform -> forward -> loss -> backward ->
  optimizer, the JAX package's ``_build_train_step`` order; BatchNorm
  running statistics update in the forward. Every parameter gets a gradient
  before the optimizer step (zeros where the forward does not reach it, as
  REM's conv_query and conv_value), so weight decay and momentum touch the
  same set as optax does on the JAX side.
- ``train`` sets the epoch's learning rate from the scheduler and averages
  the step metrics; ``run`` trains, evaluates at ``eval_freq`` and at the
  last epoch (which the reference skips, ``engine.py:216``), and saves a
  reference-format checkpoint at each evaluation.
- Evaluation: features, the distmat and the ranking stay on the device
  until the metrics are read. ``test`` returns the rank-1 of the LAST
  target dataset, the reference's quirk (``engine.py:319-337``).

Not ported yet, and refused when asked for: fixbase (open_layers warm-up),
resume (ROADMAP A.11), gradient accumulation (A.16).
"""

from __future__ import annotations

import datetime
import json
import os.path as osp
import shutil
import time

import numpy as np
import torch

from ..models.fast_eval import build_fast_ieee_eval_step, supports_fast_eval
from ..ops import compute_distance_matrix, evaluate_rank
from ..optim import set_lr
from ..utils.avgmeter import AverageMeter, MetricMeter
from ..utils.tools import mkdir_if_missing

__all__ = ["Engine"]


def _traced_accuracy(logits, pids):
    """Top-1 accuracy (%), averaged over the part axis when present
    (reference ``engine/image/margin.py:127-137``)."""
    preds = logits.argmax(-1)
    if logits.ndim == 3:  # (B, P, C)
        return 100.0 * (preds == pids[:, None]).float().mean()
    return 100.0 * (preds == pids).float().mean()


class Engine:
    """Train and eval engine for one model on one device. Subclasses
    implement ``compute_loss(out, pids, hp)`` -> (scalar loss, metrics
    dict of scalars); ``hp`` is ``loss_hparams(epoch)``.

    ``fused_eval`` (``cfg.cuda.fused_eval``) routes the full IEEE model
    through the folded head with the partpool kernel
    (``models/fast_eval.py``); other models take the plain forward.
    ``seed`` seeds the device generator of the train transforms.
    """

    def __init__(self, datamanager, model, optimizer=None, scheduler=None,
                 device="cuda", fused_eval: bool = True, seed: int = 1,
                 accum_steps: int = 1):
        if int(accum_steps) != 1:
            raise NotImplementedError(
                "train.accum_steps > 1 is not ported yet: ROADMAP A.16")
        self.datamanager = datamanager
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler or (lambda epoch: 0.0)
        self.device = torch.device(device)
        self.fused_eval = fused_eval
        self.train_loader = datamanager.train_loader
        self.test_loader = datamanager.test_loader
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
        self.epoch = 0
        self.max_epoch = 1
        self._eval_step_fn = None
        self._metrics_path = None

    def _log_metrics(self, record: dict) -> None:
        if self._metrics_path:
            with open(self._metrics_path, "a") as f:
                f.write(json.dumps(record) + "\n")

    # ------------------------------------------------------------------
    # subclass interface
    # ------------------------------------------------------------------
    def compute_loss(self, out, pids, hp=None):
        """Map forward outputs + labels to ``(scalar_loss, metrics_dict)``."""
        raise NotImplementedError

    def loss_hparams(self, epoch):
        """Per-epoch loss hyperparameters (a dict), or None."""
        return None

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _transform_train(self, imgs):
        tfm = self.datamanager.transform_tr
        if isinstance(imgs, (tuple, list)):
            # an independent draw per modality, in order (the reference
            # applies its transform per image, ``dataset.py:334-339``)
            return tuple(tfm(m, self.generator) for m in imgs)
        return tfm(imgs, self.generator)

    def train_step(self, imgs, pids, hp=None) -> dict:
        """One optimizer step on a batch already on the device (uint8
        images, int64 pids). Returns the metrics as 0-d tensors on the
        device, ``loss`` last."""
        if self.optimizer is None:
            raise ValueError("training needs an optimizer")
        self.model.train()
        out = self.model(self._transform_train(imgs))
        loss, metrics = self.compute_loss(out, pids, hp)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.optimizer.step()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return metrics

    def _put_batch(self, data):
        imgs = data["img"]
        imgs = (tuple(self._put(m) for m in imgs)
                if isinstance(imgs, (tuple, list)) else self._put(imgs))
        return imgs, self._put(np.asarray(data["pid"], np.int64))

    def train(self, print_freq=10, fixbase_epoch=0, open_layers=None):
        """One epoch over the train loader at the scheduler's rate."""
        if self.epoch < fixbase_epoch and open_layers:
            raise NotImplementedError(
                "train.fixbase_epoch > 0 (open_layers warm-up) is not ported "
                "yet: ROADMAP A.11")
        losses = MetricMeter()
        batch_time = AverageMeter()
        data_time = AverageMeter()
        lr = float(self.scheduler(self.epoch))
        set_lr(self.optimizer, lr)
        hp = self.loss_hparams(self.epoch)
        num_batches = len(self.train_loader)
        end = time.time()
        for batch_idx, data in enumerate(self.train_loader):
            imgs, pids = self._put_batch(data)
            data_time.update(time.time() - end)
            metrics = self.train_step(imgs, pids, hp)
            losses.update({k: float(v) for k, v in metrics.items()})
            batch_time.update(time.time() - end)
            if (batch_idx + 1) % print_freq == 0:
                nb_left = num_batches - (batch_idx + 1)
                ep_left = self.max_epoch - (self.epoch + 1)
                eta = batch_time.avg * (nb_left + ep_left * num_batches)
                print(
                    "epoch: [{0}/{1}][{2}/{3}]\t"
                    "time {bt.val:.3f} ({bt.avg:.3f})\t"
                    "data {dt.val:.3f} ({dt.avg:.3f})\t"
                    "eta {eta}\t{losses}\tlr {lr:.6f}".format(
                        self.epoch + 1, self.max_epoch, batch_idx + 1,
                        num_batches, bt=batch_time, dt=data_time,
                        eta=datetime.timedelta(seconds=int(eta)),
                        losses=losses, lr=lr))
            end = time.time()
        self._log_metrics({
            "kind": "train_epoch", "epoch": self.epoch + 1, "lr": lr,
            **(hp or {}), "batch_time_avg": batch_time.avg,
            "data_time_avg": data_time.avg,
            **{k: m.avg for k, m in losses.meters.items()},
        })

    def save_model(self, epoch, rank1, save_dir, is_best=False):
        """``<save_dir>/model/model.pth.tar-<epoch+1>`` in the reference's
        format, ``{'state_dict', 'epoch', 'rank1'}`` (what
        ``models/weights.py:load_reference_checkpoint`` reads), and a copy
        as ``model-best.pth.tar`` when ``is_best``."""
        out_dir = osp.join(save_dir, "model")
        mkdir_if_missing(out_dir)
        path = osp.join(out_dir, f"model.pth.tar-{epoch + 1}")
        state = {k: v.detach().cpu()
                 for k, v in self.model.state_dict().items()}
        torch.save({"state_dict": state, "epoch": epoch + 1,
                    "rank1": float(rank1)}, path)
        if is_best:
            shutil.copy(path, osp.join(out_dir, "model-best.pth.tar"))
        print(f'Checkpoint saved to "{path}"')

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def _build_eval_step(self):
        model = self.model
        tfm = self.datamanager.transform_te
        if self.fused_eval and supports_fast_eval(model):
            return build_fast_ieee_eval_step(model, transform=tfm)

        @torch.inference_mode()
        def step(imgs):
            if isinstance(imgs, (tuple, list)):
                imgs = tuple(tfm(m) for m in imgs)
            else:
                imgs = tfm(imgs)
            return model(imgs)

        return step

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device, non_blocking=True)

    def extract_features(self, imgs):
        """uint8 (B, H, W, 3) batch, or a tuple of them, already on the
        device -> (B, D) f32 features on the device."""
        if self._eval_step_fn is None:
            self._eval_step_fn = self._build_eval_step()
        self.model.eval()
        return self._eval_step_fn(imgs)

    def _feature_extraction(self, loader):
        """-> (features (N, D) f32 on the device, pids, camids numpy)."""
        feats, pids, camids = [], [], []
        t0 = time.time()
        # pad the tail batch to the loader's batch size by repeating its
        # last item: every batch has the same shape (the JAX package pads
        # to avoid recompiles; here it keeps kernel launch shapes fixed)
        batch_size = loader.batch_size
        for data in loader:
            imgs = data["img"]
            multi = isinstance(imgs, (tuple, list))
            n = (imgs[0] if multi else imgs).shape[0]
            if n < batch_size:
                pad = batch_size - n
                if multi:
                    imgs = tuple(np.concatenate(
                        [m, np.repeat(m[-1:], pad, 0)]) for m in imgs)
                else:
                    imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)])
            imgs = (tuple(self._put(m) for m in imgs) if multi
                    else self._put(imgs))
            feats.append(self.extract_features(imgs)[:n].float())
            pids.extend(data["pid"].tolist())
            camids.extend(data["camid"].tolist())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        print(f"Speed: {(time.time() - t0) / max(len(feats), 1):.4f} "
              "sec/batch")
        return torch.cat(feats), np.asarray(pids), np.asarray(camids)

    def _evaluate(self, dataset_name="", query_loader=None,
                  gallery_loader=None, dist_metric="euclidean",
                  normalize_feature=False, visrank=False, visrank_topk=10,
                  save_dir="", use_metric_cuhk03=False, ranks=(1, 5, 10, 20),
                  rerank=False):
        """-> (cmc numpy, mAP): the full CMC curve and the mAP."""
        if rerank or visrank:
            raise NotImplementedError(
                "test.rerank and test.visrank are not ported yet")
        print("Extracting features from query set ...")
        qf, q_pids, q_camids = self._feature_extraction(query_loader)
        print(f"Done, obtained {qf.shape[0]}-by-{qf.shape[1]} matrix")
        print("Extracting features from gallery set ...")
        gf, g_pids, g_camids = self._feature_extraction(gallery_loader)
        print(f"Done, obtained {gf.shape[0]}-by-{gf.shape[1]} matrix")

        if normalize_feature:
            print("Normalizing features with L2 norm ...")
            qf = qf / qf.norm(dim=1, keepdim=True).clamp_min(1e-12)
            gf = gf / gf.norm(dim=1, keepdim=True).clamp_min(1e-12)

        print(f"Computing distance matrix with metric={dist_metric} ...")
        distmat = compute_distance_matrix(qf, gf, dist_metric)

        print("Computing CMC and mAP ...")
        cmc, mAP = evaluate_rank(distmat, q_pids, g_pids, q_camids, g_camids,
                                 use_metric_cuhk03=use_metric_cuhk03)
        print("** Results **")
        print(f"mAP: {mAP:.1%}")
        print("CMC curve")
        # ranks beyond the gallery size are unattainable on tiny galleries
        ranks = [r for r in ranks if r <= len(cmc)]
        for r in ranks:
            print(f"Rank-{r:<3}: {cmc[r - 1]:.1%}")
        self._log_metrics({
            "kind": "eval", "epoch": self.epoch + 1,
            "dataset": dataset_name, "mAP": float(mAP),
            **{f"rank{r}": float(cmc[r - 1]) for r in ranks},
        })
        return cmc, mAP

    def test(self, dist_metric="euclidean", normalize_feature=False,
             visrank=False, visrank_topk=10, save_dir="",
             use_metric_cuhk03=False, ranks=(1, 5, 10, 20),
             rerank=False) -> float:
        rank1 = 0.0
        for name in self.test_loader:
            domain = ("source" if name in self.datamanager.sources
                      else "target")
            print(f"##### Evaluating {name} ({domain}) #####")
            cmc, _ = self._evaluate(
                dataset_name=name,
                query_loader=self.test_loader[name]["query"],
                gallery_loader=self.test_loader[name]["gallery"],
                dist_metric=dist_metric, normalize_feature=normalize_feature,
                visrank=visrank, visrank_topk=visrank_topk,
                save_dir=save_dir, use_metric_cuhk03=use_metric_cuhk03,
                ranks=ranks, rerank=rerank)
            rank1 = float(cmc[0])
        return rank1  # last target only: reference quirk kept

    def run(self, save_dir: str = "log", max_epoch: int = 0,
            start_epoch: int = 0, print_freq: int = 10,
            fixbase_epoch: int = 0, open_layers=None,
            fixbase_bn_freeze: bool = False, fixbase_bn_eval: bool = True,
            start_eval: int = 0, eval_freq: int = -1,
            test_only: bool = False, dist_metric: str = "euclidean",
            normalize_feature: bool = False, visrank: bool = False,
            visrank_topk: int = 10, use_metric_cuhk03: bool = False,
            ranks=(1, 5, 10, 20), rerank: bool = False,
            resume: str = "") -> float:
        """Train ``start_epoch``..``max_epoch`` and evaluate, or with
        ``test_only`` evaluate only; returns the last rank-1. The JAX
        package's ``Engine.run`` with its default save policy: evaluation
        at every ``eval_freq``-th epoch from ``start_eval`` and at the last,
        a checkpoint at each evaluation."""
        del fixbase_bn_freeze, fixbase_bn_eval  # only read under fixbase
        if save_dir:
            mkdir_if_missing(save_dir)
            self._metrics_path = osp.join(save_dir, "metrics.jsonl")
        if resume:
            raise NotImplementedError(
                "resume is not ported yet: ROADMAP A.11")
        test_kw = dict(dist_metric=dist_metric,
                       normalize_feature=normalize_feature, visrank=visrank,
                       visrank_topk=visrank_topk, save_dir=save_dir,
                       use_metric_cuhk03=use_metric_cuhk03, ranks=ranks,
                       rerank=rerank)
        if test_only:
            return self.test(**test_kw)

        time_start = time.time()
        self.max_epoch = max_epoch
        print("=> Start training")
        rank1, best_rank1 = 0.0, -1.0
        for self.epoch in range(start_epoch, max_epoch):
            self.train(print_freq=print_freq, fixbase_epoch=fixbase_epoch,
                       open_layers=open_layers)
            is_last = (self.epoch + 1) == max_epoch
            should_eval = (eval_freq > 0 and (self.epoch + 1) >= start_eval
                           and (self.epoch + 1) % eval_freq == 0)
            if should_eval or is_last:
                rank1 = self.test(**test_kw)
                is_best = rank1 > best_rank1
                best_rank1 = max(best_rank1, rank1)
                self.save_model(self.epoch, rank1, save_dir, is_best=is_best)
        elapsed = round(time.time() - time_start)
        print(f"Elapsed {datetime.timedelta(seconds=elapsed)}")
        return rank1
