"""Engine base: run / train / test / evaluate.

Counterpart of ``ieee_tpu/engine/engine.py`` (reference
``torchreid/engine/engine.py:126-529``). Batches arrive as uint8 numpy
arrays, go to the device, and are transformed there.

- Training (``train_step``): transform -> forward -> loss -> backward ->
  optimizer, the JAX package's ``_build_train_step`` order; BatchNorm
  running statistics update in the forward. Every trainable parameter gets
  a gradient before the optimizer step (zeros where the forward does not
  reach it, as REM's conv_query and conv_value), so weight decay and
  momentum touch the same set as optax does on the JAX side. ``data.k_tfm``
  > 1 folds each image's K augmentation draws into the batch, adjacent,
  with the pids repeated alike (``_fold_k_tfm``); ``train.accum_steps`` > 1
  runs the batch as that many micro-batches in order, the BN running
  statistics chained through them, and averages gradients and metrics
  before the one optimizer step (``_accum_grads``).
- ``train`` sets the epoch's learning rate from the scheduler and averages
  the step metrics. Under fixbase (``epoch < fixbase_epoch`` with
  ``open_layers``) only the open top-level modules train: the others'
  parameters take no gradient, so SGD skips them and their moments stay as
  they were (``_mask_opt_state``), and their BatchNorms keep their running
  statistics (``stats_mask``) and, with ``fixbase_bn_eval``, normalise by
  them where the JAX package's interceptor reaches (``_freeze``).
- ``run`` resumes from a checkpoint, trains, evaluates at ``eval_freq`` and
  at the last epoch (which the reference skips, ``engine.py:216``), and
  saves a reference-format checkpoint with the optimizer's state at each
  evaluation, or every ``save_freq`` epochs (``utils/checkpoint.py``).
- Evaluation: features, the distmat and the ranking stay on the device
  until the metrics are read. ``test.rerank`` re-ranks the distmat
  (k-reciprocal, k1 20, k2 6, lambda 0.3): on the card through
  ``re_ranking_device``, on a CPU engine through the numpy oracle, as the
  JAX engine off the TPU. ``test`` returns the rank-1 of the LAST target
  dataset, the reference's quirk (``engine.py:319-337``).
"""

from __future__ import annotations

import datetime
import json
import os.path as osp
import time

import numpy as np
import torch

from ..models.common import FastBatchNorm
from ..models.fast_eval import build_fast_ieee_eval_step, supports_fast_eval
from ..models.int8_eval import (
    build_int8_ieee_eval_step,
    build_int8_reid_eval_step,
    supports_int8_eval,
)
from ..ops import (compute_distance_matrix, evaluate_rank, re_ranking,
                   re_ranking_device)
from ..optim import set_lr
from ..utils.avgmeter import AverageMeter, MetricMeter
from ..utils.checkpoint import resume_from_checkpoint, save_checkpoint
from ..utils.tools import mkdir_if_missing

__all__ = ["Engine"]


def _traced_accuracy(logits, pids):
    """Top-1 accuracy (%), averaged over the part axis when present
    (reference ``engine/image/margin.py:127-137``)."""
    preds = logits.argmax(-1)
    if logits.ndim == 3:  # (B, P, C)
        return 100.0 * (preds == pids[:, None]).float().mean()
    return 100.0 * (preds == pids).float().mean()


def named_units(model):
    """(name, module) of the model's top-level modules, as
    ``train.open_layers`` names them: the JAX package's module names where
    the model gives them (``IEEE3modalPart.named_units``), else its
    children's."""
    if hasattr(model, "named_units"):
        return list(model.named_units())
    return list(model.named_children())


def is_open(name: str, open_layers) -> bool:
    """The JAX package's rule (``Engine._open_layers_mask``): a top-level
    module is open when any name in ``open_layers`` is a substring of its
    name."""
    opens = [open_layers] if isinstance(open_layers, str) else open_layers
    return any(o in name for o in opens)


class Engine:
    """Train and eval engine for one model on one device. Subclasses
    implement ``compute_loss(out, pids, hp)`` -> (scalar loss, metrics
    dict of scalars); ``hp`` is ``loss_hparams(epoch)``.

    ``fused_eval`` (``cfg.cuda.fused_eval``) routes the full IEEE model
    through the folded head with the partpool kernel
    (``models/fast_eval.py``); other models take the plain forward. Off
    by default, as in the JAX package's engine. ``int8_eval``
    (``cfg.cuda.int8_eval``) routes the IEEE model with the full head and
    ungrouped ``ReIDResNet``s through the w8a8 path with the conv_s8
    kernel (``models/int8_eval.py``) and takes precedence over
    ``fused_eval``, as in the JAX engine; another model warns and takes
    the plain forward.
    ``seed`` seeds the device generator of the train transforms and of
    the model's dropout (``ReIDResNet.dropout_generator``);
    ``accum_steps`` is ``train.accum_steps``.
    """

    def __init__(self, datamanager, model, optimizer=None, scheduler=None,
                 device="cuda", fused_eval: bool = False, seed: int = 1,
                 accum_steps: int = 1, int8_eval: bool = False,
                 rerank_bf16: bool = False):
        if int(accum_steps) < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.accum_steps = int(accum_steps)
        self.k_tfm = int(getattr(datamanager, "k_tfm", 1))
        self.datamanager = datamanager
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler or (lambda epoch: 0.0)
        self.device = torch.device(device)
        self.fused_eval = fused_eval
        self.int8_eval = int8_eval
        self.rerank_bf16 = rerank_bf16
        self.train_loader = datamanager.train_loader
        self.test_loader = datamanager.test_loader
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(seed))
        if hasattr(model, "dropout_generator"):
            # dropout draws from the same seeded generator, as the JAX
            # engine's dropout key comes from its seeded rng
            model.dropout_generator = self.generator
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

    @staticmethod
    def _fold_k_tfm(x):
        """(K, B, 3, H, W) k_tfm draws -> (B*K, 3, H, W) with each image's
        K draws adjacent, channels_last (the JAX ``_fold_k_tfm``, which
        keeps the sampler's contiguous-per-pid layout)."""
        k, b, c, h, w = x.shape
        return x.permute(1, 0, 3, 4, 2).reshape(b * k, h, w, c).permute(
            0, 3, 1, 2)

    def _accum_grads(self, imgs, pids, hp):
        """Gradient accumulation (the JAX ``_accum_grads``): the batch in
        ``accum_steps`` micro-batches, in order, each forward updating the
        BN running statistics after the one before; the gradients summed,
        then divided by the count; the loss and metrics averaged."""
        accum = self.accum_steps
        multi = isinstance(imgs, tuple)
        b = (imgs[0] if multi else imgs).shape[0]
        if b % accum:
            raise ValueError(
                f"train batch {b} (incl. k_tfm draws) is not divisible by "
                f"accum_steps={accum}")
        n = b // accum
        losses, metrics = [], []
        for i in range(accum):
            sl = slice(i * n, (i + 1) * n)
            out = self.model(tuple(m[sl] for m in imgs) if multi
                             else imgs[sl])
            loss, mets = self.compute_loss(out, pids[sl], hp)
            loss.backward()
            losses.append(loss.detach())
            metrics.append({k: v.detach() for k, v in mets.items()})
        for p in self.model.parameters():
            if p.grad is not None:
                p.grad.div_(accum)
        return (torch.stack(losses).mean(),
                {k: torch.stack([m[k] for m in metrics]).mean()
                 for k in metrics[0]})

    def train_step(self, imgs, pids, hp=None) -> dict:
        """One optimizer step on a batch already on the device (uint8
        images, int64 pids). Returns the metrics as 0-d tensors on the
        device, ``loss`` last."""
        if self.optimizer is None:
            raise ValueError("training needs an optimizer")
        self.model.train()
        imgs = self._transform_train(imgs)
        if self.k_tfm > 1:
            # the K draws into the batch axis; pids repeat K-adjacent so the
            # (P, K * k_tfm) loss contract holds
            imgs = (tuple(self._fold_k_tfm(m) for m in imgs)
                    if isinstance(imgs, tuple) else self._fold_k_tfm(imgs))
            pids = pids.repeat_interleave(self.k_tfm)
        self.optimizer.zero_grad(set_to_none=True)
        if self.accum_steps > 1:
            loss, metrics = self._accum_grads(imgs, pids, hp)
        else:
            loss, metrics = self.compute_loss(self.model(imgs), pids, hp)
            loss.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None and p.requires_grad:
                    p.grad = torch.zeros_like(p)
        self.optimizer.step()
        metrics["loss"] = loss.detach()
        return metrics

    def _put_batch(self, data):
        imgs = data["img"]
        imgs = (tuple(self._put(m) for m in imgs)
                if isinstance(imgs, (tuple, list)) else self._put(imgs))
        return imgs, self._put(np.asarray(data["pid"], np.int64))

    def _freeze(self, open_layers, bn_eval: bool, bn_freeze: bool):
        """Fixbase for one epoch: every top-level module that is not open
        (``is_open``) takes no gradient, and its BatchNorms keep their
        running statistics (with ``bn_eval`` or ``bn_freeze``, the JAX
        ``stats_mask``) and, with ``bn_eval``, normalise by them in their
        own forward (the JAX ``_bn_eval_interceptor``). Returns what
        ``_unfreeze`` restores."""
        params, bns = [], []
        for name, unit in named_units(self.model):
            if is_open(name, open_layers):
                continue
            for p in unit.parameters():
                if p.requires_grad:
                    p.requires_grad_(False)
                    params.append(p)
            for bn in unit.modules():
                if isinstance(bn, FastBatchNorm):
                    bn.use_running = bool(bn_eval)
                    bn.pin_stats = bool(bn_eval or bn_freeze)
                    bns.append(bn)
        return params, bns

    @staticmethod
    def _unfreeze(frozen) -> None:
        params, bns = frozen
        for p in params:
            p.requires_grad_(True)
        for bn in bns:
            bn.use_running = bn.pin_stats = False

    def train(self, print_freq=10, fixbase_epoch=0, open_layers=None,
              fixbase_bn_freeze=False, fixbase_bn_eval=True):
        """One epoch over the train loader at the scheduler's rate; under
        fixbase (``epoch < fixbase_epoch`` and ``open_layers``) only the
        open modules train (``_freeze``)."""
        frozen = None
        if self.epoch < fixbase_epoch and open_layers:
            print(f"* Only train {open_layers} (epoch: {self.epoch + 1}/"
                  f"{fixbase_epoch})")
            frozen = self._freeze(open_layers, fixbase_bn_eval,
                                  fixbase_bn_freeze)
        try:
            self._train_epoch(print_freq)
        finally:
            if frozen is not None:
                self._unfreeze(frozen)

    def _train_epoch(self, print_freq):
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
        format, ``{'state_dict', 'epoch', 'rank1', 'optimizer'}`` (what
        ``models/weights.py:load_reference_checkpoint`` reads, and what
        resume restores), and a copy as ``model-best.pth.tar`` when
        ``is_best`` (``utils/checkpoint.py:save_checkpoint``)."""
        save_checkpoint(self.model, osp.join(save_dir, "model"), epoch + 1,
                        rank1=rank1, is_best=is_best,
                        optimizer=self.optimizer)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def _build_eval_step(self):
        model = self.model
        tfm = self.datamanager.transform_te
        if self.int8_eval:
            if supports_int8_eval(model):
                if supports_fast_eval(model):
                    return build_int8_ieee_eval_step(model, transform=tfm)
                return build_int8_reid_eval_step(model, transform=tfm)
            print("WARN: cuda.int8_eval unsupported for "
                  f"{type(model).__name__}; using the plain path")
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
        if visrank:
            raise NotImplementedError("test.visrank is not ported yet")
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

        if rerank:
            print("Applying person re-ranking ...")
            distmat_qq = compute_distance_matrix(qf, qf, dist_metric)
            distmat_gg = compute_distance_matrix(gf, gf, dist_metric)
            if self.device.type == "cuda":
                # on the card: the masked-matrix re-rank, its min-sum on the
                # jaccard_minsum kernel (ops/rerank_device.py)
                distmat = re_ranking_device(distmat, distmat_qq, distmat_gg,
                                            minsum_bf16=self.rerank_bf16)
            else:
                # the numpy oracle, as the JAX engine off the TPU
                distmat = re_ranking(distmat.numpy(), distmat_qq.numpy(),
                                     distmat_gg.numpy())

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
            resume: str = "", save_freq: int = -1,
            save_best: bool = True) -> float:
        """Train ``start_epoch``..``max_epoch`` and evaluate, or with
        ``test_only`` evaluate only; returns the last rank-1. The JAX
        package's ``Engine.run``: ``resume`` (a checkpoint, or a directory
        for its newest) restores the model and the optimizer and starts at
        the checkpoint's epoch; evaluation at every ``eval_freq``-th epoch
        from ``start_eval`` and at the last. With ``save_freq`` <= 0 a
        checkpoint at each evaluation; else every ``save_freq`` epochs, at
        the last and, unless ``save_best`` is False, at each best
        evaluation."""
        if save_dir:
            mkdir_if_missing(save_dir)
            self._metrics_path = osp.join(save_dir, "metrics.jsonl")
        if resume:
            start_epoch = resume_from_checkpoint(resume, self.model,
                                                 self.optimizer)
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
                       open_layers=open_layers,
                       fixbase_bn_freeze=fixbase_bn_freeze,
                       fixbase_bn_eval=fixbase_bn_eval)
            is_last = (self.epoch + 1) == max_epoch
            should_eval = (eval_freq > 0 and (self.epoch + 1) >= start_eval
                           and (self.epoch + 1) % eval_freq == 0)
            is_best = False
            if should_eval or is_last:
                rank1 = self.test(**test_kw)
                is_best = rank1 > best_rank1
                best_rank1 = max(best_rank1, rank1)
            if save_freq <= 0:
                should_save = should_eval or is_last
            else:
                should_save = ((self.epoch + 1) % save_freq == 0 or is_last
                               or (is_best and save_best))
            if should_save:
                self.save_model(self.epoch, rank1, save_dir, is_best=is_best)
        elapsed = round(time.time() - time_start)
        print(f"Elapsed {datetime.timedelta(seconds=elapsed)}")
        return rank1
