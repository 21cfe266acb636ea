"""Engine, eval half: feature extraction, distmat, CMC/mAP.

Counterpart of ``ieee_tpu/engine/engine.py`` (``_build_eval_step``,
``_feature_extraction``, ``_evaluate``, ``test``, ``run(test_only=True)``;
reference ``torchreid/engine/engine.py:287-439``). Batches arrive as uint8
numpy arrays, go to the device, and are normalised there; features, the
distmat and the ranking stay on the device until the metrics are read.
``test`` returns the rank-1 of the LAST target dataset, the reference's
quirk (``engine.py:319-337``). Training comes with the training slice.
"""

from __future__ import annotations

import json
import os.path as osp
import time

import numpy as np
import torch

from ..models.fast_eval import build_fast_ieee_eval_step, supports_fast_eval
from ..ops import compute_distance_matrix, evaluate_rank
from ..utils.tools import mkdir_if_missing

__all__ = ["Engine"]


class Engine:
    """Eval engine for one model on one device.

    ``fused_eval`` (``cfg.cuda.fused_eval``) routes the full IEEE model
    through the folded head with the partpool kernel
    (``models/fast_eval.py``); other models take the plain forward.
    """

    def __init__(self, datamanager, model, device="cuda",
                 fused_eval: bool = True):
        self.datamanager = datamanager
        self.model = model
        self.device = torch.device(device)
        self.fused_eval = fused_eval
        self.test_loader = datamanager.test_loader
        self.epoch = 0
        self._eval_step_fn = None
        self._metrics_path = None

    def _log_metrics(self, record: dict) -> None:
        if self._metrics_path:
            with open(self._metrics_path, "a") as f:
                f.write(json.dumps(record) + "\n")

    def _build_eval_step(self):
        model = self.model.eval()
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

    def run(self, save_dir: str = "log", test_only: bool = False,
            dist_metric: str = "euclidean", normalize_feature: bool = False,
            visrank: bool = False, visrank_topk: int = 10,
            use_metric_cuhk03: bool = False, ranks=(1, 5, 10, 20),
            rerank: bool = False, **train_kwargs) -> float:
        """``test_only=True``: evaluate and return rank-1. Training (the
        other ``engine_run_kwargs``) is not ported yet and raises."""
        if save_dir:
            mkdir_if_missing(save_dir)
            self._metrics_path = osp.join(save_dir, "metrics.jsonl")
        if not test_only:
            raise NotImplementedError(
                "training is not ported yet: run with test.evaluate True")
        del train_kwargs
        return self.test(
            dist_metric=dist_metric, normalize_feature=normalize_feature,
            visrank=visrank, visrank_topk=visrank_topk, save_dir=save_dir,
            use_metric_cuhk03=use_metric_cuhk03, ranks=ranks, rerank=rerank)
