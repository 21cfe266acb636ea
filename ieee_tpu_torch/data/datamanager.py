"""Image data manager (counterpart of ``ieee_tpu/data/datamanager.py``;
reference ``torchreid/data/datamanager.py:90-348``).

Builds the sum-of-sources train set and its train loader (the train
sampler, ``drop_last``), and per-target query/gallery test loaders, all
yielding uint8 numpy batches, with each target's query and gallery records
(``test_dataset``); the transforms run on the device
(``transforms.py``). The JAX package's decode and device caches, the
unlabeled target train loader and multi-host sampler sharding are not
ported yet.
"""

from __future__ import annotations

from typing import Dict

from .datasets import init_image_dataset
from .loader import DataLoader
from .sampler import build_train_sampler
from .transforms import build_transforms

__all__ = ["ImageDataManager"]


class ImageDataManager:
    data_type = "image"

    def __init__(self, root="", sources=None, targets=None, height=256,
                 width=128, transforms="random_flip", k_tfm=1,
                 norm_mean=None, norm_std=None, use_gpu=False, split_id=0,
                 combineall=False, load_train_targets=False,
                 batch_size_train=32, batch_size_test=32, workers=4,
                 num_instances=4, num_cams=1, num_datasets=1,
                 train_sampler="RandomSampler",
                 train_sampler_t="RandomSampler", seed=None, verbose=True,
                 prefetch=2, decode_cache=False, device_cache=False,
                 **dataset_kwargs):
        del use_gpu, train_sampler_t
        if decode_cache or device_cache or load_train_targets:
            raise NotImplementedError(
                "data.decode_cache, data.device_cache and "
                "data.load_train_targets are not ported yet")
        self.sources = [sources] if isinstance(sources, str) else sources
        if self.sources is None:
            raise ValueError("sources must not be None")
        self.targets = [targets] if isinstance(targets, str) else targets
        if self.targets is None:
            self.targets = self.sources
        self.height = height
        self.width = width
        self.k_tfm = int(k_tfm)
        self.batch_size_train = batch_size_train
        self.num_instances = num_instances
        self.transform_tr, self.transform_te = build_transforms(
            height, width, transforms=transforms, norm_mean=norm_mean,
            norm_std=norm_std, k_tfm=self.k_tfm)

        common = dict(mode="train", combineall=combineall, root=root,
                      split_id=split_id, height=height, width=width,
                      verbose=verbose, **dataset_kwargs)
        if verbose:
            print("=> Loading train (source) dataset")
        trainset = sum(
            (init_image_dataset(name, **common) for name in self.sources[1:]),
            init_image_dataset(self.sources[0], **common),
        )
        self.trainset = trainset
        self._num_train_pids = trainset.num_train_pids
        self._num_train_cams = trainset.num_train_cams
        first = trainset.train[0][0]
        self._num_streams = (len(first) if isinstance(first, (list, tuple))
                             else 1)
        self.train_loader = DataLoader(
            trainset,
            build_train_sampler(trainset.train, train_sampler,
                                batch_size=batch_size_train,
                                num_instances=num_instances,
                                num_cams=num_cams, num_datasets=num_datasets,
                                seed=seed),
            batch_size=batch_size_train, drop_last=True, workers=workers,
            prefetch=prefetch)

        if verbose:
            print("=> Loading test (target) dataset")
        self.test_loader: Dict[str, Dict[str, DataLoader]] = {}
        # each target's query and gallery records (path(s), pid, camid,
        # ...), which test.visrank draws
        self.test_dataset: Dict[str, Dict[str, list]] = {}
        for name in self.targets:
            sets = {
                mode: init_image_dataset(
                    name, mode=mode, combineall=combineall, root=root,
                    split_id=split_id, height=height, width=width,
                    verbose=False, **dataset_kwargs)
                for mode in ("query", "gallery")
            }
            self.test_loader[name] = {
                mode: DataLoader(ds, sampler=range(len(ds)),
                                 batch_size=batch_size_test, drop_last=False,
                                 workers=workers, prefetch=prefetch)
                for mode, ds in sets.items()
            }
            self.test_dataset[name] = {"query": sets["query"].query,
                                       "gallery": sets["gallery"].gallery}

        if verbose:
            print("\n  **************** Summary ****************")
            print(f"  source            : {self.sources}")
            print(f"  # source datasets : {len(self.sources)}")
            print(f"  # source ids      : {self.num_train_pids}")
            print(f"  # source images   : {len(trainset.train)}")
            print(f"  # source cameras  : {self.num_train_cams}")
            print(f"  target            : {self.targets}")
            print("  *****************************************\n")

    @property
    def num_train_pids(self):
        return self._num_train_pids

    @property
    def num_train_cams(self):
        return self._num_train_cams

    @property
    def num_streams(self):
        """1 = single image per item; >1 = multi-modal image list."""
        return self._num_streams
