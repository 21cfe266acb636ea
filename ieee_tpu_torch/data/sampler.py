"""Train samplers (reference ``torchreid/data/sampler.py``).

The port's own copy of ``ieee_tpu/data/sampler.py`` (numpy only; the port
imports nothing of the JAX package): the same seed gives the same index
order as the JAX package, which the 3M loss's P x K layout depends on.
Pure-numpy index generators, seeded via ``numpy.random.Generator``.
"""

from __future__ import annotations

import copy
from collections import defaultdict
from typing import List, Sequence

import numpy as np

AVAI_SAMPLERS = [
    "RandomIdentitySampler",
    "SequentialSampler",
    "RandomSampler",
    "RandomDomainSampler",
    "RandomDatasetSampler",
]


class SequentialSampler:
    def __init__(self, data_source, **kwargs):
        self.n = len(data_source)

    def __iter__(self):
        return iter(range(self.n))

    def __len__(self):
        return self.n


class RandomSampler:
    def __init__(self, data_source, seed=None, **kwargs):
        self.n = len(data_source)
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return iter(self.rng.permutation(self.n).tolist())

    def __len__(self):
        return self.n


class RandomIdentitySampler:
    """P x K batches: P pids per batch, K consecutive instances each
    (reference ``sampler.py:17-84``). The K-consecutive layout is a hard
    contract for the 3M/hetero losses' (P, K, D) reshape.
    """

    def __init__(self, data_source, batch_size, num_instances, seed=None, **kwargs):
        if batch_size < num_instances:
            raise ValueError(
                f"batch_size={batch_size} must be no less than "
                f"num_instances={num_instances}"
            )
        self.batch_size = batch_size
        self.num_instances = num_instances
        self.num_pids_per_batch = batch_size // num_instances
        self.index_dic = defaultdict(list)
        for index, items in enumerate(data_source):
            self.index_dic[items[1]].append(index)
        self.pids = list(self.index_dic.keys())
        if len(self.pids) < self.num_pids_per_batch:
            raise ValueError(
                f"Need >= {self.num_pids_per_batch} pids, got {len(self.pids)}"
            )
        self.rng = np.random.default_rng(seed)

        # estimated epoch length (reference ``sampler.py:42-50``)
        self.length = 0
        for pid in self.pids:
            num = max(len(self.index_dic[pid]), self.num_instances)
            self.length += num - num % self.num_instances

    def __iter__(self):
        batch_idxs_dict = defaultdict(list)
        for pid in self.pids:
            idxs = list(self.index_dic[pid])
            if len(idxs) < self.num_instances:
                idxs = self.rng.choice(
                    idxs, size=self.num_instances, replace=True
                ).tolist()
            self.rng.shuffle(idxs)
            batch = []
            for idx in idxs:
                batch.append(int(idx))
                if len(batch) == self.num_instances:
                    batch_idxs_dict[pid].append(batch)
                    batch = []

        avai_pids = copy.deepcopy(self.pids)
        final_idxs: List[int] = []
        while len(avai_pids) >= self.num_pids_per_batch:
            selected = self.rng.choice(
                len(avai_pids), size=self.num_pids_per_batch, replace=False
            )
            for pid in [avai_pids[i] for i in sorted(selected)]:
                final_idxs.extend(batch_idxs_dict[pid].pop(0))
                if not batch_idxs_dict[pid]:
                    avai_pids.remove(pid)
        return iter(final_idxs)

    def __len__(self):
        return self.length


class RandomDomainSampler:
    """Batches balanced over camera domains (reference ``sampler.py:86-144``)."""

    def __init__(self, data_source, batch_size, n_domain, seed=None, **kwargs):
        self.domain_dict = defaultdict(list)
        for i, items in enumerate(data_source):
            self.domain_dict[items[2]].append(i)
        self.domains = list(self.domain_dict.keys())
        if not n_domain or n_domain <= 0:
            n_domain = len(self.domains)
        if batch_size % n_domain != 0:
            raise ValueError("batch_size must be divisible by n_domain")
        self.n_img_per_domain = batch_size // n_domain
        self.batch_size = batch_size
        self.n_domain = n_domain
        self.rng = np.random.default_rng(seed)
        # exact stream length, as the reference (sampler.py:112-113)
        # materializes one draw — len(data_source) overestimates when
        # domains are imbalanced (iteration stops at the first depleted
        # one). With n_domain < len(domains) each round samples a random
        # domain subset, so later draws can differ in length from this
        # probe; the number is display-only (ETA / len(loader)), matching
        # the reference's identical one-draw estimate.
        self.length = len(self._draw())

    def _draw(self) -> List[int]:
        domain_dict = {d: list(v) for d, v in self.domain_dict.items()}
        final_idxs: List[int] = []
        stop = False
        while not stop:
            selected = self.rng.choice(
                len(self.domains), size=self.n_domain, replace=False
            )
            for d in [self.domains[i] for i in selected]:
                idxs = domain_dict[d]
                take = self.rng.choice(
                    len(idxs), size=min(self.n_img_per_domain, len(idxs)),
                    replace=False,
                )
                for t in sorted(take, reverse=True):
                    final_idxs.append(idxs.pop(t))
                if len(idxs) < self.n_img_per_domain:
                    stop = True
        return final_idxs

    def __iter__(self):
        return iter(self._draw())

    def __len__(self):
        return self.length


class RandomDatasetSampler:
    """Batches balanced over source datasets (reference ``sampler.py:147-203``)."""

    def __init__(self, data_source, batch_size, n_dataset, seed=None, **kwargs):
        self.ds_dict = defaultdict(list)
        for i, items in enumerate(data_source):
            self.ds_dict[items[3]].append(i)
        self.datasets = list(self.ds_dict.keys())
        if not n_dataset or n_dataset <= 0:
            n_dataset = len(self.datasets)
        if batch_size % n_dataset != 0:
            raise ValueError("batch_size must be divisible by n_dataset")
        self.n_img_per_dset = batch_size // n_dataset
        self.n_dataset = n_dataset
        self.rng = np.random.default_rng(seed)
        # exact stream length (see RandomDomainSampler.length)
        self.length = len(self._draw())

    def _draw(self) -> List[int]:
        ds_dict = {d: list(v) for d, v in self.ds_dict.items()}
        final_idxs: List[int] = []
        stop = False
        while not stop:
            selected = self.rng.choice(
                len(self.datasets), size=self.n_dataset, replace=False
            )
            for d in [self.datasets[i] for i in selected]:
                idxs = ds_dict[d]
                take = self.rng.choice(
                    len(idxs), size=min(self.n_img_per_dset, len(idxs)),
                    replace=False,
                )
                for t in sorted(take, reverse=True):
                    final_idxs.append(idxs.pop(t))
                if len(idxs) < self.n_img_per_dset:
                    stop = True
        return final_idxs

    def __iter__(self):
        return iter(self._draw())

    def __len__(self):
        return self.length


def build_train_sampler(
    data_source,
    train_sampler: str,
    batch_size: int = 32,
    num_instances: int = 4,
    num_cams: int = 1,
    num_datasets: int = 1,
    seed=None,
    **kwargs,
):
    """Sampler factory (reference ``sampler.py:206-246``)."""
    if train_sampler not in AVAI_SAMPLERS:
        raise ValueError(f"sampler must be one of {AVAI_SAMPLERS}, "
                         f"but got {train_sampler}")
    if train_sampler == "RandomIdentitySampler":
        return RandomIdentitySampler(data_source, batch_size, num_instances,
                                     seed=seed)
    if train_sampler == "RandomDomainSampler":
        return RandomDomainSampler(data_source, batch_size, num_cams, seed=seed)
    if train_sampler == "RandomDatasetSampler":
        return RandomDatasetSampler(data_source, batch_size, num_datasets,
                                    seed=seed)
    if train_sampler == "SequentialSampler":
        return SequentialSampler(data_source)
    return RandomSampler(data_source, seed=seed)
