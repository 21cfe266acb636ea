"""Host-side batch loader: sampler indices -> decoded uint8 numpy batches.

Counterpart of ``ieee_tpu/data/loader.py`` (numpy and threads only). The
host only decodes and collates; normalisation happens on the device
(``transforms.py``). A thread pool overlaps decode with device compute.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List

import numpy as np

__all__ = ["DataLoader"]


def _collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    first = items[0]
    batch: Dict[str, Any] = {}
    if isinstance(first["img"], list):  # multi-modal: list of (H,W,3)
        n_modal = len(first["img"])
        batch["img"] = tuple(
            np.stack([it["img"][m] for it in items]) for m in range(n_modal)
        )
    else:
        batch["img"] = np.stack([it["img"] for it in items])
    batch["pid"] = np.asarray([it["pid"] for it in items], np.int32)
    batch["camid"] = np.asarray([it["camid"] for it in items], np.int32)
    batch["dsetid"] = np.asarray([it.get("dsetid", 0) for it in items], np.int32)
    batch["impath"] = [it["impath"] for it in items]
    return batch


class DataLoader:
    """Iterates a dataset in sampler order, yielding collated numpy batches.

    ``workers`` 0 decodes in the caller's thread; ``workers`` >= 1 decodes
    that many batches in parallel threads (PIL and numpy release the GIL),
    delivered in sampler order with at most ``prefetch + workers`` in
    flight."""

    def __init__(
        self,
        dataset,
        sampler,
        batch_size: int,
        drop_last: bool = False,
        workers: int = 0,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.workers = workers
        self.prefetch = max(prefetch, 1)

    def _batches_of_indices(self) -> Iterator[List[int]]:
        buf: List[int] = []
        for idx in iter(self.sampler):
            buf.append(idx)
            if len(buf) == self.batch_size:
                yield buf
                buf = []
        if buf and not self.drop_last:
            yield buf

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _load_batch(self, indices: List[int]) -> Dict[str, Any]:
        return _collate([self.dataset[i] for i in indices])

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.workers <= 0:
            for indices in self._batches_of_indices():
                yield self._load_batch(indices)
            return
        ex = ThreadPoolExecutor(max_workers=self.workers)
        pending: deque = deque()
        it = self._batches_of_indices()
        try:
            for _ in range(self.prefetch + self.workers):
                indices = next(it, None)
                if indices is None:
                    break
                pending.append(ex.submit(self._load_batch, indices))
            while pending:
                batch = pending.popleft().result()
                indices = next(it, None)
                if indices is not None:
                    pending.append(ex.submit(self._load_batch, indices))
                yield batch
        finally:
            ex.shutdown(wait=False, cancel_futures=True)
