"""Market1501 (counterpart of ``ieee_tpu/data/datasets/image/market1501.py``;
reference ``torchreid/data/datasets/image/market1501.py``).

Layout: ``market1501/[Market-1501-v15.09.15/]{bounding_box_train, query,
bounding_box_test[, images]}/*.jpg``, names ``<pid>_c<cam>s...``. Images of
pid -1 (junk) are dropped; pid 0 (background) stays in the gallery and is
a junk pid of ``combine_all``. ``market1501_500k`` adds the 500k
distractors under ``images/`` to the gallery.

Divergence (the JAX package's): the reference hardcodes a Windows
``dataset_dir`` (``market1501.py:24``); this uses the ``market1501``
subdirectory of ``root``.
"""

from __future__ import annotations

import glob
import os.path as osp
import re

from ..base import ImageDataset


class Market1501(ImageDataset):
    """identities: 1501 (+1 background); images 12936 train / 3368 query /
    15913 gallery."""

    _junk_pids = [0, -1]
    dataset_dir = "market1501"

    def __init__(self, root="", market1501_500k=False, **kwargs):
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, self.dataset_dir)

        self.data_dir = self.dataset_dir
        data_dir = osp.join(self.data_dir, "Market-1501-v15.09.15")
        if osp.isdir(data_dir):
            self.data_dir = data_dir

        self.train_dir = osp.join(self.data_dir, "bounding_box_train")
        self.query_dir = osp.join(self.data_dir, "query")
        self.gallery_dir = osp.join(self.data_dir, "bounding_box_test")
        self.extra_gallery_dir = osp.join(self.data_dir, "images")
        self.market1501_500k = market1501_500k

        required = [self.data_dir, self.train_dir, self.query_dir,
                    self.gallery_dir]
        if market1501_500k:
            required.append(self.extra_gallery_dir)
        self.check_before_run(required)

        train = self.process_dir(self.train_dir, relabel=True)
        query = self.process_dir(self.query_dir, relabel=False)
        gallery = self.process_dir(self.gallery_dir, relabel=False)
        if market1501_500k:
            gallery += self.process_dir(self.extra_gallery_dir, relabel=False)
        super().__init__(train, query, gallery, **kwargs)

    @staticmethod
    def process_dir(dir_path, relabel=False):
        img_paths = sorted(glob.glob(osp.join(dir_path, "*.jpg")))
        pattern = re.compile(r"([-\d]+)_c(\d)")

        pid_container = set()
        for img_path in img_paths:
            pid, _ = map(int, pattern.search(img_path).groups())
            if pid == -1:
                continue  # junk images are just ignored
            pid_container.add(pid)
        pid2label = {pid: label for label, pid in enumerate(sorted(pid_container))}

        data = []
        for img_path in img_paths:
            pid, camid = map(int, pattern.search(img_path).groups())
            if pid == -1:
                continue
            if not (0 <= pid <= 1501 and 1 <= camid <= 6):
                raise ValueError(f"{img_path}: pid {pid} or camera {camid} "
                                 "outside Market-1501's ranges")
            camid -= 1
            if relabel:
                pid = pid2label[pid]
            data.append((img_path, pid, camid))
        return data
