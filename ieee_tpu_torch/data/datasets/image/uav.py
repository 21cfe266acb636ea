"""UAVdata: a 2-modal (RGB + Gray) dataset (counterpart of
``ieee_tpu/data/datasets/image/uav.py``; reference
``torchreid/data/datasets/image/UAV.py:48-76``, whose Windows path split is
``os.path.basename`` here).

Layout: ``UAVdata/{train, query, gallery}/{RGB, Gray}/`` with the same file
names in both; pid = characters 1-3 of the name; camid is a running index
(every image its own camera, as the reference).
"""

from __future__ import annotations

import glob
import os.path as osp

from ..base import MultiModalImageDataset


class UAV(MultiModalImageDataset):
    dataset_dir = "UAVdata"

    def __init__(self, root="", **kwargs):
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, self.dataset_dir)
        self.data_dir = self.dataset_dir

        self.train_dir = osp.join(self.data_dir, "train")
        self.query_dir = osp.join(self.data_dir, "query")
        self.gallery_dir = osp.join(self.data_dir, "gallery")
        self.check_before_run(
            [self.data_dir, self.train_dir, self.query_dir, self.gallery_dir]
        )

        train = self.process_dir(self.train_dir, relabel=True)
        query = self.process_dir(self.query_dir, relabel=False)
        gallery = self.process_dir(self.gallery_dir, relabel=False)
        super().__init__(train, query, gallery, **kwargs)

    @staticmethod
    def process_dir(dir_path, relabel=False):
        img_paths = sorted(glob.glob(osp.join(dir_path, "RGB", "*.jpg")))
        pid_container = set()
        for p in img_paths:
            pid = int(osp.basename(p).split(".")[0][1:4])
            if pid == -1:
                continue
            pid_container.add(pid)
        pid2label = {pid: label for label, pid in enumerate(sorted(pid_container))}

        data = []
        for i, p in enumerate(img_paths):
            name = osp.basename(p)
            pid = int(name.split(".")[0][1:4])
            if pid == -1:
                continue
            if relabel:
                pid = pid2label[pid]
            # camid: the running index, as the reference
            data.append(([p, osp.join(dir_path, "Gray", name)], pid, i))
        return data
