"""RGBNT201 — the flagship RGB+NI+TI multi-modal re-ID dataset.

Counterpart of ``ieee_tpu/data/datasets/image/rgbnt201.py``; reference
analog: ``torchreid/data/datasets/image/RGBNT201.py:14-72``.
Layout: ``RGBNT201/{train_171,test}/{RGB,NI,TI}/*.jpg`` with identical
filenames across modality dirs; pid = first 6 chars of the name; camid =
4th char of the second ``_`` field, 1-indexed.

Divergence (documented, SURVEY §7): the reference splits paths on ``'\\'``
(Windows-only, ``RGBNT201.py:51,59``); we use ``os.path.basename``.
"""

from __future__ import annotations

import glob
import os.path as osp

from ..base import MultiModalImageDataset


class RGBNT201(MultiModalImageDataset):
    dataset_dir = "RGBNT201"

    def __init__(self, root="", **kwargs):
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, self.dataset_dir)
        self.data_dir = self.dataset_dir

        self.train_dir = osp.join(self.data_dir, "train_171")
        self.query_dir = osp.join(self.data_dir, "test")
        self.gallery_dir = osp.join(self.data_dir, "test")

        self.check_before_run(
            [self.data_dir, self.train_dir, self.query_dir, self.gallery_dir]
        )

        train = self.process_dir(self.train_dir, relabel=True)
        query = self.process_dir(self.query_dir, relabel=False)
        gallery = self.process_dir(self.gallery_dir, relabel=False)
        super().__init__(train, query, gallery, **kwargs)

    @staticmethod
    def process_dir(dir_path, relabel=False):
        img_paths_rgb = sorted(glob.glob(osp.join(dir_path, "RGB", "*.jpg")))
        pid_container = set()
        for p in img_paths_rgb:
            name = osp.basename(p)
            pid_container.add(int(name.split("_")[0][0:6]))
        pid2label = {pid: label for label, pid in enumerate(sorted(pid_container))}

        data = []
        for p in img_paths_rgb:
            name = osp.basename(p)
            triplet = [
                p,
                osp.join(dir_path, "NI", name),
                osp.join(dir_path, "TI", name),
            ]
            pid = int(name.split("_")[0][0:6])
            camid = int(name.split("_")[1][3]) - 1  # index starts from 0
            if relabel:
                pid = pid2label[pid]
            data.append((triplet, pid, camid))
        return data
