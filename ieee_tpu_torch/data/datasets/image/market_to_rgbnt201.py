"""Market1501 converted to the 3-modal RGBNT201 layout (counterpart of
``ieee_tpu/data/datasets/image/market_to_rgbnt201.py``; reference
``torchreid/data/datasets/image/market_to_RGBNT201.py``, whose hardcoded
Windows ``dataset_dir`` is a directory of ``root`` here).

Layout: ``market1501_to_RGBNT201/{train, query, gallery}/{RGB, NI, TI}/``
with the same file names in each modality; names ``<pid>_c<cam>...``.
"""

from __future__ import annotations

import glob
import os.path as osp

from ..base import MultiModalImageDataset


class MarketToRGBNT201(MultiModalImageDataset):
    _junk_pids = [0, -1]
    dataset_dir = "market1501_to_RGBNT201"

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
        img_paths_rgb = sorted(glob.glob(osp.join(dir_path, "RGB", "*.jpg")))
        pid_container = set()
        for p in img_paths_rgb:
            pid = int(osp.basename(p).split("_")[0])
            if pid == -1:
                continue
            pid_container.add(pid)
        pid2label = {pid: label for label, pid in enumerate(sorted(pid_container))}

        data = []
        for p in img_paths_rgb:
            name = osp.basename(p)
            triplet = [p, osp.join(dir_path, "NI", name),
                       osp.join(dir_path, "TI", name)]
            pid = int(name.split("_")[0])
            if pid == -1:
                continue
            camid = int(name.split("_")[1][1])
            if not (0 <= pid <= 1501 and 1 <= camid <= 6):
                raise ValueError(f"{p}: pid {pid} or camera {camid} outside "
                                 "Market-1501's ranges")
            camid -= 1
            if relabel:
                pid = pid2label[pid]
            data.append((triplet, pid, camid))
        return data
