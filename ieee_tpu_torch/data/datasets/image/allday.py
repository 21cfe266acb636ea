"""AllDay: a 3-modal dataset with a per-image timeid (counterpart of
``ieee_tpu/data/datasets/image/allday.py``; reference
``torchreid/data/datasets/image/AllDay.py:48-104``).

Items are 4-tuples (img-list, pid, camid, timeid): the timeid rides the
dsetid slot, as the reference's ``MultiModalImageDataset`` returns it.
Names ``<pid:6>_cam<c>_<timeid>_...``. The test split's NI and TI images
live in ``NI_change_ID_final`` and ``TI_change_ID_final``.
"""

from __future__ import annotations

import glob
import os.path as osp

from ..base import MultiModalImageDataset


class AllDay(MultiModalImageDataset):
    dataset_dir = "AllDay"

    def __init__(self, root="", **kwargs):
        self.root = osp.abspath(osp.expanduser(root))
        self.dataset_dir = osp.join(self.root, self.dataset_dir)
        self.data_dir = self.dataset_dir

        self.train_dir = osp.join(self.data_dir, "train")
        self.query_dir = osp.join(self.data_dir, "test")
        self.gallery_dir = osp.join(self.data_dir, "test")
        self.check_before_run(
            [self.data_dir, self.train_dir, self.query_dir, self.gallery_dir]
        )

        train = self._process_dir(self.train_dir, relabel=True,
                                  test_layout=False)
        query = self._process_dir(self.query_dir, relabel=False,
                                  test_layout=True)
        gallery = self._process_dir(self.gallery_dir, relabel=False,
                                    test_layout=True)
        super().__init__(train, query, gallery, **kwargs)

    @staticmethod
    def _process_dir(dir_path, relabel=False, test_layout=False):
        ni_dir = "NI_change_ID_final" if test_layout else "NI"
        ti_dir = "TI_change_ID_final" if test_layout else "TI"
        img_paths_rgb = sorted(glob.glob(osp.join(dir_path, "RGB", "*.jpg")))
        pid_container = set()
        for p in img_paths_rgb:
            pid_container.add(int(osp.basename(p).split("_")[0][0:6]))
        pid2label = {pid: label for label, pid in enumerate(sorted(pid_container))}

        data = []
        for p in img_paths_rgb:
            name = osp.basename(p)
            triplet = [p, osp.join(dir_path, ni_dir, name),
                       osp.join(dir_path, ti_dir, name)]
            fields = name.split("_")
            pid = int(fields[0][0:6])
            camid = int(fields[1][3]) - 1
            timeid = int(fields[2])
            if relabel:
                pid = pid2label[pid]
            data.append((triplet, pid, camid, timeid))
        return data
