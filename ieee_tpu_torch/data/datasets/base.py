"""Dataset base classes.

Counterpart of ``ieee_tpu/data/datasets/base.py`` (numpy only; the image
datasets, single- and multi-modal; the video ones are not ported yet).
Reference analog:
``torchreid/data/datasets/dataset.py``. Data items are
tuples ``(img_path_or_paths, pid, camid, dsetid)`` (``dataset.py:54-62``);
datasets combine with ``+``/``sum()`` with pid/camid/dsetid offsetting
(``dataset.py:101-156``); ``combine_all`` folds query+gallery identities into
train (``dataset.py:195-222``).

As in the JAX package, ``__getitem__`` returns decoded and resized uint8
numpy arrays (HWC); normalisation happens on the device in the batch
transform (``ieee_tpu_torch/data/transforms.py``).
"""

from __future__ import annotations

import copy
import os.path as osp
from typing import List, Sequence, Tuple

import numpy as np

from ...utils.tools import read_image


def _resize_uint8(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize via PIL (host decode path)."""
    from PIL import Image

    if img.shape[0] == height and img.shape[1] == width:
        return img
    return np.asarray(
        Image.fromarray(img).resize((width, height), Image.BILINEAR),
        dtype=np.uint8,
    )


class Dataset:
    """A generic re-ID dataset: train/query/gallery lists of item tuples."""

    _junk_pids: List[int] = []
    dataset_dir = ""
    dataset_url = None

    def __init__(
        self,
        train,
        query,
        gallery,
        transform=None,
        k_tfm: int = 1,
        mode: str = "train",
        combineall: bool = False,
        verbose: bool = True,
        height: int = 256,
        width: int = 128,
        **kwargs,
    ):
        # extend 3-tuples to 4-tuples with dsetid = 0
        self.train = [self._ensure4(t) for t in train]
        self.query = [self._ensure4(t) for t in query]
        self.gallery = [self._ensure4(t) for t in gallery]
        self.transform = transform  # host-side hook; normally None (device tfm)
        self.k_tfm = k_tfm
        self.mode = mode
        self.combineall = combineall
        self.verbose = verbose
        self.height = height
        self.width = width

        self.num_train_pids = self.get_num_pids(self.train)
        self.num_train_cams = self.get_num_cams(self.train)
        self.num_datasets = self.get_num_datasets(self.train)

        if self.combineall:
            self.combine_all()

        if self.mode == "train":
            self.data = self.train
        elif self.mode == "query":
            self.data = self.query
        elif self.mode == "gallery":
            self.data = self.gallery
        else:
            raise ValueError(
                f"Invalid mode. Got {self.mode}, expected train | query | gallery"
            )

        if self.verbose:
            self.show_summary()

    @staticmethod
    def _ensure4(item) -> Tuple:
        if len(item) >= 4:
            return tuple(item[:4])
        return tuple(item) + (0,)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        raise NotImplementedError

    # -- combining --------------------------------------------------------
    def __add__(self, other: "Dataset") -> "Dataset":
        """Offset other's pids/camids/dsetids past ours and concat train
        (reference ``dataset.py:101-156``)."""
        train = copy.deepcopy(self.train)
        num_train_pids = self.get_num_pids(train)
        num_train_cams = self.get_num_cams(train)
        num_dsets = self.get_num_datasets(train)
        for paths, pid, camid, dsetid in other.train:
            train.append(
                (paths, pid + num_train_pids, camid + num_train_cams,
                 dsetid + num_dsets)
            )
        cls = (ImageDataset if isinstance(self, ImageDataset)
               else MultiModalImageDataset)
        return cls(
            train,
            self.query,
            self.gallery,
            transform=self.transform,
            k_tfm=self.k_tfm,
            mode=self.mode,
            combineall=False,
            verbose=False,
            height=self.height,
            width=self.width,
        )

    def __radd__(self, other):
        return self if other == 0 else self.__add__(other)

    # -- stats ------------------------------------------------------------
    @staticmethod
    def parse_data(data):
        pids = {item[1] for item in data}
        cams = {item[2] for item in data}
        return len(pids), len(cams)

    def get_num_pids(self, data):
        return self.parse_data(data)[0]

    def get_num_cams(self, data):
        return self.parse_data(data)[1]

    @staticmethod
    def get_num_datasets(data):
        return len({item[3] for item in data})

    # -- combine_all ------------------------------------------------------
    def combine_all(self):
        """Relabel query+gallery identities into train
        (reference ``dataset.py:195-222``)."""
        combined = copy.deepcopy(self.train)
        g_pids = {
            item[1] for item in self.gallery if item[1] not in self._junk_pids
        }
        pid2label = {pid: i for i, pid in enumerate(sorted(g_pids))}

        def _combine(data):
            for paths, pid, camid, dsetid in data:
                if pid in self._junk_pids:
                    continue
                combined.append(
                    (paths, pid2label[pid] + self.num_train_pids, camid, dsetid)
                )

        _combine(self.query)
        _combine(self.gallery)
        self.train = combined
        self.num_train_pids = self.get_num_pids(self.train)

    # -- fs helpers ---------------------------------------------------------
    def check_before_run(self, required_files):
        if isinstance(required_files, str):
            required_files = [required_files]
        for fpath in required_files:
            if not osp.exists(fpath):
                raise RuntimeError(f'"{fpath}" is not found')

    def show_summary(self):
        pass

    def _read_resized(self, path: str) -> np.ndarray:
        img = read_image(path)
        return _resize_uint8(img, self.height, self.width)


class ImageDataset(Dataset):
    """Single-image items (reference ``dataset.py:354-415``).

    __getitem__ -> dict(img=(H,W,3) uint8, pid, camid, impath, dsetid).
    """

    def __getitem__(self, index):
        path, pid, camid, dsetid = self.data[index]
        return {
            "img": self._read_resized(path),
            "pid": pid,
            "camid": camid,
            "impath": path,
            "dsetid": dsetid,
        }

    def show_summary(self):
        num_train_pids, num_train_cams = self.parse_data(self.train)
        num_query_pids, num_query_cams = self.parse_data(self.query)
        num_gallery_pids, num_gallery_cams = self.parse_data(self.gallery)
        print(f"=> Loaded {self.__class__.__name__}")
        print("  ----------------------------------------")
        print("  subset   | # ids | # images | # cameras")
        print("  ----------------------------------------")
        print(f"  train    | {num_train_pids:5d} | {len(self.train):8d} | {num_train_cams:9d}")
        print(f"  query    | {num_query_pids:5d} | {len(self.query):8d} | {num_query_cams:9d}")
        print(f"  gallery  | {num_gallery_pids:5d} | {len(self.gallery):8d} | {num_gallery_cams:9d}")
        print("  ----------------------------------------")


class MultiModalImageDataset(Dataset):
    """Items whose first element is a LIST of per-modality image paths
    (reference ``dataset.py:322-351``; RGBNT201-style R/N/T triplets).

    __getitem__ -> dict(img=list[(H,W,3) uint8], pid, camid, impath, dsetid).
    The reference returns the 4th tuple slot as ``timeid``; it is the dsetid
    for most datasets (AllDay overrides with a real timeid).
    """

    def __getitem__(self, index):
        paths, pid, camid, dsetid = self.data[index]
        imgs = [self._read_resized(p) for p in paths]
        return {
            "img": imgs,
            "pid": pid,
            "camid": camid,
            "impath": paths[0],
            "dsetid": dsetid,
            "timeid": dsetid,
        }

    show_summary = ImageDataset.show_summary
