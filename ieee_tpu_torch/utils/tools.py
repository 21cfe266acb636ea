"""Small host-side helpers (counterpart of ``ieee_tpu/utils/tools.py``).

Reference analog: ``torchreid/utils/tools.py``. ``read_image`` retries a
bounded number of times instead of looping forever (reference
``utils/tools.py:110-117``).
"""

from __future__ import annotations

import errno
import json
import os
import os.path as osp
import random
import time
import warnings

import numpy as np
import torch

__all__ = ["mkdir_if_missing", "check_isfile", "read_json", "write_json",
           "set_random_seed", "read_image"]


def mkdir_if_missing(dirname: str) -> None:
    if dirname and not osp.exists(dirname):
        try:
            os.makedirs(dirname)
        except OSError as e:
            if e.errno != errno.EEXIST:
                raise


def check_isfile(fpath: str) -> bool:
    isfile = osp.isfile(fpath)
    if not isfile:
        warnings.warn(f'No file found at "{fpath}"')
    return isfile


def read_json(fpath: str):
    with open(fpath, "r") as f:
        return json.load(f)


def write_json(obj, fpath: str) -> None:
    mkdir_if_missing(osp.dirname(fpath))
    with open(fpath, "w") as f:
        json.dump(obj, f, indent=4, separators=(",", ": "))


def set_random_seed(seed: int) -> None:
    """Seed the host RNGs and torch's default generators. The port's model
    init and data take explicit generators and seeds; this covers the rest."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    # note: only inherited by CHILD processes (worker subprocesses); the
    # current interpreter's hash seed was fixed at startup and cannot be
    # changed here
    os.environ["PYTHONHASHSEED"] = str(seed)


def read_image(path: str, max_retries: int = 5) -> np.ndarray:
    """Read an image file into an RGB uint8 HWC array."""
    from PIL import Image

    if not osp.exists(path):
        raise IOError(f'"{path}" does not exist')
    last_err = None
    for _ in range(max_retries):
        try:
            img = Image.open(path).convert("RGB")
            return np.asarray(img, dtype=np.uint8)
        except IOError as e:  # transient FS hiccup; bounded retry
            last_err = e
            time.sleep(0.05)
    raise IOError(f'Failed to read "{path}" after {max_retries} attempts') from last_err
