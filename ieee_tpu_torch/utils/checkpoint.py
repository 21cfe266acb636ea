"""Checkpoint save / list / load / resume and tolerant weight loading.

Counterpart of ``ieee_tpu/utils/checkpoint.py`` (reference
``torchreid/utils/torchtools.py:13-133, 256-311``). A checkpoint is the
reference's own torch file, ``<dir>/model.pth.tar-<epoch>``: the model's
``state_dict`` in the reference's key layout (what
``models/weights.py:load_reference_checkpoint`` reads), the epoch, the
rank-1 and, for resume, the optimizer's ``state_dict``. A small JSON
sidecar (``model.pth.tar-<epoch>.json``: epoch, rank1) is written before
the file it describes, and every write goes to a temporary name first and
is renamed into place, so a killed run leaves no torn checkpoint (a kill
between the two leaves an orphan sidecar, which nothing reads as a
checkpoint). The transform generator's state is not saved, as the JAX
package does not save its transform key: after a resume the augmentation
draws start again from the seed.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import shutil
import warnings
from typing import List, Optional, Tuple

import torch

from .tools import mkdir_if_missing

__all__ = ["save_checkpoint", "list_checkpoints", "load_checkpoint",
           "resume_from_checkpoint", "load_pretrained_weights"]

_PREFIX = "model.pth.tar-"


def _atomic_json(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _atomic_save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(model: torch.nn.Module, save_dir: str, epoch: int,
                    rank1: Optional[float] = None, is_best: bool = False,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> str:
    """Write ``<save_dir>/model.pth.tar-<epoch>`` (and a
    ``model-best.pth.tar`` copy when ``is_best``); returns its path."""
    mkdir_if_missing(save_dir)
    fpath = osp.join(save_dir, f"{_PREFIX}{epoch}")
    meta = {"epoch": int(epoch)}
    if rank1 is not None:
        meta["rank1"] = float(rank1)
    state = {"state_dict": {k: v.detach().cpu()
                            for k, v in model.state_dict().items()},
             "epoch": int(epoch),
             "rank1": None if rank1 is None else float(rank1)}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
    _atomic_json(fpath + ".json", meta)
    _atomic_save(state, fpath)
    print(f'Checkpoint saved to "{fpath}"')
    if is_best:
        best = osp.join(save_dir, "model-best.pth.tar")
        _atomic_json(best + ".json", meta)
        shutil.copy(fpath, best + ".tmp")
        os.replace(best + ".tmp", best)
    return fpath


def list_checkpoints(dirpath: str) -> List[Tuple[int, str]]:
    """Every epoch checkpoint in ``dirpath`` as ``[(epoch, path)]``, by
    epoch ascending: the one parser of the ``model.pth.tar-<epoch>`` name
    (resume, the latest lookup and pruning all use it)."""
    if not osp.isdir(dirpath):
        return []
    out = []
    for f in os.listdir(dirpath):
        if not f.startswith(_PREFIX) or f.endswith((".json", ".tmp")):
            continue
        tail = f[len(_PREFIX):]
        if tail.isdigit():
            out.append((int(tail), osp.join(dirpath, f)))
    out.sort()
    return out


def load_checkpoint(fpath: str) -> dict:
    """The checkpoint dict at ``fpath``, or at the newest checkpoint when
    ``fpath`` is a directory (reference ``torchtools.py:61-94``)."""
    if fpath is None:
        raise ValueError("File path is None")
    if osp.isdir(fpath):
        cands = list_checkpoints(fpath)
        if not cands:
            raise FileNotFoundError(f'No checkpoint found at "{fpath}"')
        fpath = cands[-1][1]
    if not osp.exists(fpath):
        raise FileNotFoundError(f'File is not found at "{fpath}"')
    return torch.load(fpath, map_location="cpu", weights_only=False)


def resume_from_checkpoint(fpath: str, model: torch.nn.Module,
                           optimizer: Optional[torch.optim.Optimizer] = None
                           ) -> int:
    """Restore the model (every key) and, when given and saved, the
    optimizer's state; returns the epoch to start from, the checkpoint's
    epoch (reference ``torchtools.py:97-133``)."""
    print(f'Loading checkpoint from "{fpath}"')
    ckpt = load_checkpoint(fpath)
    model.load_state_dict(ckpt["state_dict"])
    if optimizer is not None and "optimizer" in ckpt:
        optimizer.load_state_dict(ckpt["optimizer"])
        print("Loaded model + optimizer + batch stats")
    else:
        print("Loaded model + batch stats")
    start_epoch = int(ckpt.get("epoch", 0))
    print(f"Last epoch = {start_epoch}")
    if ckpt.get("rank1") is not None:
        print(f"Last rank1 = {ckpt['rank1']:.1%}")
    return start_epoch


def load_pretrained_weights(model: torch.nn.Module, weight_path: str
                            ) -> Tuple[List[str], List[str]]:
    """Partial load (reference ``load_pretrained_weights``,
    ``torchtools.py:256-311``): every entry of the file whose key and shape
    match the model's loads, the rest is kept and reported. Takes a
    checkpoint or a bare state dict (a DataParallel ``module.`` prefix is
    dropped). Returns (loaded keys, discarded keys)."""
    ckpt = torch.load(weight_path, map_location="cpu", weights_only=False)
    src = ckpt.get("state_dict", ckpt)
    own = model.state_dict()
    matched, discarded = [], []
    with torch.no_grad():
        for k, v in src.items():
            k = k[len("module."):] if k.startswith("module.") else k
            if k in own and tuple(own[k].shape) == tuple(v.shape):
                own[k].copy_(v)
                matched.append(k)
            else:
                discarded.append(k)
    if not matched:
        warnings.warn(f'The pretrained weights "{weight_path}" cannot be '
                      "loaded: no layers matched")
    else:
        print(f'Successfully loaded pretrained weights from "{weight_path}"')
        if discarded:
            print("** The following layers are discarded due to unmatched "
                  f"keys or layer size: {discarded[:20]}"
                  f"{' ...' if len(discarded) > 20 else ''}")
    return matched, discarded
