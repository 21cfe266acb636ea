"""Result visualisation: ranked-result strips and multi-modal t-SNE scatter.

Counterpart of ``ieee_tpu/utils/reidtools.py``, copied unchanged; reference
analog: ``torchreid/utils/reidtools.py:18-154`` (``visualize_ranked_results``
with green/red borders, via cv2) and the engine's ``showPointMultiModal``
t-SNE scatter (``engine/engine.py:463-490``). Host numpy only: the engine
passes the distmat and the features as host arrays. PIL draws the strips;
matplotlib and scikit-learn, both optional, the scatter.

Divergence fix (SURVEY known-quirk list): the reference t-SNE slices the
2304-d feature assuming R,N,T order while ``fc_all`` is T,R,N
(``ieee3modalPart.py:502``); the slicing here follows the real T,R,N layout.
"""

from __future__ import annotations

import os.path as osp
from typing import Sequence

import numpy as np

from .tools import mkdir_if_missing

__all__ = ["visualize_ranked_results", "show_point_multi_modal"]

GRID_SPACING = 10
QUERY_EXTRA_SPACING = 90
BW = 5  # border width


def _load_thumb(path, width, height):
    from PIL import Image

    from .tools import read_image

    img = read_image(path if isinstance(path, str) else path[0])
    return np.asarray(
        Image.fromarray(img).resize((width, height), Image.BILINEAR)
    )


def _bordered(img, color):
    h, w, _ = img.shape
    out = np.zeros((h + 2 * BW, w + 2 * BW, 3), np.uint8)
    out[:, :] = color
    out[BW:-BW, BW:-BW] = img
    return out


def visualize_ranked_results(distmat, dataset, data_type="image", width=128,
                             height=256, save_dir="", topk=10):
    """Write one strip image per query: query | top-k gallery, green border =
    correct pid, red = wrong (reference ``reidtools.py:18-154``). For
    ``data_type="video"`` each query gets a folder of per-rank tracklet
    subfolders (``query_top000``, ``gallery_topNNN_TRUE|FALSE``) holding
    the copied frames, as the reference's ``_cp_img_to`` does.

    Args:
        distmat: (num_query, num_gallery).
        dataset: (query, gallery) lists of (path(s), pid, camid[, dsetid]).
    """
    from PIL import Image

    distmat = np.asarray(distmat)
    num_q, num_g = distmat.shape
    mkdir_if_missing(save_dir)
    query, gallery = dataset
    assert num_q == len(query) and num_g == len(gallery)

    indices = np.argsort(distmat, axis=1)

    if data_type == "video":
        _visualize_ranked_tracklets(indices, query, gallery, save_dir, topk)
        return
    for q_idx in range(num_q):
        qentry = query[q_idx]
        qpath, qpid, qcamid = qentry[0], qentry[1], qentry[2]
        qimg = _bordered(_load_thumb(qpath, width, height), (0, 0, 0))
        strip = [qimg, np.full((qimg.shape[0], QUERY_EXTRA_SPACING, 3), 255,
                               np.uint8)]
        rank_idx = 1
        for g_idx in indices[q_idx]:
            gentry = gallery[g_idx]
            gpath, gpid, gcamid = gentry[0], gentry[1], gentry[2]
            if (gpid == qpid) and (gcamid == qcamid):
                continue  # same-camera junk, as the eval protocol
            color = (0, 255, 0) if gpid == qpid else (255, 0, 0)
            strip.append(_bordered(_load_thumb(gpath, width, height), color))
            strip.append(np.full((qimg.shape[0], GRID_SPACING, 3), 255,
                                 np.uint8))
            rank_idx += 1
            if rank_idx > topk:
                break
        grid = np.concatenate(strip[:-1], axis=1)
        qname = osp.basename(qpath if isinstance(qpath, str) else qpath[0])
        qname = qname.replace("/", "_").replace(":", "_")
        if not qname.lower().endswith((".jpg", ".jpeg", ".png")):
            qname += ".jpg"
        Image.fromarray(grid).save(osp.join(save_dir, qname))
    print(f'Done. Images have been saved to "{save_dir}" ...')


def _visualize_ranked_tracklets(indices, query, gallery, save_dir, topk):
    """Video-reid ranks: one folder per query tracklet, with the query's
    frames under ``query_top000`` and each ranked gallery tracklet's frames
    under ``gallery_topNNN_TRUE|FALSE`` (reference ``reidtools.py:51-77``
    ``_cp_img_to``)."""
    import shutil

    def _paths(p):
        return list(p) if isinstance(p, (tuple, list)) else [p]

    for q_idx in range(len(query)):
        qentry = query[q_idx]
        qpaths, qpid, qcamid = _paths(qentry[0]), qentry[1], qentry[2]
        qdir = osp.join(save_dir,
                        osp.basename(osp.splitext(qpaths[0])[0]))
        dst = osp.join(qdir, "query_top000")
        mkdir_if_missing(dst)
        for p in qpaths:
            shutil.copy(p, dst)
        rank_idx = 1
        for g_idx in indices[q_idx]:
            gentry = gallery[g_idx]
            gpaths, gpid, gcamid = _paths(gentry[0]), gentry[1], gentry[2]
            if (gpid == qpid) and (gcamid == qcamid):
                continue  # same-camera junk, as the eval protocol
            suffix = "TRUE" if gpid == qpid else "FALSE"
            dst = osp.join(qdir,
                           f"gallery_top{rank_idx:03d}_{suffix}")
            mkdir_if_missing(dst)
            for p in gpaths:
                shutil.copy(p, dst)
            rank_idx += 1
            if rank_idx > topk:
                break
    print(f'Done. Tracklet folders have been saved to "{save_dir}" ...')


def show_point_multi_modal(features, real_labels, save_path="tsne.png",
                           modal_dims: Sequence[int] = (768, 768, 768),
                           perplexity: float = 30.0, seed: int = 0):
    """t-SNE scatter of per-modality feature blocks colored by identity
    (reference ``engine/engine.py:463-490``). ``features`` is (N, 2304) in
    T,R,N block order."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.manifold import TSNE  # scikit-learn is optional

    features = np.asarray(features)
    real_labels = np.asarray(real_labels)
    print(f"draw points of {len(set(real_labels.tolist()))} classes")

    blocks = []
    start = 0
    for d in modal_dims:
        blocks.append(features[:, start:start + d])
        start += d

    fig, axes = plt.subplots(1, len(blocks),
                             figsize=(6 * len(blocks), 6))
    if len(blocks) == 1:
        axes = [axes]
    names = ["T", "R", "N"]  # fc_all block order (ieee3modalPart.py:502)
    for ax, block, nm in zip(axes, blocks, names):
        emb = TSNE(n_components=2, random_state=seed,
                   perplexity=min(perplexity, max(len(block) - 1, 1) / 3)
                   ).fit_transform(block)
        ax.scatter(emb[:, 0], emb[:, 1], c=real_labels, cmap="tab20", s=12)
        ax.set_title(f"modality {nm}")
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(save_path, dpi=150)
    plt.close(fig)
    print(f'Saved t-SNE scatter to "{save_path}"')
