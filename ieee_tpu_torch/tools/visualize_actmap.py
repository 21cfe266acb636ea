"""Visualize activation maps per modality.

Counterpart of ``tools/visualize_actmap.py`` (reference analog:
``tools/visualize_actmap.py:26-154``): forwards the query images with
``return_featuremaps=True`` in eval mode under ``torch.no_grad()`` on
``--device``, takes the L2 channel energy of the trunk's final feature map
and writes it as a heatmap beside the input image and their overlay, one
PNG per image. ``--modal`` selects RGB / NI / TI for multi-modal models.

The port's maps are NCHW (bf16 and channels_last under the default compute
dtype); each is cast to f32 and copied to the host as NHWC, where the
energy (the sum of squares over the channels) and the JAX tool's
normalisation (L2 per image, then min-max) run in numpy as there. The JET
colours come from a 256-entry table computed here from matplotlib's jet
segment data, sampled as ``LinearSegmentedColormap`` samples it, so the tool
needs no matplotlib.

Usage:
    python -m ieee_tpu_torch.tools.visualize_actmap --config-file <yaml> \
        --root <data-root> --weights <ckpt> --save-dir log/actmap \
        [--modal RGB] [--device cuda] [key value ...]
"""

from __future__ import annotations

import argparse
import os.path as osp

import numpy as np
import torch

from ..config import get_default_config, imagedata_kwargs
from ..data import ImageDataManager
from ..models import build_model
from ..utils.checkpoint import load_pretrained_weights
from ..utils.tools import mkdir_if_missing
from ._timing import parse_tool_args

__all__ = ["visactmap", "main", "JET_LUT"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406])
IMAGENET_STD = np.array([0.229, 0.224, 0.225])
MODAL_IDX = {"RGB": 0, "NI": 1, "TI": 2}

# matplotlib's jet (matplotlib/_cm.py ``_jet_data``): per channel, rows of
# (x, y below x, y above x)
_JET_DATA = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
              (0.91, 0, 0), (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.0, 0, 0)),
}


def _lookup_table(n: int, data) -> np.ndarray:
    """``n`` samples of a segmented channel over [0, 1], as matplotlib's
    ``colors._create_lookup_table`` (gamma 1) computes them."""
    adata = np.array(data)
    x, y0, y1 = adata[:, 0] * (n - 1), adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n) ** 1.0
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]],
                          distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


#: (256, 3) float64 RGB of matplotlib's ``cm.jet``
JET_LUT = np.stack([_lookup_table(256, _JET_DATA[c])
                    for c in ("red", "green", "blue")], axis=1)


def _colormap_jet(x):
    """x in [0, 1] -> uint8 RGB, equal to ``(matplotlib.cm.jet(x)[..., :3]
    * 255).astype(np.uint8)``: x scaled by 256 in its own dtype and
    truncated, 1.0 on the last entry, under and over range on the first and
    last, NaN black."""
    n = len(JET_LUT)
    xa = np.array(x, copy=True)
    if xa.dtype.kind == "f":
        xa *= n
        xa[xa == n] = n - 1
    under, over, bad = xa < 0, xa >= n, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under] = 0
    idx[over] = n - 1
    idx[bad] = 0
    rgb = JET_LUT.take(idx, axis=0)
    rgb[bad] = 0.0
    return (rgb * 255).astype(np.uint8)


def visactmap(model, test_loader, save_dir, width, height, modal="RGB",
              max_batches=10, device="cuda"):
    """Write the activation maps of the first ``max_batches`` query batches
    of each target under ``save_dir/actmap_<target>``; returns the paths
    written."""
    from PIL import Image

    device = torch.device(device)
    model.eval()

    def put(a):  # uint8 NHWC batch -> normalised f32 NCHW on the device
        a = (a.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        return torch.from_numpy(a.astype(np.float32)).to(device).permute(
            0, 3, 1, 2)

    def host_nhwc(fmap):
        return np.ascontiguousarray(
            fmap.float().permute(0, 2, 3, 1).cpu().numpy())

    written = []
    for target, loaders in test_loader.items():
        out_dir = osp.join(save_dir, "actmap_" + target)
        mkdir_if_missing(out_dir)
        for b_idx, data in enumerate(loaders["query"]):
            if b_idx >= max_batches:
                break
            imgs = data["img"]
            multi = isinstance(imgs, tuple)
            with torch.no_grad():
                if multi:
                    fmaps = model(tuple(put(m) for m in imgs),
                                  return_featuremaps=True)
                    fmap = host_nhwc(fmaps[MODAL_IDX[modal]])
                    shown = imgs[MODAL_IDX[modal]]
                else:
                    fmap = host_nhwc(model(put(imgs),
                                           return_featuremaps=True))
                    shown = imgs

            # L2 channel energy -> per-image [0,1] heatmap (reference :96-118)
            energy = (fmap ** 2).sum(axis=-1)  # (B, h, w)
            b, h, w = energy.shape
            flat = energy.reshape(b, -1)
            flat = flat / (np.linalg.norm(flat, axis=1, keepdims=True) + 1e-12)
            energy = flat.reshape(b, h, w)
            emin = energy.min(axis=(1, 2), keepdims=True)
            emax = energy.max(axis=(1, 2), keepdims=True)
            energy = (energy - emin) / (emax - emin + 1e-12)

            for i in range(b):
                am = np.asarray(
                    Image.fromarray((energy[i] * 255).astype(np.uint8)).resize(
                        (width, height), Image.BILINEAR
                    ), np.float32,
                ) / 255.0
                heat = _colormap_jet(am)
                overlay = (0.6 * shown[i] + 0.4 * heat).astype(np.uint8)
                grid = np.concatenate(
                    [shown[i],
                     np.full((height, 10, 3), 255, np.uint8),
                     heat,
                     np.full((height, 10, 3), 255, np.uint8),
                     overlay],
                    axis=1,
                )
                name = osp.basename(
                    data["impath"][i] if isinstance(data["impath"][i], str)
                    else data["impath"][i][0]
                ).replace("/", "_").replace(":", "_")
                path = osp.join(out_dir, f"{b_idx}_{name}.png")
                Image.fromarray(grid).save(path)
                written.append(path)
        print(f"actmaps for {target} ({modal}) written to {out_dir}")
    return written


def main(argv=None) -> list:
    """Run the tool; returns the paths of the PNGs written."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config-file", type=str, default="")
    parser.add_argument("--root", type=str, default="")
    parser.add_argument("--weights", type=str, default="")
    parser.add_argument("--save-dir", type=str, default="log/actmap")
    parser.add_argument("--modal", type=str, default="RGB",
                        choices=list(MODAL_IDX))
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args, device = parse_tool_args(parser, argv)

    cfg = get_default_config()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.root:
        cfg.data.root = args.root
    if args.opts:
        cfg.merge_from_list(args.opts)

    dm = ImageDataManager(**imagedata_kwargs(cfg))
    model = build_model(cfg.model.name, num_classes=dm.num_train_pids,
                        loss=cfg.loss.name, pretrained=cfg.model.pretrained,
                        dtype=cfg.cuda.compute_dtype, device=device)
    if args.weights:
        load_pretrained_weights(model, args.weights)

    return visactmap(model, dm.test_loader, args.save_dir, cfg.data.width,
                     cfg.data.height, modal=args.modal, device=device)


if __name__ == "__main__":
    main()
