"""Synthetic in-memory datasets (no reference analog).

Counterpart of ``ieee_tpu/data/datasets/image/synthetic.py`` (``Synthetic``,
``SyntheticMM`` and their renderers, numpy only): the same seed gives the
same paths, pixels, pids and camids as the JAX package.

Purpose: CI/tests/bench run in environments without the (license-gated) re-ID
datasets on disk. These generate deterministic random images in memory with
realistic id/camera structure so every layer above (sampler, loaders, engine,
eval protocol) exercises identically to a real dataset.
"""

from __future__ import annotations

import numpy as np

from ..base import ImageDataset, MultiModalImageDataset


def _make_split(rng, num_pids, imgs_per_pid, num_cams, num_modal,
                pid_offset=0, scheme="synthetic"):
    data = []
    for pid in range(num_pids):
        for j in range(imgs_per_pid):
            camid = int(rng.integers(0, num_cams))
            key = int(rng.integers(0, 2**31))
            if num_modal == 1:
                data.append((f"{scheme}://{pid + pid_offset}/{j}/{key}",
                             pid + pid_offset, camid))
            else:
                paths = [
                    f"{scheme}://{pid + pid_offset}/{j}/{key}/{m}"
                    for m in range(num_modal)
                ]
                data.append((paths, pid + pid_offset, camid))
    return data


def _md5_seed(s: str) -> int:
    import hashlib

    return int(hashlib.md5(s.encode()).hexdigest()[:8], 16)


# --- synthetic-x1: the discriminative cross-modal benchmark -----------------
# Knobs are frozen under the scheme version tag: changing any constant must
# bump "x1" -> "x2" (decode caches and artifacts key on the path string).
_X1_GRID = (16, 8)      # cell grid, upsampled to (height, width)
_X1_GROUP = 4           # pids per shared-code group (within-group
                        # discrimination NEEDS the modality-specific codes)
_X1_A_SHARED = 14.0     # amplitude of the group-shared code (all modalities)
_X1_A_SPEC = 14.0       # amplitude of the modality-specific per-pid code
_X1_NOISE = 30.0        # per-pixel gaussian camera noise (sigma)
_X1_N_BANDS = 8         # horizontal occlusion bands (2 grid rows each)
_X1_N_OCCLUDE = 2       # bands wiped per image (part-level nuisance)


def _render_x1(path: str, height: int, width: int) -> np.ndarray:
    """``synthetic-x1://pid/j/key/m`` — cross-modal factorized identities.

    Identity signal is split ACROSS modalities (the regime the reference's
    CIM/3M/REM modules target, reference ieee3modalPart.py:427-435,:51-80;
    losses/multi_modal_margin_loss_new.py:19-40):

    * a *group-shared* code (same for ``pid // _X1_GROUP``, rendered in every
      modality at weak amplitude): redundant noisy views — cross-modal
      mixing can denoise it, single-modality training cannot.
    * a *modality-specific* per-pid code (one per (pid, modality)): the only
      within-group discriminant. A representation that collapses to the
      cross-modal consensus retrieves at group level only (mAP ceiling
      ~K_gallery-matched-by-group), which is the failure mode the 3M margin
      loss penalizes.
    * per-image camera nuisance: channel affine, horizontal roll, gaussian
      noise, plus *stripe occlusion* (2 of 8 horizontal bands wiped to
      mid-gray): occluded part-stripes carry no identity signal, rewarding
      part/global re-weighting (REM) over blind part pooling.
    """
    gh, gw = _X1_GRID
    parts = path[len("synthetic-x1://"):].split("/")
    pid, modal = parts[0], (parts[3] if len(parts) > 3 else "0")
    group = int(pid) // _X1_GROUP
    shared_rng = np.random.default_rng(_md5_seed(f"x1-shared/{group}"))
    spec_rng = np.random.default_rng(_md5_seed(f"x1-spec/{pid}/{modal}"))
    z_shared = shared_rng.normal(size=(gh, gw, 3))
    z_spec = spec_rng.normal(size=(gh, gw, 3))
    img = 128.0 + _X1_A_SHARED * z_shared + _X1_A_SPEC * z_spec

    rng = np.random.default_rng(_md5_seed(path))
    gain = rng.uniform(0.75, 1.35, size=(1, 1, 3))
    offset = rng.uniform(-24.0, 24.0, size=(1, 1, 3))
    img = (img - 128.0) * gain + 128.0 + offset
    # stripe occlusion in grid space (gh rows / _X1_N_BANDS bands)
    bands = rng.choice(_X1_N_BANDS, size=_X1_N_OCCLUDE, replace=False)
    rows_per_band = gh // _X1_N_BANDS
    for b in bands:
        img[b * rows_per_band:(b + 1) * rows_per_band] = 128.0
    img = np.kron(img, np.ones((-(-height // gh), -(-width // gw), 1)))
    img = img[:height, :width]
    img = np.roll(img, rng.integers(-width // 8, width // 8 + 1), axis=1)
    img += rng.normal(0.0, _X1_NOISE, size=img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _render(path: str, height: int, width: int) -> np.ndarray:
    """Deterministic pseudo-image from the path string (md5, not hash():
    python string hashing is randomized per process, which broke decode
    caches persisted across test processes).

    Two schemes:

    * ``synthetic://pid/j/key[/m]`` — every image iid random (throughput /
      pipeline tests; retrieval metrics are chance by design).
    * ``synthetic-corr://pid/j/key[/m]`` — the 16x8 base pattern is seeded
      by (pid, modality) only; each image then gets a per-image "camera
      effect" (random per-channel gain/offset, horizontal roll, noise)
      seeded by the full path. Same-identity images share structure but
      NOT raw pixels, so retrieval with untrained features starts near
      chance yet is LEARNABLE — end-to-end training runs show real mAP
      convergence (the stand-in for the license-gated RGBNT201 protocol).
    """
    if path.startswith("synthetic-x1://"):
        return _render_x1(path, height, width)
    rng = np.random.default_rng(_md5_seed(path))
    if path.startswith("synthetic-corr://"):
        parts = path[len("synthetic-corr://"):].split("/")
        pid = parts[0]
        modal = parts[3] if len(parts) > 3 else "0"
        base_rng = np.random.default_rng(_md5_seed(f"corr-id/{pid}/{modal}"))
        base = base_rng.integers(32, 224, size=(16, 8, 3), dtype=np.int16)
        img = np.kron(base, np.ones((-(-height // 16), -(-width // 8), 1),
                                    dtype=np.int16))
        img = img[:height, :width].astype(np.float32)
        # camera effect: per-channel affine + horizontal roll + noise
        gain = rng.uniform(0.4, 1.6, size=(1, 1, 3))
        offset = rng.uniform(-48.0, 48.0, size=(1, 1, 3))
        img = img * gain + offset
        img = np.roll(img, rng.integers(-width // 4, width // 4 + 1), axis=1)
        img += rng.normal(0.0, 24.0, size=img.shape)
        return np.clip(img, 0, 255).astype(np.uint8)
    base = rng.integers(0, 256, size=(8, 4, 3), dtype=np.uint8)
    # ceil-divide so any (height, width) is covered, then crop — floor
    # division under-covered sizes not divisible by 8/4 (broadcast crash)
    img = np.kron(base, np.ones((-(-height // 8), -(-width // 4), 1),
                                dtype=np.uint8))[:height, :width]
    noise = rng.integers(0, 32, size=(height, width, 3), dtype=np.uint8)
    # widen before adding: uint8 + uint8 wraps mod 256 (pixel 240 + noise 30
    # would flip to 14) and the clip would never fire
    return np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)


class _SyntheticMixin:
    def _read_resized(self, path: str) -> np.ndarray:
        return _render(path, self.height, self.width)


class Synthetic(_SyntheticMixin, ImageDataset):
    """Single-modal synthetic dataset. ``correlated=True`` makes
    same-identity images share appearance (learnable retrieval).
    ``heldout_test=True`` draws the query/gallery identities DISJOINT from
    the train identities (open-set protocol, like the real re-ID datasets'
    train/test splits); default False keeps the historical seen-id split."""

    def __init__(self, root="", num_pids=16, imgs_per_pid=8, num_cams=4,
                 seed=0, correlated=False, heldout_test=False, **kwargs):
        rng = np.random.default_rng(seed)
        scheme = "synthetic-corr" if correlated else "synthetic"
        test_offset = num_pids if heldout_test else 0
        train = _make_split(rng, num_pids, imgs_per_pid, num_cams, 1,
                            scheme=scheme)
        query = _make_split(rng, num_pids // 2, 2, num_cams, 1, scheme=scheme,
                            pid_offset=test_offset)
        gallery = _make_split(rng, num_pids // 2, 4, num_cams, 1,
                              scheme=scheme, pid_offset=test_offset)
        kwargs.setdefault("verbose", False)
        super().__init__(train, query, gallery, **kwargs)


class SyntheticMM(_SyntheticMixin, MultiModalImageDataset):
    """3-modal (R/N/T-style) synthetic dataset. ``correlated=True`` makes
    same-identity images share per-modality appearance (learnable
    retrieval).
    ``heldout_test=True`` makes the query/gallery identities disjoint from
    the train identities (open-set protocol; see ``Synthetic``)."""

    def __init__(self, root="", num_pids=16, imgs_per_pid=8, num_cams=4,
                 num_modal=3, seed=0, correlated=False, heldout_test=False,
                 cross_modal=False, **kwargs):
        rng = np.random.default_rng(seed)
        scheme = "synthetic-corr" if correlated else "synthetic"
        if cross_modal:
            # the discriminative benchmark: identity info factorized across
            # modalities (see _render_x1); implies learnable appearance
            scheme = "synthetic-x1"
        test_offset = num_pids if heldout_test else 0
        train = _make_split(rng, num_pids, imgs_per_pid, num_cams, num_modal,
                            scheme=scheme)
        query = _make_split(rng, num_pids // 2, 2, num_cams, num_modal,
                            scheme=scheme, pid_offset=test_offset)
        gallery = _make_split(rng, num_pids // 2, 4, num_cams, num_modal,
                              scheme=scheme, pid_offset=test_offset)
        kwargs.setdefault("verbose", False)
        super().__init__(train, query, gallery, **kwargs)
