"""Training data: LR/HR patch pairs per the SRCNN recipe.

The port of ``srcnn_cpp_tpu/train/data.py``, NumPy arrays in and out.  The
reference ships no trainer; its checkpoint came from the Dong et al. 2014
recipe — sub-images cropped from ground truth, degraded by bicubic
downscale (MATLAB imresize kernel) and re-upscaled, regressed to the HR
crop.  This module reproduces that data pipeline on the Y channel in the
0-255 domain the reference weights use, with the same NumPy random
streams as the JAX package, so both draw the same permutations and
batches.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..imageio import imread_bgr
from ..ops.color import bgr2ycrcb_u8_planar
from ..ops.resize import resize_separable
from ..ops.resize_tables import resize_bicubic_u8_np

__all__ = ["patches_from_image", "dataset_from_dir", "iterate_minibatches"]


def _y_plane(bgr: np.ndarray) -> np.ndarray:
    """BGR uint8 ``[H, W, 3]`` -> its OpenCV-exact Y plane, uint8."""
    planar = torch.from_numpy(np.ascontiguousarray(np.moveaxis(bgr, -1, 0)))
    return bgr2ycrcb_u8_planar(planar)[0].numpy()


def _degrade_y(y: np.ndarray, scale: float) -> np.ndarray:
    """GT Y -> bicubic-degraded, re-upscaled Y (same size), uint8.

    Degradation uses the anti-aliased Keys a=-0.5 kernel (imresize
    semantics, reference Pictures/Resize.m); the re-upscale uses the
    pipeline's OpenCV-exact bicubic, i.e. exactly what inference sees.
    """
    h, w = y.shape
    lh, lw = int(round(h / scale)), int(round(w / scale))
    lr = resize_separable(torch.from_numpy(y.astype(np.float32)), (lh, lw),
                          "cubic_matlab").numpy()
    lr = np.clip(np.round(lr), 0, 255).astype(np.uint8)
    return resize_bicubic_u8_np(lr, (h, w))


def patches_from_image(bgr: np.ndarray, scale: float = 2.0,
                       patch: int = 33, stride: int = 14,
                       rng: np.random.Generator | None = None,
                       max_patches: int | None = None):
    """(lr_up_patches, hr_patches) uint8 [N, patch, patch] from one image."""
    y = _y_plane(bgr)
    h, w = y.shape
    ch = int(h // scale * scale)
    cw = int(w // scale * scale)
    y = y[:ch, :cw]
    lr_up = _degrade_y(y, scale)
    xs, ys_ = [], []
    for r in range(0, ch - patch + 1, stride):
        for c in range(0, cw - patch + 1, stride):
            xs.append(lr_up[r:r + patch, c:c + patch])
            ys_.append(y[r:r + patch, c:c + patch])
    x = np.stack(xs) if xs else np.zeros((0, patch, patch), np.uint8)
    t = np.stack(ys_) if ys_ else np.zeros((0, patch, patch), np.uint8)
    if rng is not None:
        perm = rng.permutation(len(x))
        x, t = x[perm], t[perm]
    if max_patches is not None:
        x, t = x[:max_patches], t[:max_patches]
    return x, t


def dataset_from_dir(path, scale: float = 2.0, patch: int = 33,
                     stride: int = 14, seed: int = 0,
                     max_patches_per_image: int | None = None):
    """Concatenate patch pairs over every readable image under ``path``."""
    rng = np.random.default_rng(seed)
    xs, ts = [], []
    for f in sorted(Path(path).iterdir()):
        if f.suffix.lower() not in {".png", ".jpg", ".jpeg", ".bmp"}:
            continue
        bgr = imread_bgr(f)
        if bgr is None:
            continue
        x, t = patches_from_image(bgr, scale, patch, stride, rng,
                                  max_patches_per_image)
        xs.append(x)
        ts.append(t)
    if not xs:
        raise ValueError(f"no readable images under {path}")
    return np.concatenate(xs), np.concatenate(ts)


def iterate_minibatches(x: np.ndarray, t: np.ndarray, batch: int,
                        seed: int = 0, epochs: int | None = None):
    """Shuffled minibatch generator over patch pairs."""
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        perm = rng.permutation(len(x))
        for i in range(0, len(x) - batch + 1, batch):
            sel = perm[i:i + batch]
            yield x[sel], t[sel]
        epoch += 1
