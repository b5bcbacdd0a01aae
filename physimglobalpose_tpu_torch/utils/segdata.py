"""Segmentation training data pipeline (host-side numpy).

Reference: fcn_segmentation_package/utils/SegDataGenerator.py (519 LoC) -
Keras-era generator with random crop / zoom / horizontal flip / padding to a
fixed target size and an ignore label for loss masking. Here the same
augmentations are pure-numpy functions plus a batched iterator that yields
NHWC float images and int label maps; the ignore label follows the reference
convention (label == num_classes is ignored by the loss, models/fcn.py
softmax_xent_ignore_last). A numpy copy of the JAX package's utils/segdata.py.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class AugmentConfig:
    target_size: Tuple[int, int] = (320, 320)  # (H, W)
    zoom_range: Tuple[float, float] = (0.8, 1.2)
    horizontal_flip: bool = True
    crop_mode: str = "random"  # "random" | "center" | "none"
    ignore_label: int = 255


def random_zoom(img: np.ndarray, label: np.ndarray, zoom: float):
    """Nearest-neighbor zoom of image+label by the same factor."""
    h, w = img.shape[:2]
    nh, nw = max(1, int(h * zoom)), max(1, int(w * zoom))
    ri = np.clip((np.arange(nh) / zoom).astype(np.int64), 0, h - 1)
    ci = np.clip((np.arange(nw) / zoom).astype(np.int64), 0, w - 1)
    return img[ri][:, ci], label[ri][:, ci]


def pad_or_crop(
    img: np.ndarray,
    label: np.ndarray,
    target: Tuple[int, int],
    rng: np.random.Generator,
    mode: str = "random",
    ignore_label: int = 255,
):
    """Pad (image with zeros, label with ignore) then crop to target size.

    Matches the reference's pad-to-target + crop behavior
    (SegDataGenerator pad/crop paths); the ignore padding keeps padded pixels
    out of the loss.
    """
    th, tw = target
    h, w = img.shape[:2]
    ph, pw = max(th - h, 0), max(tw - w, 0)
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
        label = np.pad(label, ((0, ph), (0, pw)), constant_values=ignore_label)
        h, w = img.shape[:2]
    if mode == "center":
        y0, x0 = (h - th) // 2, (w - tw) // 2
    elif mode == "random":
        y0 = int(rng.integers(0, h - th + 1))
        x0 = int(rng.integers(0, w - tw + 1))
    else:
        y0 = x0 = 0
    return img[y0 : y0 + th, x0 : x0 + tw], label[y0 : y0 + th, x0 : x0 + tw]


def augment_pair(
    img: np.ndarray,
    label: np.ndarray,
    cfg: AugmentConfig,
    rng: np.random.Generator,
):
    """One augmented (image, label) pair at cfg.target_size."""
    if cfg.zoom_range != (1.0, 1.0):
        zoom = float(rng.uniform(*cfg.zoom_range))
        img, label = random_zoom(img, label, zoom)
    if cfg.horizontal_flip and rng.random() < 0.5:
        img = img[:, ::-1]
        label = label[:, ::-1]
    img, label = pad_or_crop(
        img, label, cfg.target_size, rng,
        mode=cfg.crop_mode if cfg.crop_mode != "none" else "pad",
        ignore_label=cfg.ignore_label,
    )
    return np.ascontiguousarray(img), np.ascontiguousarray(label)


def batches(
    images: Sequence[np.ndarray],
    labels: Sequence[np.ndarray],
    num_classes: int,
    batch_size: int,
    cfg: AugmentConfig = AugmentConfig(),
    seed: int = 0,
    epochs: int | None = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields (images [B,H,W,3] f32 in [0,1], labels [B,H,W] i32).

    Pixels with the ignore label are remapped to num_classes, which the loss
    ignores (loss_function.py semantics).
    """
    rng = np.random.default_rng(seed)
    n = len(images)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n)
        for start in range(0, n - batch_size + 1, batch_size):
            bi: List[np.ndarray] = []
            bl: List[np.ndarray] = []
            for k in order[start : start + batch_size]:
                img, lab = augment_pair(images[k], labels[k], cfg, rng)
                bi.append(img.astype(np.float32) / 255.0)
                lab = lab.astype(np.int32)
                lab = np.where(lab == cfg.ignore_label, num_classes, lab)
                bl.append(lab)
            yield np.stack(bi), np.stack(bl)
        epoch += 1
