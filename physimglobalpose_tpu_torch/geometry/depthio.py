"""Depth / probability / mask image codecs (host-side numpy).

Reference semantics (utilities.cpp):
- readDepthImage: 16-bit PNG, APC datasets store depth bit-rotated; decode is
  d = rot16(d_raw, left=13) / 10000 meters (a full 16-bit circular shift).
- writeDepthImage: meters * 10000 -> uint16, no rotation.
- readProbImage: 16-bit PNG / 10000 -> [0, 1] float probability.

PIL is imported inside the PNG readers and writers only, so the in-memory
path (scene_from_arrays) works without it.
"""

from __future__ import annotations

import numpy as np

DEPTH_SCALE = 10000.0


def _image_module():
    from PIL import Image

    return Image


def rot16_left(x: np.ndarray, k: int) -> np.ndarray:
    """16-bit circular left shift by k."""
    x = x.astype(np.uint16)
    return ((x << k) | (x >> (16 - k))).astype(np.uint16)


def decode_depth(raw: np.ndarray, bit_rotated: bool = True) -> np.ndarray:
    """uint16 raw depth image -> float32 meters (APC rot-left-13 if bit_rotated)."""
    raw = raw.astype(np.uint16)
    if bit_rotated:
        raw = rot16_left(raw, 13)
    return raw.astype(np.float32) / DEPTH_SCALE


def encode_depth(depth_m: np.ndarray, bit_rotated: bool = False) -> np.ndarray:
    """float32 meters -> uint16; bit_rotated=True applies the inverse of the
    APC decode rotation (rot-left-3) so the file reads back through the APC path."""
    raw = (depth_m * DEPTH_SCALE).astype(np.uint16)
    if bit_rotated:
        raw = rot16_left(raw, 3)
    return raw


def read_depth_png_raw(path: str, bit_rotated: bool = True) -> np.ndarray:
    """16-bit depth PNG -> de-rotated uint16 codec values (meters * 10000)."""
    img = np.array(_image_module().open(path))
    if img.dtype != np.uint16:
        img = img.astype(np.uint16)
    if bit_rotated:
        img = rot16_left(img, 13)
    return img


def read_depth_png(path: str, bit_rotated: bool = True) -> np.ndarray:
    raw = read_depth_png_raw(path, bit_rotated=bit_rotated)
    return raw.astype(np.float32) / DEPTH_SCALE


def write_depth_png(path: str, depth_m: np.ndarray, bit_rotated: bool = False) -> None:
    _image_module().fromarray(encode_depth(depth_m, bit_rotated=bit_rotated)).save(path)


def read_prob_png(path: str) -> np.ndarray:
    """16-bit probability PNG -> float32 in [0, ~6.5] (nominally [0, 1])."""
    return np.array(_image_module().open(path)).astype(np.float32) / DEPTH_SCALE


def write_prob_png(path: str, prob: np.ndarray) -> None:
    _image_module().fromarray((prob * DEPTH_SCALE).astype(np.uint16)).save(path)


def read_class_mask_png(path: str) -> np.ndarray:
    """Class-id mask (single channel; first channel if RGB) -> int32 array."""
    img = np.array(_image_module().open(path))
    if img.ndim == 3:
        img = img[..., 0]
    return img.astype(np.int32)


def read_color_png(path: str) -> np.ndarray:
    """RGB color image -> uint8 [H, W, 3]."""
    return np.array(_image_module().open(path).convert("RGB"))
