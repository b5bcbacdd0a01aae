"""Result visualization (host-side, PIL and numpy; no display server).

Replaces the reference's RViz marker publishing (main.cpp:20-81: per-object
mesh markers and the scene cloud on ROS topics) with image artifacts: the
estimated poses are projected into the color frame as colored point overlays
and saved as PNGs. A numpy copy of the JAX package's utils/viz.py; PIL is
imported inside the writers only.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_COLORS = [
    (255, 64, 64), (64, 255, 64), (64, 64, 255), (255, 255, 0),
    (255, 64, 255), (64, 255, 255), (255, 160, 0), (160, 64, 255),
]


def _save_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)


def project_points(points: np.ndarray, intrinsics: np.ndarray, h: int, w: int):
    """[N, 3] camera-frame points -> (rows, cols, valid)."""
    z = points[:, 2]
    safe = np.where(z <= 0, 1.0, z)
    cols = np.round(points[:, 0] * intrinsics[0, 0] / safe + intrinsics[0, 2]).astype(int)
    rows = np.round(points[:, 1] * intrinsics[1, 1] / safe + intrinsics[1, 2]).astype(int)
    ok = (z > 0) & (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    return rows, cols, ok


def overlay_poses(
    color: np.ndarray,
    intrinsics: np.ndarray,
    model_clouds: Sequence[np.ndarray],
    poses_cam: Sequence[np.ndarray],
    alpha: float = 0.6,
) -> np.ndarray:
    """Blend each object's transformed model cloud over the color image."""
    out = color.astype(np.float32).copy()
    h, w = color.shape[:2]
    for i, (cloud, pose) in enumerate(zip(model_clouds, poses_cam)):
        pts = cloud @ pose[:3, :3].T + pose[:3, 3]
        rows, cols, ok = project_points(pts, intrinsics, h, w)
        c = np.asarray(_COLORS[i % len(_COLORS)], np.float32)
        out[rows[ok], cols[ok]] = (1 - alpha) * out[rows[ok], cols[ok]] + alpha * c
    return out.astype(np.uint8)


def save_overlay(path: str, color, intrinsics, model_clouds, poses_cam) -> None:
    _save_png(path, overlay_poses(color, intrinsics, model_clouds, poses_cam))


def depth_to_image(depth: np.ndarray, max_depth: float = 2.0) -> np.ndarray:
    """Depth map -> grayscale uint8 visualization (0 = empty -> black)."""
    d = np.clip(depth / max_depth, 0, 1)
    img = (d * 255).astype(np.uint8)
    return np.where(depth > 0, img, 0).astype(np.uint8)


def save_depth_image(path: str, depth: np.ndarray, max_depth: float = 2.0) -> None:
    _save_png(path, depth_to_image(depth, max_depth))
