"""The plain reference that judges the program's answers: NumPy only.

It imports nothing of the program and takes nothing the program made. From
the benchmark's own inputs (the boxes' sizes, the generated frame, the exact
poses) and an answer's poses it recomputes:

- ADD-S (Hinterstoisser et al.): the mean, over a fixed grid of points of
  the box surface at the true pose, of the distance to the box surface at the
  answered pose;
- the LCP fit: the share of an object's observed points (its mask's depth
  pixels, back-projected) that lie within delta of the box surface at a pose,
  the paper's verification score, at the answer against the truth.
"""

from __future__ import annotations

import numpy as np

from gpubench import scenes

SURFACE_STEP_M = 0.005  # grid pitch of the ADD-S surface samples


def box_surface_points(size, step: float = SURFACE_STEP_M) -> np.ndarray:
    """[N, 3] points on the six faces of a box centred at the origin, on a
    grid of pitch about `step` (the same points every call)."""
    half = np.asarray(size, np.float64) / 2.0
    pts = []
    for axis in range(3):
        u, v = [a for a in range(3) if a != axis]
        nu = max(2, int(round(2 * half[u] / step)) + 1)
        nv = max(2, int(round(2 * half[v] / step)) + 1)
        gu, gv = np.meshgrid(np.linspace(-half[u], half[u], nu), np.linspace(-half[v], half[v], nv))
        for sign in (-1.0, 1.0):
            p = np.zeros((gu.size, 3))
            p[:, u], p[:, v], p[:, axis] = gu.ravel(), gv.ravel(), sign * half[axis]
            pts.append(p)
    return np.concatenate(pts)


def transform(pose: np.ndarray, pts: np.ndarray) -> np.ndarray:
    pose = np.asarray(pose, np.float64)
    return pts @ pose[:3, :3].T + pose[:3, 3]


def adds_m(pose: np.ndarray, truth: np.ndarray, size, surface: np.ndarray) -> float:
    """ADD-S in metres of `pose` against `truth`: the mean over the box's
    `surface` points at the truth of the distance to the box surface at
    `pose` (the limit of the nearest model point as the samples grow dense)."""
    if not np.all(np.isfinite(pose)):
        return float("inf")
    gt = transform(truth, surface)
    return float(distance_to_box_surface(gt, pose, size).mean())


# The rotations that map a box with three distinct extents onto itself.
BOX_SYMMETRIES = (np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
                  np.diag([-1.0, -1.0, 1.0]))


def pose_errors(pose: np.ndarray, truth: np.ndarray) -> tuple:
    """(translation error in m, rotation error in degrees up to the box's
    symmetries) of `pose` against `truth`."""
    pose, truth = np.asarray(pose, np.float64), np.asarray(truth, np.float64)
    if not np.all(np.isfinite(pose)):
        return float("inf"), float("inf")
    t = float(np.linalg.norm(pose[:3, 3] - truth[:3, 3]))
    rel = pose[:3, :3].T @ truth[:3, :3]
    cos = max(float(np.trace(rel @ s) - 1.0) / 2.0 for s in BOX_SYMMETRIES)
    return t, float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def distance_to_box_surface(pts_cam: np.ndarray, pose: np.ndarray, size) -> np.ndarray:
    """Unsigned distance of camera-frame points to the surface of the box of
    extents `size` at `pose` (camera frame)."""
    pose = np.asarray(pose, np.float64)
    local = (pts_cam - pose[:3, 3]) @ pose[:3, :3]
    q = np.abs(local) - np.asarray(size, np.float64) / 2.0
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = -np.minimum(q.max(axis=-1), 0.0)
    return np.where(q.max(axis=-1) > 0, outside, inside)


def observed_points(scene: scenes.Scene, class_id: int, k: np.ndarray) -> np.ndarray:
    """[N, 3] camera-frame points of the object's mask pixels that have depth."""
    vs, us = np.nonzero((scene.mask == class_id) & (scene.depth > 0))
    z = scene.depth[vs, us].astype(np.float64)
    return np.stack([(us - k[0, 2]) * z / k[0, 0], (vs - k[1, 2]) * z / k[1, 1], z], -1)


def lcp_fit(pts: np.ndarray, pose: np.ndarray, size, delta: float) -> float:
    """Share of `pts` within `delta` of the box surface at `pose`."""
    if len(pts) == 0 or not np.all(np.isfinite(pose)):
        return 0.0
    return float(np.mean(distance_to_box_surface(pts, pose, size) <= delta))
