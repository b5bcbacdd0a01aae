"""Depth -> point cloud conversions and fixed-size compaction.

Reference semantics (utilities.cpp:125-244): back-projection keeps pixels
with depth in (0.1, 2.0) m; x = (col - cx) d / fx, y = (row - cy) d / fy,
z = d. Clouds stay organized [H, W] maps with validity masks; extraction to
a fixed-size buffer (the segment path) keeps a random subset when there are
more valid points than the buffer holds.
"""

from __future__ import annotations

import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)


def backproject(
    depth: torch.Tensor,
    intrinsics: torch.Tensor,
    depth_min: float = 0.1,
    depth_max: float = 2.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Organized back-projection: depth [H, W] -> (points [H, W, 3], valid [H, W])."""
    h, w = depth.shape
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    rows = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None].expand(h, w)
    cols = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :].expand(h, w)
    valid = (depth > depth_min) & (depth < depth_max)
    d = torch.where(valid, depth, 0.0)
    x = (cols - cx) * d / fx
    y = (rows - cy) * d / fy
    return torch.stack([x, y, d], dim=-1), valid


def project_zmin(
    points: torch.Tensor,
    valid: torch.Tensor,
    intrinsics: torch.Tensor,
    height: int,
    width: int,
) -> torch.Tensor:
    """Project camera-frame points [N, 3] (mask [N]) into a depth map
    [height, width] with z-min compositing (convert2d), 0 where nothing
    projects. Pixels round to nearest, the inverse of backproject; the
    reference's bounds are exclusive-low (utilities.cpp:240)."""
    px = points @ intrinsics.T
    z = px[:, 2]
    safe_z = torch.where(z == 0, 1.0, z)
    col = torch.floor(px[:, 0] / safe_z + 0.5).to(torch.int64)
    row = torch.floor(px[:, 1] / safe_z + 0.5).to(torch.int64)
    inb = (row > 0) & (row < height) & (col > 0) & (col < width) & valid & (z > 0)
    flat = torch.where(inb, row * width + col, height * width)  # spill slot
    buf = torch.full((height * width + 1,), torch.inf, device=points.device)
    buf.scatter_reduce_(0, flat, torch.where(inb, z, torch.inf), reduce="amin")
    depth = buf[:-1].reshape(height, width)
    return torch.where(torch.isinf(depth), 0.0, depth)


def compact_mask_indices(
    mask: torch.Tensor,
    max_points: int,
    generator: torch.Generator | None = None,
    priority: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Indices of up to max_points True entries of mask, padded.

    With more valid entries than max_points a uniform random subset is kept:
    `priority` is the [M] uniform draw in [0, 1) that orders the valid
    entries (drawn from `generator` when not given). With neither, the first
    max_points in scan order are kept. Invalid entries sort last (priority
    2); ties keep the lower index first.

    Returns (idx [max_points] int64, out_mask [max_points] bool).
    """
    m = mask.shape[0]
    if priority is None and generator is not None:
        priority = torch.rand(m, generator=generator, device=mask.device)
    if priority is None:
        priority = torch.linspace(0.0, 1.0, m, device=mask.device)
    priority = torch.where(mask, priority.to(torch.float32), 2.0)
    idx = torch.sort(priority, stable=True).indices[:max_points]
    return idx, mask[idx]


def compact_masked_points(
    points: torch.Tensor,
    mask: torch.Tensor,
    max_points: int,
    generator: torch.Generator | None = None,
    priority: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Up to max_points masked points [M, 3] into a fixed buffer
    -> (out [max_points, 3], out_mask [max_points])."""
    idx, out_mask = compact_mask_indices(mask, max_points, generator, priority)
    out = torch.where(out_mask[:, None], points[idx], 0.0)
    return out, out_mask


def crop_segment(
    depth: torch.Tensor,
    obj_prob: torch.Tensor,
    intrinsics: torch.Tensor,
    max_points: int,
    generator: torch.Generator | None = None,
    depth_min: float = 0.1,
    depth_max: float = 2.0,
    prob_threshold: float = 0.0,
    priority: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """mask x depth -> fixed-size segment cloud + per-point probability
    (Segmentation::compute3dSegment's depth.mul(mask) step).

    Returns (points [max_points, 3], probs [max_points], mask [max_points]).
    """
    pts, valid = backproject(depth, intrinsics, depth_min, depth_max)
    sel = valid & (obj_prob > prob_threshold)
    flat_pts = pts.reshape(-1, 3)
    idx, out_mask = compact_mask_indices(sel.reshape(-1), max_points, generator, priority)
    out = torch.where(out_mask[:, None], flat_pts[idx], 0.0)
    probs = torch.where(out_mask, obj_prob.reshape(-1)[idx], 0.0)
    return out, probs, out_mask
