"""Batched depth rendering: point-splat z-min rasterization.

Reference: depth_sim renders each object's textured mesh through OpenGL FBOs
at 640x480 and clamps depth > 1 m to zero (renderScene.cpp:45-71); MCTS
states min-composite the newly added object's render over the parent state's
buffer (UCTState.cpp:62-68).

Here an object's dense surface cloud is transformed, projected
(pointcloud.project_zmin's pixel rule) and z-min scattered with a small
square splat footprint that closes holes. A batch of images is one scatter:
each image owns a slice of one flat buffer (its pixels plus a spill slot for
points that land outside), so every splat tap of every point of every image
goes through a single scatter_reduce(amin). A min does not depend on the
order of the updates, so the depth is exact.
"""

from __future__ import annotations

import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)


def splat_depth(
    points: torch.Tensor,  # [..., N, 3] camera-frame
    valid: torch.Tensor,  # [..., N] bool
    intrinsics: torch.Tensor,  # [3, 3], or [..., 3, 3] one per image
    height: int,
    width: int,
    radius: int = 1,
) -> torch.Tensor:
    """Project points and z-min scatter with a (2r+1)^2 splat -> [..., H, W]."""
    batch = points.shape[:-2]
    n = points.shape[-2]
    pts = points.reshape(-1, n, 3)
    b = pts.shape[0]
    px = pts @ intrinsics.reshape(-1, 3, 3).transpose(-1, -2)
    z = px[..., 2]
    safe_z = torch.where(z == 0, 1.0, z)
    col = torch.floor(px[..., 0] / safe_z + 0.5).to(torch.int64)
    row = torch.floor(px[..., 1] / safe_z + 0.5).to(torch.int64)
    ok = valid.reshape(b, n) & (z > 0)

    hw = height * width
    taps = torch.arange(-radius, radius + 1, device=points.device)
    dr = taps.repeat_interleave(len(taps))  # row offset of each tap, dr-major
    dc = taps.repeat(len(taps))
    r = row[:, None, :] + dr[None, :, None]  # [B, T, N]
    c = col[:, None, :] + dc[None, :, None]
    inb = ok[:, None, :] & (r >= 0) & (r < height) & (c >= 0) & (c < width)
    base = torch.arange(b, device=points.device)[:, None, None] * (hw + 1)
    flat = base + torch.where(inb, r * width + c, hw)
    buf = torch.full((b * (hw + 1),), torch.inf, device=points.device)
    src = torch.where(inb, z[:, None, :], torch.inf)
    buf.scatter_reduce_(0, flat.reshape(-1), src.reshape(-1), reduce="amin")
    depth = buf.reshape(b, hw + 1)[:, :hw].reshape(batch + (height, width))
    return torch.where(torch.isinf(depth), 0.0, depth)


def _clamp_far(depth: torch.Tensor, max_depth: float) -> torch.Tensor:
    """The reference's 1 m render cut (renderScene.cpp:70); 0 disables it."""
    return torch.where(depth > max_depth, 0.0, depth) if max_depth > 0 else depth


def render_object_depth(
    pose: torch.Tensor,  # [4, 4] camera-frame object pose
    model_pts: torch.Tensor,  # [N, 3]
    model_mask: torch.Tensor,  # [N] bool
    intrinsics: torch.Tensor,
    height: int,
    width: int,
    radius: int = 1,
    max_depth: float = 0.0,
) -> torch.Tensor:
    """Render one object at one pose -> [H, W]. max_depth > 0 clamps far
    depth to 0 like the reference's 1 m render clamp; 0 disables it."""
    pts = model_pts @ pose[:3, :3].T + pose[:3, 3]
    depth = splat_depth(pts, model_mask, intrinsics, height, width, radius)
    return _clamp_far(depth, max_depth)


def render_objects_batch(
    poses: torch.Tensor,  # [B, 4, 4]
    model_pts: torch.Tensor,  # [N, 3]
    model_mask: torch.Tensor,  # [N] bool
    intrinsics: torch.Tensor,
    height: int,
    width: int,
    radius: int = 1,
    max_depth: float = 0.0,
) -> torch.Tensor:
    """B poses of the same object, one scatter -> [B, H, W]."""
    pts = torch.einsum("bij,nj->bni", poses[:, :3, :3], model_pts) + poses[:, None, :3, 3]
    mask = model_mask.expand(poses.shape[0], -1)
    depth = splat_depth(pts, mask, intrinsics, height, width, radius)
    return _clamp_far(depth, max_depth)


def render_scene_depth(
    poses: torch.Tensor,  # [..., K, 4, 4] camera-frame object poses
    model_pts: torch.Tensor,  # [K, N, 3], or [..., K, N, 3] a scene each
    model_mask: torch.Tensor,  # [..., K, N] bool
    intrinsics: torch.Tensor,  # [3, 3], or [..., 3, 3] a scene each
    height: int,
    width: int,
    radius: int = 1,
    max_depth: float = 0.0,
) -> torch.Tensor:
    """Render all K objects of each scene in one scatter -> [..., H, W].

    Equal to composite_min over per-object render_object_depth calls
    (scatter-min is associative); a leading batch of scenes shares the same
    scatter, each with its own clouds and camera where those carry the
    batch (the multi-scene leaf batch)."""
    pts = (
        torch.einsum("...kij,...knj->...kni", poses[..., :3, :3], model_pts)
        + poses[..., :, None, :3, 3]
    )
    batch = pts.shape[:-3]
    k, n = model_pts.shape[-3:-1]
    mask = model_mask.expand(batch + (k, n))
    depth = splat_depth(
        pts.reshape(batch + (k * n, 3)), mask.reshape(batch + (k * n,)),
        intrinsics, height, width, radius,
    )
    return _clamp_far(depth, max_depth)


def composite_min(depth_a: torch.Tensor, depth_b: torch.Tensor) -> torch.Tensor:
    """Min-composite two depth maps where 0 means empty (UCTState.cpp:62-68)."""
    both = torch.minimum(depth_a, depth_b)
    return torch.where(depth_a == 0, depth_b, torch.where(depth_b == 0, depth_a, both))
