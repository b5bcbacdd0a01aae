"""MSAC plane fitting and table removal.

Reference: SceneCfg::removeTable (SceneCfg.cpp:38-82) fits the dominant plane
with PCL MSAC at a 5 mm threshold and zeroes every depth pixel within 5 mm of
it. All RANSAC trials are scored at once as one [N, iters] distance block,
then the best plane gets one least-squares refinement over its inliers. The
table frame for physics is then refined by ICP of a canonical table-top
cloud against the plane inliers (SceneCfg.cpp:87-157).
"""

from __future__ import annotations

import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)
from physimglobalpose_tpu_torch.ops import icp as icp_mod


def fit_plane_ransac(
    points: torch.Tensor,
    mask: torch.Tensor,
    generator: torch.Generator | None = None,
    threshold: float = 0.005,
    iters: int = 256,
    triplets: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """MSAC plane fit.

    Args:
      points: [N, 3]; mask: [N] bool.
      triplets: optional [iters, 3] point indices of the candidate planes
        (drawn from the valid points with `generator` when not given).
    Returns:
      plane [4] (unit normal n, offset d) with n.p + d = 0; inliers [N] bool.
    """
    if triplets is None:
        probs = mask.to(torch.float32)
        probs = probs + (probs.sum() == 0).to(torch.float32)  # no valid point: uniform
        triplets = torch.multinomial(
            probs, iters * 3, replacement=True, generator=generator
        ).reshape(iters, 3)
    tri = points[triplets]  # [iters, 3, 3]
    v1 = tri[:, 1] - tri[:, 0]
    v2 = tri[:, 2] - tri[:, 0]
    nrm = torch.linalg.cross(v1, v2)
    nrm_len = torch.linalg.norm(nrm, dim=-1, keepdim=True)
    nrm = nrm / torch.clamp(nrm_len, min=1e-12)
    d = -torch.sum(nrm * tri[:, 0], dim=-1)  # [iters]

    dist = torch.abs(points @ nrm.T + d[None, :])  # [N, iters]
    dist = torch.where(mask[:, None], dist, threshold)
    cost = torch.sum(torch.clamp(dist, max=threshold) ** 2, dim=0)
    cost = torch.where(nrm_len[:, 0] < 1e-9, torch.inf, cost)  # degenerate triples
    best = torch.argmin(cost)
    bn, bd = nrm[best], d[best]

    # Least-squares refinement over the consensus set.
    inl = mask & (torch.abs(points @ bn + bd) < threshold)
    w = inl.to(torch.float32)[:, None]
    cnt = torch.clamp(w.sum(), min=1.0)
    mean = torch.sum(points * w, dim=0) / cnt
    cent = (points - mean) * w
    cov = cent.T @ cent / cnt
    _, vecs = torch.linalg.eigh(cov)
    rn = vecs[:, 0]
    rn = rn * torch.where(torch.dot(rn, bn) < 0, -1.0, 1.0)
    rd = -torch.dot(rn, mean)
    inliers = mask & (torch.abs(points @ rn + rd) < threshold)
    return torch.cat([rn, rd[None]]), inliers


def remove_table_depth(
    depth: torch.Tensor,
    points: torch.Tensor,
    valid: torch.Tensor,
    plane: torch.Tensor,
    threshold: float = 0.005,
) -> torch.Tensor:
    """Zero depth pixels within threshold of the plane (SceneCfg.cpp:69-80)."""
    dist = torch.abs(torch.einsum("hwc,c->hw", points, plane[:3]) + plane[3])
    return torch.where(valid & (dist < threshold), 0.0, depth)


def table_pose_from_plane(plane: torch.Tensor, anchor: torch.Tensor) -> torch.Tensor:
    """A canonical SE(3) frame on the plane (z-axis = plane normal), with its
    origin at the anchor projected onto the plane."""
    z = plane[:3] / torch.linalg.norm(plane[:3])
    e_x = torch.tensor([1.0, 0.0, 0.0], device=plane.device)
    e_y = torch.tensor([0.0, 1.0, 0.0], device=plane.device)
    ref = torch.where(torch.abs(z[0]) < 0.9, e_x, e_y)
    x = torch.linalg.cross(ref, z)
    x = x / torch.linalg.norm(x)
    y = torch.linalg.cross(z, x)
    pose = torch.eye(4, device=plane.device)
    pose[:3, :3] = torch.stack([x, y, z], dim=-1)
    pose[:3, 3] = anchor - (torch.dot(z, anchor) + plane[3]) * z
    return pose


def canonical_table_cloud(
    half_extents: tuple[float, float, float], grid: int = 12, device=None
) -> torch.Tensor:
    """Top-face grid [grid^2, 3] of the table box in the surface frame (z = 0).

    The in-memory replacement for the reference's canonical `table.ply`
    (SceneCfg.cpp:109): a regular grid over the top face of the same
    0.8 x 0.8 m box the physics stage uses (PhySim.cpp:22-48).
    """
    hx, hy, _ = half_extents
    xs = torch.linspace(-hx, hx, grid, device=device)
    ys = torch.linspace(-hy, hy, grid, device=device)
    gx, gy = torch.meshgrid(xs, ys, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), torch.zeros_like(gx).reshape(-1)], dim=-1)


def refine_table_pose(
    table_pose: torch.Tensor,  # [4, 4] initial surface frame (z = plane normal)
    scene_pts: torch.Tensor,  # [N, 3] scene points (same frame as table_pose)
    scene_mask: torch.Tensor,  # [N] bool
    plane4: torch.Tensor,  # [4] fitted plane
    half_extents: tuple[float, float, float],
    threshold: float = 0.005,
    iters: int = 50,
    max_corr_dist: float = 0.01,
) -> torch.Tensor:
    """getTableParams parity (SceneCfg.cpp:87-157): refine the table frame by
    point-to-point ICP of the canonical table-top cloud against the plane
    inliers (50 iterations, 1 cm correspondence cap in the reference). A
    planar model constrains tilt and height, what the settle depends on."""
    return refine_table_poses([(table_pose, scene_pts, scene_mask, plane4)], half_extents,
                              threshold, iters, max_corr_dist)[0]


def refine_table_poses(tables, half_extents: tuple[float, float, float],
                       threshold: float = 0.005, iters: int = 50,
                       max_corr_dist: float = 0.01) -> list:
    """refine_table_pose of several tables, (table_pose, scene_pts,
    scene_mask, plane4) each, their ICPs together (ops/icp.refine_icp_each):
    each table's answer is the one it gets alone."""
    cloud = canonical_table_cloud(half_extents, device=tables[0][1].device)
    jobs = []
    for table_pose, scene_pts, scene_mask, plane4 in tables:
        dist = torch.abs(scene_pts @ plane4[:3] + plane4[3])
        inl = scene_mask & (dist < threshold)
        jobs.append((table_pose[None], cloud, torch.zeros_like(cloud), scene_pts, inl))
    refined = icp_mod.refine_icp_each(jobs, iters=iters, trim_fraction=0.8,
                                      max_corr_dist=max_corr_dist, point_to_plane=False)
    return [r[0] for r in refined]
