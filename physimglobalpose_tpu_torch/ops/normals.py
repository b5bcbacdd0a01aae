"""k-NN PCA normal estimation with viewpoint orientation, and radius
outlier removal.

Replaces the reference's MLS normals with k-nearest-neighbour covariance PCA;
normals are flipped toward the viewpoint (camera origin) as
flipNormalTowardsViewpoint does (ObjectPoseCandidateSet.cpp:41-51).
"""

from __future__ import annotations

import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N,3] x [M,3] -> [N,M] squared distances (matmul expansion)."""
    a2 = torch.sum(a * a, dim=-1)
    b2 = torch.sum(b * b, dim=-1)
    cross = a @ b.T
    return torch.clamp(a2[:, None] + b2[None, :] - 2.0 * cross, min=0.0)


def knn_normals(
    points: torch.Tensor,
    mask: torch.Tensor,
    k: int = 16,
    viewpoint: torch.Tensor | None = None,
) -> torch.Tensor:
    """PCA normals from the k nearest valid neighbours.

    Args:
      points: [N, 3]; mask: [N] bool; viewpoint: [3] (default origin).
    Returns:
      normals [N, 3], unit, oriented toward the viewpoint; zero for invalid.
    """
    big = 1e9
    d2 = torch.where(mask[None, :], pairwise_sq_dists(points, points), big)
    # k nearest, exact distance ties in index order (a stable sort).
    near_d, idx = torch.sort(d2, dim=-1, stable=True)
    near_d, idx = near_d[:, :k], idx[:, :k]
    neigh = points[idx]  # [N, k, 3]
    w = (near_d < big * 0.5).to(points.dtype)  # [N, k] valid-neighbour weights
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    mean = torch.sum(neigh * w[..., None], dim=-2) / wsum
    cent = (neigh - mean[:, None, :]) * w[..., None]
    cov = torch.einsum("nki,nkj->nij", cent, cent) / wsum[..., None]
    # Smallest-eigenvalue eigenvector (ascending order -> first column).
    _, eigvecs = torch.linalg.eigh(cov)
    normal = eigvecs[..., 0]
    vp = torch.zeros(3, dtype=points.dtype, device=points.device) if viewpoint is None else viewpoint
    to_vp = vp[None, :] - points
    sign = torch.where(torch.sum(normal * to_vp, dim=-1, keepdim=True) < 0, -1.0, 1.0)
    normal = normal * sign
    normal = normal / torch.clamp(torch.linalg.norm(normal, dim=-1, keepdim=True), min=1e-12)
    return torch.where(mask[:, None], normal, 0.0)


def radius_outlier_mask(
    points: torch.Tensor, mask: torch.Tensor, radius: float, min_neighbors: int
) -> torch.Tensor:
    """A point survives with >= min_neighbors valid neighbours (itself
    excluded) within radius (ObjectPoseCandidateSet.cpp:28-33)."""
    d2 = pairwise_sq_dists(points, points)
    within = (d2 <= radius * radius) & mask[None, :]
    counts = torch.sum(within, dim=-1) - mask.to(torch.int64)
    return mask & (counts >= min_neighbors)
