"""Batched fixed-iteration ICP: point-to-plane and point-to-point.

Reference: PCL TrimmedICP / point-to-point / point-to-plane refiners run one
pose at a time (utilities.cpp:651-739). Here H hypotheses refine together;
each iteration is one nearest-neighbour block + one closed-form update, with
a fixed iteration count and masked correspondences.

Correspondences run segment -> transformed model (every observed point has a
true correspondence on the model under partial occlusion). Outliers are
down-weighted by a Welsch kernel (default) or exactly trimmed to the best
trim_fraction of in-range matches. Hypotheses run in chunks of h_chunk, so
the [h_chunk, Ns, Nm] distance block is the largest tensor built.
"""

from __future__ import annotations

import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)


def _trim_weights(mind2, seg_mask, trim_fraction, max_corr_dist):
    """Weight 1 for the best trim_fraction of in-range correspondences. [B, Ns]."""
    ns = mind2.shape[-1]
    in_range = seg_mask & (mind2 <= max_corr_dist * max_corr_dist)
    n_valid = torch.sum(in_range, dim=-1)
    n_keep = torch.clamp((n_valid * trim_fraction).to(torch.int64), min=3)
    d_sorted = torch.sort(torch.where(in_range, mind2, torch.inf), dim=-1).values
    kth = torch.gather(d_sorted, -1, torch.clamp(n_keep - 1, 0, ns - 1)[:, None])
    return (in_range & (mind2 <= kth)).to(torch.float32)


def _robust_weights(mind2, seg_mask, max_corr_dist):
    """Welsch kernel at scale max_corr_dist/2, zero beyond max_corr_dist."""
    sigma2 = (max_corr_dist * 0.5) ** 2
    in_range = seg_mask & (mind2 <= max_corr_dist * max_corr_dist)
    return torch.where(in_range, torch.exp(-mind2 / (2.0 * sigma2)), 0.0)


def _skew(k: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(k[..., 0])
    return torch.stack(
        [
            torch.stack([z, -k[..., 2], k[..., 1]], dim=-1),
            torch.stack([k[..., 2], z, -k[..., 0]], dim=-1),
            torch.stack([-k[..., 1], k[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def _solve_point_to_point(p, q, w):
    """Weighted Kabsch per batch row: (R, t) minimizing sum w |R p + t - q|^2.

    p, q: [B, N, 3]; w: [B, N]. Returns rot [B, 3, 3], t [B, 3].
    """
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-6)
    pc = torch.sum(p * w[..., None], dim=-2) / wsum
    qc = torch.sum(q * w[..., None], dim=-2) / wsum
    x = (p - pc[:, None]) * w[..., None]
    y = q - qc[:, None]
    h = x.transpose(-1, -2) @ y  # [B, 3, 3]
    u, _, vt = torch.linalg.svd(h)
    v = vt.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(v @ u.transpose(-1, -2)))
    diag = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    rot = v @ diag @ u.transpose(-1, -2)
    t = qc - torch.einsum("bij,bj->bi", rot, pc)
    return rot, t


def _solve_point_to_plane(p, q, n, w):
    """Linearized point-to-plane per batch row: minimize
    sum w ((p + omega x p + t - q).n)^2, omega -> rotation by Rodrigues."""
    r = torch.sum((p - q) * n, dim=-1)  # [B, N]
    c = torch.linalg.cross(p, n)  # [B, N, 3]
    jac = torch.cat([c, n], dim=-1)  # [B, N, 6]
    jw = jac * w[..., None]
    a = jw.transpose(-1, -2) @ jac + 1e-8 * torch.eye(6, device=p.device)
    b = -(jw.transpose(-1, -2) @ r[..., None])
    x = torch.linalg.solve_ex(a, b).result[..., 0]  # no host sync; NaN rows fall back
    omega, t = x[..., :3], x[..., 3:]
    theta = torch.linalg.norm(omega, dim=-1)
    kx = _skew(omega / torch.clamp(theta, min=1e-12)[..., None])
    eye = torch.eye(3, device=p.device)
    rot = (
        eye
        + torch.sin(theta)[..., None, None] * kx
        + (1.0 - torch.cos(theta))[..., None, None] * (kx @ kx)
    )
    return rot, t


def _icp_chunk(tf, model_pts, model_nrm, seg_pts, seg_mask, iters, trim_fraction,
               max_corr_dist, point_to_plane, exact_trim, nn_refresh):
    """Refine tf [B, 4, 4] (nn_refresh > 1 reuses correspondences for that
    many solves, re-solving against the model-frame matches in between)."""
    seg_sq = torch.sum(seg_pts * seg_pts, dim=-1)

    def correspond(tf):
        rot, t = tf[:, :3, :3], tf[:, :3, 3]
        tm = model_pts @ rot.transpose(-1, -2) + t[:, None, :]  # [B, Nm, 3]
        d2 = (
            seg_sq[None, :, None]
            + torch.sum(tm * tm, dim=-1)[:, None, :]
            - 2.0 * (seg_pts @ tm.transpose(-1, -2))
        )  # [B, Ns, Nm]
        mind2 = torch.amin(d2, dim=-1)
        # Matched point/normal as a row-normalized argmin one-hot (ties averaged).
        onehot = (d2 <= mind2[..., None]).to(torch.float32)
        onehot = onehot / torch.clamp(torch.sum(onehot, dim=-1, keepdim=True), min=1.0)
        p_model = onehot @ model_pts  # [B, Ns, 3] in the MODEL frame
        n_model = onehot @ model_nrm
        mind2 = torch.where(seg_mask, mind2, torch.inf)
        if exact_trim:
            w = _trim_weights(mind2, seg_mask, trim_fraction, max_corr_dist)
        else:
            w = _robust_weights(mind2, seg_mask, max_corr_dist)
        return p_model, n_model, w

    def solve(tf, p_model, n_model, w):
        rot, t = tf[:, :3, :3], tf[:, :3, 3]
        p = p_model @ rot.transpose(-1, -2) + t[:, None, :]
        seg_b = seg_pts.expand(p.shape[0], -1, -1)
        if point_to_plane:
            drot, dt = _solve_point_to_plane(p, seg_b, n_model @ rot.transpose(-1, -2), w)
        else:
            drot, dt = _solve_point_to_point(p, seg_b, w)
        out = torch.zeros_like(tf)
        out[:, :3, :3] = drot @ rot
        out[:, :3, 3] = torch.einsum("bij,bj->bi", drot, t) + dt
        out[:, 3, 3] = 1.0
        return out

    done = 0
    while done < iters:
        corr = correspond(tf)
        for _ in range(min(max(nn_refresh, 1), iters - done)):
            tf = solve(tf, *corr)
            done += 1
    return tf


def refine_icp(
    transforms: torch.Tensor,  # [H, 4, 4]
    model_pts: torch.Tensor,  # [Nm, 3]
    model_nrm: torch.Tensor,  # [Nm, 3]
    seg_pts: torch.Tensor,  # [Ns, 3]
    seg_mask: torch.Tensor,  # [Ns]
    iters: int = 20,
    trim_fraction: float = 0.8,
    max_corr_dist: float = 0.02,
    point_to_plane: bool = True,
    h_chunk: int = 64,
    exact_trim: bool = False,
    nn_refresh: int = 1,
) -> torch.Tensor:
    """Refine H poses; returns [H, 4, 4]. A hypothesis whose refinement goes
    non-finite (too few correspondences) keeps its input pose."""
    out = []
    for tf in transforms.split(h_chunk):
        ref = _icp_chunk(
            tf, model_pts, model_nrm, seg_pts, seg_mask, iters, trim_fraction,
            max_corr_dist, point_to_plane, exact_trim, nn_refresh,
        )
        ok = torch.all(torch.isfinite(ref).reshape(ref.shape[0], -1), dim=-1)
        out.append(torch.where(ok[:, None, None], ref, tf))
    return torch.cat(out)
