"""Base sampling - all bases drawn in parallel: StoCS and classic Super4PCS.

Reference semantics (SelectQuadrilateralStoCS, match4pcsBase.cc:600-792):
four sequential categorical draws over the segment points; after each draw
the per-point weight is multiplied by an "edge factor" - 1 iff the PPF of
(previous pick, candidate) exists in the model's PPF table, else 0. Draw 3
additionally gates on the inner angle at the base (>= 30 deg), draw 4 on
near-coplanarity and a 1 cm minimum spacing.

B bases are drawn at once: each draw is a Gumbel-argmax categorical over
[B, N] log-weights. Bases whose weight row collapses to zero are flagged
invalid rather than re-drawn. Two deliberate fixes over the reference, as in
the JAX package: the inner-angle gate normalizes before the angle test, and
coplanarity uses the true point-plane distance.

sample_bases_uniform is the probability-free base selection of classic
Super4PCS (the SUPER4PCS and V4PCS modes): four uniform picks per base,
gated on distinctness and a minimum pairwise spread.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)
from physimglobalpose_tpu_torch.ops import ppf as ppf_mod
from physimglobalpose_tpu_torch.ops import rigid_fit

NEG_INF = -1e30


class BaseSet(NamedTuple):
    indices: torch.Tensor  # [B, 4] int64 into the segment, TryQuadrilateral order
    invariant1: torch.Tensor  # [B]
    invariant2: torch.Tensor  # [B]
    valid: torch.Tensor  # [B] bool


def gumbel_noise(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """Standard Gumbel draws -log(-log(U))."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _categorical_rows(log_w: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """One categorical draw per row of [B, N] log-weights (Gumbel-argmax;
    gumbel holds [B, N] standard Gumbel draws). Ties take the first index,
    as jnp.argmax does."""
    return torch.argmax(log_w + gumbel, dim=-1)


def _unit(x: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(n, min=1e-12)


def sample_bases(
    seg_pts: torch.Tensor,
    seg_nrm: torch.Tensor,
    seg_prob: torch.Tensor,
    seg_mask: torch.Tensor,
    table: ppf_mod.PPFTable,
    num_bases: int,
    min_base_angle_deg: float = 30.0,
    coplanarity_threshold: float = 0.01,
    min_point_spacing: float = 0.01,
    generator: torch.Generator | None = None,
    gumbel: torch.Tensor | None = None,
) -> BaseSet:
    """Draw num_bases 4-point StoCS bases in parallel.

    Args:
      seg_pts/seg_nrm: [N, 3]; seg_prob/seg_mask: [N].
      table: model PPF table (edge factors).
      gumbel: optional injected [4, B, N] Gumbel noise, one slice per draw
        (drawn from `generator` when not given).
    """
    n = seg_pts.shape[0]
    b = num_bases
    dev = seg_pts.device
    if gumbel is None:
        gumbel = gumbel_noise((4, b, n), generator, dev)
    rows = torch.arange(b, device=dev)

    base_w = torch.where(seg_mask & (seg_prob > 0), seg_prob, 0.0)
    log0 = torch.where(base_w > 0, torch.log(torch.clamp(base_w, min=1e-30)), NEG_INF)

    def draw(i, logw):
        return _categorical_rows(logw, gumbel[i])

    def edge_log(prev_idx):
        """log edge factor [B, N]: 0 where PPF(prev, i) present, -inf else."""
        bins = ppf_mod.ppf_bins_torch(
            seg_pts[prev_idx][:, None, :], seg_nrm[prev_idx][:, None, :],
            seg_pts[None], seg_nrm[None],
            table.trans_disc, table.rot_disc, table.max_dist_mm,
        )
        return torch.where(ppf_mod.lookup_presence(table, bins), 0.0, NEG_INF)

    # Draw 1: plain probability-weighted.
    logw1 = log0[None].expand(b, n)
    b1 = draw(0, logw1)

    # Draw 2: edge-compatible with b1.
    logw2 = logw1 + edge_log(b1)
    logw2.scatter_(1, b1[:, None], NEG_INF)  # a scatter: no host copy of the value
    b2 = draw(1, logw2)

    # Draw 3: edge-compatible with b2, inner angle >= threshold.
    v1u = _unit(seg_pts[b2] - seg_pts[b1])  # [B, 3]
    v2u = _unit(seg_pts[None] - seg_pts[b1][:, None, :])  # [B, N, 3]
    cosang = torch.abs(torch.sum(v1u[:, None, :] * v2u, dim=-1))  # folded angle
    cos_min = torch.cos(torch.deg2rad(torch.tensor(min_base_angle_deg, dtype=torch.float32)))
    angle_ok = cosang <= cos_min  # a CPU scalar: no copy to the device
    logw3 = logw2 + edge_log(b2) + torch.where(angle_ok, 0.0, NEG_INF)
    logw3.scatter_(1, b2[:, None], NEG_INF)
    b3 = draw(2, logw3)

    # Draw 4: edge-compatible with b3, near-coplanar, min spacing.
    p1, p2, p3 = seg_pts[b1], seg_pts[b2], seg_pts[b3]
    nrm = torch.linalg.cross(p2 - p1, p3 - p1)  # [B, 3]
    nlen = torch.sqrt(torch.sum(nrm * nrm, dim=-1, keepdim=True))
    nrm_u = nrm / torch.clamp(nlen, min=1e-12)
    plane_ok_possible = nlen[..., 0] > 1e-9
    dist_plane = torch.abs(
        torch.sum((seg_pts[None] - p1[:, None, :]) * nrm_u[:, None, :], dim=-1)
    )  # [B, N]
    coplanar = (dist_plane <= coplanarity_threshold) | ~plane_ok_possible[:, None]

    def far_from(pk):
        diff = seg_pts[None] - pk[:, None, :]
        return torch.sqrt(torch.sum(diff * diff, dim=-1)) >= min_point_spacing

    spacing_ok = far_from(p1) & far_from(p2) & far_from(p3)
    logw4 = logw3 + edge_log(b3) + torch.where(coplanar & spacing_ok, 0.0, NEG_INF)
    logw4.scatter_(1, b3[:, None], NEG_INF)
    b4 = draw(3, logw4)

    # Validity: the chosen weight must be finite at every step.
    valid = (
        (logw1[rows, b1] > NEG_INF / 2)
        & (logw2[rows, b2] > NEG_INF / 2)
        & (logw3[rows, b3] > NEG_INF / 2)
        & (logw4[rows, b4] > NEG_INF / 2)
    )

    raw_idx = torch.stack([b1, b2, b3, b4], dim=-1)  # [B, 4]
    perm, inv1, inv2 = rigid_fit.try_quadrilateral(seg_pts[raw_idx])
    idx = torch.gather(raw_idx, -1, perm)
    return BaseSet(indices=idx, invariant1=inv1, invariant2=inv2, valid=valid)


def sample_bases_uniform(
    seg_pts: torch.Tensor,
    seg_mask: torch.Tensor,
    num_bases: int,
    min_spread: float = 0.01,
    generator: torch.Generator | None = None,
    gumbel: torch.Tensor | None = None,
) -> BaseSet:
    """Classic Super4PCS base selection: uniform random wide 4-point bases.

    The probability-free analogue of the reference's SelectQuadrilateral
    (match4pcsBase.cc:470-577): four independent uniform picks per base over
    the unmasked points, then distinctness and a minimum pairwise spread,
    reordered by TryQuadrilateral. Bases failing the gates are flagged
    invalid (callers oversample).

    gumbel: optional injected [4, B, N] Gumbel noise, one slice per pick.
    """
    n = seg_pts.shape[0]
    b = num_bases
    dev = seg_pts.device
    if gumbel is None:
        gumbel = gumbel_noise((4, b, n), generator, dev)
    logw = torch.where(seg_mask, 0.0, NEG_INF)[None].expand(b, n)
    raw_idx = torch.stack([_categorical_rows(logw, gumbel[i]) for i in range(4)], dim=-1)

    pts = seg_pts[raw_idx]  # [B, 4, 3]
    diff = pts[:, :, None, :] - pts[:, None, :, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1))  # [B, 4, 4]
    eye = torch.eye(4, dtype=torch.bool, device=dev)[None]
    spread_ok = ((dist >= min_spread) | eye).flatten(1).all(dim=1)
    same = raw_idx[:, :, None] == raw_idx[:, None, :]
    distinct = ~(same & ~eye).flatten(1).any(dim=1)
    picked_valid = seg_mask[raw_idx].all(dim=-1)
    valid = spread_ok & distinct & picked_valid

    perm, inv1, inv2 = rigid_fit.try_quadrilateral(pts)
    idx = torch.gather(raw_idx, -1, perm)
    return BaseSet(indices=idx, invariant1=inv1, invariant2=inv2, valid=valid)
