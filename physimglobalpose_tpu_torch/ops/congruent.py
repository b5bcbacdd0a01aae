"""Congruent-set extraction (StoCS) and batched hypothesis construction.

Reference semantics (ExtractCongruentSet, match4pcsBase.cc:1929-2039 StoCS
branch): the two base segments are discretized to PPF bins; the model's
pair lists for those bins are the candidate pair sets. A (pair1, pair2)
combination is congruent when the invariant points e1 = q_i + inv1 (q_j - q_i)
and e2 = q_k + inv2 (q_l - q_k) coincide within the distance threshold and
the pair directions subtend the base's angle. At most 100 congruent quads
per base are kept (random subsample); each yields a rigid transform from the
first three point correspondences.

For B bases at once the pair lists are CSR gathers ([B, K, 2] + masks), the
K x K compatibility test is one [B, K, K] comparison, and a per-base random
priority order keeps <= Q quads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)
from physimglobalpose_tpu_torch.ops import ppf as ppf_mod
from physimglobalpose_tpu_torch.ops import rigid_fit
from physimglobalpose_tpu_torch.ops.sampling import BaseSet


class HypothesisSet(NamedTuple):
    transforms: torch.Tensor  # [H, 4, 4] model->camera poses
    valid: torch.Tensor  # [H] bool
    base_id: torch.Tensor  # [H] int64 - which base produced it


def _unit(x: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(n, min=1e-12)


def extract_congruent_quads(
    bases: BaseSet,
    seg_pts: torch.Tensor,
    seg_nrm: torch.Tensor,
    model_pts: torch.Tensor,
    table: ppf_mod.PPFTable,
    max_pairs: int = 256,
    max_quads_per_base: int = 100,
    dist_threshold: float = 0.01,
    angle_cos_eps: float = 0.15,
    generator: torch.Generator | None = None,
    priority: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Find congruent model quads for every base.

    priority: optional injected [B, K*K] uniform draw that orders each base's
    congruent combinations (drawn from `generator` when not given).
    Returns quads [B, Q, 4] int64 model indices (i, j, k, l), valid [B, Q].
    """
    b = bases.indices.shape[0]
    q = max_quads_per_base
    i1, i2, i3, i4 = (bases.indices[:, k] for k in range(4))
    p1, p2, p3, p4 = (seg_pts[i] for i in (i1, i2, i3, i4))
    n1, n2, n3, n4 = (seg_nrm[i] for i in (i1, i2, i3, i4))

    bins1 = ppf_mod.ppf_bins_torch(p1, n1, p2, n2, table.trans_disc, table.rot_disc, table.max_dist_mm)
    bins2 = ppf_mod.ppf_bins_torch(p3, n3, p4, n4, table.trans_disc, table.rot_disc, table.max_dist_mm)
    pairs1, m1 = ppf_mod.gather_pairs(table, bins1, max_pairs)  # [B, K, 2], [B, K]
    pairs2, m2 = ppf_mod.gather_pairs(table, bins2, max_pairs)
    pairs1, pairs2 = pairs1.long(), pairs2.long()

    # Invariant points and pair directions in model coordinates.
    qa = model_pts[pairs1[..., 0]]  # [B, K, 3]
    qb = model_pts[pairs1[..., 1]]
    qc = model_pts[pairs2[..., 0]]
    qd = model_pts[pairs2[..., 1]]
    e1 = qa + bases.invariant1[:, None, None] * (qb - qa)
    e2 = qc + bases.invariant2[:, None, None] * (qd - qc)
    d1 = _unit(qb - qa)
    d2 = _unit(qd - qc)
    alpha = torch.sum(_unit(p2 - p1) * _unit(p4 - p3), dim=-1)  # [B] base angle cosine

    # [B, K, K] compatibility.
    dist2 = torch.sum((e1[:, :, None, :] - e2[:, None, :, :]) ** 2, dim=-1)
    dir_cos = torch.einsum("bkc,bmc->bkm", d1, d2)
    ok = (
        (dist2 <= dist_threshold * dist_threshold)
        & (torch.abs(dir_cos - alpha[:, None, None]) <= angle_cos_eps)
        & m1[:, :, None]
        & m2[:, None, :]
        & bases.valid[:, None, None]
    )

    # Random subsample of <= Q per base; ties (the invalid sentinel) keep the
    # lower index first.
    flat_ok = ok.reshape(b, -1)
    if priority is None:
        priority = torch.rand(flat_ok.shape, generator=generator, device=flat_ok.device)
    priority = torch.where(flat_ok, priority.to(torch.float32), 2.0)
    sel = torch.sort(priority, dim=1, stable=True).indices[:, :q]  # [B, Q] into K*K
    valid = torch.gather(flat_ok, 1, sel)
    k1_idx = sel // max_pairs
    k2_idx = sel % max_pairs
    qi = torch.gather(pairs1[..., 0], 1, k1_idx)
    qj = torch.gather(pairs1[..., 1], 1, k1_idx)
    qk = torch.gather(pairs2[..., 0], 1, k2_idx)
    ql = torch.gather(pairs2[..., 1], 1, k2_idx)
    return torch.stack([qi, qj, qk, ql], dim=-1), valid


def hypotheses_from_quads(
    bases: BaseSet,
    quads: torch.Tensor,
    quads_valid: torch.Tensor,
    seg_pts: torch.Tensor,
    model_pts: torch.Tensor,
) -> HypothesisSet:
    """Rigid transforms for all (base, quad) combinations, flattened; the fit
    uses base points b1,b2,b3 <- model points i,j,k (match4pcsBase.cc:1521-1523)."""
    b, q = quads.shape[:2]
    base_tri = seg_pts[bases.indices[:, :3]]  # [B, 3, 3]
    base_tri = base_tri[:, None].expand(b, q, 3, 3).reshape(-1, 3, 3)
    quad_tri = model_pts[quads[..., :3]].reshape(-1, 3, 3)  # [B*Q, 3, 3]
    tf, rms, ok = rigid_fit.rigid_fit_3pt(base_tri, quad_tri)
    valid = quads_valid.reshape(-1) & ok & (rms >= 0.0)
    base_id = torch.arange(b, device=quads.device)[:, None].expand(b, q).reshape(-1)
    return HypothesisSet(transforms=tf, valid=valid, base_id=base_id)
