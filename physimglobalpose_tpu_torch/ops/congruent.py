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

The classic Super4PCS path (operMode 0, the SUPER4PCS mode) takes its pair
lists from geometric distance matching instead of the PPF table
(extract_pairs_by_distance, extract_congruent_quads_classic); V4PCS
(operMode 2) matches all six pairwise base distances
(extract_congruent_quads_tetra). Every random order is a uniform priority
that can be injected; invalid entries get priority 2.0, and ties keep index
order, as JAX's top_k(-priority) does.
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

    return _select_quads(ok, pairs1, pairs2, q, generator, priority)


def _first_by_priority(ok: torch.Tensor, count: int, generator, priority) -> torch.Tensor:
    """Indices [..., count] of the `count` lowest uniform priorities among the
    True entries of ok [..., M], then the False ones (priority 2.0), tied
    priorities in index order, as top_k(-priority) orders them.
    priority: the optional injected [..., M] uniform draw.

    The priorities are non-negative floats, whose bits order as they do, so
    (bits << 32 | index) is a distinct int64 key per entry: a top-k
    selection over it gives the stable order without sorting all M."""
    if priority is None:
        priority = torch.rand(ok.shape, generator=generator, device=ok.device)
    priority = torch.where(ok, priority.to(torch.float32), 2.0)
    index = torch.arange(ok.shape[-1], device=ok.device)
    key = (priority.view(torch.int32).to(torch.int64) << 32) | index
    return torch.topk(key, count, dim=-1, largest=False, sorted=True).indices


def _select_quads(ok, pairs1, pairs2, q, generator, priority):
    """Random subsample of <= q congruent (pair1, pair2) combinations per base
    from the [B, K, K] compatibility ok. Returns quads [B, q, 4], valid [B, q]."""
    b, k = ok.shape[:2]
    flat_ok = ok.reshape(b, -1)
    sel = _first_by_priority(flat_ok, q, generator, priority)  # [B, Q] into K*K
    valid = torch.gather(flat_ok, 1, sel)
    k1_idx = sel // k
    k2_idx = sel % k
    qi = torch.gather(pairs1[..., 0], 1, k1_idx)
    qj = torch.gather(pairs1[..., 1], 1, k1_idx)
    qk = torch.gather(pairs2[..., 0], 1, k2_idx)
    ql = torch.gather(pairs2[..., 1], 1, k2_idx)
    return torch.stack([qi, qj, qk, ql], dim=-1), valid


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.sqrt(torch.sum(d * d, dim=-1))


def extract_pairs_by_distance(
    model_pts: torch.Tensor,
    model_mask: torch.Tensor,
    dist: torch.Tensor,
    eps: float,
    max_pairs: int,
    generator: torch.Generator | None = None,
    priority: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Geometric pair extraction for classic Super4PCS mode.

    All directed model pairs whose length matches `dist` within eps (the
    brute-force semantics of ExtractPairs, 4pcs.cc:109-193), a random
    <= max_pairs of them. dist is a scalar or batched [B]; priority the
    optional injected uniform draw [B?, Nm*Nm]. Returns ([B?, max_pairs, 2]
    int64 model indices, [B?, max_pairs] mask).
    """
    n = model_pts.shape[0]
    d = _dist(model_pts[:, None, :], model_pts[None, :, :])  # [N, N]
    eye = torch.eye(n, dtype=torch.bool, device=model_pts.device)
    valid2 = model_mask[:, None] & model_mask[None, :] & ~eye
    ok = valid2 & (torch.abs(d - dist[..., None, None]) <= eps)  # [B?, N, N]
    flat_ok = ok.reshape(*dist.shape, n * n)
    sel = _first_by_priority(flat_ok, max_pairs, generator, priority)
    mask = torch.gather(flat_ok, -1, sel)
    return torch.stack([sel // n, sel % n], dim=-1), mask


def _pair_lists_by_distance(model_pts, model_mask, d12, d34, dist_threshold, max_pairs,
                            generator, pair_priority):
    """The two pair lists of a classic or tetra extraction: model pairs at the
    base's first and second segment lengths. pair_priority: optional
    injected [2, B, Nm*Nm]."""
    pp = (None, None) if pair_priority is None else pair_priority
    pairs1, m1 = extract_pairs_by_distance(model_pts, model_mask, d12, dist_threshold, max_pairs,
                                           generator, pp[0])
    pairs2, m2 = extract_pairs_by_distance(model_pts, model_mask, d34, dist_threshold, max_pairs,
                                           generator, pp[1])
    return pairs1, m1, pairs2, m2


def extract_congruent_quads_classic(
    bases: BaseSet,
    seg_pts: torch.Tensor,
    model_pts: torch.Tensor,
    model_mask: torch.Tensor,
    max_pairs: int = 256,
    max_quads_per_base: int = 100,
    dist_threshold: float = 0.01,
    angle_cos_eps: float = 0.15,
    generator: torch.Generator | None = None,
    pair_priority: torch.Tensor | None = None,
    priority: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Congruent-quad extraction with distance-extracted pair lists.

    The classic Super4PCS path (operMode 0): pair sets come from geometric
    distance matching instead of the PPF table (ExtractCongruentSet non-StoCS
    branch, match4pcsBase.cc:1953-1960); the invariant-point matching is the
    StoCS path's. pair_priority [2, B, Nm*Nm] and priority [B, K*K] are the
    optional injected draws of the two pair lists and the selection.
    """
    i1, i2, i3, i4 = (bases.indices[:, k] for k in range(4))
    p1, p2, p3, p4 = (seg_pts[i] for i in (i1, i2, i3, i4))
    pairs1, m1, pairs2, m2 = _pair_lists_by_distance(
        model_pts, model_mask, _dist(p2, p1), _dist(p4, p3), dist_threshold, max_pairs,
        generator, pair_priority,
    )
    qa = model_pts[pairs1[..., 0]]
    qb = model_pts[pairs1[..., 1]]
    qc = model_pts[pairs2[..., 0]]
    qd = model_pts[pairs2[..., 1]]
    e1 = qa + bases.invariant1[:, None, None] * (qb - qa)
    e2 = qc + bases.invariant2[:, None, None] * (qd - qc)
    alpha = torch.sum(_unit(p2 - p1) * _unit(p4 - p3), dim=-1)

    dist2 = torch.sum((e1[:, :, None, :] - e2[:, None, :, :]) ** 2, dim=-1)
    dir_cos = torch.einsum("bkc,bmc->bkm", _unit(qb - qa), _unit(qd - qc))
    ok = (
        (dist2 <= dist_threshold * dist_threshold)
        & (torch.abs(dir_cos - alpha[:, None, None]) <= angle_cos_eps)
        & m1[:, :, None]
        & m2[:, None, :]
        & bases.valid[:, None, None]
    )
    return _select_quads(ok, pairs1, pairs2, max_quads_per_base, generator, priority)


def extract_congruent_quads_tetra(
    bases: BaseSet,
    seg_pts: torch.Tensor,
    model_pts: torch.Tensor,
    model_mask: torch.Tensor,
    max_pairs: int = 256,
    max_quads_per_base: int = 100,
    dist_threshold: float = 0.01,
    generator: torch.Generator | None = None,
    pair_priority: torch.Tensor | None = None,
    priority: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """V4PCS tetrahedron congruence (operMode 2): all six pairwise base
    distances must match (FindCongruentQuadrilateralsV4PCS,
    match4pcsBase.cc:978-1044, inactive in the reference). Pair list 1
    supplies (v1, v2) at the base distance d12, pair list 2 (v3, v4) at d34,
    and a combination is congruent when the four cross distances (d13, d14,
    d23, d24) also match within the threshold: one [B, K, K] test. The
    injected draws are as in extract_congruent_quads_classic.
    """
    i1, i2, i3, i4 = (bases.indices[:, k] for k in range(4))
    p1, p2, p3, p4 = (seg_pts[i] for i in (i1, i2, i3, i4))
    pairs1, m1, pairs2, m2 = _pair_lists_by_distance(
        model_pts, model_mask, _dist(p2, p1), _dist(p4, p3), dist_threshold, max_pairs,
        generator, pair_priority,
    )
    qa = model_pts[pairs1[..., 0]]  # [B, K, 3] candidate v1
    qb = model_pts[pairs1[..., 1]]  # candidate v2
    qc = model_pts[pairs2[..., 0]]  # candidate v3
    qd = model_pts[pairs2[..., 1]]  # candidate v4

    def cross(a_pts, b_pts, dist):
        dd = _dist(a_pts[:, :, None, :], b_pts[:, None, :, :])  # [B, K, K]
        return torch.abs(dd - dist[:, None, None]) <= dist_threshold

    ok = (
        cross(qa, qc, _dist(p3, p1))
        & cross(qa, qd, _dist(p4, p1))
        & cross(qb, qc, _dist(p3, p2))
        & cross(qb, qd, _dist(p4, p2))
        & m1[:, :, None]
        & m2[:, None, :]
        & bases.valid[:, None, None]
    )
    return _select_quads(ok, pairs1, pairs2, max_quads_per_base, generator, priority)


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
