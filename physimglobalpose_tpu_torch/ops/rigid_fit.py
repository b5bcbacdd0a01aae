"""Batched base reordering (invariants) and 3-point rigid transform fit.

Reference semantics:
- distSegmentToSegment + TryQuadrilateral (match4pcsBase.cc:76-148, 415-465):
  among the 12 ordered splits of 4 base points into two segments, pick the
  split whose segments pass closest to each other; the parametric coordinates
  of the closest points are the affine invariants (invariant1, invariant2).
- ComputeRigidTransformation (match4pcsBase.cc:1504-1614): align the
  orthonormal frames built by Gram-Schmidt from the first 3 point pairs;
  R = Rp^T Rq; reject non-orthogonal solutions.

All functions take a leading batch dimension.
"""

from __future__ import annotations

import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)

_K_SMALL = 1e-4  # kSmallNumber in distSegmentToSegment (match4pcsBase.cc:87)


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=keepdim))


def seg_seg_invariants(p1, p2, q1, q2):
    """Closest approach of segments (p1,p2), (q1,q2) -> (dist, inv1, inv2).

    The branchy reference routine in torch.where form. Inputs [..., 3].
    """
    u = p2 - p1
    v = q2 - q1
    w = p1 - q1
    a = torch.sum(u * u, dim=-1)
    b = torch.sum(u * v, dim=-1)
    c = torch.sum(v * v, dim=-1)
    d = torch.sum(u * w, dim=-1)
    e = torch.sum(v * w, dim=-1)
    f = a * c - b * b
    zero = torch.zeros_like(f)

    small = f < _K_SMALL

    # Non-parallel branch.
    s1_np = b * e - c * d
    t1_np = a * e - b * d
    s2_np = f
    t2_np = f
    neg = s1_np < 0.0
    over = s1_np > s2_np
    s1_1 = torch.where(neg, zero, torch.where(over, s2_np, s1_np))
    t1_1 = torch.where(neg, e, torch.where(over, e + b, t1_np))
    t2_1 = torch.where(neg | over, c, t2_np)

    # Parallel branch.
    s1 = torch.where(small, zero, s1_1)
    s2 = torch.where(small, torch.ones_like(f), s2_np)
    t1 = torch.where(small, e, t1_1)
    t2 = torch.where(small, c, t2_1)

    # t clamping (both branches).
    tneg = t1 < 0.0
    tover = t1 > t2
    s1_tn = torch.where(-d < 0.0, zero, torch.where(-d > a, s2, -d))
    s2_tn = torch.where(-d < 0.0, s2, torch.where(-d > a, s2, a))
    db = -d + b
    s1_to = torch.where(db < 0.0, zero, torch.where(db > a, s2, db))
    s2_to = torch.where(db < 0.0, s2, torch.where(db > a, s2, a))

    s1 = torch.where(tneg, s1_tn, torch.where(tover, s1_to, s1))
    s2 = torch.where(tneg, s2_tn, torch.where(tover, s2_to, s2))
    t1 = torch.where(tneg, zero, torch.where(tover, t2, t1))

    inv1 = torch.where(torch.abs(s1) < _K_SMALL, zero, s1 / s2)
    inv2 = torch.where(torch.abs(t1) < _K_SMALL, zero, t1 / t2)
    dist = _norm(w + inv1[..., None] * u - inv2[..., None] * v)
    return dist, inv1, inv2


# The 12 ordered splits tried by TryQuadrilateral's nested loops
# (i, j distinct; k = first index not in {i,j}; l = the remaining one).
_SPLITS = []
for _i in range(4):
    for _j in range(4):
        if _i == _j:
            continue
        _k = next(x for x in range(4) if x not in (_i, _j))
        _l = next(x for x in range(4) if x not in (_i, _j, _k))
        _SPLITS.append((_i, _j, _k, _l))
_SPLITS = tuple(_SPLITS)
_SPLITS_ON: dict = {}  # the table on each device, uploaded once


def _splits_on(device: torch.device) -> torch.Tensor:
    if device not in _SPLITS_ON:
        _SPLITS_ON[device] = torch.tensor(_SPLITS, dtype=torch.int64, device=device)
    return _SPLITS_ON[device]


def try_quadrilateral(base_pts: torch.Tensor):
    """Reorder 4-point bases [..., 4, 3] for minimum segment crossing distance.

    Returns (perm [..., 4] int64, invariant1 [...], invariant2 [...]).
    """
    splits = _splits_on(base_pts.device)  # [12, 4]
    p = base_pts[..., splits, :]  # [..., 12, 4, 3]
    dist, inv1, inv2 = seg_seg_invariants(
        p[..., 0, :], p[..., 1, :], p[..., 2, :], p[..., 3, :]
    )
    best = torch.argmin(dist, dim=-1)  # [...]
    take = lambda x: torch.gather(x, -1, best[..., None])[..., 0]
    return splits[best], take(inv1), take(inv2)


def rigid_fit_3pt(p: torch.Tensor, q: torch.Tensor):
    """Rigid transform aligning point triple q -> p.

    Args:
      p: [..., 3, 3] target points (scene base triple).
      q: [..., 3, 3] source points (model congruent triple).
    Returns:
      (transform [..., 4, 4], rms [...], ok [...] bool).
    """
    eps = 1e-6
    p0, p1, p2 = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    q0, q1, q2 = q[..., 0, :], q[..., 1, :], q[..., 2, :]

    def frame(a0, a1, a2):
        v1 = a1 - a0
        n1 = _norm(v1, keepdim=True)
        ok1 = n1[..., 0] > eps
        v1 = v1 / torch.clamp(n1, min=eps)
        v2 = (a2 - a0) - torch.sum((a2 - a0) * v1, dim=-1, keepdim=True) * v1
        n2 = _norm(v2, keepdim=True)
        ok2 = n2[..., 0] > eps
        v2 = v2 / torch.clamp(n2, min=eps)
        v3 = torch.linalg.cross(v1, v2)
        return torch.stack([v1, v2, v3], dim=-2), ok1 & ok2  # rows

    rp, okp = frame(p0, p1, p2)
    rq, okq = frame(q0, q1, q2)
    rot = torch.einsum("...ji,...jk->...ik", rp, rq)  # rp^T @ rq

    # Orthogonality check (match4pcsBase.cc:1564-1566).
    rr = torch.einsum("...ij,...jk->...ik", rot, rot)
    diag = torch.diagonal(rr, dim1=-2, dim2=-1)
    ortho_ok = torch.all(diag - 1.0 <= 1e-5, dim=-1)

    cen_p = (p0 + p1 + p2) / 3.0
    cen_q = (q0 + q1 + q2) / 3.0

    # rms over the 3 pairs (the reference divides by pairs.size() == 4).
    qs = torch.stack([q0, q1, q2], dim=-2) - cen_q[..., None, :]
    ps = torch.stack([p0, p1, p2], dim=-2) - cen_p[..., None, :]
    moved = torch.einsum("...ij,...nj->...ni", rot, qs)
    rms = torch.sum(_norm(moved - ps), dim=-1) / 4.0

    t = cen_p - torch.einsum("...ij,...j->...i", rot, cen_q)
    transform = torch.zeros(rot.shape[:-2] + (4, 4), dtype=rot.dtype, device=rot.device)
    transform[..., :3, :3] = rot
    transform[..., :3, 3] = t
    transform[..., 3, 3] = 1.0
    return transform, rms, okp & okq & ortho_ok
