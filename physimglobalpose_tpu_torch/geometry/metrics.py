"""Pose-error metrics: symmetry-folded rot/trans error, ADD/ADD-S, EMD.

Reference semantics: utilities.cpp getPoseError (:514-548): relative rotation
test^-1 * gt converted to euler XYZ degrees, folded per axis by the object's
symmetry annotation (90/180/360), averaged; translation is plain L2.
getEMDError (:425-484) bins transformed model clouds into a 20^3 histogram
and compares with earth-mover's distance; here the same histogram binning
feeds a Sinkhorn approximation (batched, on the tensors' device) and an exact
transportation LP (host, the oracle).

ADD/ADD-S follow the standard Hinterstoisser definitions (not in the
reference repo, but its evaluation metric in the paper).

Plain functions on tensors, batched over leading dimensions; they run where
their inputs lie.
"""

from __future__ import annotations

import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)
from physimglobalpose_tpu_torch.geometry import se3


def fold_symmetry(rot_err_deg: torch.Tensor, sym_deg: torch.Tensor) -> torch.Tensor:
    """Fold per-axis rotation errors by symmetry annotation.

    sym==90: err -> min(|err-90|, 90-|err-90|); sym==180: min(err, 180-err);
    sym==360: 0 (utilities.cpp:530-543). Other values leave err unchanged.
    """
    e = torch.abs(rot_err_deg)
    e90 = torch.abs(e - 90.0)
    e90 = torch.minimum(e90, 90.0 - e90)
    e180 = torch.minimum(e, 180.0 - e)
    out = torch.where(sym_deg == 90, e90, e)
    out = torch.where(sym_deg == 180, e180, out)
    return torch.where(sym_deg == 360, 0.0, out)


def pose_error(test_pose: torch.Tensor, gt_pose: torch.Tensor, sym_deg: torch.Tensor):
    """(mean folded rotation error deg, translation error m).

    Matches utilities.cpp:514-548: rotdiff = R_test^-1 R_gt -> euler XYZ in
    degrees -> symmetry fold -> mean over axes.
    """
    rotdiff = test_pose[..., :3, :3].transpose(-1, -2) @ gt_pose[..., :3, :3]
    eul = se3.matrix_to_euler_xyz(rotdiff) * (180.0 / torch.pi)
    mean_rot = torch.mean(fold_symmetry(eul, sym_deg), dim=-1)
    trans = torch.linalg.norm(gt_pose[..., :3, 3] - test_pose[..., :3, 3], dim=-1)
    return mean_rot, trans


def add_error(test_pose: torch.Tensor, gt_pose: torch.Tensor, model: torch.Tensor) -> torch.Tensor:
    """ADD: mean L2 between corresponding transformed model points."""
    p1 = se3.transform_points(test_pose, model)
    p2 = se3.transform_points(gt_pose, model)
    return torch.mean(torch.linalg.norm(p1 - p2, dim=-1), dim=-1)


def adds_error(test_pose: torch.Tensor, gt_pose: torch.Tensor, model: torch.Tensor,
               chunk: int = 256) -> torch.Tensor:
    """ADD-S: mean over gt points of the distance to the nearest test point.

    Blockwise over gt chunks, so [N, N] is never built whole for a large
    model. Distances come from coordinate differences, not from the
    |a|^2 + |b|^2 - 2 a.b expansion, so nothing cancels at camera distance.
    """
    p_test = se3.transform_points(test_pose, model)  # [..., N, 3]
    p_gt = se3.transform_points(gt_pose, model)
    total = p_test.new_zeros(p_test.shape[:-2])
    for gt_c in p_gt.split(chunk, dim=-2):
        diff = gt_c[..., :, None, :] - p_test[..., None, :, :]  # [..., chunk, N, 3]
        total = total + torch.sum(torch.amin(torch.linalg.norm(diff, dim=-1), dim=-1), dim=-1)
    return total / model.shape[-2]


def emd_histograms(test_pose, gt_pose, model, lo, hi, bins: int = 20):
    """The bins^3 occupancy histograms underlying getEMDError
    (utilities.cpp:425-484).

    Returns (hist_test, hist_gt), each [..., bins**3], as float point counts;
    points outside [lo, hi) are dropped.
    """
    def hist(points):
        rel = (points - lo) / (hi - lo)  # [..., N, 3] in [0, 1)
        idx = torch.clamp(torch.floor(rel * bins).to(torch.int64), 0, bins - 1)
        inside = torch.all((rel >= 0) & (rel < 1), dim=-1)
        flat = (idx[..., 0] * bins + idx[..., 1]) * bins + idx[..., 2]
        flat = torch.where(inside, flat, bins**3)  # out-of-range bucket, dropped
        out = points.new_zeros(points.shape[:-2] + (bins**3 + 1,))
        out.scatter_add_(-1, flat, torch.ones_like(flat, dtype=points.dtype))
        return out[..., : bins**3]

    return hist(se3.transform_points(test_pose, model)), hist(
        se3.transform_points(gt_pose, model)
    )


def emd_error_approx(test_pose, gt_pose, model, lo, hi, bins: int = 20,
                     sinkhorn_iters: int = 50, eps: float = 0.5) -> torch.Tensor:
    """Entropy-regularized EMD between the two bins^3 histograms.

    The reference calls OpenCV's exact EMD with L2 ground distance over bin
    coordinates (utilities.cpp:484). Exact simplex EMD is host-sequential, so
    the batched version runs Sinkhorn on the same cost matrix; with small eps
    it converges to the same transport distance.
    """
    h1, h2 = emd_histograms(test_pose, gt_pose, model, lo, hi, bins)
    ax = torch.arange(bins, dtype=torch.float32, device=h1.device)
    coords = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1).reshape(-1, 3)
    cost = torch.linalg.norm(coords[:, None, :] - coords[None, :, :], dim=-1)

    a = h1 / torch.clamp(torch.sum(h1, dim=-1, keepdim=True), min=1e-9)
    b = h2 / torch.clamp(torch.sum(h2, dim=-1, keepdim=True), min=1e-9)
    k = torch.exp(-cost / eps)
    u, v = torch.ones_like(a), torch.ones_like(b)
    for _ in range(sinkhorn_iters):
        u = a / torch.clamp(v @ k.T, min=1e-30)  # k @ v
        v = b / torch.clamp(u @ k, min=1e-30)  # k^T @ u
    transport = u[..., :, None] * k * v[..., None, :]
    return torch.sum(transport * cost, dim=(-1, -2))


def emd_error_exact(test_pose, gt_pose, model, lo, hi, bins: int = 20) -> float:
    """EXACT EMD with the reference's semantics (utilities.cpp:425-484).

    The reference calls cv::EMD(sig1, sig2, CV_DIST_L2) over 20^3 histograms
    whose signatures carry raw point counts and integer bin coordinates; the
    result is min-cost-flow cost divided by the total flow min(W1, W2).
    Host-side and sequential by nature (a transportation LP), so this is the
    offline-eval / oracle path; emd_error_approx is the batched Sinkhorn whose
    error this function bounds.

    Solved with scipy HiGHS over the nonzero bins only: variables f_ij >= 0,
    row sums <= w1, col sums <= w2, total flow = min(W1, W2): OpenCV's
    unbalanced-EMD convention (identical to the balanced LP when the
    histograms have equal mass, i.e. no points fall outside [lo, hi)).
    """
    import numpy as np
    from scipy.optimize import linprog
    from scipy.sparse import lil_matrix

    as_t = lambda x: torch.as_tensor(x, dtype=torch.float32)
    h1, h2 = emd_histograms(
        as_t(test_pose), as_t(gt_pose), as_t(model), as_t(lo), as_t(hi), bins=bins
    )
    w1 = h1.detach().cpu().numpy().astype(np.float64)
    w2 = h2.detach().cpu().numpy().astype(np.float64)
    if w1.ndim != 1:
        raise ValueError("emd_error_exact is unbatched (offline oracle)")
    nz1 = np.nonzero(w1)[0]
    nz2 = np.nonzero(w2)[0]
    if len(nz1) == 0 or len(nz2) == 0:
        return 0.0

    def coords(flat):
        x, rem = np.divmod(flat, bins * bins)
        y, z = np.divmod(rem, bins)
        return np.stack([x, y, z], axis=-1).astype(np.float64)

    c1, c2 = coords(nz1), coords(nz2)
    cost = np.linalg.norm(c1[:, None, :] - c2[None, :, :], axis=-1)
    n1, n2 = len(nz1), len(nz2)
    total = min(w1.sum(), w2.sum())

    # Transportation LP: A_ub encodes row/col capacity, A_eq the total flow.
    a_ub = lil_matrix((n1 + n2, n1 * n2))
    for i in range(n1):
        a_ub[i, i * n2 : (i + 1) * n2] = 1.0
    for j in range(n2):
        a_ub[n1 + j, j::n2] = 1.0
    b_ub = np.concatenate([w1[nz1], w2[nz2]])
    res = linprog(
        cost.ravel(),
        A_ub=a_ub.tocsr(), b_ub=b_ub,
        A_eq=np.ones((1, n1 * n2)), b_eq=[total],
        method="highs",
    )
    if not res.success:  # pragma: no cover - tiny feasible LP
        raise RuntimeError(f"exact EMD LP failed: {res.message}")
    return float(res.fun / total)
