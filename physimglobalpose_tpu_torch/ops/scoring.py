"""Hypothesis-scoring pipeline: coarse LCP -> top-k ICP -> fine LCP.

The reference scores every congruent-set transform with a full-resolution
kd-tree LCP (match4pcsBase.cc:1885-1914) and refines only post-hoc. Here the
shape is hierarchical: score the full hypothesis set against a subsampled
validation cloud (cheaper, ranking-faithful), then spend ICP and
full-resolution LCP only on the surviving top-k, and optionally rescore the
best of those in an exact tier.

On the card one call launches the hypothesis-block LCP kernel once (coarse),
the segment-stationary ICP kernel once per iteration, and the per-hypothesis
LCP kernel once for the bulk fine tier and once for the exact tier
(ops/lcp.py, ops/icp.py); a tier that sees more than 2,048 segment points
(the exact tier on a large segment) launches the streaming LCP kernel
instead. On CPU tensors the same steps run through the kernels' plain
versions. Everything between the kernels (top-k, the 6x6
solves, the final sort) is plain PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from physimglobalpose_tpu_torch.ops import icp as icp_mod
from physimglobalpose_tpu_torch.ops import lcp as lcp_mod


class ScoredHypotheses(NamedTuple):
    top_transforms: torch.Tensor  # [K, 4, 4] refined
    # [K] weighted LCP, descending. With fine_seg_stride == 1 every entry is
    # full-resolution. With fine_seg_stride > 1 only the first fine_exact_k
    # entries carry full-resolution scores of the exact tier; the tail holds
    # strided bulk-tier scores, valid for ranking the tail but not as
    # calibrated scores.
    top_scores: torch.Tensor
    coarse_scores: torch.Tensor  # [H]


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores, exact ties by lowest index (a stable
    sort): unweighted coarse scores are multiples of 1/Nv, so the boundary
    usually sits inside a large exact tie."""
    return torch.sort(scores, descending=True, stable=True).indices[:k]


def uses_segside_icp(n_seg: int, n_model: int) -> bool:
    """The JAX package's routing rule for the segment-stationary ICP, copied
    so a shape takes the same refiner in both packages (the constant is a
    routing constant, not a memory size of the card)."""
    return lcp_mod.pad128(n_seg) * lcp_mod.pad128(n_model) <= (1 << 20)


def score_refine_pipeline(
    transforms: torch.Tensor,  # [H, 4, 4]
    model_search_pts: torch.Tensor,  # [Nm, 3] sparse cloud (ICP)
    model_search_nrm: torch.Tensor,
    model_validation_pts: torch.Tensor,  # [Nv, 3] dense cloud (LCP)
    model_validation_nrm: torch.Tensor,
    seg_pts: torch.Tensor,
    seg_nrm: torch.Tensor,
    seg_prob: torch.Tensor,
    seg_mask: torch.Tensor,
    top_k: int = 1024,
    coarse_subsample: int = 4,
    icp_iters: int = 10,
    icp_subsample: int = 1,
    delta: float = 0.005,
    normal_gate_deg: float = 30.0,
    icp_nn_refresh: int = 1,
    coarse_precision: str | None = None,
    fine_precision: str | None = None,
    coarse_weighted: bool = True,
    fine_exact_k: int = 0,
    icp_precision: str | None = None,
    coarse_seg_stride: int = 1,
    icp_seg_stride: int = 1,
    fine_seg_stride: int = 1,
    exact_precision: str | None = None,
    fine_hb_lane_pack: bool | None = None,
    coarse_topk_approx: bool = False,
) -> ScoredHypotheses:
    """Score all H hypotheses coarsely, refine and rescore the best top_k.

    Stage 1 ranks every hypothesis by LCP on every coarse_subsample-th
    validation point and every coarse_seg_stride-th segment point
    (coarse_precision tier; coarse_weighted=False counts points within delta
    and skips the normal gate). Stage 2 refines the top_k survivors by
    point-to-plane ICP on every icp_subsample-th search point and every
    icp_seg_stride-th segment point: the segment-stationary refiner
    (icp_precision tier) where uses_segside_icp allows, else refine_icp with
    icp_nn_refresh. Stage 3 rescores them with the full validation cloud,
    weighted, at fine_precision on every fine_seg_stride-th segment point;
    when fine_exact_k > 0 and fine_precision is a lowered tier, the best
    fine_exact_k are rescored on the whole segment at exact_precision and
    their scores replace the bulk ones. fine_seg_stride > 1 needs that exact
    tier and raises without it, because the strided bulk would otherwise be
    the reported score. fine_hb_lane_pack forces or forbids the
    hypothesis-block kernel for the bulk fine tier (ops/lcp.lcp_scores).

    coarse_topk_approx is accepted for signature parity with the JAX package,
    where it selects an approximate top-k primitive of the TPU as a probe; it
    is not a production flag, has no counterpart here, and the exact top-k
    is used whatever its value.

    The tensors' device decides where it runs: CUDA tensors go through the
    kernels, CPU tensors through their plain versions.
    """
    del coarse_topk_approx
    k = min(top_k, transforms.shape[0])

    coarse = lcp_mod.lcp_scores(
        transforms,
        model_validation_pts[::coarse_subsample], model_validation_nrm[::coarse_subsample],
        seg_pts[::coarse_seg_stride], seg_nrm[::coarse_seg_stride],
        seg_prob[::coarse_seg_stride], seg_mask[::coarse_seg_stride],
        delta=delta, normal_gate_deg=normal_gate_deg, weighted=coarse_weighted,
        matmul_precision=coarse_precision,
    )

    top_tfs = transforms[top_k_indices(coarse, k)]
    icp_pts = model_search_pts[::icp_subsample]
    icp_nrm = model_search_nrm[::icp_subsample]
    i_seg = seg_pts[::icp_seg_stride]
    i_mask = seg_mask[::icp_seg_stride]
    if uses_segside_icp(i_seg.shape[0], icp_pts.shape[0]):
        refined = icp_mod.refine_icp_segside(
            top_tfs, icp_pts, icp_nrm, i_seg, i_mask,
            iters=icp_iters, matmul_precision=icp_precision,
        )
    else:
        refined = icp_mod.refine_icp(
            top_tfs, icp_pts, icp_nrm, i_seg, i_mask,
            iters=icp_iters, point_to_plane=True, nn_refresh=icp_nn_refresh,
        )

    exact_tier = bool(fine_exact_k) and fine_precision not in (None, "highest")
    if fine_seg_stride > 1 and not exact_tier:
        raise ValueError(
            "fine_seg_stride > 1 requires the exact rescore tier "
            "(fine_exact_k > 0 with a lowered fine_precision); without it "
            "the bulk fine tier is the final score and striding it would "
            "silently change reported scores"
        )
    fine = lcp_mod.lcp_scores(
        refined, model_validation_pts, model_validation_nrm,
        seg_pts[::fine_seg_stride], seg_nrm[::fine_seg_stride],
        seg_prob[::fine_seg_stride], seg_mask[::fine_seg_stride],
        delta=delta, normal_gate_deg=normal_gate_deg, weighted=True,
        matmul_precision=fine_precision, hb_lane_pack=fine_hb_lane_pack,
    )
    if exact_tier:
        idx_e = top_k_indices(fine, min(fine_exact_k, k))
        exact = lcp_mod.lcp_scores(
            refined[idx_e], model_validation_pts, model_validation_nrm,
            seg_pts, seg_nrm, seg_prob, seg_mask,
            delta=delta, normal_gate_deg=normal_gate_deg, weighted=True,
            matmul_precision=exact_precision,
        )
        fine = fine.clone()
        fine[idx_e] = exact
    order = torch.sort(fine, descending=True, stable=True).indices
    return ScoredHypotheses(
        top_transforms=refined[order], top_scores=fine[order], coarse_scores=coarse
    )
