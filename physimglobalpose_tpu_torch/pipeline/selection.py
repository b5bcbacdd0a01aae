"""Hypothesis selection: LCP best-pose + symmetry-aware greedy clustering.

Reference (HypothesisSelection.cpp): LCPSelection takes the generation
stage's best hypothesis as the final pose per object (:117-239);
greedyClustering (:66-115) prunes hypotheses below 0.5x the best score, then
clusters by symmetry-folded pose distance (rot < 10 deg, trans < 2 cm)
accumulating votes. As in the JAX package, nothing in the pipeline calls the
clustering; MCTS selection lives in pipeline/mcts.py.
"""

from __future__ import annotations

import math

import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)
from physimglobalpose_tpu_torch.geometry import metrics, se3


def lcp_select(best_transform: torch.Tensor, best_score: torch.Tensor) -> torch.Tensor:
    """LCP mode: the best-scoring hypothesis is the pose (identity if none)."""
    eye = torch.eye(4, dtype=best_transform.dtype, device=best_transform.device)
    return torch.where(best_score > 0, best_transform, eye)


def greedy_cluster_votes(
    transforms: torch.Tensor,  # [H, 4, 4]
    scores: torch.Tensor,  # [H]
    sym: torch.Tensor,  # [3]
    rot_thresh_deg: float = 10.0,
    trans_thresh: float = 0.02,
    prune_factor: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Vote accumulation over pose clusters (HypothesisSelection.cpp:66-115).

    Every hypothesis pair is compared at once: a hypothesis's vote is the
    score mass of the surviving hypotheses within (rot, trans) distance of
    it - the reference's ranking signal without its sequential absorption.
    Returns (votes [H], keep [H] bool).
    """
    keep = scores >= prune_factor * torch.max(scores)
    rot = transforms[:, :3, :3]
    rel = torch.einsum("hji,kjl->hkil", rot, rot)  # R_h^T R_k
    eul = se3.matrix_to_euler_xyz(rel) * (180.0 / math.pi)
    rot_close = torch.mean(metrics.fold_symmetry(eul, sym), dim=-1) < rot_thresh_deg
    t = transforms[:, :3, 3]
    d = t[:, None] - t[None, :]
    trans_close = torch.sqrt(torch.sum(d * d, dim=-1)) < trans_thresh
    near = rot_close & trans_close & keep[None, :] & keep[:, None]
    votes = torch.sum(near * torch.where(keep, scores, 0.0)[None, :], dim=-1)
    return votes, keep


def cluster_select(transforms: torch.Tensor, scores: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
    """The pose with the highest cluster vote mass (first of ties)."""
    votes, keep = greedy_cluster_votes(transforms, scores, sym)
    return transforms[torch.argmax(torch.where(keep, votes, -1.0))]
