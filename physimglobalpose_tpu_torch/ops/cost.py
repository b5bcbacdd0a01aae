"""Pixel-wise scene explanation cost.

Reference (UCTState::computeCost, UCTState.cpp:93-116): over all pixels with
|observed - rendered| > 1 cm, count obScore (observed occupied), renScore
(rendered occupied), intScore (both); renderScore = obScore + renScore -
intScore, lower is better. Batched over [..., H, W] depth stacks.
"""

from __future__ import annotations

import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)


def render_cost(
    obs_depth: torch.Tensor,  # [..., H, W]
    ren_depth: torch.Tensor,  # [..., H, W]
    threshold: float = 0.01,
) -> torch.Tensor:
    """The 3-term unexplained-pixel count, float32 [...]; lower is better."""
    diff_big = torch.abs(obs_depth - ren_depth) > threshold
    ob = (obs_depth > 0) & diff_big
    ren = (ren_depth > 0) & diff_big
    inter = ob & ren
    return (
        torch.sum(ob, dim=(-2, -1))
        + torch.sum(ren, dim=(-2, -1))
        - torch.sum(inter, dim=(-2, -1))
    ).to(torch.float32)
