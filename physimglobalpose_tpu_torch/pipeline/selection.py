"""Hypothesis selection (LCP mode).

Reference: LCPSelection (HypothesisSelection.cpp:117-239) takes the
generation stage's best hypothesis as the final pose per object. The
clustering and MCTS selections are not ported yet.
"""

from __future__ import annotations

import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)


def lcp_select(best_transform: torch.Tensor, best_score: torch.Tensor) -> torch.Tensor:
    """LCP mode: the best-scoring hypothesis is the pose (identity if none)."""
    eye = torch.eye(4, dtype=best_transform.dtype, device=best_transform.device)
    return torch.where(best_score > 0, best_transform, eye)
