"""Operations and bytes of the program's kernels, from the shapes of their calls.

The bound of an LCP call (ops/lcp.lcp_scores) is the least time the card
could take for the work its inputs need, whatever computes it: every
hypothesis checks every pair of a valid model point and a valid segment
point, 8 floating-point operations a pair (a difference, its square and
sum, a compare), at the float32 peak outside the tensor cores for the exact
tier and at the bf16 tensor-core peak for a lowered tier; each input byte
read once and each score written once against the memory bandwidth; the
larger of the two. Peaks: peaks.json, at the card's full power limit.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
LCP_FLOP_PER_PAIR = 8
EXACT_TIERS = (None, "highest", "high3")


def lcp_bound_s(hypotheses: int, model_pts: int, seg_pts: int, tier) -> float:
    flops = LCP_FLOP_PER_PAIR * hypotheses * model_pts * seg_pts
    peak = PEAKS["fp32_flop_per_s"] if tier in EXACT_TIERS else PEAKS["bf16_flop_per_s"]
    # transforms [H, 4, 4], model points and normals, segment points, normals,
    # probabilities and mask, scores [H]; float32 throughout
    nbytes = 4 * (16 * hypotheses + 6 * model_pts + 8 * seg_pts + hypotheses)
    return max(flops / peak, nbytes / PEAKS["hbm_byte_per_s"])


def lcp_share(run) -> float | None:
    """Percent of the LCP calls' bound in the device time of the kernels
    launched inside them, over the traced requests."""
    tr = run["trace"]
    if not tr or not tr["lcp_calls"] or "lcp" not in tr["ranges"]:
        return None
    device_s = tr["ranges"]["lcp"]["device_s"]
    if device_s <= 0:
        return None
    return 100.0 * sum(lcp_bound_s(*call) for call in tr["lcp_calls"]) / device_s
