"""Inputs, production flags and fidelity gates of the scoring benchmark.

The workload is the hottest path of the reference (per-transform kd-tree
verification, match4pcsBase.cc:1699-1766): H candidate poses of a dense model
cloud scored against an observed segment through
ops/scoring.score_refine_pipeline. This module holds what a benchmark of that
path needs and nothing that times it: the synthetic inputs (numpy, from a
seed; the same draws as the JAX package's bench.make_inputs), the tuned
production flag set, and the gates that hold a production result against the
exact pipeline on the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from physimglobalpose_tpu_torch import _torchcfg
from physimglobalpose_tpu_torch.ops import scoring

H = 16384  # hypotheses per batch
NV = 4096  # dense validation cloud (max_validation_points)
NM = 1024  # sparse ICP model cloud (max_model_points)
NS = 1024  # segment size (max_segment_points)
ICP_ITERS = 6  # the exact pipeline's iterations (the fidelity yardstick)
PROD_ICP_ITERS = 4  # production budget, gated against the 6-iteration exact pipeline


def prod_flags() -> dict:
    """The tuned production flag set of score_refine_pipeline: unweighted
    "default"-tier coarse ranking on every 16th validation point and every
    4th segment point, 4 "default"-tier ICP iterations on the top 256 with
    every 2nd model and segment point, a "default"-tier bulk fine tier on
    every 4th segment point, and a "high3" exact tier for the best 32."""
    return dict(
        top_k=256, coarse_subsample=16, coarse_seg_stride=4,
        icp_iters=PROD_ICP_ITERS, icp_subsample=2,
        coarse_precision="default", icp_nn_refresh=2, coarse_weighted=False,
        fine_precision="default", fine_exact_k=32, fine_seg_stride=4,
        icp_precision="default", exact_precision="high3", icp_seg_stride=2,
    )


def make_inputs(seed=0, clutter=False, h=H, nv=NV, nm=NM, ns=NS):
    """The nine input arrays of score_refine_pipeline, as numpy arrays:
    (transforms, model_search_pts, model_search_nrm, model_validation_pts,
    model_validation_nrm, seg_pts, seg_nrm, seg_prob, seg_mask).

    clutter=True is the ranking-fidelity workload: a quarter of the segment
    is uniform clutter and half the hypotheses are garbage (0.1-0.3 m off).
    In the easy mode all hypotheses are near-correct, so mis-ranking would
    not show.
    """
    rng = np.random.default_rng(seed)
    model_v = rng.uniform(-0.06, 0.06, size=(nv, 3)).astype(np.float32)
    nrm_v = rng.normal(size=(nv, 3)).astype(np.float32)
    nrm_v /= np.linalg.norm(nrm_v, axis=1, keepdims=True)
    model_m = model_v[:nm]
    nrm_m = nrm_v[:nm]
    offset = np.array([0.05, 0.0, 0.6], np.float32)
    seg = (model_v[:ns] + offset).astype(np.float32)
    seg_nrm = nrm_v[:ns].copy()
    if clutter:
        n_cl = ns // 4
        seg[ns - n_cl:] = rng.uniform(-0.2, 0.2, size=(n_cl, 3)) + offset
        cn = rng.normal(size=(n_cl, 3)).astype(np.float32)
        seg_nrm[ns - n_cl:] = cn / np.linalg.norm(cn, axis=1, keepdims=True)
    seg_prob = rng.uniform(0.5, 1.0, size=ns).astype(np.float32)
    seg_mask = np.ones(ns, bool)
    tfs = np.tile(np.eye(4, dtype=np.float32), (h, 1, 1))
    tfs[:, :3, 3] = offset + rng.normal(scale=0.01, size=(h, 3))
    if clutter:
        sign = np.where(np.arange(h) % 4 == 1, 1.0, -1.0)
        bad = np.arange(h) % 2 == 1
        tfs[bad, 0, 3] += (rng.uniform(0.1, 0.3, size=h) * sign)[bad]
        tfs[bad, 1, 3] += rng.uniform(0.1, 0.3, size=h)[bad]
    return tfs, model_m, nrm_m, model_v, nrm_v, seg, seg_nrm, seg_prob, seg_mask


def to_tensors(inputs, device=None):
    """The arrays of make_inputs as tensors on `device` (the card unless the
    caller asks for the CPU)."""
    dev = _torchcfg.resolve_device(device)
    return tuple(torch.as_tensor(np.asarray(a), device=dev) for a in inputs)


def exact_pipeline(inputs) -> scoring.ScoredHypotheses:
    """The exact pipeline the gates compare with: weighted float32 coarse
    ranking on every 8th validation point, 6 float32 ICP iterations on the
    top 512, float32 fine scores."""
    return scoring.score_refine_pipeline(
        *inputs, top_k=512, coarse_subsample=8, icp_iters=ICP_ITERS, icp_subsample=2,
        icp_precision=None, icp_nn_refresh=2,
    )


def fidelity_gate(inputs, prod: scoring.ScoredHypotheses, clutter: bool, device=None) -> dict:
    """Hold a production result against the exact pipeline on the same inputs.

    inputs: the tensors the production result was computed from (arrays are
    moved to `device`). Gates: clutter - at least 63 of the exact pipeline's
    coarse top 64 survive into the production coarse top 256; easy - the
    production winner's score trails the exact winner's by less than 0.002;
    both - the top-1 translation drifts less than 2 mm. Raises
    AssertionError on a failed gate; returns the measured values.
    """
    if not all(isinstance(a, torch.Tensor) for a in inputs):
        inputs = to_tensors(inputs, device)
    exact = exact_pipeline(inputs)
    got = {}
    if clutter:
        prod_top256 = set(scoring.top_k_indices(prod.coarse_scores, 256).tolist())
        exact_top64 = set(scoring.top_k_indices(exact.coarse_scores, 64).tolist())
        got["survival"] = len(exact_top64 & prod_top256)
        if got["survival"] < 63:
            raise AssertionError(
                f"fidelity gate failed: only {got['survival']}/64 of the exact coarse "
                "top-64 survive the production ranking (clutter)"
            )
    else:
        got["score_gap"] = float(exact.top_scores[0]) - float(prod.top_scores[0])
        if not got["score_gap"] < 0.002:
            raise AssertionError(
                "fidelity gate failed: production winner trails the exact pipeline's "
                f"winner by {got['score_gap']:.4f} (easy)"
            )
    got["drift_m"] = float(
        torch.linalg.norm(prod.top_transforms[0, :3, 3] - exact.top_transforms[0, :3, 3])
    )
    if not got["drift_m"] < 0.002:
        raise AssertionError(
            f"fidelity gate failed: top-1 drifts {got['drift_m'] * 1000:.2f} mm from the "
            f"exact pipeline winner (clutter={clutter})"
        )
    return got
