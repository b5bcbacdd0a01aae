"""Hypothesis generation: the StoCS pipeline for one object.

Reference flow (CongruentSetMatching::generate + Perform_N_steps,
ObjectPoseCandidateSet.cpp:23-70, match4pcsBase.cc:1822-1925): sample 100
bases, extract congruent sets per base (<=100 each), fit a rigid transform
per congruent quad, score every transform with weighted LCP, keep the best.
Here base sampling, congruent extraction, B*Q rigid fits and the H-way LCP
scoring (one CUDA kernel launch on the card) run back to back on the device,
with no host round trip in between.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)
from physimglobalpose_tpu_torch.config import PipelineConfig, DEFAULT_CONFIG
from physimglobalpose_tpu_torch.ops import congruent, lcp, ppf, sampling
from physimglobalpose_tpu_torch.pipeline.segmentation import Segment3D


class HypothesisResult(NamedTuple):
    transforms: torch.Tensor  # [H, 4, 4]
    scores: torch.Tensor  # [H] weighted LCP (0 for invalid)
    valid: torch.Tensor  # [H] bool
    best_transform: torch.Tensor  # [4, 4]
    best_score: torch.Tensor  # []
    enough_points: torch.Tensor  # [] bool - segment had > min_segment_points


def generate_hypotheses(
    seg: Segment3D,
    model_search_pts: torch.Tensor,  # [Nm, 3] (padded)
    model_search_mask: torch.Tensor,  # [Nm]
    table: ppf.PPFTable,
    model_validation_pts: torch.Tensor,  # [Nv, 3]
    model_validation_nrm: torch.Tensor,  # [Nv, 3]
    cfg: PipelineConfig = DEFAULT_CONFIG,
    generator: torch.Generator | None = None,
    gumbel: torch.Tensor | None = None,
    quad_priority: torch.Tensor | None = None,
) -> HypothesisResult:
    """StoCS generation (the JAX package's mode="stocs") + weighted-LCP
    verification for one object segment.

    gumbel ([4, B, N]) and quad_priority ([B, K*K]) are the optional injected
    draws of sampling.sample_bases and congruent.extract_congruent_quads;
    they come from `generator` when not given.
    """
    st = cfg.stocs

    # Degenerate-segment bail (<= 30 points -> identity pose): the kernels
    # still run, the validity is zeroed.
    enough = torch.sum(seg.mask) > cfg.preprocess.min_segment_points

    bases = sampling.sample_bases(
        seg.pts, seg.nrm, seg.prob, seg.mask, table, num_bases=st.num_bases,
        min_base_angle_deg=st.min_base_angle_deg,
        coplanarity_threshold=st.coplanarity_threshold,
        min_point_spacing=st.min_point_spacing,
        generator=generator, gumbel=gumbel,
    )
    quads, quads_valid = congruent.extract_congruent_quads(
        bases, seg.pts, seg.nrm, model_search_pts, table,
        max_pairs=st.max_pairs_per_ppf, max_quads_per_base=st.max_quads_per_base,
        dist_threshold=st.distance_factor * st.delta,
        generator=generator, priority=quad_priority,
    )
    # Congruent pairs referencing padded model rows are invalid.
    quads_valid = quads_valid & torch.all(model_search_mask[quads], dim=-1)
    hyps = congruent.hypotheses_from_quads(bases, quads, quads_valid, seg.pts, model_search_pts)

    scores = lcp.lcp_scores(
        hyps.transforms, model_validation_pts, model_validation_nrm,
        seg.pts, seg.nrm, seg.prob, seg.mask,
        delta=cfg.lcp.delta, normal_gate_deg=cfg.lcp.normal_gate_deg, weighted=True,
    )
    valid = hyps.valid & enough
    scores = torch.where(valid, scores, 0.0)
    best = torch.argmax(scores)
    best_score = scores[best]
    eye = torch.eye(4, device=scores.device)
    best_tf = torch.where(best_score > 0, hyps.transforms[best], eye)
    return HypothesisResult(
        transforms=hyps.transforms, scores=scores, valid=valid,
        best_transform=best_tf, best_score=best_score, enough_points=enough,
    )


def top_k_hypotheses(result: HypothesisResult, k: int):
    """The k best-scoring hypotheses, ties in index order (the MCTS
    branching set; a superset of the reference's improving prefix)."""
    idx = torch.sort(result.scores, descending=True, stable=True).indices[:k]
    return result.transforms[idx], result.scores[idx]


def stack_object_tables(tables: list[ppf.PPFTable]) -> ppf.PPFTable:
    """Stack per-object PPF tables along a leading object axis (pairs padded)."""
    p_max = max(int(t.pairs.shape[0]) for t in tables)
    pairs = torch.stack(
        [
            torch.cat([t.pairs, t.pairs.new_zeros(p_max - t.pairs.shape[0], 2)])
            for t in tables
        ]
    )
    t0 = tables[0]
    return ppf.PPFTable(
        presence=torch.stack([t.presence for t in tables]),
        offsets=torch.stack([t.offsets for t in tables]),
        counts=torch.stack([t.counts for t in tables]),
        pairs=pairs,
        trans_disc=t0.trans_disc, rot_disc=t0.rot_disc, max_dist_mm=t0.max_dist_mm,
    )


def generate_hypotheses_batch(
    segs: Segment3D,  # fields stacked with a leading object axis [K, ...]
    model_search_pts: torch.Tensor,  # [K, Nm, 3]
    model_search_mask: torch.Tensor,  # [K, Nm]
    tables: ppf.PPFTable,  # stacked (stack_object_tables)
    model_validation_pts: torch.Tensor,  # [K, Nv, 3]
    model_validation_nrm: torch.Tensor,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    generator: torch.Generator | None = None,
    gumbel: torch.Tensor | None = None,
    quad_priority: torch.Tensor | None = None,
) -> HypothesisResult:
    """All K objects' generation + verification; fields stacked [K, ...].

    Objects run one after another (one LCP kernel launch each); the result
    for object i equals generate_hypotheses on object i with the same draws
    (gumbel [K, 4, B, N], quad_priority [K, B, K*K] when injected).
    """
    results = []
    for i in range(model_search_pts.shape[0]):
        table_i = ppf.PPFTable(
            presence=tables.presence[i], offsets=tables.offsets[i],
            counts=tables.counts[i], pairs=tables.pairs[i],
            trans_disc=tables.trans_disc, rot_disc=tables.rot_disc,
            max_dist_mm=tables.max_dist_mm,
        )
        results.append(generate_hypotheses(
            Segment3D(*(x[i] for x in segs)),
            model_search_pts[i], model_search_mask[i], table_i,
            model_validation_pts[i], model_validation_nrm[i], cfg, generator=generator,
            gumbel=None if gumbel is None else gumbel[i],
            quad_priority=None if quad_priority is None else quad_priority[i],
        ))
    return HypothesisResult(*(torch.stack(f) for f in zip(*results)))
