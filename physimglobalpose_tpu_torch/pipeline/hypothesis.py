"""Hypothesis generation for one object: congruent sets or PPF voting.

Reference flow (CongruentSetMatching::generate + Perform_N_steps,
ObjectPoseCandidateSet.cpp:23-70, match4pcsBase.cc:1822-1925): sample 100
bases, extract congruent sets per base (<=100 each), fit a rigid transform
per congruent quad, score every transform with weighted LCP, keep the best.
Three congruent-set modes, as in the JAX package: "stocs" (segmentation-prior
weighted bases + PPF-table pair lists, operMode 1), "super4pcs" (uniform
bases + geometric distance pairs, operMode 0) and "v4pcs" (tetrahedron
bases matched on all six distances, operMode 2); generate_hypotheses_voting
is the PPF Hough-voting generator. Base sampling, congruent extraction, the
rigid fits and the H-way LCP scoring (one CUDA kernel launch on the card) run
back to back on the device, with no host round trip in between.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)
from physimglobalpose_tpu_torch.config import PipelineConfig, DEFAULT_CONFIG
from physimglobalpose_tpu_torch.ops import congruent, lcp, ppf, ppf_voting, sampling
from physimglobalpose_tpu_torch.pipeline.segmentation import Segment3D


class HypothesisResult(NamedTuple):
    transforms: torch.Tensor  # [H, 4, 4]
    scores: torch.Tensor  # [H] weighted LCP (0 for invalid)
    valid: torch.Tensor  # [H] bool
    best_transform: torch.Tensor  # [4, 4]
    best_score: torch.Tensor  # []
    enough_points: torch.Tensor  # [] bool - segment had > min_segment_points


GEN_MODES = ("stocs", "super4pcs", "v4pcs")


def _score_and_pick(transforms, hyp_valid, enough, seg, model_validation_pts,
                    model_validation_nrm, cfg) -> HypothesisResult:
    """Weighted-LCP verification of every hypothesis, then the best one
    (identity when no hypothesis scores above 0)."""
    scores = lcp.lcp_scores(
        transforms, model_validation_pts, model_validation_nrm,
        seg.pts, seg.nrm, seg.prob, seg.mask,
        delta=cfg.lcp.delta, normal_gate_deg=cfg.lcp.normal_gate_deg, weighted=True,
    )
    valid = hyp_valid & enough
    scores = torch.where(valid, scores, 0.0)
    # Gathers by a device index (indexing by a 0-dim tensor would read it
    # back to the host).
    best = torch.argmax(scores)[None]
    best_score = scores.index_select(0, best)[0]
    eye = torch.eye(4, device=scores.device)
    best_tf = torch.where(best_score > 0, transforms.index_select(0, best)[0], eye)
    return HypothesisResult(
        transforms=transforms, scores=scores, valid=valid,
        best_transform=best_tf, best_score=best_score, enough_points=enough,
    )


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
    mode: str = "stocs",
    pair_priority: torch.Tensor | None = None,
) -> HypothesisResult:
    """Congruent-set generation in `mode` (one of GEN_MODES) + weighted-LCP
    verification for one object segment.

    The optional injected draws (else drawn from `generator`): gumbel
    [4, B, N] for the base sampler, quad_priority [B, K*K] for the congruent
    selection, and in the super4pcs and v4pcs modes pair_priority
    [2, B, Nm*Nm] for the two distance-matched pair lists.
    """
    st = cfg.stocs
    dist_threshold = st.distance_factor * st.delta

    # Degenerate-segment bail (<= 30 points -> identity pose): the kernels
    # still run, the validity is zeroed.
    enough = torch.sum(seg.mask) > cfg.preprocess.min_segment_points

    if mode == "stocs":
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
            dist_threshold=dist_threshold, generator=generator, priority=quad_priority,
        )
    elif mode in ("super4pcs", "v4pcs"):
        bases = sampling.sample_bases_uniform(
            seg.pts, seg.mask, num_bases=st.num_bases, min_spread=st.min_point_spacing,
            generator=generator, gumbel=gumbel,
        )
        extract = (congruent.extract_congruent_quads_classic if mode == "super4pcs"
                   else congruent.extract_congruent_quads_tetra)
        quads, quads_valid = extract(
            bases, seg.pts, model_search_pts, model_search_mask,
            max_pairs=st.max_pairs_per_ppf, max_quads_per_base=st.max_quads_per_base,
            dist_threshold=dist_threshold, generator=generator,
            pair_priority=pair_priority, priority=quad_priority,
        )
    else:
        raise ValueError(f"unknown generation mode {mode!r}")
    # Congruent pairs referencing padded model rows are invalid.
    quads_valid = quads_valid & torch.all(model_search_mask[quads], dim=-1)
    hyps = congruent.hypotheses_from_quads(bases, quads, quads_valid, seg.pts, model_search_pts)
    return _score_and_pick(hyps.transforms, hyps.valid, enough, seg, model_validation_pts,
                           model_validation_nrm, cfg)


def generate_hypotheses_voting(
    seg: Segment3D,
    model_search_pts: torch.Tensor,
    model_search_nrm: torch.Tensor,
    model_search_mask: torch.Tensor,
    table: ppf.PPFTable,
    model_validation_pts: torch.Tensor,
    model_validation_nrm: torch.Tensor,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    generator: torch.Generator | None = None,
    gumbel: torch.Tensor | None = None,
) -> HypothesisResult:
    """PPF Hough-voting generation (ops/ppf_voting.py: 64 reference points,
    32 pairs a PPF bin, the top min(max_hypotheses, 256) poses) + weighted-LCP
    verification; the working realization of the reference's PPFVoting
    strategy (ObjectPoseCandidateSet.cpp:108-115 stub). gumbel: the optional
    injected [64, N] draw of the reference points."""
    enough = torch.sum(seg.mask) > cfg.preprocess.min_segment_points
    res = ppf_voting.ppf_vote(
        seg.pts, seg.nrm, seg.mask,
        model_search_pts, model_search_nrm, model_search_mask, table,
        n_ref=64, max_pairs=32, top_poses=min(cfg.stocs.max_hypotheses, 256),
        generator=generator, gumbel=gumbel,
    )
    return _score_and_pick(res.transforms, res.valid, enough, seg, model_validation_pts,
                           model_validation_nrm, cfg)


def draw_generation(generator: torch.Generator, mode: str, n_seg: int, n_model: int,
                    cfg: PipelineConfig = DEFAULT_CONFIG, device=None) -> dict:
    """The random draws generate_hypotheses(generator=...) makes for one
    object, drawn from `generator` with the same calls in the same order, as
    the keyword arguments that inject them: gumbel [4, B, n_seg], in the
    super4pcs and v4pcs modes pair_priority [2, B, n_model^2] (two draws),
    then quad_priority [B, max_pairs^2]. Every shape is fixed by the config
    and the padded cloud sizes, so a caller can draw ahead of the work and
    run the work elsewhere (another device, a batch)."""
    st = cfg.stocs
    b, k = st.num_bases, st.max_pairs_per_ppf
    dev = torch.device(device) if device is not None else generator.device
    out = {"gumbel": sampling.gumbel_noise((4, b, n_seg), generator, dev)}
    if mode in ("super4pcs", "v4pcs"):
        out["pair_priority"] = torch.stack([
            torch.rand((b, n_model * n_model), generator=generator, device=dev) for _ in range(2)
        ])
    elif mode != "stocs":
        raise ValueError(f"unknown generation mode {mode!r}")
    out["quad_priority"] = torch.rand((b, k * k), generator=generator, device=dev)
    return out


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
    mode: str = "stocs",
    pair_priority: torch.Tensor | None = None,
) -> HypothesisResult:
    """All K objects' generation in `mode` + verification; fields stacked [K, ...].

    Objects run one after another (one LCP kernel launch each); the result
    for object i equals generate_hypotheses on object i with the same draws
    (gumbel [K, 4, B, N], quad_priority [K, B, K*K], pair_priority
    [K, 2, B, Nm*Nm] when injected).
    """
    return generate_hypotheses_jobs(
        segs, model_search_pts, model_search_mask, tables, model_validation_pts,
        model_validation_nrm, cfg, generators=[generator] * model_search_pts.shape[0],
        gumbel=gumbel, quad_priority=quad_priority, mode=mode, pair_priority=pair_priority,
    )


def generate_hypotheses_jobs(
    segs: Segment3D,  # fields stacked with a leading job axis [J, ...]
    model_search_pts: torch.Tensor,  # [J, Nm, 3]
    model_search_mask: torch.Tensor,  # [J, Nm]
    tables: ppf.PPFTable,  # stacked with a leading job axis
    model_validation_pts: torch.Tensor,  # [J, Nv, 3]
    model_validation_nrm: torch.Tensor,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    generators: list | None = None,
    gumbel: torch.Tensor | None = None,
    quad_priority: torch.Tensor | None = None,
    mode: str = "stocs",
    pair_priority: torch.Tensor | None = None,
) -> HypothesisResult:
    """A flat (scene, object) job axis with per-job draws: generators[j]
    (jobs of one scene may share its generator; jobs then draw in job
    order), or gumbel / quad_priority / pair_priority with a leading job
    axis (draw_generation's shapes). Row j equals generate_hypotheses on job
    j with the same draws; jobs run one after another, one LCP launch each.
    The scene sweep (parallel/scene_sweep.py) flattens many scenes' objects
    into this axis."""
    j = model_search_pts.shape[0]
    if generators is None:
        generators = [None] * j
    if len(generators) != j:
        raise ValueError(f"{len(generators)} generators for {j} jobs")

    def pick(draws, i):
        return None if draws is None else draws[i]

    results = []
    for i in range(j):
        table_i = ppf.PPFTable(
            presence=tables.presence[i], offsets=tables.offsets[i],
            counts=tables.counts[i], pairs=tables.pairs[i],
            trans_disc=tables.trans_disc, rot_disc=tables.rot_disc,
            max_dist_mm=tables.max_dist_mm,
        )
        results.append(generate_hypotheses(
            Segment3D(*(x[i] for x in segs)),
            model_search_pts[i], model_search_mask[i], table_i,
            model_validation_pts[i], model_validation_nrm[i], cfg, generator=generators[i],
            gumbel=pick(gumbel, i), quad_priority=pick(quad_priority, i), mode=mode,
            pair_priority=pick(pair_priority, i),
        ))
    return HypothesisResult(*(torch.stack(f) for f in zip(*results)))
