"""Port parity: ops/scoring.score_refine_pipeline against the JAX pipeline on
its kernel branch (use_pallas=True, Pallas interpret mode on the CPU), stage
by stage with the JAX stage's output injected into the next, and as a whole;
then the port's own copies of the JAX package's ranking-fidelity checks under
clutter (tests/test_scoring_clutter.py).

Hard decisions on near-ties (which of many equally scored hypotheses makes
the top-k cut) are held by outcome, not by index, wherever the two packages'
scores feeding the decision may differ in the last bit; where the very same
scores are injected, indices are compared exactly.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from _torch_common import n, scoring_inputs, t
from physimglobalpose_tpu.ops import icp as jicp, lcp as jlcp, scoring as jscoring
from physimglobalpose_tpu_torch import bench_inputs
from physimglobalpose_tpu_torch.ops import icp, lcp, scoring

# A small clutter workload and the production flag set cut to its size.
SHAPE = dict(h=128, nv=512, nm=128, ns=128)
FLAGS = dict(
    top_k=32, coarse_subsample=4, coarse_seg_stride=2, icp_iters=3, icp_subsample=2,
    coarse_precision="default", icp_nn_refresh=2, coarse_weighted=False,
    fine_precision="default", fine_exact_k=8, fine_seg_stride=2,
    icp_precision="default", exact_precision="high3", icp_seg_stride=2,
)
NV, NV_COARSE = SHAPE["nv"], SHAPE["nv"] // FLAGS["coarse_subsample"]


def interpret(fn, *args, **kw):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    with mock.patch.object(pl, "pallas_call", functools.partial(orig, interpret=True)):
        return fn(*args, **kw)


@pytest.fixture(scope="module")
def stages():
    """The JAX pipeline's stages on the small clutter workload, one by one."""
    jin = bench.make_inputs(seed=0, clutter=True, **SHAPE)
    tfs, mm, nm_, mv, nv_, seg, sn, sp, sm = jin
    f = FLAGS
    cs, ss = f["coarse_subsample"], f["coarse_seg_stride"]
    coarse = interpret(
        jlcp.lcp_scores, tfs, mv[::cs], nv_[::cs], seg[::ss], sn[::ss], sp[::ss], sm[::ss],
        weighted=False, use_pallas=True, matmul_precision=f["coarse_precision"])
    idx = jax.lax.top_k(coarse, f["top_k"])[1]
    refined = interpret(
        jicp.refine_icp_pallas_segside.__wrapped__, tfs[idx], mm[::2], nm_[::2],
        seg[::f["icp_seg_stride"]], sm[::f["icp_seg_stride"]], iters=f["icp_iters"],
        matmul_precision=f["icp_precision"])
    fs = f["fine_seg_stride"]
    fine = interpret(
        jlcp.lcp_scores, refined, mv, nv_, seg[::fs], sn[::fs], sp[::fs], sm[::fs],
        weighted=True, use_pallas=True, matmul_precision=f["fine_precision"])
    idx_e = jax.lax.top_k(fine, f["fine_exact_k"])[1]
    exact = interpret(
        jlcp.lcp_scores, refined[idx_e], mv, nv_, seg, sn, sp, sm,
        weighted=True, use_pallas=True, matmul_precision=f["exact_precision"])
    final = fine.at[idx_e].set(exact)
    order = jnp.argsort(-final)
    whole = interpret(jscoring.score_refine_pipeline.__wrapped__, *jin, use_pallas=True, **f)
    return dict(jin=jin, tin=scoring_inputs(jin), coarse=coarse, idx=idx, refined=refined,
                fine=fine, idx_e=idx_e, exact=exact, final=final, order=order, whole=whole)


def test_jax_stages_are_the_jax_pipeline(stages):
    # The stage-by-stage JAX run above is the pipeline itself.
    np.testing.assert_allclose(n(stages["whole"].coarse_scores), n(stages["coarse"]), atol=0)
    np.testing.assert_allclose(n(stages["whole"].top_scores),
                               n(stages["final"])[n(stages["order"])], atol=1e-6)


def test_stage_coarse_scores(stages):
    tfs, _, _, mv, nv_, seg, sn, sp, sm = stages["tin"]
    cs, ss = FLAGS["coarse_subsample"], FLAGS["coarse_seg_stride"]
    got = lcp.lcp_scores(tfs, mv[::cs], nv_[::cs], seg[::ss], sn[::ss], sp[::ss], sm[::ss],
                         weighted=False, matmul_precision="default")
    want = n(stages["coarse"])
    assert want.max() > 0.1 and (want == 0).sum() > 32  # good and garbage hypotheses
    # One point of the coarse cloud: a d^2 on the threshold may flip with the
    # order of the sum.
    np.testing.assert_allclose(n(got), want, atol=1.0 / NV_COARSE)


def test_stage_top_k_indices(stages):
    # The same scores in: the same indices out, ties by lowest index.
    got = scoring.top_k_indices(t(stages["coarse"]), FLAGS["top_k"])
    np.testing.assert_array_equal(n(got), n(stages["idx"]))
    got = scoring.top_k_indices(t(stages["fine"]), FLAGS["fine_exact_k"])
    np.testing.assert_array_equal(n(got), n(stages["idx_e"]))


def test_stage_icp_refinement(stages):
    tfs, mm, nm_, _, _, seg, _, _, sm = stages["tin"]
    top = tfs[torch.as_tensor(np.array(stages["idx"]))]
    s = FLAGS["icp_seg_stride"]
    assert scoring.uses_segside_icp(seg[::s].shape[0], mm[::2].shape[0])
    got = n(icp.refine_icp_segside(top, mm[::2], nm_[::2], seg[::s], sm[::s],
                                   iters=FLAGS["icp_iters"], matmul_precision="default"))
    want = n(stages["refined"])
    model = n(mm)
    disp = [np.linalg.norm((model @ g[:3, :3].T + g[:3, 3]) - (model @ w[:3, :3].T + w[:3, 3]),
                           axis=1).mean() for g, w in zip(got, want)]
    disp = np.array(disp)
    # Segment points within max_corr_dist of the placed model, before and
    # after JAX's refinement: a hypothesis that holds the 48 object points of
    # the segment at both ends has a well-determined 6x6 system.
    m2, sg = n(mm[::2]), n(seg[::s])[n(sm[::s])]

    def in_range(poses):
        placed = np.einsum("hij,nj->hni", poses[:, :3, :3], m2) + poses[:, None, :3, 3]
        d = np.linalg.norm(sg[None, :, None] - placed[:, None], axis=-1).min(-1)
        return (d <= 0.02).sum(-1)

    well = np.minimum(in_range(n(top)), in_range(want)) >= 40
    assert well.sum() >= 24 and (~well).sum() >= 1
    # Mean model-point displacement per hypothesis ("default" tier: the two
    # packages round W*col and g at different places): median under 0.02 mm
    # (0.003 mm measured); the well-determined hypotheses all within 0.5 mm
    # (0.30 mm measured). The rest are garbage survivors that keep a handful
    # of in-range correspondences; their systems are ill-conditioned and
    # amplify the rounding, so they are held to 5 mm only (2.1 mm measured;
    # the float32 tier lands 28 mm from it).
    assert np.median(disp) < 2e-5
    assert disp[well].max() < 5e-4
    assert disp.max() < 5e-3
    assert np.abs(want - n(top)).max() > 1e-3  # the poses moved


def test_stage_fine_and_exact_scores(stages):
    _, _, _, mv, nv_, seg, sn, sp, sm = stages["tin"]
    refined = t(stages["refined"])
    fs = FLAGS["fine_seg_stride"]
    fine = lcp.lcp_scores(refined, mv, nv_, seg[::fs], sn[::fs], sp[::fs], sm[::fs],
                          weighted=True, matmul_precision="default")
    np.testing.assert_allclose(n(fine), n(stages["fine"]), atol=2.0 / NV)
    exact = lcp.lcp_scores(refined[torch.as_tensor(np.array(stages["idx_e"]))], mv, nv_, seg, sn, sp,
                           sm, weighted=True, matmul_precision="high3")
    np.testing.assert_allclose(n(exact), n(stages["exact"]), atol=2.0 / NV)
    assert n(stages["exact"]).max() > 0.05


def test_stage_exact_scatter_and_order(stages):
    # Port pipeline with the JAX stage outputs injected for everything up to
    # the scatter: the final order and scores must come out as in JAX.
    injected = iter([t(stages["coarse"]), t(stages["fine"]), t(stages["exact"])])
    with mock.patch.object(lcp, "lcp_scores", lambda *a, **k: next(injected)), \
            mock.patch.object(icp, "refine_icp_segside", lambda *a, **k: t(stages["refined"])):
        out = scoring.score_refine_pipeline(*stages["tin"], **FLAGS)
    np.testing.assert_array_equal(n(out.top_scores), n(stages["final"])[n(stages["order"])])
    np.testing.assert_array_equal(n(out.top_transforms), n(stages["refined"])[n(stages["order"])])
    np.testing.assert_array_equal(n(out.top_transforms), n(stages["whole"].top_transforms))


def test_pipeline_matches_jax_pipeline(stages):
    out = scoring.score_refine_pipeline(*stages["tin"], **FLAGS)
    want = stages["whole"]
    assert out.top_transforms.shape == (32, 4, 4) and out.top_scores.shape == (32,)
    assert out.coarse_scores.shape == (SHAPE["h"],)
    np.testing.assert_allclose(n(out.coarse_scores), n(want.coarse_scores), atol=1.0 / NV_COARSE)
    # By outcome, not by index: the winner lands within 1 mm of JAX's and
    # scores within 2 points of the validation cloud.
    drift = np.linalg.norm(n(out.top_transforms)[0, :3, 3] - n(want.top_transforms)[0, :3, 3])
    assert drift < 1e-3
    assert abs(float(out.top_scores[0]) - float(want.top_scores[0])) <= 2.0 / NV
    assert bool((out.top_scores[:-1] >= out.top_scores[1:]).all())
    # coarse_topk_approx has no counterpart in the port: the exact top-k either way.
    again = scoring.score_refine_pipeline(*stages["tin"], coarse_topk_approx=True, **FLAGS)
    np.testing.assert_array_equal(n(again.top_scores), n(out.top_scores))


def test_large_clouds_take_refine_icp(stages):
    # Beyond the segment-stationary rule the pipeline refines with refine_icp.
    assert not scoring.uses_segside_icp(1024, 1025)
    assert scoring.uses_segside_icp(1024, 1024) and scoring.uses_segside_icp(512, 512)
    calls = []
    real = icp.refine_icp

    def spy(*a, **k):
        calls.append(k)
        return real(*a, **k)

    with mock.patch.object(scoring, "uses_segside_icp", lambda *_: False), \
            mock.patch.object(icp, "refine_icp", spy):
        out = scoring.score_refine_pipeline(*stages["tin"], **FLAGS)
    assert calls == [dict(iters=3, point_to_plane=True, nn_refresh=2)]
    drift = np.linalg.norm(
        n(out.top_transforms)[0, :3, 3] - n(stages["whole"].top_transforms)[0, :3, 3])
    assert drift < 2e-3


# ------------------------------------------- ranking fidelity under clutter


@functools.lru_cache(maxsize=None)
def _clutter_case(seed):
    inputs = bench_inputs.to_tensors(
        bench_inputs.make_inputs(seed=seed, clutter=True, h=512, nv=1024, nm=256, ns=256), "cpu")
    tfs, _, _, mv, nv_, seg, sn, sp, sm = inputs
    # Exhaustive reference: full-resolution weighted LCP on all hypotheses.
    exhaustive = n(lcp.lcp_scores_plain(tfs, mv, nv_, seg, sn, sp, sm, weighted=True))
    return inputs, exhaustive


def _run(seed, coarse_weighted=True, **extra):
    inputs, exhaustive = _clutter_case(seed)
    out = scoring.score_refine_pipeline(
        *inputs, top_k=64, coarse_subsample=8, icp_iters=5, icp_subsample=2,
        coarse_weighted=coarse_weighted, **extra)
    return inputs[0], out, exhaustive


def _check_top1(tfs, out, exhaustive, seed, score_tol=1e-3):
    best_exh = n(tfs)[int(np.argmax(exhaustive))]
    best_pipe = n(out.top_transforms[0])
    # The winner is ICP-refined: within refinement distance (< 2 cm) of the
    # exhaustive winner, never on a garbage hypothesis (>= 10 cm off).
    dist = np.linalg.norm(best_pipe[:3, 3] - best_exh[:3, 3])
    assert dist < 0.02, f"seed {seed}: pipeline top-1 {dist:.3f} m from exhaustive"
    assert float(out.top_scores[0]) >= float(exhaustive.max()) - score_tol


@pytest.mark.parametrize("coarse_weighted", [True, False], ids=["weighted", "unweighted"])
def test_coarse_fine_top1_matches_exhaustive(coarse_weighted):
    for seed in (0, 1, 2):
        _check_top1(*_run(seed, coarse_weighted=coarse_weighted), seed)


# Unlike the JAX package's CPU run of these two checks, the bulk fine tier
# here really is lowered to bf16 operands on the CPU too: it ranks the 64
# survivors with a few points of noise, so the best of them can miss the
# exact tier's 8 places and the reported winner can trail it by a few
# points of the 1024-point cloud (2.9 measured on seed 0): 4 / Nv.
TWO_TIER_TOL = 4.0 / 1024


def test_two_tier_fine_top1_matches_exhaustive():
    for seed in (0, 1):
        tfs, out, exhaustive = _run(seed, coarse_weighted=False, fine_precision="default",
                                    fine_exact_k=8)
        _check_top1(tfs, out, exhaustive, seed, TWO_TIER_TOL)


def test_coarse_gate_keeps_all_good_hypotheses():
    _, out, exhaustive = _run(seed=3)
    good = exhaustive >= 0.8 * exhaustive.max()
    kept = n(scoring.top_k_indices(out.coarse_scores, 64))
    missed = set(np.nonzero(good)[0]) - set(kept.tolist())
    assert not missed, f"coarse gate dropped good hypotheses: {sorted(missed)[:5]}"


def test_fine_seg_stride_top1_matches_exhaustive():
    for seed in (0, 1):
        tfs, out, exhaustive = _run(seed, coarse_weighted=False, fine_precision="default",
                                    fine_exact_k=8, fine_seg_stride=2)
        _check_top1(tfs, out, exhaustive, seed, TWO_TIER_TOL)


def test_fine_seg_stride_requires_exact_tier():
    with pytest.raises(ValueError, match="fine_seg_stride"):
        _run(0, fine_seg_stride=2)  # no fine_precision / fine_exact_k
    with pytest.raises(ValueError, match="fine_seg_stride"):
        _run(0, fine_seg_stride=2, fine_exact_k=8, fine_precision="highest")


# ------------------------------------------------------- large-segment path


def test_large_segment_pipeline_matches_jax_pipeline():
    # A 2,304-point segment: the strided coarse, ICP and bulk fine tiers see
    # 1,152 points and stay on the segment-stationary formulation; only the
    # exact tier sees the whole segment and takes the streaming one (on the
    # CPU its plain version). Against the JAX pipeline on its XLA branch
    # (use_pallas=False: float32 throughout, refine_icp for the ICP), so the
    # port's lowered tiers are "high3" (float32-grade) and the comparison is
    # by outcome. The two refine with different ICPs there (segment-stationary
    # against refine_icp), so the winners agree within 1 mm and 0.01 of score
    # (0.0035 measured); on JAX's own refined poses the port's exact tier gives
    # JAX's scores within 2 points of the validation cloud.
    shape = dict(h=64, nv=2304, nm=256, ns=2304)
    flags = dict(top_k=16, coarse_subsample=8, coarse_seg_stride=2, icp_iters=3,
                 icp_subsample=2, icp_seg_stride=2, icp_nn_refresh=2, coarse_weighted=False,
                 fine_precision="high3", fine_exact_k=4, fine_seg_stride=2,
                 exact_precision="high3")
    jin = bench.make_inputs(seed=0, clutter=True, **shape)
    want = jscoring.score_refine_pipeline(*jin, use_pallas=False, **flags)

    seen = []
    real = lcp.lcp_scores_stream

    def spy(*a, **k):
        seen.append((a[0].shape[0], a[3].shape[0], k.get("matmul_precision")))
        return real(*a, **k)

    with mock.patch.object(lcp, "lcp_scores_stream", spy):
        out = scoring.score_refine_pipeline(*scoring_inputs(jin), **flags)
    assert seen == [(4, 2304, "high3")]  # the exact tier, and nothing else
    assert out.top_transforms.shape == (16, 4, 4) and out.coarse_scores.shape == (64,)
    np.testing.assert_allclose(n(out.coarse_scores), n(want.coarse_scores), atol=1.0 / 288)
    drift = np.linalg.norm(n(out.top_transforms)[0, :3, 3] - n(want.top_transforms)[0, :3, 3])
    assert drift < 1e-3
    assert float(want.top_scores[0]) > 0.3
    assert abs(float(out.top_scores[0]) - float(want.top_scores[0])) < 0.01
    assert bool((out.top_scores[:-1] >= out.top_scores[1:]).all())
    _, _, _, mv, nv_, seg, sn, sp, sm = scoring_inputs(jin)
    rescored = lcp.lcp_scores(t(want.top_transforms[:4]), mv, nv_, seg, sn, sp, sm,
                              matmul_precision="high3")
    np.testing.assert_allclose(n(rescored), n(want.top_scores[:4]), atol=2.0 / 2304)
