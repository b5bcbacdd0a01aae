"""Port parity: ops/lcp.lcp_scores_plain against the JAX XLA scorer and
against the TPU kernels it stands for (_lcp_kernel_segside and
_lcp_kernel_segside_hb, run in Pallas interpret mode on the CPU), tier by
tier, and the copied kernel-routing rule against the JAX one. The CUDA
kernels themselves are held against lcp_scores_plain on the card by
chip_smoke.py."""

import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from _torch_common import n, t, tb
from physimglobalpose_tpu.ops import lcp as jlcp
from physimglobalpose_tpu_torch.ops import lcp


def make_case(rng, n_model, n_seg, n_hyp, n_masked, jitter=0.05):
    """Model cloud, a noisy cluttered segment of it, hypotheses near the truth
    (rotation jitter in radians, translation jitter in 5 cm / 100 units)."""
    model = rng.uniform(-0.05, 0.05, size=(n_model, 3)).astype(np.float32)
    mn = rng.normal(size=(n_model, 3))
    mn = (mn / np.linalg.norm(mn, axis=1, keepdims=True)).astype(np.float32)
    rot = Rotation.from_euler("xyz", [10, 20, 30], degrees=True).as_matrix()
    tr = np.array([0.05, -0.03, 0.6])
    k = n_seg - n_seg // 5
    idx = rng.choice(n_model, size=k, replace=False)
    seg = model[idx] @ rot.T + tr + rng.normal(scale=0.001, size=(k, 3))
    clutter = rng.uniform(-0.2, 0.2, size=(n_seg - k, 3)) + tr
    seg_pts = np.concatenate([seg, clutter]).astype(np.float32)
    seg_nrm = np.concatenate([mn[idx] @ rot.T, rng.normal(size=(n_seg - k, 3))])
    seg_nrm = (seg_nrm / np.linalg.norm(seg_nrm, axis=1, keepdims=True)).astype(np.float32)
    seg_prob = rng.uniform(0.5, 1.0, size=n_seg).astype(np.float32)
    mask = np.ones(n_seg, bool)
    mask[rng.choice(n_seg, size=n_masked, replace=False)] = False
    tfs = np.tile(np.eye(4, dtype=np.float32), (n_hyp, 1, 1))
    jit = Rotation.from_rotvec(rng.normal(scale=jitter, size=(n_hyp, 3))).as_matrix()
    tfs[:, :3, :3] = jit @ rot
    tfs[:, :3, 3] = tr + rng.normal(scale=0.06 * jitter, size=(n_hyp, 3))
    tfs[-1] = np.eye(4)  # a hypothesis far from everything
    return tfs, model, mn, seg_pts, seg_nrm, seg_prob, mask


def _both(case):
    jargs = tuple(jnp.asarray(a) for a in case)
    targs = tuple(t(a) for a in case[:-1]) + (tb(case[-1]),)
    return jargs, targs


@pytest.mark.parametrize("weighted", [True, False])
def test_plain_matches_xla(rng, weighted):
    # Near-exact hypotheses (as tests/test_lcp.py uses): the XLA scorer works
    # in uncentred coordinates, so a point right at the delta radius may
    # round the other way there.
    case = make_case(rng, 300, 200, 21, 12, jitter=0.005)
    jargs, targs = _both(case)
    want = np.asarray(jlcp.lcp_scores_xla(*jargs, weighted=weighted))
    got = n(lcp.lcp_scores_plain(*targs, weighted=weighted, h_chunk=8))
    assert want.max() > 0.2  # the case exercises real matches
    np.testing.assert_allclose(got, want, atol=1e-5 if not weighted else 2.0 / 300)


def _interpret_segside(jargs, **kw):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    with mock.patch.object(pl, "pallas_call", functools.partial(orig, interpret=True)):
        return np.asarray(jlcp.lcp_scores_pallas_segside.__wrapped__(*jargs, **kw))


@pytest.mark.parametrize(
    "n_model,n_seg,n_hyp",
    [
        (128, 96, 11),  # 8 model copies fit the lane budget: the hypothesis-batched branch
        (2048, 768, 3),  # nv above the budget: the per-hypothesis tiled branch (main path's)
    ],
)
def test_plain_matches_tpu_kernel_interpret(rng, n_model, n_seg, n_hyp):
    case = make_case(rng, n_model, n_seg, n_hyp, 16)
    jargs, targs = _both(case)
    for weighted in (True, False):
        want = _interpret_segside(jargs, weighted=weighted)
        got = n(lcp.lcp_scores_plain(*targs, weighted=weighted))
        tol = 2.0 / n_model if weighted else 1e-5
        np.testing.assert_allclose(got, want, atol=tol)


def test_dispatch_uses_plain_on_cpu(rng):
    case = make_case(rng, 200, 150, 5, 5)
    _, targs = _both(case)
    before = lcp.lcp_segside.launches
    np.testing.assert_array_equal(n(lcp.lcp_scores(*targs)), n(lcp.lcp_scores_plain(*targs)))
    assert lcp.lcp_segside.launches == before


def test_kernel_wrapper_takes_only_cuda_tensors():
    tr12 = torch.zeros(4, 12)
    with pytest.raises(ValueError, match="CUDA"):
        lcp.lcp_segside(tr12, torch.zeros(8, 3), torch.zeros(8, 3), torch.zeros(5, 8),
                        2.5e-5, 0.866, True)


def test_tie_rule_takes_max_prob_and_max_normal():
    # Two segment points at exactly the same place: the model point matches
    # both; the score takes the larger probability.
    seg = np.array([[0, 0, 0.5], [0, 0, 0.5], [1, 1, 1]], np.float32)
    nrm = np.array([[0, 0, 1], [0, 0, 1], [1, 0, 0]], np.float32)
    prob = np.array([0.3, 0.9, 1.0], np.float32)
    tf = np.eye(4, dtype=np.float32)[None]
    got = lcp.lcp_scores_plain(t(tf), t([[0, 0, 0.5]]), t([[0, 0, 1]]), t(seg), t(nrm),
                               t(prob), tb([True, True, True]))
    np.testing.assert_allclose(n(got), [0.9], atol=1e-6)


# ------------------------------------------------------------ tiers, routing


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "unweighted"])
@pytest.mark.parametrize("precision", [None, "default", "high3"])
def test_plain_tiers_match_tpu_kernel_interpret(rng, precision, weighted):
    # Per-hypothesis kernel (hb_lane_pack=False), 20 masked points. Tolerance
    # 2/Nv: the packages sum the d^2 terms in different orders, so a point on
    # the delta^2 threshold or an exact-tie rule may flip.
    case = make_case(rng, 512, 200, 24, 20)
    jargs, targs = _both(case)
    want = _interpret_segside(jargs, weighted=weighted, matmul_precision=precision,
                              hb_lane_pack=False)
    got = n(lcp.lcp_scores_plain(*targs, weighted=weighted, matmul_precision=precision))
    assert want.max() > 0.05
    np.testing.assert_allclose(got, want, atol=2.0 / 512)


@pytest.mark.parametrize("precision", [None, "default", "high3"])
@pytest.mark.parametrize(
    "n_model,n_seg,hb_lane_pack",
    [(128, 96, None), (512, 200, True)],
    ids=["auto_small_model", "forced_model_tiled"],
)
def test_dispatch_matches_tpu_hypothesis_block_interpret(rng, n_model, n_seg, hb_lane_pack,
                                                        precision):
    # The hypothesis-block branch (whole-model by the auto rule at a small Nv,
    # model-tiled when forced). It has no high3 tier: both packages then score
    # in float32. Tolerance 2/Nv as above.
    case = make_case(rng, n_model, n_seg, 19, 8)
    jargs, targs = _both(case)
    assert lcp.uses_hypothesis_block(n_model, n_seg, hb_lane_pack)
    for weighted in (True, False):
        want = _interpret_segside(jargs, weighted=weighted, matmul_precision=precision,
                                  hb_lane_pack=hb_lane_pack)
        got = n(lcp.lcp_scores(*targs, weighted=weighted, matmul_precision=precision,
                               hb_lane_pack=hb_lane_pack))
        np.testing.assert_allclose(got, want, atol=2.0 / n_model)
        if precision == "high3":
            np.testing.assert_array_equal(got, n(lcp.lcp_scores_plain(*targs, weighted=weighted)))


class _Routed(Exception):
    pass


def _jax_route(nv, ns, hb_lane_pack):
    """Which TPU kernel lcp_scores_pallas_segside hands to pallas_call."""
    from jax.experimental import pallas as pl

    def record(kernel, **_kw):
        raise _Routed(kernel.func.__name__)

    args = (jnp.zeros((3, 4, 4)), jnp.zeros((nv, 3)), jnp.zeros((nv, 3)), jnp.zeros((ns, 3)),
            jnp.zeros((ns, 3)), jnp.zeros(ns), jnp.ones(ns, bool))
    with mock.patch.object(pl, "pallas_call", record):
        with pytest.raises(_Routed) as info:
            jlcp.lcp_scores_pallas_segside.__wrapped__(*args, hb_lane_pack=hb_lane_pack)
    return str(info.value) == "_lcp_kernel_segside_hb"


@pytest.mark.parametrize("hb_lane_pack", [None, True, False])
def test_routing_rule_matches_jax(hb_lane_pack):
    for nv in (1, 100, 128, 129, 256, 257, 512, 1000, 4096):
        for ns in (1, 128, 256, 257, 768, 1024, 1500, 2048):
            assert lcp.uses_hypothesis_block(nv, ns, hb_lane_pack) == _jax_route(
                nv, ns, hb_lane_pack), (nv, ns, hb_lane_pack)
    # The benchmark's tiers: coarse -> hypothesis block, fine and exact -> per hypothesis.
    assert lcp.uses_hypothesis_block(256, 256)
    assert not lcp.uses_hypothesis_block(4096, 256)
    assert not lcp.uses_hypothesis_block(4096, 1024)


def test_high3_is_float32_grade_and_default_is_not(rng):
    # A tier silently computed in float32 fails the second half; a high3 tier
    # that is really "default" fails the first.
    # d^2-insensitive inputs: hypotheses exactly on or 3 delta off the truth,
    # no noise, so no point sits near the delta^2 threshold.
    case = list(make_case(rng, 400, 300, 8, 10, jitter=0.0))
    tfs, model, mn, seg_pts = case[:4]
    rot, tr = tfs[0, :3, :3], tfs[0, :3, 3]
    k = 300 - 300 // 5
    seg_pts[:k] = (seg_pts[:k] - tr) @ rot  # undo, then re-place without noise
    idx = np.argmin(((seg_pts[:k, None] - model[None]) ** 2).sum(-1), axis=1)
    seg_pts[:k] = model[idx] @ rot.T + tr
    tfs[4:, :3, 3] += 0.015
    tfs[-1] = tfs[0]
    targs = tuple(t(a) for a in case[:-1]) + (tb(case[-1]),)
    f32 = n(lcp.lcp_scores_plain(*targs))
    high3 = n(lcp.lcp_scores_plain(*targs, matmul_precision="high3"))
    assert f32[0] > 0.3
    np.testing.assert_allclose(high3, f32, atol=1e-6)

    # Scene-scale inputs (noise, jittered hypotheses): bf16 operands put
    # ~5e-5 of noise on d^2, twice delta^2, so "default" scores move.
    case = make_case(rng, 512, 200, 24, 12)
    _, targs = _both(case)
    f32 = n(lcp.lcp_scores_plain(*targs, weighted=False))
    low = n(lcp.lcp_scores_plain(*targs, weighted=False, matmul_precision="default"))
    assert np.abs(low - f32).max() >= 2.0 / 512
    high3 = n(lcp.lcp_scores_plain(*targs, weighted=False, matmul_precision="high3"))
    assert np.abs(high3 - f32).max() < np.abs(low - f32).max()


def test_hb_wrapper_takes_only_cuda_tensors_and_no_high3():
    tr12 = torch.zeros(4, 12)
    args = (tr12, torch.zeros(8, 3), torch.zeros(8, 3), torch.zeros(5, 8), 2.5e-5, 0.866, True)
    with pytest.raises(ValueError, match="CUDA"):
        lcp.lcp_segside_hb(*args)
    with pytest.raises(ValueError, match="high3"):
        lcp.lcp_segside_hb(*args, matmul_precision="high3")
    with pytest.raises(ValueError, match="matmul_precision"):
        lcp.lcp_scores(torch.zeros(1, 4, 4), *[torch.zeros(4, 3)] * 4, torch.zeros(4),
                       torch.ones(4, dtype=torch.bool), matmul_precision="bf16")


# ------------------------------------------- ragged shapes and constructed ties
# The cases chip_smoke.py holds kernel-against-plain on the card, held here
# plain-against-JAX: shapes that the CUDA kernel's tiling makes ragged, and
# exact ties of the nearest distance inside one chunk of 32 segment points, in
# two and in three chunks.


def twisted_case(rng, n_model, n_seg, n_hyp, n_masked, twist):
    """make_case with a twist: "all_masked", "masked_first" (the first third
    of the segment masked), or a tuple of row offsets at which the first 8
    segment points are placed again, with their own normals and
    probabilities."""
    case = make_case(rng, n_model, n_seg, n_hyp, n_masked)
    seg_pts, mask = case[3], case[6]
    if twist == "all_masked":
        mask[:] = False
    elif twist == "masked_first":
        mask[:] = True
        mask[: n_seg // 3] = False
    elif twist is not None:
        mask[:8] = True
        for offset in twist:
            seg_pts[offset:offset + 8] = seg_pts[:8]
            mask[offset:offset + 8] = True
    return case


# (Nv, Ns, H, masked, twist)
RAGGED = {
    "nv_off_tile_h1": (300, 200, 1, 12, None),
    "h33_nv77": (77, 90, 33, 9, None),
    "ns1": (128, 1, 5, 0, None),
    "ns1023": (900, 1023, 2, 30, None),
    "all_masked": (128, 100, 4, 0, "all_masked"),
    "masked_first": (200, 150, 6, 0, "masked_first"),
    "tie_one_chunk": (256, 128, 6, 5, (16,)),
    "tie_two_chunks": (256, 128, 6, 5, (40,)),
    "tie_three_chunks": (256, 128, 6, 5, (40, 70)),
}


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "unweighted"])
@pytest.mark.parametrize("precision", [None, "default", "high3"])
@pytest.mark.parametrize("name", list(RAGGED))
def test_plain_matches_tpu_kernel_interpret_on_ragged_and_tied_cases(rng, name, precision,
                                                                     weighted):
    # Per-hypothesis kernel, tolerance 2/Nv as above. The tie cases move the
    # weighted score by more than that when the tie rule is not applied
    # (checked below), so agreement holds the rule too.
    nv, ns, h, masked, twist = RAGGED[name]
    case = twisted_case(rng, nv, ns, h, masked, twist)
    jargs, targs = _both(case)
    want = _interpret_segside(jargs, weighted=weighted, matmul_precision=precision,
                              hb_lane_pack=False)
    got = n(lcp.lcp_scores_plain(*targs, weighted=weighted, matmul_precision=precision))
    assert got.shape == (h,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2.0 / nv)
    if twist == "all_masked":
        assert np.abs(got).max() == 0.0 and np.abs(want).max() == 0.0


@pytest.mark.parametrize("precision", [None, "default", "high3"])
@pytest.mark.parametrize("offsets", [(16,), (40,), (40, 70)],
                         ids=["one_chunk", "two_chunks", "three_chunks"])
def test_constructed_ties_take_max_prob_and_max_normal(offsets, precision):
    # One model point at the origin, identity pose. The nearest segment point
    # stands at row 0 and again at the offsets; the copies differ in
    # probability and normal. Every copy ties exactly in every tier (the same
    # operands), so the score is the largest probability among them, gated by
    # the best normal among them: both packages. The other points lie 9 cm or
    # more away.
    rng = np.random.default_rng(7)
    ns = 96
    seg = rng.uniform(0.05, 0.2, size=(ns, 3)).astype(np.float32)
    nrm = np.tile(np.array([[1.0, 0, 0]], np.float32), (ns, 1))
    prob = np.full(ns, 0.5, np.float32)
    rows = (0, *offsets)
    for r, p in zip(rows, (0.3, 0.9, 0.6)):
        seg[r] = [0.001, 0.002, 0.001]
        prob[r] = p
    nrm[rows[-1]] = [0, 0, 1]  # only the last copy's normal agrees with the model's
    tf = np.eye(4, dtype=np.float32)[None]
    model, mn = np.zeros((1, 3), np.float32), np.array([[0, 0, 1]], np.float32)
    case = (tf, model, mn, seg, nrm, prob, np.ones(ns, bool))
    jargs, targs = _both(case)
    # delta = 5 cm: the copies stay the nearest by far, and the bf16 operands
    # of "default" (about 1e-4 on d^2 at these coordinates) cannot push them
    # out of range.
    kw = dict(delta=0.05, matmul_precision=precision)
    want = _interpret_segside(jargs, hb_lane_pack=False, **kw)
    got = n(lcp.lcp_scores_plain(*targs, **kw))
    np.testing.assert_allclose(want, [0.9], atol=1e-6)
    np.testing.assert_allclose(got, [0.9], atol=1e-6)
    # Without the agreeing copy the gate closes: the tie rule decided the score.
    keep = np.ones(ns, bool)
    keep[rows[-1]] = False
    got = n(lcp.lcp_scores_plain(*targs[:-1], tb(keep), **kw))
    np.testing.assert_allclose(got, [0.0], atol=1e-6)
