"""Port parity: the other hypothesis generators and selections - classic
Super4PCS and V4PCS (ops/sampling.sample_bases_uniform, ops/congruent's
distance pair lists and classic / tetra quads), PPF voting
(ops/ppf_voting.py, hypothesis.generate_hypotheses_voting), the clustering
selection (selection.greedy_cluster_votes, cluster_select) and
ops/icp.icp_fitness - against the JAX functions, with the JAX draws injected.

Tolerances: indices, masks and vote counts exact; transforms within 1e-5
(and 2e-5 relative where a whole pipeline fits near-collinear triples);
LCP scores within 2 / Nv (the LCP tests' bar); cluster votes within 1e-5.
Jitted JAX functions are called op by op (__wrapped__) where a threshold
decides a set, as tests/test_torch_stocs.py does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree
from scipy.spatial.transform import Rotation

from _torch_common import n, t, tb
from physimglobalpose_tpu.config import PipelineConfig as JCfg, StoCSConfig as JSt
from physimglobalpose_tpu.ops import congruent as jcong, icp as jicp, ppf as jppf
from physimglobalpose_tpu.ops import ppf_voting as jvote, sampling as jsamp
from physimglobalpose_tpu.pipeline import hypothesis as jhyp, selection as jsel
from physimglobalpose_tpu.pipeline.segmentation import Segment3D as JSeg
from physimglobalpose_tpu_torch.config import PipelineConfig, StoCSConfig
from physimglobalpose_tpu_torch.ops import congruent, icp, ppf, ppf_voting, sampling
from physimglobalpose_tpu_torch.pipeline import hypothesis, selection
from physimglobalpose_tpu_torch.pipeline.segmentation import Segment3D
from test_icp import make_case
from test_stocs import box_model
from test_torch_stocs import make_segment

B, KP, Q = 16, 64, 16  # bases, pair-list cap, quads a base
ST = dict(num_bases=B, max_quads_per_base=Q, max_pairs_per_ppf=KP)


@pytest.fixture(scope="module")
def assets():
    mpts, mnrm = box_model(np.random.default_rng(7), n=200)
    return mpts, mnrm, jppf.build_ppf_table(mpts, mnrm), ppf.build_ppf_table(mpts, mnrm)


def _uniform_pairs(key, b, nm):
    """The JAX draws of extract_pairs_by_distance over a batch of b distances."""
    return np.stack([np.asarray(jax.random.uniform(k, (nm * nm,)))
                     for k in jax.random.split(key, b)])


def _uniform_bases_both(pts, mask, key, b=B):
    jb = jsamp.sample_bases_uniform(key, jnp.asarray(pts), jnp.asarray(mask), num_bases=b)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (b, len(pts))))
                       for k in jax.random.split(key, 4)])
    return jb, sampling.sample_bases_uniform(t(pts), tb(mask), num_bases=b, gumbel=t(gumbel))


def _same_split(jb, tb_, pts):
    """Rows of two BaseSets that hold the same four points split into the
    same two segments crossing at the same place. try_quadrilateral may pick
    another order of an equivalent split when a last bit differs
    (tests/test_torch_stocs.py), so the permutation itself is not held."""
    ji, ti = np.asarray(jb.indices), n(tb_.indices)

    def segments(perm):
        return [frozenset([frozenset(r[:2]), frozenset(r[2:])]) for r in perm.tolist()]

    def crossing(perm, i1, i2):
        q = pts[perm]
        e1 = q[:, 0] + i1[:, None] * (q[:, 1] - q[:, 0])
        e2 = q[:, 2] + i2[:, None] * (q[:, 3] - q[:, 2])
        return np.linalg.norm(e1 - e2, axis=-1)

    assert segments(ti) == segments(ji)
    np.testing.assert_allclose(crossing(ti, n(tb_.invariant1), n(tb_.invariant2)),
                               crossing(ji, np.asarray(jb.invariant1), np.asarray(jb.invariant2)),
                               atol=1e-6)
    return (ji == ti).all(axis=1)


def test_sample_bases_uniform_with_injected_gumbel(assets, rng):
    mpts, mnrm, _, _ = assets
    pts, _, _, mask, _ = make_segment(rng, mpts, mnrm)
    jb, tb_ = _uniform_bases_both(pts, mask, jax.random.key(3), b=64)
    valid = np.asarray(jb.valid)
    np.testing.assert_array_equal(n(tb_.valid), valid)
    assert valid.sum() >= 40
    assert _same_split(jb, tb_, pts).mean() > 0.9
    same = (np.asarray(jb.indices) == n(tb_.indices)).all(axis=1)
    np.testing.assert_allclose(n(tb_.invariant1)[same], np.asarray(jb.invariant1)[same], atol=1e-5)
    np.testing.assert_allclose(n(tb_.invariant2)[same], np.asarray(jb.invariant2)[same], atol=1e-5)
    # The masked rows (160 of 192 are live) are never picked.
    assert (n(tb_.indices) < 160).all()


def _as_port_bases(jb):
    return sampling.BaseSet(t(jb.indices, torch.int64), t(jb.invariant1), t(jb.invariant2),
                            tb(jb.valid))


@pytest.mark.parametrize("batched", [False, True])
def test_extract_pairs_by_distance_with_injected_priority(assets, batched):
    mpts = assets[0]
    nm = len(mpts)
    mask = np.ones(nm, bool)
    mask[-20:] = False  # padded model rows never pair
    key = jax.random.key(11)
    if batched:
        dist = np.array([0.03, 0.05, 0.08, 0.2], np.float32)
        prio = _uniform_pairs(key, len(dist), nm)
    else:
        dist = np.float32(0.05)
        prio = np.asarray(jax.random.uniform(key, (nm * nm,)))
    jp, jm = jcong.extract_pairs_by_distance(jnp.asarray(mpts), jnp.asarray(mask),
                                             jnp.asarray(dist), 0.01, key, KP)
    tp, tm = congruent.extract_pairs_by_distance(t(mpts), tb(mask), t(dist), 0.01, KP,
                                                 priority=t(prio))
    np.testing.assert_array_equal(n(tm), np.asarray(jm))
    np.testing.assert_array_equal(n(tp), np.asarray(jp))
    assert np.asarray(jm).sum() > KP // 2
    pairs = n(tp)[n(tm)]
    length = np.linalg.norm(mpts[pairs[:, 0]] - mpts[pairs[:, 1]], axis=-1)
    want_length = np.broadcast_to(np.asarray(dist)[..., None], n(tm).shape)[n(tm)]
    assert (pairs < nm - 20).all() and (pairs[:, 0] != pairs[:, 1]).all()
    assert np.abs(length - want_length).max() <= 0.01 + 1e-6


def _classic_draws(key, b, nm, kp):
    k1, k2, k_sel = jax.random.split(key, 3)
    return (np.stack([_uniform_pairs(k1, b, nm), _uniform_pairs(k2, b, nm)]),
            np.asarray(jax.random.uniform(k_sel, (b, kp * kp))))


@pytest.mark.parametrize("mode", ["classic", "tetra"])
def test_congruent_quads_by_distance_with_injected_draws(assets, rng, mode):
    mpts, mnrm, _, _ = assets
    pts, _, _, mask, _ = make_segment(rng, mpts, mnrm)
    # The JAX bases go to both packages: this holds the extraction alone.
    jb = jsamp.sample_bases_uniform(jax.random.key(5), jnp.asarray(pts), jnp.asarray(mask), B)
    tb_ = _as_port_bases(jb)
    mmask = np.ones(len(mpts), bool)
    key = jax.random.key(6)
    jfn = jcong.extract_congruent_quads_classic if mode == "classic" else \
        jcong.extract_congruent_quads_tetra
    tfn = congruent.extract_congruent_quads_classic if mode == "classic" else \
        congruent.extract_congruent_quads_tetra
    jq, jv = jfn(jb, jnp.asarray(pts), jnp.asarray(mpts), jnp.asarray(mmask), key,
                 max_pairs=KP, max_quads_per_base=Q)
    pair_prio, sel_prio = _classic_draws(key, B, len(mpts), KP)
    tq, tv = tfn(tb_, t(pts), t(mpts), tb(mmask), max_pairs=KP, max_quads_per_base=Q,
                 pair_priority=t(pair_prio), priority=t(sel_prio))
    jv, jq = np.asarray(jv), np.asarray(jq)
    np.testing.assert_array_equal(n(tv), jv)
    assert jv.sum() > 20
    np.testing.assert_array_equal(n(tq)[jv], jq[jv])
    jh = jcong.hypotheses_from_quads(jb, jnp.asarray(jq), jnp.asarray(jv), jnp.asarray(pts),
                                     jnp.asarray(mpts))
    th = congruent.hypotheses_from_quads(tb_, tq, tv, t(pts), t(mpts))
    valid = np.asarray(jh.valid)
    np.testing.assert_array_equal(n(th.valid), valid)
    np.testing.assert_allclose(n(th.transforms)[valid], np.asarray(jh.transforms)[valid], atol=1e-5)


@pytest.mark.parametrize("mode", ["super4pcs", "v4pcs"])
def test_generate_hypotheses_modes_with_injected_draws(assets, rng, mode):
    mpts, mnrm, jtab, ttab = assets
    pts, nrm, prob, mask, _ = make_segment(rng, mpts, mnrm)
    jcfg, cfg = JCfg(stocs=JSt(**ST)), PipelineConfig(stocs=StoCSConfig(**ST))
    key = jax.random.key(8)
    want = jhyp.generate_hypotheses.__wrapped__(
        key, JSeg(*(jnp.asarray(a) for a in (pts, nrm, prob, mask))),
        jnp.asarray(mpts), jnp.ones(len(mpts), bool), jtab, jnp.asarray(mpts), jnp.asarray(mnrm),
        jcfg, use_pallas=False, mode=mode,
    )
    k_base, k_quad = jax.random.split(key)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (B, len(pts))))
                       for k in jax.random.split(k_base, 4)])
    pair_prio, sel_prio = _classic_draws(k_quad, B, len(mpts), KP)
    got = hypothesis.generate_hypotheses(
        Segment3D(t(pts), t(nrm), t(prob), tb(mask)), t(mpts), tb(np.ones(len(mpts), bool)),
        ttab, t(mpts), t(mnrm), cfg, gumbel=t(gumbel), quad_priority=t(sel_prio), mode=mode,
        pair_priority=t(pair_prio),
    )
    # Hypotheses are base-major; a base whose split try_quadrilateral orders
    # otherwise (a last-bit tie) draws other pair lists, so rows are held
    # where the base is the same, and the best score over all of them.
    jbases = jsamp.sample_bases_uniform(k_base, jnp.asarray(pts), jnp.asarray(mask), B,
                                        min_spread=jcfg.stocs.min_point_spacing)
    tbases = sampling.sample_bases_uniform(t(pts), tb(mask), B, gumbel=t(gumbel))
    rows = np.repeat(_same_split(jbases, tbases, pts), Q)
    assert rows.mean() > 0.9
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(n(got.valid)[rows], valid[rows])
    assert valid[rows].sum() > 20
    # A fit on a near-collinear triple moves the last bits of its
    # translation (~0.6 m) by up to ~2e-5 relative.
    np.testing.assert_allclose(n(got.transforms)[rows & valid],
                               np.asarray(want.transforms)[rows & valid], rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(n(got.scores)[rows], np.asarray(want.scores)[rows],
                               atol=2.0 / len(mpts))
    assert abs(float(got.best_score) - float(want.best_score)) <= 2.0 / len(mpts)
    if rows[int(np.argmax(np.asarray(want.scores)))]:
        np.testing.assert_allclose(n(got.best_transform), np.asarray(want.best_transform),
                                   rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("mode", ["super4pcs", "v4pcs"])
def test_generate_hypotheses_modes_recover_pose(rng, mode):
    # tests/test_stocs.py::test_v4pcs_mode_recovers_pose on the port, with the
    # port's own draws, in both distance-matched modes.
    mpts, mnrm = box_model(np.random.default_rng(7), n=200)
    ttab = ppf.build_ppf_table(mpts, mnrm)
    pts, nrm, _, mask, true_pose = make_segment(rng, mpts, mnrm, n_pad=256)
    cfg = PipelineConfig(stocs=StoCSConfig(num_bases=64, max_quads_per_base=32,
                                           max_pairs_per_ppf=128))
    res = hypothesis.generate_hypotheses(
        Segment3D(t(pts), t(nrm), t(mask.astype(np.float32)), tb(mask)), t(mpts),
        tb(np.ones(len(mpts), bool)), ttab, t(mpts), t(mnrm), cfg,
        generator=torch.Generator().manual_seed(7), mode=mode,
    )
    assert bool(res.enough_points) and float(res.best_score) > 0.15
    best = n(res.best_transform)
    d, _ = cKDTree(mpts @ true_pose[:3, :3].T + true_pose[:3, 3]).query(
        mpts @ best[:3, :3].T + best[:3, 3])
    assert np.mean(d) < 0.01


def test_generate_hypotheses_rejects_unknown_mode(assets, rng):
    mpts, mnrm, _, ttab = assets
    pts, nrm, prob, mask, _ = make_segment(rng, mpts, mnrm)
    with pytest.raises(ValueError, match="generation mode"):
        hypothesis.generate_hypotheses(
            Segment3D(t(pts), t(nrm), t(prob), tb(mask)), t(mpts), tb(np.ones(len(mpts), bool)),
            ttab, t(mpts), t(mnrm), mode="hough",
        )


# ---------------------------------------------------------------- PPF voting


def test_canonical_frame_matches_jax(rng):
    p = rng.normal(size=(8, 3)).astype(np.float32)
    nv = rng.normal(size=(8, 3)).astype(np.float32)
    nv[:2] = [[1.0, 0, 0], [-1.0, 0, 0]]  # the degenerate axes
    want = np.asarray(jvote.canonical_frame(jnp.asarray(p), jnp.asarray(nv)))
    got = n(ppf_voting.canonical_frame(t(p), t(nv)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    unit = nv / np.linalg.norm(nv, axis=1, keepdims=True)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", got[:, :3, :3], unit), [[1, 0, 0]] * 8,
                               atol=1e-5)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", got[:, :3, :3], p) + got[:, :3, 3], 0,
                               atol=1e-5)
    partner = rng.normal(size=(8, 3)).astype(np.float32)
    np.testing.assert_allclose(n(ppf_voting._alpha_of(t(got), t(partner))),
                               np.asarray(jvote._alpha_of(jnp.asarray(want), jnp.asarray(partner))),
                               atol=1e-5)


def _vote_case(n_model=160):
    mpts, mnrm = box_model(np.random.default_rng(3), n=n_model)
    rot = Rotation.from_euler("xyz", [25, -35, 55], degrees=True).as_matrix().astype(np.float32)
    tr = np.array([0.05, -0.1, 0.7], np.float32)
    return mpts, mnrm, mpts @ rot.T + tr, mnrm @ rot.T


def _votes_both(mpts, mnrm, seg_pts, seg_nrm, seg_mask, key, **kw):
    jtab, ttab = jppf.build_ppf_table(mpts, mnrm), ppf.build_ppf_table(mpts, mnrm)
    mmask = np.ones(len(mpts), bool)
    want = jvote.ppf_vote.__wrapped__(
        key, jnp.asarray(seg_pts), jnp.asarray(seg_nrm), jnp.asarray(seg_mask),
        jnp.asarray(mpts), jnp.asarray(mnrm), jnp.asarray(mmask), jtab, **kw)
    g = np.asarray(jax.random.gumbel(jax.random.split(key, 1)[0], (kw["n_ref"], len(seg_pts))))
    got = ppf_voting.ppf_vote(t(seg_pts), t(seg_nrm), tb(seg_mask), t(mpts), t(mnrm), tb(mmask),
                              ttab, gumbel=t(g), **kw)
    return want, got


def test_ppf_vote_with_injected_gumbel_matches_jax():
    mpts, mnrm, seg_pts, seg_nrm = _vote_case()
    mask = np.ones(len(seg_pts), bool)
    mask[::7] = False
    want, got = _votes_both(mpts, mnrm, seg_pts, seg_nrm, mask, jax.random.key(0),
                            n_ref=24, max_pairs=16, top_poses=32)
    np.testing.assert_array_equal(n(got.votes), np.asarray(want.votes))
    np.testing.assert_array_equal(n(got.valid), np.asarray(want.valid))
    np.testing.assert_allclose(n(got.transforms), np.asarray(want.transforms), atol=1e-5)
    assert int(got.votes[0]) > 3
    # At least one top pose aligns the model with the scene
    # (tests/test_ppf_voting.py::test_voting_recovers_pose).
    tree = cKDTree(seg_pts)
    best = min(float(np.mean(tree.query(mpts @ tf[:3, :3].T + tf[:3, 3])[0]))
               for tf in n(got.transforms)[:16])
    assert best < 0.01, best


def test_ppf_vote_ties_keep_jax_order():
    # A small scene and few reference points: the 2,560-entry vote table
    # holds only small counts, so the top 96 poses cross long runs of tied
    # counts, which JAX's top_k orders by index.
    mpts, mnrm, seg_pts, seg_nrm = _vote_case(n_model=40)
    want, got = _votes_both(mpts, mnrm, seg_pts, seg_nrm, np.ones(len(seg_pts), bool),
                            jax.random.key(4), n_ref=2, max_pairs=4, n_alpha=32, top_poses=96)
    votes = n(got.votes)
    assert (votes[1:] == votes[:-1]).sum() > 60
    np.testing.assert_array_equal(votes, np.asarray(want.votes))
    np.testing.assert_allclose(n(got.transforms), np.asarray(want.transforms), atol=1e-5)


def test_generate_hypotheses_voting_with_injected_gumbel(assets, rng):
    mpts, mnrm, jtab, ttab = assets
    pts, nrm, prob, mask, pose = make_segment(rng, mpts, mnrm)
    jcfg, cfg = JCfg(stocs=JSt(**ST)), PipelineConfig(stocs=StoCSConfig(**ST))
    key = jax.random.key(9)
    ones = np.ones(len(mpts), bool)
    want = jhyp.generate_hypotheses_voting.__wrapped__(
        key, JSeg(*(jnp.asarray(a) for a in (pts, nrm, prob, mask))), jnp.asarray(mpts),
        jnp.asarray(mnrm), jnp.asarray(ones), jtab, jnp.asarray(mpts), jnp.asarray(mnrm), jcfg,
        use_pallas=False,
    )
    g = np.asarray(jax.random.gumbel(jax.random.split(key, 1)[0], (64, len(pts))))
    got = hypothesis.generate_hypotheses_voting(
        Segment3D(t(pts), t(nrm), t(prob), tb(mask)), t(mpts), t(mnrm), tb(ones), ttab, t(mpts),
        t(mnrm), cfg, gumbel=t(g),
    )
    assert got.transforms.shape == (256, 4, 4)
    np.testing.assert_array_equal(n(got.valid), np.asarray(want.valid))
    np.testing.assert_allclose(n(got.transforms), np.asarray(want.transforms), atol=1e-5)
    np.testing.assert_allclose(n(got.scores), np.asarray(want.scores), atol=2.0 / len(mpts))
    np.testing.assert_allclose(n(got.best_transform), np.asarray(want.best_transform), atol=1e-4)
    assert np.linalg.norm(n(got.best_transform)[:3, 3] - pose[:3, 3]) < 0.01


# ---------------------------------------------------------------- selection, fitness


def mk(rot_deg, tr):
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = Rotation.from_euler("xyz", rot_deg, degrees=True).as_matrix()
    pose[:3, 3] = tr
    return pose


def _votes_both_packages(tfs, scores, sym):
    jv, jk = jsel.greedy_cluster_votes(jnp.asarray(tfs), jnp.asarray(scores), jnp.asarray(sym))
    tv, tk = selection.greedy_cluster_votes(t(tfs), t(scores), t(sym))
    np.testing.assert_array_equal(n(tk), np.asarray(jk))
    np.testing.assert_allclose(n(tv), np.asarray(jv), atol=1e-5)
    return n(tv), n(tk)


def test_cluster_votes_prefer_consensus():
    a = [mk([10, 0, 0], [0.1, 0.0, 0.5]), mk([12, 0, 0], [0.105, 0.0, 0.5]),
         mk([9, 1, 0], [0.1, 0.005, 0.5])]
    b = [mk([80, 40, 0], [0.3, 0.2, 0.7]), mk([-60, 10, 90], [0.0, -0.2, 0.4])]
    tfs = np.stack(a + b)
    scores = np.array([0.5, 0.55, 0.52, 0.6, 0.58], np.float32)
    votes, keep = _votes_both_packages(tfs, scores, np.zeros(3, np.float32))
    assert keep.all() and votes[:3].max() > votes[3:].max()
    best = n(selection.cluster_select(t(tfs), t(scores), t(np.zeros(3))))
    want = np.asarray(jsel.cluster_select(jnp.asarray(tfs), jnp.asarray(scores), jnp.zeros(3)))
    np.testing.assert_array_equal(best, want)
    assert np.linalg.norm(best[:3, 3] - [0.1, 0.0, 0.5]) < 0.02


def test_cluster_prune_factor():
    tfs = np.stack([mk([0, 0, 0], [0, 0, 0.5])] * 3)
    _, keep = _votes_both_packages(tfs, np.array([1.0, 0.3, 0.9], np.float32), np.zeros(3, np.float32))
    assert keep[0] and keep[2] and not keep[1]


def test_symmetry_aware_clustering():
    tfs = np.stack([mk([0, 0, 0], [0.1, 0, 0.5]), mk([0, 0, 180], [0.1, 0, 0.5])])
    scores = np.ones(2, np.float32)
    v_sym, _ = _votes_both_packages(tfs, scores, np.array([0, 0, 180], np.float32))
    v_nosym, _ = _votes_both_packages(tfs, scores, np.zeros(3, np.float32))
    assert v_sym[0] > v_nosym[0]


def test_cluster_votes_on_random_hypotheses(rng):
    # Many hypotheses around two poses: every pair's fold and distance test.
    base = [mk([10, 20, 30], [0.1, 0.0, 0.5]), mk([0, 0, 170], [0.12, 0.01, 0.5])]
    tfs = np.stack([
        mk(np.array([10, 20, 30]) * (i % 2) + np.array([0, 0, 170]) * (1 - i % 2)
           + rng.normal(0, 6, 3), base[i % 2][:3, 3] + rng.normal(0, 0.01, 3))
        for i in range(40)])
    scores = rng.uniform(0.2, 1.0, 40).astype(np.float32)
    for sym in ([0, 0, 0], [180, 180, 180], [0, 90, 360]):
        _votes_both_packages(tfs, scores, np.array(sym, np.float32))
    np.testing.assert_array_equal(
        n(selection.cluster_select(t(tfs), t(scores), t(np.zeros(3)))),
        np.asarray(jsel.cluster_select(jnp.asarray(tfs), jnp.asarray(scores), jnp.zeros(3))))


def test_icp_fitness_matches_jax(rng):
    model, _, seg, true_pose, init = make_case(rng)
    mask = np.ones(len(seg), bool)
    mask[:30] = False
    tfs = np.stack([true_pose, np.eye(4, dtype=np.float32), init])
    want = np.asarray(jicp.icp_fitness(jnp.asarray(tfs), jnp.asarray(model), jnp.asarray(seg),
                                       jnp.asarray(mask)))
    got = n(icp.icp_fitness(t(tfs), t(model), t(seg), tb(mask)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got[0] > 0.9 and got[1] < 0.2
