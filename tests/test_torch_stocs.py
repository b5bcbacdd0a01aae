"""Port parity: ops/rigid_fit, ops/sampling, ops/congruent and
pipeline/hypothesis (stocs mode) with the JAX draws injected."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from _torch_common import n, t, tb
from physimglobalpose_tpu.config import PipelineConfig as JCfg, StoCSConfig as JSt
from physimglobalpose_tpu.ops import congruent as jcong, ppf as jppf, rigid_fit as jrf
from physimglobalpose_tpu.ops import sampling as jsamp
from physimglobalpose_tpu.pipeline import hypothesis as jhyp, selection as jsel
from physimglobalpose_tpu.pipeline.segmentation import Segment3D as JSeg
from physimglobalpose_tpu_torch.config import PipelineConfig, StoCSConfig
from physimglobalpose_tpu_torch.ops import congruent, ppf, rigid_fit, sampling
from physimglobalpose_tpu_torch.pipeline import hypothesis, selection
from physimglobalpose_tpu_torch.pipeline.segmentation import Segment3D
from test_stocs import box_model

ST = dict(num_bases=16, max_quads_per_base=16, max_pairs_per_ppf=64)


@pytest.fixture(scope="module")
def assets():
    rng = np.random.default_rng(7)
    mpts, mnrm = box_model(rng, n=200)
    return mpts, mnrm, jppf.build_ppf_table(mpts, mnrm), ppf.build_ppf_table(mpts, mnrm)


def make_segment(rng, mpts, mnrm, n_seg=160, n_pad=192):
    rot = Rotation.from_euler("xyz", [15, -25, 40], degrees=True).as_matrix().astype(np.float32)
    tr = np.array([0.02, -0.05, 0.65], np.float32)
    idx = rng.choice(len(mpts), size=n_seg, replace=False)
    pts = np.zeros((n_pad, 3), np.float32)
    nrm = np.zeros((n_pad, 3), np.float32)
    pts[:n_seg] = mpts[idx] @ rot.T + tr
    nrm[:n_seg] = mnrm[idx] @ rot.T
    mask = np.zeros(n_pad, bool)
    mask[:n_seg] = True
    prob = np.where(mask, rng.uniform(0.5, 1.0, size=n_pad), 0.0).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3], pose[:3, 3] = rot, tr
    return pts, nrm, prob, mask, pose


def test_try_quadrilateral_and_rigid_fit_match_jax(rng):
    base = rng.uniform(-0.1, 0.1, size=(50, 4, 3)).astype(np.float32)
    jp, ji1, ji2 = jrf.try_quadrilateral(jnp.asarray(base))
    tp, ti1, ti2 = rigid_fit.try_quadrilateral(t(base))
    # A split and its reversals / segment swap describe the same two segments
    # at the same distance, so a last-bit rounding difference may pick
    # another of them. Hold the segment pair and the crossing distance.
    jp, tp = np.asarray(jp), n(tp)
    assert (jp == tp).all(axis=1).mean() > 0.9

    def segments(perm):
        return [frozenset([frozenset(r[:2]), frozenset(r[2:])]) for r in perm.tolist()]

    def crossing(perm, i1, i2):
        q = np.take_along_axis(base, perm[..., None], axis=1)
        e1 = q[:, 0] + i1[:, None] * (q[:, 1] - q[:, 0])
        e2 = q[:, 2] + i2[:, None] * (q[:, 3] - q[:, 2])
        return np.linalg.norm(e1 - e2, axis=-1)

    assert segments(tp) == segments(jp)
    np.testing.assert_allclose(crossing(tp, n(ti1), n(ti2)),
                               crossing(jp, np.asarray(ji1), np.asarray(ji2)), atol=1e-6)
    p = base[:, :3]
    q = rng.uniform(-0.1, 0.1, size=(50, 3, 3)).astype(np.float32)
    q[:3, 1] = q[:3, 0]  # degenerate triples
    jt, jrms, jok = jrf.rigid_fit_3pt(jnp.asarray(p), jnp.asarray(q))
    tt, trms, tok = rigid_fit.rigid_fit_3pt(t(p), t(q))
    np.testing.assert_array_equal(n(tok), np.asarray(jok))
    np.testing.assert_allclose(n(tt), np.asarray(jt), atol=1e-5)
    np.testing.assert_allclose(n(trms), np.asarray(jrms), atol=1e-5)


def _bases_both(assets, rng, key):
    mpts, mnrm, jtab, ttab = assets
    pts, nrm, prob, mask, _ = make_segment(rng, mpts, mnrm)
    b = ST["num_bases"]
    jb = jsamp.sample_bases(key, jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(prob),
                            jnp.asarray(mask), jtab, num_bases=b)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (b, len(pts))))
                       for k in jax.random.split(key, 4)])
    tb_ = sampling.sample_bases(t(pts), t(nrm), t(prob), tb(mask), ttab, num_bases=b,
                                gumbel=t(gumbel))
    return (pts, nrm, prob, mask), jb, tb_


def test_sample_bases_with_injected_gumbel(assets, rng):
    _, jb, tb_ = _bases_both(assets, rng, jax.random.key(4))
    np.testing.assert_array_equal(n(tb_.valid), np.asarray(jb.valid))
    assert n(tb_.valid).sum() >= 8
    np.testing.assert_array_equal(n(tb_.indices), np.asarray(jb.indices))
    np.testing.assert_allclose(n(tb_.invariant1), np.asarray(jb.invariant1), atol=1e-5)
    np.testing.assert_allclose(n(tb_.invariant2), np.asarray(jb.invariant2), atol=1e-5)


def test_congruent_quads_with_injected_priority(assets, rng):
    mpts, _, jtab, ttab = assets
    (pts, nrm, _, _), jb, tb_ = _bases_both(assets, rng, jax.random.key(5))
    key = jax.random.key(6)
    kk = ST["max_pairs_per_ppf"]
    jq, jv = jcong.extract_congruent_quads(jb, jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(mpts),
                                           jtab, key, max_pairs=kk, max_quads_per_base=16)
    prio = jax.random.uniform(key, (ST["num_bases"], kk * kk))
    tq, tv = congruent.extract_congruent_quads(tb_, t(pts), t(nrm), t(mpts), ttab, max_pairs=kk,
                                               max_quads_per_base=16, priority=t(prio))
    jv, jq = np.asarray(jv), np.asarray(jq)
    np.testing.assert_array_equal(n(tv), jv)
    assert jv.sum() > 20
    np.testing.assert_array_equal(n(tq)[jv], jq[jv])  # valid quads exact
    jh = jcong.hypotheses_from_quads(jb, jnp.asarray(jq), jnp.asarray(jv), jnp.asarray(pts),
                                     jnp.asarray(mpts))
    th = congruent.hypotheses_from_quads(tb_, tq, tv, t(pts), t(mpts))
    valid = np.asarray(jh.valid)
    np.testing.assert_array_equal(n(th.valid), valid)
    np.testing.assert_allclose(n(th.transforms)[valid], np.asarray(jh.transforms)[valid], atol=1e-5)


def _jax_draws(key, b, n_seg, kk):
    k_base, k_quad = jax.random.split(key)
    gumbel = np.stack([np.asarray(jax.random.gumbel(k, (b, n_seg)))
                       for k in jax.random.split(k_base, 4)])
    return gumbel, np.asarray(jax.random.uniform(k_quad, (b, kk * kk)))


def test_generate_hypotheses_with_injected_draws(assets, rng):
    mpts, mnrm, jtab, ttab = assets
    pts, nrm, prob, mask, pose = make_segment(rng, mpts, mnrm)
    jcfg, cfg = JCfg(stocs=JSt(**ST)), PipelineConfig(stocs=StoCSConfig(**ST))
    key = jax.random.key(8)
    # Op by op (unjitted): XLA's fusion under jit rounds the [B, K, K]
    # congruence test differently at its thresholds; eager JAX and the port
    # round alike, so the valid set can be held exactly.
    want = jhyp.generate_hypotheses.__wrapped__(
        key, JSeg(*(jnp.asarray(a) for a in (pts, nrm, prob, mask))),
        jnp.asarray(mpts), jnp.ones(len(mpts), bool), jtab, jnp.asarray(mpts), jnp.asarray(mnrm),
        jcfg, use_pallas=False,
    )
    gumbel, qprio = _jax_draws(key, ST["num_bases"], len(pts), ST["max_pairs_per_ppf"])
    got = hypothesis.generate_hypotheses(
        Segment3D(t(pts), t(nrm), t(prob), tb(mask)), t(mpts), tb(np.ones(len(mpts), bool)),
        ttab, t(mpts), t(mnrm), cfg, gumbel=t(gumbel), quad_priority=t(qprio),
    )
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(n(got.valid), valid)
    np.testing.assert_allclose(n(got.scores), np.asarray(want.scores), atol=2.0 / len(mpts))
    np.testing.assert_allclose(n(got.best_transform), np.asarray(want.best_transform), atol=1e-4)
    assert float(got.best_score) > 0.3
    assert np.linalg.norm(n(got.best_transform)[:3, 3] - pose[:3, 3]) < 0.01
    # top-k and LCP selection follow the JAX ordering.
    jt, js = jhyp.top_k_hypotheses(want, 5)
    tt, ts = hypothesis.top_k_hypotheses(got, 5)
    np.testing.assert_allclose(n(ts), np.asarray(js), atol=2.0 / len(mpts))
    np.testing.assert_allclose(
        n(selection.lcp_select(got.best_transform, got.best_score)),
        np.asarray(jsel.lcp_select(want.best_transform, want.best_score)), atol=1e-4,
    )


def test_batch_matches_individual_and_jax(assets, rng):
    mpts, mnrm, jtab, ttab = assets
    cfg, jcfg = PipelineConfig(stocs=StoCSConfig(**ST)), JCfg(stocs=JSt(**ST))
    pts, nrm, prob, mask, _ = make_segment(rng, mpts, mnrm)
    segs = Segment3D(*(x[None].expand(2, *x.shape) for x in (t(pts), t(nrm), t(prob), tb(mask))))
    ones = tb(np.ones(len(mpts), bool))
    key = jax.random.key(9)
    keys = jax.random.split(key, 2)
    draws = [_jax_draws(k, ST["num_bases"], len(pts), ST["max_pairs_per_ppf"]) for k in keys]
    batch = hypothesis.generate_hypotheses_batch(
        segs, t(mpts)[None].expand(2, -1, -1), ones[None].expand(2, -1),
        hypothesis.stack_object_tables([ttab, ttab]), t(mpts)[None].expand(2, -1, -1),
        t(mnrm)[None].expand(2, -1, -1), cfg,
        gumbel=t(np.stack([d[0] for d in draws])), quad_priority=t(np.stack([d[1] for d in draws])),
    )
    jseg = JSeg(*(jnp.stack([jnp.asarray(a)] * 2) for a in (pts, nrm, prob, mask)))
    jbatch = jhyp.generate_hypotheses_batch(
        key, jseg, jnp.stack([jnp.asarray(mpts)] * 2), jnp.ones((2, len(mpts)), bool),
        jhyp.stack_object_tables([jtab, jtab]), jnp.stack([jnp.asarray(mpts)] * 2),
        jnp.stack([jnp.asarray(mnrm)] * 2), jcfg, use_pallas=False,
    )
    for i in range(2):
        single = hypothesis.generate_hypotheses(
            Segment3D(t(pts), t(nrm), t(prob), tb(mask)), t(mpts), ones, ttab, t(mpts), t(mnrm),
            cfg, gumbel=t(draws[i][0]), quad_priority=t(draws[i][1]),
        )
        np.testing.assert_array_equal(n(batch.scores[i]), n(single.scores))
        np.testing.assert_array_equal(n(batch.best_transform[i]), n(single.best_transform))
        np.testing.assert_allclose(n(batch.best_transform[i]), np.asarray(jbatch.best_transform[i]),
                                   atol=1e-4)
