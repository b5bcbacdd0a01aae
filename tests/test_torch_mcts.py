"""The port's physics-aware search (physimglobalpose_tpu_torch/pipeline/mcts.py,
greedy_search.py) and the table refinement that feeds it
(pipeline/scene.refine_table_pose_from_depth), on the CPU, against the JAX
package on tests/test_mcts.py's decoy scene, tests/test_mcts_stacked.py's
stack and tests/test_mcts_tricp.py's cases.

Tolerances: leaf costs within 2 pixels, settled poses within 1e-4 m (and
1e-3 rad); the search picks the same assignment with the same best cost.
Every search budget here ends far before max_search_seconds."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import n, t, tb
from physimglobalpose_tpu import config as jconfig
from physimglobalpose_tpu.ops import raster as jraster
from physimglobalpose_tpu.pipeline import greedy_search as jgreedy, mcts as jmcts
from physimglobalpose_tpu.pipeline import scene as jscene
from physimglobalpose_tpu_torch import config as tconfig
from physimglobalpose_tpu_torch.models import assets
from physimglobalpose_tpu_torch.pipeline import greedy_search, mcts, scene
from physimglobalpose_tpu_torch.pipeline.api import ObjectPoseEstimate
from physimglobalpose_tpu_torch.utils import tracing

K_INTR = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], dtype=np.float32)
H, W = 120, 160
TOL_COST = 2.0  # pixels a leaf
TOL_POS = 1e-4  # m


def _cfgs(physics_kw=None, **mcts_kw):
    """The same configuration in both packages."""
    def make(mod):
        return mod.PipelineConfig(
            render=mod.RenderConfig(width=W, height=H),
            physics=mod.PhysicsConfig(**(physics_kw or dict(steps=30))),
            mcts=mod.MCTSConfig(**mcts_kw),
        )
    return make(tconfig), make(jconfig)


def box_cloud(n_pts=600, size=0.06, seed=0):
    rng = np.random.default_rng(seed)
    faces = rng.integers(0, 6, n_pts)
    u, v = rng.uniform(-0.5, 0.5, (2, n_pts))
    pts = np.zeros((n_pts, 3), np.float32)
    for i, f in enumerate(faces):
        ax, sign = f // 2, 1 if f % 2 == 0 else -1
        dims = [d for d in range(3) if d != ax]
        pts[i, ax] = sign * size / 2
        pts[i, dims[0]] = u[i] * size
        pts[i, dims[1]] = v[i] * size
    return pts


def box_object(size, n_render=600, seed=0):
    s = size / 2
    eqs = np.tile(np.array([0, 0, 1, -1e9], np.float32), (96, 1))
    eqs[:6] = [[1, 0, 0, -s], [-1, 0, 0, -s], [0, 1, 0, -s], [0, -1, 0, -s], [0, 0, 1, -s],
               [0, 0, -1, -s]]
    return dict(
        hull_pts=np.array([[x, y, z] for x in (-s, s) for y in (-s, s) for z in (-s, s)],
                          np.float32),
        hull_mask=np.ones(8, bool), hull_eqs=eqs,
        render_pts=box_cloud(n_render, size, seed), render_mask=np.ones(n_render, bool),
    )


def pose_at(x, y, z):
    p = np.eye(4, dtype=np.float32)
    p[:3, 3] = [x, y, z]
    return p


def _rot_z(deg):
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    r = np.eye(4, dtype=np.float32)
    r[:2, :2] = [[c, -s], [s, c]]
    return r


def render_obs(objs_poses, radius=1):
    obs = np.zeros((H, W), np.float32)
    for obj, pose in objs_poses:
        d = jraster.render_object_depth(
            jnp.asarray(pose), jnp.asarray(obj["render_pts"]), jnp.asarray(obj["render_mask"]),
            jnp.asarray(K_INTR), H, W, radius=radius)
        obs = np.asarray(jraster.composite_min(jnp.asarray(obs), d))
    return obs


@pytest.fixture(scope="module")
def decoy():
    """tests/test_mcts.py's scene: one 6 cm box at rest at z 0.89 over a table
    whose top is at 0.86, world == camera."""
    obj = box_object(0.06)
    true_pose = pose_at(0.0, 0.0, 0.89)
    table_pose = pose_at(0.0, 0.0, 0.66)
    return dict(obj=obj, obs=render_obs([(obj, true_pose)]), true_pose=true_pose,
                table_pose=table_pose, cam_pose=np.eye(4, dtype=np.float32))


def evaluators(s, objs, hyps, cfgs, **kw):
    tcfg, jcfg = cfgs
    args = (objs, hyps, s["obs"], K_INTR, s["cam_pose"], s["table_pose"])
    return (mcts.BatchedLeafEvaluator(*args, tcfg, device="cpu", **kw),
            jmcts.BatchedLeafEvaluator(*args, jcfg, **kw))


def decoy_hyps(s):
    decoy = pose_at(0.07, 0.05, 0.89)
    decoy2 = pose_at(-0.06, 0.03, 0.95)
    return np.stack([decoy, s["true_pose"], decoy2])[None]  # the truth at slot 1


def assert_leaves_close(got, want):
    (c_t, s_t), (c_j, s_j) = got, want
    assert np.abs(c_t - np.asarray(c_j)).max() <= TOL_COST, (c_t, c_j)
    s_j = np.asarray(s_j)
    assert np.abs(s_t[..., :3, 3] - s_j[..., :3, 3]).max() < TOL_POS
    assert np.abs(s_t[..., :3, :3] - s_j[..., :3, :3]).max() < 1e-3


# ------------------------------------------------------------- leaf evaluator


def test_evaluator_matches_jax_and_prefers_true_pose(decoy):
    s = decoy
    wrong = pose_at(0.06, 0.04, 0.89)
    hyps = np.stack([s["true_pose"], wrong])[None]
    ev, jev = evaluators(s, [s["obj"]], hyps, _cfgs(leaf_batch=4, branching=3), render_scale=1)
    choices, active = np.array([[0], [1]]), np.ones((2, 1), bool)
    costs, settled = ev.evaluate(choices, active)
    assert_leaves_close((costs, settled), jev.evaluate(choices, active))
    assert costs[0] < costs[1]
    assert np.linalg.norm(settled[0, 0][:3, 3] - s["true_pose"][:3, 3]) < 0.04


@pytest.mark.parametrize("sequential", [True, False])
def test_evaluator_matches_jax_on_partial_rows(decoy, sequential):
    # Two objects over hypotheses that overlap and fall onto each other, rows
    # with one, two or no object placed, at the search's render scale 4.
    s = decoy
    rng = np.random.default_rng(0)
    hyps = np.tile(np.eye(4, dtype=np.float32), (2, 4, 1, 1))
    hyps[:, :, :3, 3] = np.c_[rng.uniform(-0.04, 0.04, (8, 2)), rng.uniform(0.9, 0.97, 8)].reshape(2, 4, 3)
    hyps[1, :, :3, :3] = _rot_z(25.0)[:3, :3]
    objs = [s["obj"], box_object(0.05, seed=3)]
    cfgs = _cfgs(leaf_batch=4, branching=4, sequential_settle=sequential)
    ev, jev = evaluators(s, objs, hyps, cfgs)
    choices = np.array([[0, 1], [2, -1], [-1, 3], [3, 0], [-1, -1], [1, 1]])
    got = ev.evaluate(choices, choices >= 0)
    assert_leaves_close(got, jev.evaluate(choices, choices >= 0))
    # A row with nothing placed keeps the (clipped) hypothesis-0 poses.
    np.testing.assert_allclose(got[1][4], hyps[:, 0], atol=1e-6)


def test_unplaced_object_does_not_collide(decoy):
    s = decoy
    blocker, placed = pose_at(0.0, 0.0, 0.89), pose_at(0.0, 0.0, 0.97)
    hyps = np.stack([np.stack([blocker, blocker]), np.stack([placed, placed])])
    ev, jev = evaluators(s, [s["obj"], s["obj"]], hyps, _cfgs(leaf_batch=4, branching=3),
                         render_scale=1)
    choices = np.array([[-1, 0]])
    got = ev.evaluate(choices, choices >= 0)
    assert_leaves_close(got, jev.evaluate(choices, choices >= 0))
    np.testing.assert_allclose(got[1][0, 1][2, 3], 0.89, atol=0.02)


def test_decimate_contact_hull_matches_jax():
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(300, 3)).astype(np.float32) * [0.04, 0.03, 0.05]
    hull = assets.convex_hull_points(pts, 64)
    h = dict(hull_pts=hull, hull_mask=np.ones(len(hull), bool),
             hull_eqs=assets.convex_hull_planes(hull), render_pts=pts)
    got = mcts._decimate_contact_hull(h, 16)
    want = jmcts._decimate_contact_hull(h, 16)
    for key in ("hull_pts", "hull_mask", "hull_eqs"):
        np.testing.assert_array_equal(got[key], want[key])
    # The shifted faces circumscribe every original vertex.
    eqs = got["hull_eqs"]
    assert (pts @ eqs[:, :3].T + eqs[:, 3] <= 1e-6).all()
    assert mcts._decimate_contact_hull(h, 64) is h


def test_evaluate_async_reads_nothing_back(decoy, monkeypatch):
    # The search's overlap rests on evaluate_async queueing work only.
    s = decoy
    ev, _ = evaluators(s, [s["obj"]], decoy_hyps(s), _cfgs(leaf_batch=4, branching=3))

    def no_host_read(*a, **k):
        raise AssertionError("evaluate_async read a device value")

    for name in ("item", "tolist", "cpu", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, no_host_read)
    costs, settled = ev.evaluate_async(np.array([[1], [0]]), np.ones((2, 1), bool))
    monkeypatch.undo()
    assert costs.shape == (2,) and settled.shape == (2, 1, 4, 4)


def test_search_entry_points_need_a_card_unless_asked_for_the_cpu(decoy):
    s = decoy
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = ([s["obj"]], decoy_hyps(s), s["obs"], K_INTR, s["cam_pose"], s["table_pose"],
            _cfgs()[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        mcts.BatchedLeafEvaluator(*args)
    assert mcts.BatchedLeafEvaluator(*args, device="cpu").device.type == "cpu"


# ---------------------------------------------------------------- the tree


def test_uct_search_matches_jax(decoy):
    s = decoy
    cfgs = _cfgs(leaf_batch=4, branching=3, max_search_seconds=600.0)
    ev, jev = evaluators(s, [s["obj"]], decoy_hyps(s), cfgs, render_scale=1)
    hyp_scores = np.array([[0.9, 0.5, 0.8]], np.float32)  # the decoy ranks first by LCP
    stats = {}
    assign, best = mcts.uct_search(ev, hyp_scores, cfgs[0], seed=0, max_iterations=10,
                                   stats=stats)
    j_assign, j_best = jmcts.uct_search(jev, hyp_scores, cfgs[1], seed=0, max_iterations=10)
    assert assign[0] == 1
    np.testing.assert_array_equal(assign, j_assign)
    assert abs(best - j_best) <= TOL_COST
    # Budget 1 + 3 (one object, three children), under the cap of 10.
    assert stats["search_budget"] == 4 and 0 < stats["search_expansions"] <= 4
    assert stats["search_deadline_cut"] is False


def test_uct_search_two_objects_matches_jax(decoy):
    # A deeper tree (k 2, c 4, budget 21 in batches of 8 with two in flight,
    # padded rows and cached terminals): the same choices from the same costs.
    s = decoy
    objs = [s["obj"], box_object(0.05, seed=3)]
    truth_b = pose_at(0.09, -0.02, 0.885)
    s2 = dict(s, obs=render_obs([(objs[0], s["true_pose"]), (objs[1], truth_b)]))
    rng = np.random.default_rng(1)
    hyps = np.tile(np.eye(4, dtype=np.float32), (2, 4, 1, 1))
    hyps[0, :, :3, 3] = s["true_pose"][:3, 3] + np.c_[rng.uniform(-0.05, 0.05, (4, 2)), np.zeros(4)]
    hyps[1, :, :3, 3] = truth_b[:3, 3] + np.c_[rng.uniform(-0.05, 0.05, (4, 2)), np.zeros(4)]
    hyps[0, 2], hyps[1, 1] = s["true_pose"], truth_b
    cfgs = _cfgs(leaf_batch=8, branching=4, max_search_seconds=600.0)
    ev, jev = evaluators(s2, objs, hyps, cfgs)
    hyp_scores = rng.uniform(0.3, 0.9, (2, 4)).astype(np.float32)
    got = mcts.uct_search(ev, hyp_scores, cfgs[0], seed=3)
    want = jmcts.uct_search(jev, hyp_scores, cfgs[1], seed=3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[0], [2, 1])
    assert abs(got[1] - want[1]) <= TOL_COST


def test_search_counts_the_leaf_batches_it_collected(decoy, monkeypatch):
    # Batches of 2 with one in flight and cached terminals (budget 4 under a
    # cap of 10): stats and the caller's span count what _collect_batch
    # handed the evaluator; each round is a span of its own.
    s = decoy
    cfgs = _cfgs(leaf_batch=2, branching=3, max_search_seconds=600.0)
    ev = mcts.BatchedLeafEvaluator([s["obj"]], decoy_hyps(s), s["obs"], K_INTR, s["cam_pose"],
                                   s["table_pose"], cfgs[0], device="cpu", render_scale=1)
    collected, orig = [], mcts._collect_batch
    monkeypatch.setattr(mcts, "_collect_batch",
                        lambda *a: collected.append(orig(*a)) or collected[-1])
    stats = {}
    with tracing.span("search") as search:
        mcts.uct_search(ev, np.array([[0.9, 0.5, 0.8]], np.float32), cfgs[0], seed=0,
                        max_iterations=10, stats=stats)
    batches = [p for p in collected if p]
    assert stats["search_leaf_batches"] == len(batches) >= 2
    assert stats["search_leaves"] == sum(map(len, batches))
    # Each batch is queued padded to the batch size of 2.
    assert search.counts == {"leaf_batches": len(batches), "leaves": stats["search_leaves"],
                             "leaf_rows": 2 * len(batches)}
    assert len(search.find_all("search.leaf_eval")) == len(batches)
    assert len(search.find_all("search.backup")) == len(batches)
    assert len(search.find_all("search.collect")) == len(collected)


@pytest.mark.parametrize("search,with_segs", [("uct", True), ("greedy", True), ("uct", False)])
def test_mcts_select_spans_its_final_pass(decoy, search, with_segs):
    # Under the caller's search span: the rounds (the UCT search's), then
    # search.final once, last, with the final pass inside it.
    s = decoy
    tcfg, _ = _cfgs(leaf_batch=4, branching=3, max_search_seconds=600.0, max_expansions=12)
    obj = s["obj"]
    db = {"box": types.SimpleNamespace(
        hull_pts=obj["hull_pts"], hull_mask=obj["hull_mask"], hull_eqs=obj["hull_eqs"],
        validation_pts=obj["render_pts"], validation_nrm=np.zeros_like(obj["render_pts"]))}
    sc = types.SimpleNamespace(intrinsics=K_INTR, cam_pose=s["cam_pose"], scene_dir="/scenes/decoy")
    hyps = decoy_hyps(s)[0]
    est = [ObjectPoseEstimate(name="box", pose_cam=hyps[0], pose_world=hyps[0], score=0.9,
                              hypotheses=hyps, hypothesis_scores=np.array([0.9, 0.5, 0.8], np.float32))]
    seg_pts, seg_mask = _seg_of(obj["render_pts"], s["true_pose"])
    segs = [types.SimpleNamespace(pts=seg_pts, mask=seg_mask)] if with_segs else None
    with tracing.span("search") as sp:
        got = mcts.mcts_select(est, sc, db, s["table_pose"], s["obs"], tcfg, seed=3, search=search,
                               segs=segs, device="cpu")
    names = [c.name for c in sp.children]
    assert names[-1] == "search.final" and names.count("search.final") == 1
    assert ("search.leaf_eval" in names) == (search == "uct")
    final = sp.find("search.final")
    assert 0.0 < final.duration < sp.duration
    assert np.linalg.norm(got[0].pose_world[:3, 3] - s["true_pose"][:3, 3]) < 0.01


def test_mcts_select_queues_each_leaf_batch_through_the_scene_evaluator(decoy, monkeypatch):
    # The benchmark's leaf check (gpubench/tests/test_gpubench_search_leaves.py)
    # hooks BatchedLeafEvaluator.__init__ and evaluate_async(choices, active):
    # the one-scene search builds one such evaluator and queues every leaf
    # batch it counts through it, on the scene's own constants (no leading
    # row axis, no per-row gather of stacked scenes).
    from physimglobalpose_tpu_torch.ops import physics

    s = decoy
    tcfg, _ = _cfgs(leaf_batch=4, branching=3, max_search_seconds=600.0, max_expansions=12)
    obj = s["obj"]
    db = {"box": types.SimpleNamespace(
        hull_pts=obj["hull_pts"], hull_mask=obj["hull_mask"], hull_eqs=obj["hull_eqs"],
        validation_pts=obj["render_pts"], validation_nrm=np.zeros_like(obj["render_pts"]))}
    sc = types.SimpleNamespace(intrinsics=K_INTR, cam_pose=s["cam_pose"], scene_dir="/scenes/decoy")
    hyps = decoy_hyps(s)[0]
    est = [ObjectPoseEstimate(name="box", pose_cam=hyps[0], pose_world=hyps[0], score=0.9,
                              hypotheses=hyps,
                              hypothesis_scores=np.array([0.9, 0.5, 0.8], np.float32))]
    seg_pts, seg_mask = _seg_of(obj["render_pts"], s["true_pose"])
    built, queued, settled_on = [], [], []
    init = mcts.BatchedLeafEvaluator.__init__
    evaluate_async = mcts.BatchedLeafEvaluator.evaluate_async
    settle = physics.settle_in_order

    def keeping_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        built.append(self)

    def keeping_evaluate_async(self, choices, active):
        queued.append((self, np.array(choices), np.array(active)))
        return evaluate_async(self, choices, active)

    def keeping_settle(consts, *args, **kwargs):
        settled_on.append(consts)
        return settle(consts, *args, **kwargs)

    monkeypatch.setattr(mcts.BatchedLeafEvaluator, "__init__", keeping_init)
    monkeypatch.setattr(mcts.BatchedLeafEvaluator, "evaluate_async", keeping_evaluate_async)
    monkeypatch.setattr(physics, "settle_in_order", keeping_settle)
    stats = {}
    with tracing.span("search") as sp:
        mcts.mcts_select(est, sc, db, s["table_pose"], s["obs"], tcfg, seed=3, search="uct",
                         segs=[types.SimpleNamespace(pts=seg_pts, mask=seg_mask)], device="cpu",
                         stats=stats)
    assert len(built) == 1
    ev = built[0]
    assert stats["search_leaf_batches"] == sp.counts["leaf_batches"] == len(queued) >= 1
    for owner, choices, active in queued:
        assert owner is ev and choices.shape == (tcfg.mcts.leaf_batch, ev.k)
        np.testing.assert_array_equal(active, choices >= 0)
    # One settle a leaf batch on the search's constants, then the final pass's
    # on the full hulls' (the same dict when nothing is decimated).
    assert len(settled_on) == len(queued) + 1
    assert all(c is ev.consts for c in settled_on[:-1]) and settled_on[-1] is ev.consts_full
    for consts in settled_on:
        assert consts["hull_pts"].shape[0] == ev.k and consts["hull_pts"].dim() == 3
        assert consts["hyp_world"].dim() == 4 and consts["obs"].dim() == 2


def test_tree_exhaustion_terminates_enumeration():
    tree = mcts._make_tree(np.array([[0.9, 0.5, 0.8]], np.float32), k=1, c=3, budget=100, seed=0)
    pend = mcts._collect_batch(tree, alpha=5000.0, quota=3)
    assert len(pend) == 3 and not tree.root.exhausted
    mcts._backup(tree, pend, [2.0, 1.0, 3.0])
    assert tree.root.exhausted
    assert all(ch.exhausted for ch in tree.root.children.values())
    assert tree.best_cost == 1.0
    assert tree.best_assign[0] == pend[1][1][0]


def test_deadline_drains_final_inflight_batch(decoy, monkeypatch):
    s = decoy
    cfgs = _cfgs(leaf_batch=4, branching=3, max_search_seconds=30.0)
    ev, _ = evaluators(s, [s["obj"]], decoy_hyps(s), cfgs, render_scale=1)
    import time as _time

    t0 = _time.monotonic()
    seq = iter([t0, t0])
    monkeypatch.setattr(mcts.time, "monotonic", lambda: next(seq, t0 + 1e9))
    stats = {}
    assign, best_cost = mcts.uct_search(ev, np.array([[0.9, 0.5, 0.8]], np.float32), cfgs[0],
                                        seed=0, stats=stats)
    assert np.isfinite(best_cost)
    assert assign[0] == 1
    # The one batch the deadline let through held the root's three children,
    # which exhausted the tree: the deadline cut nothing.
    assert stats["search_expansions"] == 3 and stats["search_budget"] == 4
    assert stats["search_deadline_cut"] is False


def test_deadline_cut_is_reported(decoy, monkeypatch):
    # A deadline that passes before the first batch: nothing expanded, the
    # LCP ranking's first choice returned, and the cut reported.
    s = decoy
    cfgs = _cfgs(leaf_batch=4, branching=3, max_search_seconds=30.0)
    ev, _ = evaluators(s, [s["obj"]], decoy_hyps(s), cfgs, render_scale=1)
    import time as _time

    t0 = _time.monotonic()
    seq = iter([t0])
    monkeypatch.setattr(mcts.time, "monotonic", lambda: next(seq, t0 + 1e9))
    stats = {}
    assign, best_cost = mcts.uct_search(ev, np.array([[0.9, 0.5, 0.8]], np.float32), cfgs[0],
                                        seed=0, stats=stats)
    assert assign[0] == 0 and best_cost == np.inf
    assert stats == {"search_expansions": 0, "search_budget": 4, "search_deadline_cut": True,
                     "search_leaf_batches": 0, "search_leaves": 0}


# --------------------------------------------------------------- the stack


TABLE_TOP = 0.86


@pytest.fixture(scope="module")
def stacked():
    """tests/test_mcts_stacked.py's scene: an 8 cm cube on the table and a
    5 cm cube on it; the base hypothesis floats 3 cm high, the top has a
    floating decoy (choice 0) and a near-stacked hypothesis (choice 1)."""
    base, top = box_object(0.08, 500, seed=1), box_object(0.05, 500, seed=2)
    a_true = pose_at(0.0, 0.0, TABLE_TOP + 0.04)
    b_true = pose_at(0.01, 0.0, TABLE_TOP + 0.08 + 0.025)
    a_hyp = pose_at(0.0, 0.0, TABLE_TOP + 0.07)
    hyps = np.stack([np.stack([a_hyp, a_hyp]),
                     np.stack([pose_at(-0.06, 0.04, TABLE_TOP + 0.16),
                               pose_at(0.01, 0.0, TABLE_TOP + 0.08 + 0.04)])])
    s = dict(obs=render_obs([(base, a_true), (top, b_true)]), table_pose=pose_at(0, 0, 0.66),
             cam_pose=np.eye(4, dtype=np.float32))
    return s, [base, top], hyps, a_true, b_true


def test_sequential_settle_recovers_stack(stacked):
    s, objs, hyps, a_true, b_true = stacked
    cfgs = _cfgs(dict(steps=40), leaf_batch=4, branching=2, max_search_seconds=600.0,
                 render_scale=1)
    ev, jev = evaluators(s, objs, hyps, cfgs)
    hyp_scores = np.array([[0.8, 0.8], [0.9, 0.5]], np.float32)  # the decoy ranks higher
    assign, best = mcts.uct_search(ev, hyp_scores, cfgs[0], seed=0)
    j_assign, j_best = jmcts.uct_search(jev, hyp_scores, cfgs[1], seed=0)
    assert assign[1] == 1
    np.testing.assert_array_equal(assign, j_assign)
    got = ev.evaluate(np.array([assign]), np.ones((1, 2), bool))
    assert_leaves_close(got, jev.evaluate(np.array([assign]), np.ones((1, 2), bool)))
    settled = got[1]
    assert np.linalg.norm(settled[0, 0][:3, 3] - a_true[:3, 3]) < 0.015
    assert np.linalg.norm(settled[0, 1][:3, 3] - b_true[:3, 3]) < 0.015


def test_single_dynamic_fast_path_deviates_on_stacks(stacked):
    s, objs, hyps, a_true, _ = stacked
    seq = _cfgs(dict(steps=40), leaf_batch=4, branching=2, render_scale=1)
    fast = _cfgs(dict(steps=40), leaf_batch=4, branching=2, render_scale=1, sequential_settle=False)
    correct, active = np.array([[1, 1]]), np.ones((1, 2), bool)
    cost_seq, settled_seq = evaluators(s, objs, hyps, seq)[0].evaluate(correct, active)
    ev_fast, jev_fast = evaluators(s, objs, hyps, fast)
    cost_fast, settled_fast = ev_fast.evaluate(correct, active)
    assert_leaves_close((cost_fast, settled_fast), jev_fast.evaluate(correct, active))
    assert np.linalg.norm(settled_fast[0, 0][:3, 3] - a_true[:3, 3]) > 0.025
    assert np.linalg.norm(settled_seq[0, 0][:3, 3] - a_true[:3, 3]) < 0.015
    assert cost_seq[0] < cost_fast[0]


# --------------------------------------------------- the TrICP final pass


def _seg_of(cloud, pose):
    return (cloud @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32), np.ones(len(cloud), bool)


def test_tricp_final_recovers_perturbed_pose(decoy):
    s = decoy
    perturbed = (_rot_z(8.0) @ s["true_pose"]).astype(np.float32)
    perturbed[:3, 3] = s["true_pose"][:3, 3] + [0.015, -0.01, 0.0]
    hyps = np.stack([perturbed, perturbed])[None]
    cfgs = _cfgs(leaf_batch=4, branching=3)
    ev, jev = evaluators(s, [s["obj"]], hyps, cfgs, render_scale=1)
    seg_pts, seg_mask = _seg_of(s["obj"]["render_pts"], s["true_pose"])
    args = (np.array([0]), np.ones(1, bool), seg_pts[None], seg_mask[None])
    costs3, settled3 = ev.evaluate_final_tricp(*args)
    j_costs3, j_settled3 = jev.evaluate_final_tricp(*args)
    assert costs3.shape == (3,) and settled3.shape == (3, 1, 4, 4)
    assert_leaves_close((costs3, settled3), (j_costs3, j_settled3))
    best = mcts._tricp_pick(costs3)
    raw_err = np.linalg.norm(settled3[0, 0][:3, 3] - s["true_pose"][:3, 3])
    ref_err = np.linalg.norm(settled3[best, 0][:3, 3] - s["true_pose"][:3, 3])
    assert best != 0, f"TrICP never won: costs {costs3}"
    assert ref_err < raw_err and ref_err < 0.006
    costs_raw, _ = ev.evaluate_final(np.array([[0]]), np.ones((1, 1), bool))
    assert costs3.min() <= costs_raw[0] + 1e-4


def test_tricp_removal_ignores_neighbor_points():
    tcfg, jcfg = _cfgs()
    cloud = box_cloud()
    pose0, pose1 = pose_at(0.0, 0.0, 0.89), pose_at(0.075, 0.0, 0.89)
    init1 = pose1.copy()
    init1[:3, 3] += [-0.012, 0.008, 0.0]
    pts0, pts1 = cloud + pose0[:3, 3], cloud + pose1[:3, 3]
    contam = np.concatenate([pts1, pts0[:200]]).astype(np.float32)
    seg_pts = np.zeros((2, len(contam), 3), np.float32)
    seg_mask = np.zeros((2, len(contam)), bool)
    seg_pts[0, : len(pts0)], seg_mask[0, : len(pts0)] = pts0, True
    seg_pts[1], seg_mask[1] = contam, True
    args = (np.stack([pose0, init1]), np.stack([cloud, cloud]), np.zeros((2, len(cloud), 3)),
            np.ones((2, len(cloud)), bool), seg_pts, seg_mask, np.ones(2, bool))
    refined = n(mcts._tricp_refine_cam(*(t(a) if a.dtype != bool else tb(a) for a in args), tcfg))
    want = np.asarray(jmcts._tricp_refine_cam(*(jnp.asarray(a, jnp.float32) if a.dtype != bool
                                                else jnp.asarray(a) for a in args), jcfg))
    np.testing.assert_allclose(refined[0], pose0, atol=1e-3)
    assert np.linalg.norm(refined[1][:3, 3] - pose1[:3, 3]) < 0.005
    assert np.abs(refined[:, :3, 3] - want[:, :3, 3]).max() < 1e-3


def test_tricp_degenerate_segment_passes_through(decoy):
    s = decoy
    hyps = np.stack([s["true_pose"], s["true_pose"]])[None]
    ev, _ = evaluators(s, [s["obj"]], hyps, _cfgs(leaf_batch=4, branching=3), render_scale=1)
    costs3, settled3 = ev.evaluate_final_tricp(
        np.array([0]), np.ones(1, bool), np.zeros((1, 64, 3), np.float32), np.zeros((1, 64), bool))
    np.testing.assert_allclose(settled3[1], settled3[0], atol=1e-5)
    np.testing.assert_allclose(settled3[2], settled3[0], atol=1e-5)


def test_final_polish_descends_render_cost(decoy):
    s = decoy
    perturbed = (_rot_z(6.0) @ s["true_pose"]).astype(np.float32)
    perturbed[:3, 3] = s["true_pose"][:3, 3] + [0.012, -0.008, 0.0]
    hyps = np.stack([perturbed, perturbed])[None]
    tcfg, _ = _cfgs(leaf_batch=4, branching=3, final_polish_rounds=3)
    ev = mcts.BatchedLeafEvaluator([s["obj"]], hyps, s["obs"], K_INTR, s["cam_pose"],
                                   s["table_pose"], tcfg, render_scale=1, device="cpu")
    start = perturbed[None]
    polished, cost = mcts._final_polish(ev, start, np.ones(1, bool), tcfg, seed=0)
    start_cost = float(mcts._render_cost_of_poses(
        ev.consts_full, tcfg, ev.h, ev.w, ev.splat_radius, t(start[None]), tb(np.ones(1)))[0])
    assert cost <= start_cost
    err0 = np.linalg.norm(start[0][:3, 3] - s["true_pose"][:3, 3])
    err1 = np.linalg.norm(polished[0][:3, 3] - s["true_pose"][:3, 3])
    assert err1 < err0 and err1 < 0.008


# ------------------------------------------------------------ greedy search


class FakeEvaluator:
    """Deterministic cost oracle: cost = sum of per-object choice penalties."""

    def __init__(self, penalties):
        self.penalties = np.asarray(penalties, np.float64)
        self.k, self.num_hyp = self.penalties.shape
        self.calls = 0

    def evaluate(self, choices, active):
        self.calls += 1
        costs = np.zeros(len(choices))
        for i, row in enumerate(choices):
            for d, c in enumerate(row):
                if c >= 0:
                    costs[i] += self.penalties[d, c]
        return costs, np.tile(np.eye(4, dtype=np.float32), (len(choices), self.k, 1, 1))


def test_greedy_bfs_finds_optimum():
    penalties = [[5.0, 1.0, 3.0], [2.0, 4.0, 0.5], [1.0, 9.0, 2.0]]
    ev, jev = FakeEvaluator(penalties), FakeEvaluator(penalties)
    assign, cost = greedy_search.greedy_bfs_search(ev, np.zeros((3, 3), np.float32), max_iters=50)
    np.testing.assert_array_equal(assign, [1, 2, 0])
    assert np.isclose(cost, 1.0 + 0.5 + 1.0)
    want = jgreedy.greedy_bfs_search(jev, np.zeros((3, 3), np.float32), max_iters=50)
    np.testing.assert_array_equal(assign, want[0])
    assert ev.calls == jev.calls


def test_greedy_bfs_respects_budget_and_ties():
    # All-zero penalties tie every child: the heap's counter must order them
    # as the JAX package's does.
    ev, jev = FakeEvaluator(np.zeros((4, 5))), FakeEvaluator(np.zeros((4, 5)))
    assign, cost = greedy_search.greedy_bfs_search(ev, np.zeros((4, 5), np.float32), max_iters=3)
    want = jgreedy.greedy_bfs_search(jev, np.zeros((4, 5), np.float32), max_iters=3)
    assert ev.calls <= 4 and assign.shape == (4,)
    np.testing.assert_array_equal(assign, want[0])
    assert cost == want[1] and ev.calls == jev.calls


def test_greedy_bfs_on_the_decoy_scene(decoy):
    s = decoy
    ev, jev = evaluators(s, [s["obj"]], decoy_hyps(s), _cfgs(leaf_batch=4, branching=3),
                         render_scale=1)
    hyp_scores = np.array([[0.9, 0.5, 0.8]], np.float32)
    assign, cost = greedy_search.greedy_bfs_search(ev, hyp_scores)
    j_assign, j_cost = jgreedy.greedy_bfs_search(jev, hyp_scores)
    assert assign[0] == 1 == j_assign[0]
    assert abs(cost - j_cost) <= TOL_COST


# ------------------------------------------------------ the table refinement


def test_refine_table_pose_from_depth_matches_jax():
    # A tilted table plane under the box scene's camera, with depth noise;
    # the subsample draw is JAX's, handed to the port.
    rng = np.random.default_rng(2)
    h, w = 120, 160
    nrm = np.array([0.05, -0.6, -0.8])
    nrm /= np.linalg.norm(nrm)
    plane4 = np.r_[nrm, 0.55].astype(np.float32)  # n.p + d = 0
    rows, cols = np.mgrid[0:h, 0:w].astype(np.float64)
    ray = np.stack([(cols - 80) / 300.0, (rows - 60) / 300.0, np.ones_like(rows)], -1)
    depth = (-plane4[3] / (ray @ nrm)).astype(np.float32)
    depth = np.where((depth > 0.2) & (depth < 1.5), depth + rng.normal(0, 0.001, depth.shape),
                     0.0).astype(np.float32)
    tcfg, jcfg = _cfgs()
    _, _, jtable = jscene.remove_table(jnp.asarray(depth), jnp.asarray(K_INTR),
                                       jax.random.PRNGKey(0), jcfg)
    # The initial frame: JAX's remove_table frame of this depth.
    key = jax.random.PRNGKey(5)
    want = np.asarray(jscene.refine_table_pose_from_depth(
        jnp.asarray(depth), jnp.asarray(K_INTR), jnp.asarray(plane4), jtable, key, jcfg))
    priority = np.asarray(jax.random.uniform(key, (h * w,)))
    got = n(scene.refine_table_pose_from_depth(
        t(depth), t(K_INTR), t(plane4), t(np.asarray(jtable)), tcfg, priority=t(priority)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert abs(got[:3, 2] @ nrm) > 0.999  # the frame's z stays the plane normal
