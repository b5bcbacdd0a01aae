"""The port's search over many scenes at once (pipeline/mcts.py:
MultiSceneLeafEvaluator, uct_search_multi, mcts_select_multi) on the CPU,
against the JAX package on tests/test_mcts.py's decoy scene and
tests/test_mcts_mesh.py's two-scene rows (one scene of one object, one of
two): leaf costs within 2 pixels and settled poses within 1e-4 m and 1e-3
rad of JAX's (test_torch_mcts.py's bars); the rows split over 8 CPU entries
(5 rows, padded to 8) equal to the unsplit batch; the same assignments as
JAX's uct_search_multi; mcts_select_multi equal to one mcts_select a scene.

And the JAX sweep's MCTS table pose, confirmed on the CPU with the JAX
package on a scene whose camera is not the identity: sweep_scenes hands
mcts_select_multi remove_table's camera-frame, unrefined table pose, while
estimate_pose gives mcts_select the world-frame box refined from the raw
depth and shifted down by its half extent. The port's sweep does what the
JAX sweep does."""

import types

import numpy as np
import pytest

from _torch_common import jax_object_fields, write_scene_dir
from chip_smoke import camera_pose
from physimglobalpose_tpu import config as jconfig
from physimglobalpose_tpu.models import objectdb as jobjectdb
from physimglobalpose_tpu.parallel import scene_sweep as jsweep
from physimglobalpose_tpu.pipeline import api as japi, mcts as jmcts
from physimglobalpose_tpu_torch import config as tconfig
from physimglobalpose_tpu_torch.models import objectdb
from physimglobalpose_tpu_torch.parallel import mesh as mesh_mod, scene_sweep
from physimglobalpose_tpu_torch.pipeline import api, mcts
from physimglobalpose_tpu_torch.pipeline.api import ObjectPoseEstimate
from test_torch_e2e import BOXES, _cfg
from test_torch_mcts import (  # noqa: F401  (decoy is a fixture)
    K_INTR, TOL_COST, _cfgs, _rot_z, _seg_of, assert_leaves_close, decoy, evaluators, pose_at,
)


def _two_scenes(s, cfgs):
    """tests/test_mcts_mesh.py's scenes: A one object and two hypotheses, B
    two objects and two hypotheses; evaluators of both packages. Its high
    box (0, 0, 0.97) falls beside the wrong one (0.06, 0.04, 0.89) with two
    faces exactly coincident (x = 0.03), the vertex-face contact's blind spot
    (ops/physics.py), where a last-bit difference decides the rest pose:
    row (1, 0) of scene B costs 544 px in JAX and 1,145 px in the
    port. Here the high box is moved 1 cm in x and y, clear of every face of
    the boxes below it."""
    wrong, high = pose_at(0.06, 0.04, 0.89), pose_at(-0.01, 0.01, 0.97)
    hyps_a = np.stack([s["true_pose"], wrong])[None]
    hyps_b = np.stack([np.stack([s["true_pose"], wrong]), np.stack([high, wrong])])
    ev_a, jev_a = evaluators(s, [s["obj"]], hyps_a, cfgs, render_scale=1)
    ev_b, jev_b = evaluators(s, [s["obj"], s["obj"]], hyps_b, cfgs, render_scale=1)
    return [ev_a, ev_b], [jev_a, jev_b]


# 5 rows over both scenes, mixed partial assignments (not a multiple of 8).
ROWS = (np.array([0, 1, 1, 0, 1]),
        np.array([[0, -1], [0, 0], [-1, 1], [1, -1], [1, 0]], np.int64))


def test_multi_evaluator_matches_jax_and_the_single_scene_evaluators(decoy):
    cfgs = _cfgs(leaf_batch=4, branching=3)
    evs, jevs = _two_scenes(decoy, cfgs)
    msev, jmsev = mcts.MultiSceneLeafEvaluator(evs), jmcts.MultiSceneLeafEvaluator(jevs)
    assert msev.k_max == 2 and msev.ks == [1, 2] and msev.n_shards == 1
    scene_idx, choices = ROWS
    got = msev.evaluate(scene_idx, choices, choices >= 0)
    assert_leaves_close(got, jmsev.evaluate(scene_idx, choices, choices >= 0))
    assert_leaves_close(msev.evaluate_final(scene_idx, choices, choices >= 0),
                        jmsev.evaluate_final(scene_idx, choices, choices >= 0))
    # Each row against its scene's own evaluator.
    for r, (si, row) in enumerate(zip(scene_idx, choices)):
        k = evs[si].k
        c1, s1 = evs[si].evaluate(row[None, :k], row[None, :k] >= 0)
        assert abs(got[0][r] - c1[0]) <= TOL_COST
        np.testing.assert_allclose(got[1][r, :k], s1[0], atol=1e-5)


def test_multi_evaluator_rows_over_eight_entries_match_unsplit(decoy):
    cfgs = _cfgs(leaf_batch=4, branching=3)
    evs, _ = _two_scenes(decoy, cfgs)
    plain = mcts.MultiSceneLeafEvaluator(evs)
    split = mcts.MultiSceneLeafEvaluator(evs, mesh=mesh_mod.make_mesh(8, device="cpu"))
    assert split.n_shards == 8
    scene_idx, choices = ROWS
    costs_p, settled_p = plain.evaluate(scene_idx, choices, choices >= 0)
    costs_s, settled_s = split.evaluate(scene_idx, choices, choices >= 0)
    assert costs_s.shape == (8,)  # padded to the entry count
    np.testing.assert_allclose(costs_s[:5], costs_p, rtol=1e-6)
    np.testing.assert_allclose(settled_s[:5], settled_p, rtol=1e-5, atol=1e-6)
    fc_p, fs_p = plain.evaluate_final(scene_idx, choices, choices >= 0)
    fc_s, fs_s = split.evaluate_final(scene_idx, choices, choices >= 0)
    assert fc_s.shape == (5,)  # padding stripped
    np.testing.assert_allclose(fc_s, fc_p, rtol=1e-6)
    np.testing.assert_allclose(fs_s, fs_p, rtol=1e-5, atol=1e-6)


def _decoy_pair(s, cfgs):
    """tests/test_mcts.py's multi-scene case: the decoy scene twice, the
    truth at slot 1 in A and at slot 0 in B."""
    decoy1, decoy2 = pose_at(0.07, 0.05, 0.89), pose_at(-0.06, 0.03, 0.95)
    hyps_a = np.stack([decoy1, s["true_pose"], decoy2])[None]
    hyps_b = np.stack([s["true_pose"], decoy2, decoy1])[None]
    ev_a, jev_a = evaluators(s, [s["obj"]], hyps_a, cfgs, render_scale=1)
    ev_b, jev_b = evaluators(s, [s["obj"]], hyps_b, cfgs, render_scale=1)
    scores = [np.array([[0.9, 0.5, 0.8]], np.float32), np.array([[0.5, 0.8, 0.9]], np.float32)]
    return [ev_a, ev_b], [jev_a, jev_b], scores


def test_uct_search_multi_matches_jax(decoy):
    cfgs = _cfgs(leaf_batch=4, leaf_batch_multi=8, branching=3, max_search_seconds=600.0)
    evs, jevs, scores = _decoy_pair(decoy, cfgs)
    stats = {}
    got = mcts.uct_search_multi(mcts.MultiSceneLeafEvaluator(evs), scores, cfgs[0], seed=0,
                                max_iterations=10, stats=stats)
    want = jmcts.uct_search_multi(jmcts.MultiSceneLeafEvaluator(jevs), scores, cfgs[1], seed=0,
                                  max_iterations=10)
    assert got[0][0][0] == 1 and got[1][0][0] == 0
    for (a, c), (ja, jc) in zip(got, want):
        np.testing.assert_array_equal(a, ja)
        assert abs(c - jc) <= TOL_COST
    assert stats["search_budget"] == [4, 4] and stats["shared_batches"] >= 1
    assert stats["leaves"] >= sum(stats["search_expansions"])
    assert (stats["search_leaf_batches"], stats["search_leaves"]) == (
        stats["shared_batches"], stats["leaves"])
    # The same searches with each batch split over 8 CPU entries.
    split = mcts.uct_search_multi(
        mcts.MultiSceneLeafEvaluator(evs, mesh=mesh_mod.make_mesh(8, device="cpu")), scores,
        cfgs[0], seed=0, max_iterations=10)
    for (a, c), (sa, sc) in zip(got, split):
        np.testing.assert_array_equal(sa, a)
        np.testing.assert_allclose(sc, c, rtol=1e-6)


def test_tricp_multi_matches_single_and_jax(decoy):
    s = decoy
    perturbed = (_rot_z(8.0) @ s["true_pose"]).astype(np.float32)
    perturbed[:3, 3] = s["true_pose"][:3, 3] + [0.015, -0.01, 0.0]
    hyps = np.stack([perturbed, perturbed])[None]
    cfgs = _cfgs(leaf_batch=4, branching=3)
    ev_a, jev_a = evaluators(s, [s["obj"]], hyps, cfgs, render_scale=1)
    ev_b, jev_b = evaluators(s, [s["obj"]], hyps, cfgs, render_scale=1)
    seg_pts, seg_mask = _seg_of(s["obj"]["render_pts"], s["true_pose"])
    args = (np.zeros((2, 1), np.int64), np.ones((2, 1), bool),
            np.stack([seg_pts[None]] * 2), np.stack([seg_mask[None]] * 2))
    costs_m, settled_m = mcts.MultiSceneLeafEvaluator([ev_a, ev_b]).evaluate_final_tricp(*args)
    j_costs, j_settled = jmcts.MultiSceneLeafEvaluator([jev_a, jev_b]).evaluate_final_tricp(*args)
    costs_s, settled_s = ev_a.evaluate_final_tricp(np.array([0]), np.ones(1, bool),
                                                   seg_pts[None], seg_mask[None])
    assert costs_m.shape == (2, 3) and settled_m.shape == (2, 3, 1, 4, 4)
    assert_leaves_close((costs_m, settled_m), (j_costs, j_settled))
    np.testing.assert_allclose(costs_m[0], costs_s, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(settled_m[0], settled_s, rtol=1e-4, atol=1e-4)


def _estimates(hyps_cam, scores, names):
    return [ObjectPoseEstimate(name=nm, pose_cam=h[0], pose_world=h[0], score=float(sc[0]),
                               hypotheses=h, hypothesis_scores=sc)
            for nm, h, sc in zip(names, hyps_cam, scores)]


def test_mcts_select_multi_equals_one_mcts_select_a_scene(decoy):
    # Two decoy scenes (world == camera), one and two objects, through the
    # whole selection: the shared search, the TrICP final pass, the install.
    s = decoy
    tcfg, _ = _cfgs(leaf_batch=4, leaf_batch_multi=8, branching=3, max_search_seconds=600.0,
                    max_expansions=12)
    obj = s["obj"]
    db = {"box": types.SimpleNamespace(
        hull_pts=obj["hull_pts"], hull_mask=obj["hull_mask"], hull_eqs=obj["hull_eqs"],
        validation_pts=obj["render_pts"], validation_nrm=np.zeros_like(obj["render_pts"]))}
    sc = types.SimpleNamespace(intrinsics=K_INTR, cam_pose=s["cam_pose"])
    decoy1, decoy2 = pose_at(0.07, 0.05, 0.89), pose_at(-0.06, 0.03, 0.95)
    rows = [
        (_estimates([np.stack([decoy1, s["true_pose"], decoy2])],
                    [np.array([0.9, 0.5, 0.8], np.float32)], ["box"]),
         sc, s["table_pose"], s["obs"]),
        (_estimates([np.stack([s["true_pose"], decoy2, decoy1]),
                     np.stack([pose_at(0.0, 0.0, 0.97), decoy1, decoy2])],
                    [np.array([0.5, 0.8, 0.9], np.float32)] * 2, ["box", "box"]),
         sc, s["table_pose"], s["obs"]),
    ]
    seg_pts, seg_mask = _seg_of(obj["render_pts"], s["true_pose"])
    seg = types.SimpleNamespace(pts=seg_pts, mask=seg_mask)
    segs = [[seg], [seg, seg]]
    stats = {}
    got = mcts.mcts_select_multi(rows, db, tcfg, seed=0, segs_list=segs, device="cpu",
                                 stats=stats)
    for si, (row, seg_list) in enumerate(zip(rows, segs)):
        want = mcts.mcts_select(row[0], row[1], db, row[2], row[3], tcfg, seed=si, segs=seg_list,
                                device="cpu")
        assert [o.name for o in got[si]] == [o.name for o in want]
        for a, b in zip(got[si], want):
            assert a.score == b.score
            np.testing.assert_allclose(a.pose_world, b.pose_world, atol=1e-5)
            np.testing.assert_allclose(a.pose_cam, b.pose_cam, atol=1e-5)
    assert np.linalg.norm(got[0][0].pose_world[:3, 3] - s["true_pose"][:3, 3]) < 0.01
    assert stats["shared_batches"] >= 1 and len(stats["search_expansions"]) == 2
    assert mcts.mcts_select_multi([([], sc, s["table_pose"], s["obs"])], db, tcfg,
                                  device="cpu") == [[]]


@pytest.fixture(scope="module")
def table_scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("table")
    cam = camera_pose(distance=0.6)
    write_scene_dir(tmp / "scene", cam, BOXES, tmp)
    st = dict(num_bases=8, max_quads_per_base=8, max_pairs_per_ppf=32)
    jcfg, cfg = _cfg(jconfig, st_kw=st), _cfg(tconfig, st_kw=st)
    jobjs = {nm: jobjectdb.prepare_object(nm, str(tmp / f"{nm}.ply"), cls, [180, 180, 180],
                                          config=jcfg) for nm, cls, *_ in BOXES}
    tobjs = {nm: objectdb.from_numpy(jax_object_fields(o), cfg, device="cpu")
             for nm, o in jobjs.items()}
    return dict(
        sd=str(tmp / "scene"), cam=cam, jcfg=jcfg, cfg=cfg,
        jdb=jobjectdb.ObjectDB(jobjs, {o.class_id: nm for nm, o in jobjs.items()}),
        db=objectdb.ObjectDB(tobjs, {o.class_id: nm for nm, o in tobjs.items()}),
    )


def test_jax_sweep_hands_the_search_the_camera_frame_table_pose(table_scene, monkeypatch):
    s = table_scene
    seen = {}

    def capture_multi(key):
        def fake(scene_rows, *a, **k):
            seen[key] = np.array(scene_rows[0][2], np.float64)
            return [row[0] for row in scene_rows]
        return fake

    def capture_single(key):
        def fake(estimates, sc, db, table_pose, *a, **k):
            seen[key] = np.array(table_pose, np.float64)
            return estimates
        return fake

    monkeypatch.setattr(jmcts, "mcts_select_multi", capture_multi("jax_sweep"))
    monkeypatch.setattr(jmcts, "mcts_select", capture_single("jax_serial"))
    monkeypatch.setattr(mcts, "mcts_select_multi", capture_multi("port_sweep"))
    monkeypatch.setattr(mcts, "mcts_select", capture_single("port_serial"))
    jsweep.sweep_scenes(None, [s["sd"]], s["jdb"], cfg=s["jcfg"], verification_mode="MCTS")
    japi.estimate_pose(s["sd"], s["jdb"], verification_mode="MCTS", cfg=s["jcfg"],
                       write_result=False)
    scene_sweep.sweep_scenes(None, [s["sd"]], s["db"], cfg=s["cfg"], verification_mode="MCTS",
                             device="cpu")
    api.estimate_pose(s["sd"], s["db"], verification_mode="MCTS", cfg=s["cfg"],
                      write_result=False, device="cpu")

    # The JAX sweep: remove_table's pose as fitted, in the camera frame.
    prepared = jsweep.prepare_scene(s["sd"], s["jdb"], cfg=s["jcfg"], seed=0)
    np.testing.assert_allclose(seen["jax_sweep"], np.asarray(prepared.table_pose), atol=1e-6)
    # The serial path: a world-frame box, local z up, its top at the table.
    half = s["jcfg"].physics.table_half_extents[2]
    for key in ("jax_serial", "port_serial"):
        serial = seen[key]
        assert serial[2, 2] > 0.99, key
        assert abs(serial[2, 3] + half) < 0.005, key  # the box's top face at world z = 0
    # The camera looks down at 45 degrees: the camera-frame pose's z axis is
    # far from world up, and its origin is the plane anchor ~0.6 m ahead.
    sweep = seen["jax_sweep"]
    assert abs(sweep[2, 2]) < 0.9 and sweep[2, 3] > 0.3
    world = s["cam"] @ sweep
    assert np.abs(world[:3, 3] - seen["jax_serial"][:3, 3]).max() > 0.1
    # The port's sweep and serial path each do what the JAX package's do.
    port_prepared = scene_sweep.prepare_scene(s["sd"], s["db"], cfg=s["cfg"], seed=0,
                                              device="cpu")
    np.testing.assert_allclose(seen["port_sweep"], port_prepared.table_pose.numpy(), atol=1e-6)
    np.testing.assert_allclose(seen["port_sweep"], seen["jax_sweep"], atol=2e-3)
    np.testing.assert_allclose(seen["port_serial"][:3, :3], seen["jax_serial"][:3, :3], atol=2e-2)
