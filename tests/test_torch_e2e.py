"""End-to-end: the port's estimate_pose (GT / PCS / LCP, and the MCTS and
GREEDY searches) on the CPU against the JAX package's, on a procedural
two-box scene rendered with the JAX triangle rasterizer
(test_torch_e2e_modes.py runs the other hypothesis and segmentation modes
on the same scene). No draws are
injected end to end (the packages' random streams differ), so this holds
outcomes: the same objects, each port pose within ADD-S 1 cm of ground truth
and, for LCP, within 5 mm of the JAX translation. Exact parity is held
module by module in the other test_torch_* files.

Both packages have one rare failure mode on this scene: over seeds 10-21,
about 1 in 20 (object, seed) draws of either package settles ~13 mm along
a box face (ADD-S still < 1 cm). The 5 mm bar to JAX therefore holds per
seed, not for every seed; seed 0 is a typical one for both."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import jax_object_fields
from chip_smoke import box_pose_world, camera_pose, write_box_ply
from physimglobalpose_tpu import config as jconfig
from physimglobalpose_tpu.models import objectdb as jobjectdb
from physimglobalpose_tpu.ops import raster_tri
from physimglobalpose_tpu.pipeline import api as japi, scene as jscene
from physimglobalpose_tpu_torch import config as tconfig
from physimglobalpose_tpu_torch.models import objectdb
from physimglobalpose_tpu_torch.pipeline import api, scene

H, W = 240, 320
INTR = np.array([[285.0, 0, 159.5], [0, 285.0, 119.5], [0, 0, 1]], np.float32)
# (name, class id, full extents m, centre (x, y) on the table, yaw deg)
BOXES = (
    ("box_a", 1, (0.12, 0.08, 0.06), (-0.08, 0.02), 25.0),
    ("box_b", 2, (0.07, 0.05, 0.14), (0.07, -0.03), -40.0),
)
CFG_KW = dict(max_model_points=384, max_validation_points=768)
PRE_KW = dict(max_segment_points=384)
ST_KW = dict(num_bases=48, max_quads_per_base=32, max_pairs_per_ppf=128)


def _cfg(mod, pre_kw=PRE_KW, st_kw=ST_KW):
    return mod.PipelineConfig(preprocess=mod.PreprocessConfig(**pre_kw),
                              stocs=mod.StoCSConfig(**st_kw), **CFG_KW)


def _render(pose_cam, verts, faces):
    return np.asarray(raster_tri.render_mesh_depth(
        jnp.asarray(pose_cam, jnp.float32), jnp.asarray(verts), jnp.asarray(faces),
        jnp.ones(len(faces), bool), jnp.asarray(INTR), H, W,
    ))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("e2e")
    cam = camera_pose(distance=0.6)
    inv = np.linalg.inv(cam)
    table_v = np.array([[-0.4, -0.4, 0], [0.4, -0.4, 0], [0.4, 0.4, 0], [-0.4, 0.4, 0]], np.float32)
    table_f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    layers = [(_render(inv, table_v, table_f), 0)]
    jcfg, gt, jobjs = _cfg(jconfig), {}, {}
    for name, cls, size, xy, yaw in BOXES:
        ply = str(tmp / f"{name}.ply")
        verts, faces = write_box_ply(ply, size)
        gt[name] = inv @ box_pose_world(size, xy, yaw)
        layers.append((_render(gt[name], verts, faces), cls))
        jobjs[name] = jobjectdb.prepare_object(name, ply, cls, [180, 180, 180], config=jcfg)
    stack = np.stack([np.where(d > 0, d, np.inf) for d, _ in layers])
    depth = stack.min(0)
    label = np.asarray([c for _, c in layers])[stack.argmin(0)]
    label = np.where(np.isfinite(depth), label, 0).astype(np.int32)
    depth = np.where(np.isfinite(depth), depth, 0.0).astype(np.float32)
    return dict(cam=cam, depth=depth, label=label, gt=gt, jobjs=jobjs, tmp=tmp)


def _adds(pose_est, pose_gt, pts):
    a = pts @ pose_gt[:3, :3].T + pose_gt[:3, 3]
    b = pts @ pose_est[:3, :3].T + pose_est[:3, 3]
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    return d.min(axis=1).mean()


def test_estimate_pose_matches_jax_on_box_scene(setup):
    s = setup
    names = [b[0] for b in BOXES]
    for _, cls, *_ in BOXES:
        assert (s["label"] == cls).sum() > 800
    jdb = jobjectdb.ObjectDB(s["jobjs"], {o.class_id: n for n, o in s["jobjs"].items()})
    cfg = _cfg(tconfig)
    tobjs = {n: objectdb.from_numpy(jax_object_fields(o), cfg, device="cpu")
             for n, o in s["jobjs"].items()}
    tdb = objectdb.ObjectDB(tobjs, {o.class_id: n for n, o in tobjs.items()})
    kw = dict(color=np.zeros((H, W, 3), np.uint8), depth=s["depth"], intrinsics=INTR,
              cam_pose=s["cam"], object_names=names, class_mask=s["label"])

    want = japi.estimate_pose("<memory>", jdb, scene=jscene.scene_from_arrays(**kw),
                              cfg=_cfg(jconfig), seed=0, write_result=False)
    result_path = str(s["tmp"] / "result.txt")
    got = api.estimate_pose("<memory>", tdb, scene=scene.scene_from_arrays(**kw), cfg=cfg,
                            seed=0, result_path=result_path, device="cpu")

    assert [o.name for o in got.objects] == [o.name for o in want.objects] == names
    for est, jest in zip(got.objects, want.objects):
        pts = s["jobjs"][est.name].validation_pts[::2]
        assert _adds(est.pose_cam, s["gt"][est.name], pts) < 0.01, est.name
        assert _adds(jest.pose_cam, s["gt"][est.name], pts) < 0.01, est.name
        assert np.linalg.norm(est.pose_cam[:3, 3] - jest.pose_cam[:3, 3]) < 0.005, est.name
        np.testing.assert_allclose(est.pose_world, s["cam"] @ est.pose_cam, atol=1e-5)
        assert est.hypotheses.shape == (25, 4, 4) and est.score > 0.1
    assert set(got.timings) >= {"preprocess_s", "hypothesis_s", "icp_refine_s", "total_s"}

    rows = [r.split() for r in open(result_path).read().splitlines()]
    assert [r[0] for r in rows] == names and all(len(r) == 8 for r in rows)
    for r, est in zip(rows, got.objects):
        np.testing.assert_allclose([float(x) for x in r[1:4]], est.pose_world[:3, 3], atol=1e-5)
        q = np.array([float(x) for x in r[4:]])
        assert abs(np.linalg.norm(q) - 1.0) < 1e-4


def test_estimate_pose_with_large_segments_matches_jax(setup):
    # max_segment_points above the routing constant (2,048): every segment is
    # padded to 2,304 rows, so the hypothesis scoring takes the streaming LCP
    # formulation (on the CPU its plain version), once per object. Fewer
    # hypotheses than above keep it short. Outcome bars as above.
    from physimglobalpose_tpu_torch.ops import lcp

    s = setup
    names = [b[0] for b in BOXES]
    pre_kw, st_kw = dict(max_segment_points=2304), dict(ST_KW, num_bases=16, max_quads_per_base=12)
    jdb = jobjectdb.ObjectDB(s["jobjs"], {o.class_id: n for n, o in s["jobjs"].items()})
    cfg = _cfg(tconfig, pre_kw, st_kw)
    tobjs = {n: objectdb.from_numpy(jax_object_fields(o), cfg, device="cpu")
             for n, o in s["jobjs"].items()}
    tdb = objectdb.ObjectDB(tobjs, {o.class_id: n for n, o in tobjs.items()})
    kw = dict(color=np.zeros((H, W, 3), np.uint8), depth=s["depth"], intrinsics=INTR,
              cam_pose=s["cam"], object_names=names, class_mask=s["label"])
    want = japi.estimate_pose("<memory>", jdb, scene=jscene.scene_from_arrays(**kw),
                              cfg=_cfg(jconfig, pre_kw, st_kw), seed=0, write_result=False)

    seen, real = [], lcp.lcp_scores_stream

    def spy(*a, **k):
        seen.append((a[0].shape[0], a[3].shape[0]))
        return real(*a, **k)

    lcp.lcp_scores_stream = spy
    try:
        got = api.estimate_pose("<memory>", tdb, scene=scene.scene_from_arrays(**kw), cfg=cfg,
                                seed=0, write_result=False, device="cpu")
    finally:
        lcp.lcp_scores_stream = real
    assert seen == [(16 * 12, 2304)] * len(BOXES)
    assert [o.name for o in got.objects] == [o.name for o in want.objects] == names
    for est, jest in zip(got.objects, want.objects):
        pts = s["jobjs"][est.name].validation_pts[::2]
        assert _adds(est.pose_cam, s["gt"][est.name], pts) < 0.01, est.name
        assert _adds(jest.pose_cam, s["gt"][est.name], pts) < 0.01, est.name
        assert np.linalg.norm(est.pose_cam[:3, 3] - jest.pose_cam[:3, 3]) < 0.005, est.name
        assert est.score > 0.1


@pytest.mark.parametrize("mode", ["MCTS", "GREEDY"])
def test_search_modes_match_jax_on_box_scene(setup, mode):
    # The physics-aware search at a small budget (leaf batch 8, 4 hypotheses
    # an object, 40 expansions; GREEDY expands up to 300 nodes of 4
    # children), then the TrICP final pass. Outcome bars: the same objects as
    # JAX, each settled pose within ADD-S 1 cm of the truth in both packages,
    # a result.txt row per object.
    s = setup
    names = [b[0] for b in BOXES]

    def cfg_of(mod):
        return dataclasses.replace(
            _cfg(mod), render=mod.RenderConfig(width=W, height=H),
            mcts=mod.MCTSConfig(leaf_batch=8, branching=4, max_expansions=40))

    jdb = jobjectdb.ObjectDB(s["jobjs"], {o.class_id: n for n, o in s["jobjs"].items()})
    tobjs = {n: objectdb.from_numpy(jax_object_fields(o), cfg_of(tconfig), device="cpu")
             for n, o in s["jobjs"].items()}
    tdb = objectdb.ObjectDB(tobjs, {o.class_id: n for n, o in tobjs.items()})
    kw = dict(color=np.zeros((H, W, 3), np.uint8), depth=s["depth"], intrinsics=INTR,
              cam_pose=s["cam"], object_names=names, class_mask=s["label"])
    want = japi.estimate_pose("<memory>", jdb, scene=jscene.scene_from_arrays(**kw),
                              cfg=cfg_of(jconfig), seed=0, verification_mode=mode,
                              write_result=False)
    result_path = str(s["tmp"] / f"result_{mode}.txt")
    got = api.estimate_pose("<memory>", tdb, scene=scene.scene_from_arrays(**kw),
                            cfg=cfg_of(tconfig), seed=0, verification_mode=mode,
                            result_path=result_path, device="cpu")
    assert [o.name for o in got.objects] == [o.name for o in want.objects] == names
    for est, jest in zip(got.objects, want.objects):
        pts = s["jobjs"][est.name].validation_pts[::2]
        assert _adds(est.pose_cam, s["gt"][est.name], pts) < 0.01, est.name
        assert _adds(jest.pose_cam, s["gt"][est.name], pts) < 0.01, est.name
        np.testing.assert_allclose(est.pose_world, s["cam"] @ est.pose_cam, atol=1e-5)
    assert "search_s" in got.timings and "icp_refine_s" not in got.timings
    if mode == "MCTS":
        assert 0 < got.timings["search_expansions"] <= got.timings["search_budget"] <= 40
        assert got.timings["search_deadline_cut"] is False
    rows = [r.split() for r in open(result_path).read().splitlines()]
    assert [r[0] for r in rows] == names and all(len(r) == 8 for r in rows)


def test_unported_modes_raise(setup):
    # Every segmentation and hypothesis mode of the JAX package runs (here on
    # a scene with no objects, so the networks run once and nothing else),
    # and so does the debug dump: the cleaned depth and the (empty) overlay
    # (tests/test_torch_debug.py holds a full dump against JAX's).
    s = setup
    tdb = objectdb.ObjectDB({}, {})
    sc = scene.scene_from_arrays(np.zeros((H, W, 3), np.uint8), s["depth"], INTR, s["cam"], [],
                                 class_mask=np.zeros((H, W), np.int32))
    debug_dir = s["tmp"] / "debug_empty"
    res = api.estimate_pose("<memory>", tdb, scene=sc, device="cpu", write_result=False,
                            debug_dir=str(debug_dir))
    assert res.objects == [] and "total_s" in res.timings
    assert sorted(p.name for p in debug_dir.iterdir()) == [
        "depth_clean.png", "depth_clean_viz.png", "final_overlay.png"]
    for kw in (dict(segmentation_mode="FCN"), dict(segmentation_mode="FCNThreshold", fcn_tta=True),
               dict(segmentation_mode="RCNN"), dict(hypothesis_mode="SUPER4PCS"),
               dict(hypothesis_mode="V4PCS"), dict(hypothesis_mode="PPF_VOTING"),
               dict(hypothesis_mode="Hough")):
        res = api.estimate_pose("<memory>", tdb, scene=sc, device="cpu", write_result=False, **kw)
        assert res.objects == [] and "total_s" in res.timings
    for kw in (dict(verification_mode="BOGUS"), dict(hypothesis_mode="BOGUS"),
               dict(segmentation_mode="BOGUS")):
        with pytest.raises(ValueError):
            api.estimate_pose("<memory>", tdb, scene=sc, device="cpu", **kw)
    with pytest.raises(FileNotFoundError):
        api.estimate_pose("<memory>", tdb, scene=sc, device="cpu", write_result=False,
                          segmentation_mode="FCN", fcn_variant="full")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            api.estimate_pose("<memory>", tdb, scene=sc, write_result=False)


def test_cli_drives_a_cam_scene_on_the_cpu(setup, capsys):
    from physimglobalpose_tpu_torch import cli

    s, tmp = setup, setup["tmp"]
    name, cls = BOXES[0][0], BOXES[0][1]
    label = np.where(s["label"] == cls, cls, 0)
    np.savez(tmp / "scene.npz", color=np.zeros((H, W, 3), np.uint8), depth=s["depth"],
             intrinsics=INTR, cam_pose=s["cam"], object_names=np.array([name]), class_mask=label)
    (tmp / "obj_config.yml").write_text(
        "objects:\n  num_objects: 1\n  modelDiscretization: 0.01\n"
        f"  object_1:\n    name: {name}\n    classId: {cls}\n    symmetry: [180, 180, 180]\n"
    )
    rc = cli.main([
        "--dataset", "CAM", "--scene", str(tmp / "scene.npz"), "--obj-config",
        str(tmp / "obj_config.yml"), "--model-dir", str(tmp), "--cache-dir", str(tmp / "cache"),
        "--preset", "small", "--device", "cpu", "--result", str(tmp / "cli_result.txt"),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.startswith(f"{name}: t=(") and '"timings"' in out
    rows = (tmp / "cli_result.txt").read_text().splitlines()
    assert len(rows) == 1 and rows[0].split()[0] == name
    t_world = np.array([float(x) for x in rows[0].split()[1:4]])
    want = (s["cam"] @ s["gt"][name])[:3, 3]
    assert np.linalg.norm(t_world - want) < 0.01


def test_cli_drives_mcts_on_the_cpu(tmp_path, capsys):
    # `cli --verification MCTS` on chip_smoke.py's ray-cast 640x480 scene (the
    # search renders at the configured 640x480 / render_scale), one box, the
    # small preset: one padded leaf batch of 128 covers the 26-expansion
    # budget of one object with 25 hypotheses.
    from chip_smoke import BOXES as SMOKE_BOXES, INTRINSICS, render_scene
    from physimglobalpose_tpu_torch import cli

    cam = camera_pose()
    depth, label = render_scene(cam)
    name, cls, size, xy, yaw = SMOKE_BOXES[0]
    write_box_ply(str(tmp_path / f"{name}.ply"), size)
    np.savez(tmp_path / "scene.npz", color=np.zeros(depth.shape + (3,), np.uint8), depth=depth,
             intrinsics=INTRINSICS, cam_pose=cam, object_names=np.array([name]),
             class_mask=np.where(label == cls, cls, 0))
    (tmp_path / "obj_config.yml").write_text(
        "objects:\n  num_objects: 1\n  modelDiscretization: 0.01\n"
        f"  object_1:\n    name: {name}\n    classId: {cls}\n    symmetry: [180, 180, 180]\n"
    )
    rc = cli.main([
        "--dataset", "CAM", "--scene", str(tmp_path / "scene.npz"), "--obj-config",
        str(tmp_path / "obj_config.yml"), "--model-dir", str(tmp_path), "--cache-dir",
        str(tmp_path / "cache"), "--preset", "small", "--device", "cpu", "--verification", "MCTS",
        "--result", str(tmp_path / "result.txt"),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.startswith(f"{name}: t=(") and '"search_s"' in out
    rows = (tmp_path / "result.txt").read_text().splitlines()
    assert len(rows) == 1 and rows[0].split()[0] == name
    t_world = np.array([float(x) for x in rows[0].split()[1:4]])
    assert np.linalg.norm(t_world - box_pose_world(size, xy, yaw)[:3, 3]) < 0.01
