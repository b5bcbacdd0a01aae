"""Port parity: the debug dump (utils/debug.py, utils/viz.py, the prob-PNG
codec of geometry/depthio.py, and estimate_pose(debug_dir=...)) against the
JAX package's. Mirrors tests/test_utils.py::test_viz_overlay.

The two packages draw from different random streams, so the dump of one
scene is held to JAX's dump by its file list, npz keys, shapes and dtypes,
and by value where it is deterministic: the GT probability images, and
final_assignment_mesh_render against the JAX rasterizer's render of the
port's own final poses (>= 99.9 % of pixels with the same coverage, depth
within one 1e-4 m step of the PNG codec elsewhere)."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np

from _torch_common import jax_object_fields
from physimglobalpose_tpu import config as jconfig
from physimglobalpose_tpu.geometry import depthio as jdepthio
from physimglobalpose_tpu.models import assets as jassets, objectdb as jobjectdb
from physimglobalpose_tpu.ops import raster as jraster, raster_tri as jraster_tri
from physimglobalpose_tpu.pipeline import api as japi, scene as jscene
from physimglobalpose_tpu.utils import viz as jviz
from physimglobalpose_tpu_torch import config as tconfig
from physimglobalpose_tpu_torch.geometry import depthio
from physimglobalpose_tpu_torch.models import objectdb
from physimglobalpose_tpu_torch.pipeline import api, scene
from physimglobalpose_tpu_torch.utils import viz
from test_torch_e2e import BOXES, H, INTR, W, _cfg, setup  # noqa: F401  (setup is a fixture)


def test_viz_overlay(tmp_path):
    color = np.zeros((48, 64, 3), np.uint8)
    intr = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]])
    cloud = np.array([[0.0, 0.0, 0.5]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    out = viz.overlay_poses(color, intr, [cloud], [pose])
    assert out[24, 32].sum() > 0  # the point painted at the principal point
    viz.save_overlay(str(tmp_path / "o.png"), color, intr, [cloud], [pose])
    viz.save_depth_image(str(tmp_path / "d.png"), np.full((8, 8), 0.5, np.float32))
    # The numpy copy paints what the JAX package paints.
    rng = np.random.default_rng(0)
    color = rng.integers(0, 255, size=(48, 64, 3), dtype=np.uint8)
    clouds = [rng.uniform(-0.05, 0.05, size=(200, 3)).astype(np.float32) for _ in range(9)]
    poses = [np.eye(4, dtype=np.float32) for _ in range(9)]
    for i, p in enumerate(poses):
        p[:3, 3] = [0.01 * i - 0.04, 0.0, 0.3 + 0.02 * i - 0.4 * (i == 8)]
    np.testing.assert_array_equal(viz.overlay_poses(color, intr, clouds, poses),
                                  jviz.overlay_poses(color, intr, clouds, poses))
    depth = rng.uniform(-0.1, 2.5, size=(16, 16)).astype(np.float32)
    np.testing.assert_array_equal(viz.depth_to_image(depth), jviz.depth_to_image(depth))


def test_prob_png_roundtrip_against_jax_codec(tmp_path):
    rng = np.random.default_rng(1)
    prob = rng.uniform(0, 1, size=(30, 40)).astype(np.float32)
    prob[:5] = 0.0
    prob[5:8] = 1.0
    ours, theirs = str(tmp_path / "p.png"), str(tmp_path / "jp.png")
    depthio.write_prob_png(ours, prob)
    jdepthio.write_prob_png(theirs, prob)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    back = depthio.read_prob_png(theirs)
    np.testing.assert_array_equal(back, jdepthio.read_prob_png(ours))
    assert back.dtype == np.float32
    np.testing.assert_allclose(back, prob, atol=1e-4)
    assert (back[5:8] == 1.0).all() and (back[:5] == 0.0).all()


def _load(path):
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    if path.endswith(".json"):
        return json.load(open(path))
    from PIL import Image

    return np.array(Image.open(path))


def test_greedy_debug_dump_matches_jax(setup, tmp_path):
    # The two-box scene of test_torch_e2e.py in GREEDY mode at a small
    # budget, dumped by both packages.
    s = setup
    names = [b[0] for b in BOXES]

    def cfg_of(mod):
        return dataclasses.replace(_cfg(mod), render=mod.RenderConfig(width=W, height=H),
                                   mcts=mod.MCTSConfig(leaf_batch=8, branching=4, max_expansions=40))

    jdb = jobjectdb.ObjectDB(s["jobjs"], {o.class_id: n for n, o in s["jobjs"].items()})
    tobjs = {n: objectdb.from_numpy(jax_object_fields(o), cfg_of(tconfig), device="cpu")
             for n, o in s["jobjs"].items()}
    tdb = objectdb.ObjectDB(tobjs, {o.class_id: n for n, o in tobjs.items()})
    color = np.random.default_rng(2).integers(0, 255, size=(H, W, 3), dtype=np.uint8)
    kw = dict(color=color, depth=s["depth"], intrinsics=INTR, cam_pose=s["cam"],
              object_names=names, class_mask=s["label"])
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    japi.estimate_pose("<memory>", jdb, scene=jscene.scene_from_arrays(**kw),
                       cfg=cfg_of(jconfig), seed=0, verification_mode="GREEDY",
                       write_result=False, debug_dir=jdir)
    got = api.estimate_pose("<memory>", tdb, scene=scene.scene_from_arrays(**kw),
                            cfg=cfg_of(tconfig), seed=0, verification_mode="GREEDY",
                            write_result=False, debug_dir=tdir, device="cpu")

    files = sorted(os.listdir(tdir))
    assert files == sorted(os.listdir(jdir))
    want_files = {"depth_clean.png", "depth_clean_viz.png", "final_assignment_mesh_render.png",
                  "final_assignment_mesh_render_viz.png", "final_overlay.png"}
    for nm in names:
        want_files |= {f"{nm}_prob.png", f"{nm}_hypotheses.npz", f"{nm}.json"}
    assert set(files) == want_files
    for f in files:
        a, b = _load(os.path.join(tdir, f)), _load(os.path.join(jdir, f))
        if isinstance(a, dict):
            assert a.keys() == b.keys(), f
            for k in a:
                if isinstance(a[k], np.ndarray):
                    assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, (f, k)
                else:
                    assert type(a[k]) is type(b[k]), (f, k)
        else:
            assert a.shape == b.shape and a.dtype == b.dtype, f
        if f.endswith("_prob.png"):  # the GT probability images, by value
            np.testing.assert_array_equal(a, b)

    # The final mesh render against JAX's render of the port's final poses.
    final = np.zeros((H, W), np.float32)
    for est in got.objects:
        mesh = jassets.decimate_to_max_faces(s["jobjs"][est.name].mesh, 3000)
        d = jraster_tri.render_mesh_depth(
            jnp.asarray(est.pose_cam.astype(np.float32)), jnp.asarray(mesh.vertices),
            jnp.asarray(mesh.faces), jnp.ones(len(mesh.faces), bool), jnp.asarray(INTR), H, W)
        final = np.asarray(jraster.composite_min(jnp.asarray(final), d))
    final = np.where(final > cfg_of(jconfig).render.max_render_depth, 0.0, final)
    dumped = depthio.read_depth_png(os.path.join(tdir, "final_assignment_mesh_render.png"),
                                    bit_rotated=False)
    occ, want_occ = dumped > 0, final > 1e-4
    assert want_occ.sum() > 1000
    assert (occ == want_occ).mean() >= 0.999
    both = occ & want_occ
    assert np.abs(dumped[both] - final[both]).max() <= 1e-4 + 1e-6
    info = _load(os.path.join(tdir, f"{names[0]}.json"))
    assert info["score"] == got.objects[0].score
    np.testing.assert_allclose(info["pose_world"], got.objects[0].pose_world, atol=1e-6)


def test_cli_debug_dir(setup, tmp_path, capsys):
    # `cli --debug-dir` on a one-box CAM scene in LCP mode dumps the cleaned
    # depth, the object's prob image, hypotheses and info, and the overlay.
    from physimglobalpose_tpu_torch import cli

    s, tmp = setup, setup["tmp"]
    name, cls = BOXES[0][0], BOXES[0][1]
    np.savez(tmp_path / "scene.npz", color=np.zeros((H, W, 3), np.uint8), depth=s["depth"],
             intrinsics=INTR, cam_pose=s["cam"], object_names=np.array([name]),
             class_mask=np.where(s["label"] == cls, cls, 0))
    (tmp_path / "obj_config.yml").write_text(
        "objects:\n  num_objects: 1\n  modelDiscretization: 0.01\n"
        f"  object_1:\n    name: {name}\n    classId: {cls}\n    symmetry: [180, 180, 180]\n")
    debug_dir = tmp_path / "debug"
    rc = cli.main(["--dataset", "CAM", "--scene", str(tmp_path / "scene.npz"), "--obj-config",
                   str(tmp_path / "obj_config.yml"), "--model-dir", str(tmp), "--cache-dir",
                   str(tmp_path / "cache"), "--preset", "small", "--device", "cpu",
                   "--debug-dir", str(debug_dir)])
    assert rc == 0 and capsys.readouterr().out.startswith(f"{name}: t=(")
    assert sorted(p.name for p in debug_dir.iterdir()) == sorted([
        "depth_clean.png", "depth_clean_viz.png", "final_overlay.png", f"{name}_prob.png",
        f"{name}_hypotheses.npz", f"{name}.json"])
    hyp = _load(str(debug_dir / f"{name}_hypotheses.npz"))
    assert hyp["transforms"].shape == (25, 4, 4) and hyp["scores"].shape == (25,)
    np.testing.assert_array_equal(depthio.read_prob_png(str(debug_dir / f"{name}_prob.png")),
                                  (s["label"] == cls).astype(np.float32))


def test_debug_dump_writers_match_jax(tmp_path):
    # The writers estimate_pose does not call in either package (segment) and
    # the ones it does, on the same arrays (tensors on the port's side): the
    # same files, npz keys and arrays, JSON and PNG bytes.
    import torch

    from physimglobalpose_tpu.utils import debug as jdebug
    from physimglobalpose_tpu_torch.utils import debug

    rng = np.random.default_rng(3)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    prob = rng.uniform(size=(50,)).astype(np.float32)
    mask = rng.uniform(size=(50,)) > 0.3
    depth = rng.uniform(0.5, 1.5, size=(12, 16)).astype(np.float32)
    ours, theirs = debug.DebugDump(str(tmp_path / "ours")), jdebug.DebugDump(str(tmp_path / "jax"))
    for dump, conv in ((ours, torch.as_tensor), (theirs, jnp.asarray)):
        dump.segment("obj", conv(pts), conv(pts * 2), conv(prob), conv(mask))
        dump.depth("d", conv(depth))
        dump.prob_image("obj", conv(depth / 2))
        dump.info("obj", {"score": np.float32(0.5), "pose_world": np.eye(4).tolist()})
    assert not debug.DebugDump(None).enabled
    files = sorted(os.listdir(tmp_path / "ours"))
    assert files == sorted(os.listdir(tmp_path / "jax")) == [
        "d.png", "d_viz.png", "obj.json", "obj_prob.png", "obj_segment.npz"]
    for f in files:
        a, b = _load(str(tmp_path / "ours" / f)), _load(str(tmp_path / "jax" / f))
        if f.endswith(".npz"):
            assert list(a) == list(b) == ["pts", "nrm", "prob", "mask"]
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype
        elif f.endswith(".json"):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)
