"""The port's evaluation sweeps (physimglobalpose_tpu_torch/pipeline/evaluate.py)
on the CPU: a sweep over two scene directories written under tmp_path (the
ray-cast box scene of tests/test_torch_e2e.py, one box a scene, gt_info.yml
with ground-truth poses), its JSONL rows and aggregates, a rerun that skips
the logged scenes, and _metrics_for against the JAX package's on the same
poses (rotation and translation errors within 1e-4, ADD/ADD-S within 1e-6 m,
the exact EMD within 1e-6 bins)."""

import json
import types

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from chip_smoke import box_pose_world, camera_pose, write_box_ply
from physimglobalpose_tpu.pipeline import evaluate as jevaluate
from physimglobalpose_tpu_torch.geometry import depthio
from physimglobalpose_tpu_torch.pipeline import evaluate
from test_torch_e2e import BOXES, H, INTR, W, _render


def _tq(pose):
    """gt_info.yml pose format: [x y z qw qx qy qz]."""
    x, y, z, w = Rotation.from_matrix(pose[:3, :3]).as_quat()
    return [float(v) for v in pose[:3, 3]] + [float(w), float(x), float(y), float(z)]


def _write_scene(scene_dir, cam, box, tmp):
    from PIL import Image

    name, cls, size, xy, yaw = box
    scene_dir.mkdir()
    inv = np.linalg.inv(cam)
    gt_world = box_pose_world(size, xy, yaw)
    verts, faces = write_box_ply(str(tmp / f"{name}.ply"), size)
    table_v = np.array([[-0.4, -0.4, 0], [0.4, -0.4, 0], [0.4, 0.4, 0], [-0.4, 0.4, 0]], np.float32)
    table = _render(inv, table_v, np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    obj = _render(inv @ gt_world, verts, faces)
    near = (obj > 0) & ((table == 0) | (obj < table))
    depth = np.where(near, obj, table).astype(np.float32)
    depthio.write_depth_png(str(scene_dir / "frame-000000.depth.png"), depth, bit_rotated=True)
    Image.fromarray(np.where(near, cls, 0).astype(np.uint8)).save(scene_dir / "frame-000000.mask.png")
    Image.fromarray(np.zeros((H, W, 3), np.uint8)).save(scene_dir / "frame-000000.color.png")
    info = {
        "camera": {"camera_intrinsics": INTR.tolist(), "camera_pose": _tq(cam)},
        "scene": {"num_objects": 1, "object_1": {"name": name, "pose": _tq(gt_world)}},
    }
    (scene_dir / "gt_info.yml").write_text(json.dumps(info))  # JSON is YAML
    return gt_world


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("evaluate")
    cam = camera_pose(distance=0.6)
    dirs, gt = [], {}
    for i, box in enumerate(BOXES):
        d = tmp / f"scene_{i}"
        gt[box[0]] = _write_scene(d, cam, box, tmp)
        dirs.append(str(d))
    lines = "".join(
        f"  object_{i + 1}:\n    name: {name}\n    classId: {cls}\n    symmetry: [180, 180, 180]\n"
        for i, (name, cls, *_rest) in enumerate(BOXES)
    )
    (tmp / "obj_config.yml").write_text(
        f"objects:\n  num_objects: {len(BOXES)}\n  modelDiscretization: 0.01\n{lines}")
    return dict(tmp=tmp, dirs=dirs, gt=gt, log=str(tmp / "eval.jsonl"))


def test_sweep_logs_rows_and_aggregates_then_resumes(sweep, capsys, monkeypatch):
    s, tmp = sweep, sweep["tmp"]
    argv = ["--scenes", str(tmp / "scene_*"), "--log", s["log"], "--obj-config",
            str(tmp / "obj_config.yml"), "--model-dir", str(tmp), "--cache-dir",
            str(tmp / "cache"), "--preset", "small", "--device", "cpu"]
    assert evaluate.main(argv) == 0
    agg = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rows = [json.loads(r) for r in open(s["log"]).read().splitlines()]
    assert [r["scene"] for r in rows] == s["dirs"]
    for row, (name, *_rest) in zip(rows, BOXES):
        assert list(row["objects"]) == [name] and row["seconds"] > 0
        entry = row["objects"][name]
        assert set(entry) == {"score", "rot_err_deg", "trans_err_m", "add_m", "adds_m"}
        assert entry["adds_m"] < 0.01 and entry["score"] > 0.1
    adds = [r["objects"][b[0]]["adds_m"] for r, b in zip(rows, BOXES)]
    add = [r["objects"][b[0]]["add_m"] for r, b in zip(rows, BOXES)]
    assert agg["scenes"] == 2.0 and agg["adds_within_2cm"] == 1.0
    assert agg["mean_adds_m"] == pytest.approx(np.mean(adds))
    assert agg["mean_add_m"] == pytest.approx(np.mean(add))
    assert agg["mean_seconds"] == pytest.approx(np.mean([r["seconds"] for r in rows]))

    # A rerun finds both scenes logged: it runs nothing and aggregates the log.
    def no_run(*a, **k):
        raise AssertionError("a logged scene ran again")

    monkeypatch.setattr(evaluate.api, "estimate_pose", no_run)
    from physimglobalpose_tpu_torch.models import objectdb

    db = objectdb.ObjectDB({}, {})
    assert evaluate.evaluate_scenes(s["dirs"], db, s["log"], device="cpu") == agg
    assert len(open(s["log"]).read().splitlines()) == 2
    assert evaluate.completed_scenes(s["log"]) == set(s["dirs"])


def test_metrics_for_matches_jax():
    rng = np.random.default_rng(6)
    obj = types.SimpleNamespace(
        validation_pts=rng.uniform(-0.05, 0.05, (300, 3)).astype(np.float32),
        symmetry=np.array([180.0, 0.0, 90.0], np.float32),
    )
    gt = np.eye(4, dtype=np.float32)
    gt[:3, :3] = Rotation.from_euler("xyz", [20, -35, 70], degrees=True).as_matrix()
    gt[:3, 3] = [0.1, -0.05, 0.7]
    for rot_deg, shift in (([3, 2, -4], [0.004, -0.002, 0.006]), ([175, 1, 88], [0.0, 0.01, 0.0])):
        est_pose = gt.copy()
        est_pose[:3, :3] = gt[:3, :3] @ Rotation.from_euler("xyz", rot_deg, degrees=True).as_matrix()
        est_pose[:3, 3] += shift
        est = types.SimpleNamespace(pose_world=est_pose.astype(np.float32))
        got = evaluate._metrics_for(est, gt, obj, emd_exact=True)
        want = jevaluate._metrics_for(est, gt, obj, emd_exact=True)
        assert set(got) == set(want)
        assert got["rot_err_deg"] == pytest.approx(want["rot_err_deg"], abs=1e-4)
        assert got["trans_err_m"] == pytest.approx(want["trans_err_m"], abs=1e-6)
        assert got["add_m"] == pytest.approx(want["add_m"], abs=1e-6)
        assert got["adds_m"] == pytest.approx(want["adds_m"], abs=1e-6)
        assert got["emd_bins"] == pytest.approx(want["emd_bins"], abs=1e-6)


def test_sharded_sweep_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError):
        evaluate.evaluate_scenes([], None, str(tmp_path / "log.jsonl"), mesh=object())
    with pytest.raises(NotImplementedError):
        evaluate.main(["--scenes", "x", "--log", str(tmp_path / "l"), "--obj-config", "c",
                       "--model-dir", "m", "--sharded", "--device", "cpu"])
