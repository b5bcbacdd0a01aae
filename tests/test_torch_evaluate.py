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

from _torch_common import write_scene_dir
from chip_smoke import camera_pose, write_obj_config
from physimglobalpose_tpu.pipeline import evaluate as jevaluate
from physimglobalpose_tpu_torch.pipeline import evaluate
from test_torch_e2e import BOXES


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("evaluate")
    cam = camera_pose(distance=0.6)
    dirs, gt = [], {}
    for i, box in enumerate(BOXES):
        d = tmp / f"scene_{i}"
        gt.update(write_scene_dir(d, cam, [box], tmp))
        dirs.append(str(d))
    write_obj_config(tmp, BOXES)
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


def test_sharded_sweep_is_not_ported(sweep, capsys, monkeypatch):
    """Named for what it checked before the sharded sweep was ported; it now
    holds the counterpart of test_scene_sweep.py::test_evaluate_scenes_sharded_logs:
    `--sharded --device cpu` sweeps both scenes through
    scene_sweep.sweep_scenes over an 8-entry CPU device list, logs one row a
    scene (marked sharded, every object within ADD-S 1 cm), and
    evaluate_scenes(mesh=...) on the same log resumes without running."""
    from physimglobalpose_tpu_torch.models import objectdb
    from physimglobalpose_tpu_torch.parallel import mesh as mesh_mod, scene_sweep

    s, tmp = sweep, sweep["tmp"]
    log = str(tmp / "sharded.jsonl")
    argv = ["--scenes", str(tmp / "scene_*"), "--log", log, "--obj-config",
            str(tmp / "obj_config.yml"), "--model-dir", str(tmp), "--cache-dir",
            str(tmp / "cache"), "--preset", "small", "--device", "cpu", "--sharded"]
    assert evaluate.main(argv) == 0
    agg = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    rows = [json.loads(r) for r in open(log).read().splitlines()]
    assert [r["scene"] for r in rows] == s["dirs"]
    for row, (name, *_rest) in zip(rows, BOXES):
        assert row["sharded"] is True and row["batch_scenes"] == 2
        assert row["scenes_per_sec"] > 0 and row["seconds"] > 0
        assert list(row["objects"]) == [name] and row["objects"][name]["adds_m"] < 0.01
    assert agg["scenes"] == 2.0 and agg["adds_within_2cm"] == 1.0

    def no_run(*a, **k):
        raise AssertionError("a logged scene ran again")

    monkeypatch.setattr(scene_sweep, "sweep_scenes", no_run)
    monkeypatch.setattr(evaluate.api, "estimate_pose", no_run)
    mesh = mesh_mod.make_mesh(8, device="cpu")
    assert evaluate.evaluate_scenes(s["dirs"], objectdb.ObjectDB({}, {}), log, mesh=mesh,
                                    device="cpu") == agg
    assert len(open(log).read().splitlines()) == 2
