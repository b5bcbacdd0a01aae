"""The port's evaluation and measurement entry points on the CPU
(physimglobalpose_tpu_torch/scripts/): bench_scoring, whole_scene_bench,
server_loadtest and eval_fcn_checkpoints, the ports of the JAX package's
bench.py and scripts/{whole_scene_bench,server_loadtest,eval_fcn_checkpoints}.py.

Each tool runs at the sizes of a CPU test: bench_scoring at --preset small,
whole_scene_bench and server_loadtest at their small preset with its caps cut
further for the CPU (the PRESETS entry replaced, and 16 search expansions),
one repeat and two clients, on a scene of the port's generator. Each writes
the keys the JAX script writes; each raises where it is asked for a card that
is absent. The FCN figures (eval_fcn_checkpoints' mIoU, whole_scene_bench's
real-frame IoU and its neural rows' pose agreement) are held to the JAX
package's networks and metrics on the same inputs."""

import contextlib
import io
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from _torch_common import CPU
from chip_smoke import BOXES, write_box_ply, write_obj_config
from physimglobalpose_tpu.geometry import metrics as jmetrics
from physimglobalpose_tpu.models import fcn as jfcn
from physimglobalpose_tpu_torch import config as tconfig
from physimglobalpose_tpu_torch.scripts import (
    bench_scoring,
    eval_fcn_checkpoints,
    make_synthetic_scenes,
    server_loadtest,
    whole_scene_bench,
)

# The small preset cut for CPU runs: 64 hypotheses an object, a search of 16
# expansions in batches of 8.
TINY = tconfig.PipelineConfig(
    preprocess=tconfig.PreprocessConfig(max_segment_points=128),
    stocs=tconfig.StoCSConfig(num_bases=8, max_quads_per_base=8, max_pairs_per_ppf=32),
    mcts=tconfig.MCTSConfig(max_expansions=16, leaf_batch=8, leaf_batch_multi=16, branching=4),
    max_model_points=128, max_validation_points=256,
)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """One plain scene of the three boxes from the port's generator."""
    tmp = tmp_path_factory.mktemp("tools")
    for name, _cls, size, *_rest in BOXES:
        write_box_ply(str(tmp / f"{name}.ply"), size)
    obj_cfg = write_obj_config(tmp, BOXES)
    make_synthetic_scenes.main(["--out", str(tmp / "scenes"), "--n", "1", "--objects",
                                ",".join(b[0] for b in BOXES), "--model-dir", str(tmp),
                                "--obj-config", str(obj_cfg), "--device", "cpu"])
    return dict(tmp=tmp, scene=str(tmp / "scenes" / "scene_0000"), model_dir=str(tmp),
                obj_config=str(obj_cfg), cache=str(tmp / "cache"),
                flags=["--model-dir", str(tmp), "--obj-config", str(obj_cfg),
                       "--cache-dir", str(tmp / "cache"), "--device", "cpu"])


@pytest.fixture
def tiny_preset(monkeypatch):
    monkeypatch.setitem(tconfig.PRESETS, "small", TINY)


@pytest.fixture(scope="module")
def wsb(scene, tmp_path_factory):
    """whole_scene_bench's report on the scene, and its flushed file."""
    out_path = tmp_path_factory.mktemp("wsb") / "wsb.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tconfig.PRESETS, "small", TINY)
        got, _ = _stdout(whole_scene_bench.main, [
            "--scene", scene["scene"], "--repeat", "1", "--sweep-scenes", "2",
            "--fcn-variants", "small", "--real-frame", "--out", str(out_path)] + scene["flags"])
    return got, out_path


# The FCN figures against the JAX networks' on the same images: argmax labels
# at >= LABEL_AGREEMENT of the pixels, (m)IoU within IOU_TOL (measured on the
# CPU: 0.99977 or more of the pixels, mIoU within 3.4e-5).
LABEL_AGREEMENT = 0.999
IOU_TOL = 1e-3


def _jax_net(path):
    params, meta = jfcn.load_params_npz(path)
    return params, meta, jfcn.build_model(meta["model"], num_classes=meta["num_classes"])


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue()


def test_bench_scoring_gates_then_prints_one_line(capsys):
    assert bench_scoring.main(["--device", "cpu", "--preset", "small"]) == 0
    out, err = capsys.readouterr()
    [line] = out.strip().splitlines()
    got = json.loads(line)
    assert list(got) == ["metric", "value", "unit", "vs_baseline"]
    assert got["metric"] == "hypotheses_scored_per_sec_per_chip" and got["value"] > 0
    assert "H=384 x1 pipelined, easy, cpu" in got["unit"]
    assert got["vs_baseline"] == round(got["value"] / bench.baseline_hyps_per_sec(False), 2)
    assert "fidelity gates passed (easy)" in err
    for clutter in (False, True):  # the same data read as bench.py reads it
        assert bench_scoring.baseline_hyps_per_sec(clutter) == bench.baseline_hyps_per_sec(clutter)


def test_bench_scoring_prints_nothing_when_a_gate_fails(capsys):
    # The production flags are tuned for the full shape: at the small one
    # the clutter gate fails, and the tool raises before timing anything.
    with pytest.raises(AssertionError, match="survive"):
        bench_scoring.main(["--device", "cpu", "--preset", "small", "--variant", "clutter"])
    assert capsys.readouterr().out == ""


def test_whole_scene_bench_writes_the_jax_keys(wsb):
    got, out_path = wsb
    names = [b[0] for b in BOXES]
    jax_keys = {
        "backend", "scene", "objects", "timestamp", "lcp_seconds_per_scene_warm",
        "lcp_sweep_scenes_per_sec", "lcp_sweep_batch", "lcp_sweep_timings",
        "lcp_sweep_pipelined2_scenes_per_sec", "lcp_sweep_pipelined2_preprocess_host_s",
        "lcp_sweep_pipelined4_scenes_per_sec", "lcp_sweep_pipelined4_preprocess_host_s",
        "pipelined_note", "mcts_seconds_per_scene_warm", "mcts_sweep_scenes_per_sec",
        "mcts_sweep_seconds_per_scene", "fcn_small_lcp_seconds_per_scene_warm",
        "fcn_small_predictor_seconds_per_scene", "fcn_small_vs_golden_pose",
        "fcn_small_mcts_seconds_per_scene_warm", "fcn_small_mcts_predictor_seconds_per_scene",
        "fcn_real_frame_miou",
    }
    assert jax_keys <= set(got)
    assert json.loads(out_path.read_text()) == got  # flushed
    assert got["backend"] == "cpu" and got["objects"] == 3 and got["lcp_sweep_batch"] == 2
    assert got["lcp_seconds_per_scene_warm"] > 0 and got["mcts_sweep_scenes_per_sec"] > 0
    assert 0 < got["fcn_small_predictor_seconds_per_scene"] < got[
        "fcn_small_lcp_seconds_per_scene_warm"]
    assert {"preprocess_s", "device_s", "scenes_per_sec"} <= set(got["lcp_sweep_timings"])
    for key in ("fcn_small_vs_golden_pose", "lcp_pose_world", "fcn_small_pose_world"):
        assert set(got[key]) == set(names)


def test_whole_scene_bench_pose_agreement_is_the_jax_metric(wsb):
    # The neural row's agreement with the GT-segmentation row: JAX's
    # pose_error on the two rows' poses, to the rounding of the report.
    got, _ = wsb
    for name, sym in ((b[0], [180.0, 180.0, 180.0]) for b in BOXES):
        rot, tr = jmetrics.pose_error(jnp.asarray(got["fcn_small_pose_world"][name], jnp.float32),
                                      jnp.asarray(got["lcp_pose_world"][name], jnp.float32),
                                      jnp.asarray(sym, jnp.float32))
        agree = got["fcn_small_vs_golden_pose"][name]
        assert agree["rot_deg"] == pytest.approx(float(rot), abs=0.005 + 1e-3)
        assert agree["trans_m"] == pytest.approx(float(tr), abs=5e-5 + 1e-6)


def test_whole_scene_bench_real_frame_row_is_jax(wsb, scene):
    # The JAX script's row: make_labeler on the scene's colour frame and its
    # per-class loop against the mask, for every shipped checkpoint.
    from PIL import Image

    real = wsb[0]["fcn_real_frame_miou"]
    assert real["classes"] == [b[1] for b in BOXES]
    color = np.asarray(Image.open(os.path.join(scene["scene"], "frame-000000.color.png"))
                       .convert("RGB"))
    gt_mask = np.asarray(Image.open(os.path.join(scene["scene"], "frame-000000.mask.png")))
    rows = [(v, v, (1.0,)) for v in ("small", "full", "transfer", "prior")
            if os.path.exists(jfcn.shipped_checkpoint_path(v))]
    rows.append(("prior_tta", "prior", (0.5, 0.75, 1.0)))
    assert {r[0] for r in rows} == set(real) - {"classes"}
    for row, variant, tta in rows:
        params, _meta, model = _jax_net(jfcn.shipped_checkpoint_path(variant))
        label = jfcn.make_labeler(model, *color.shape[:2], tta_scales=tta)(
            jax.device_put(params), color)
        for c in real["classes"]:
            inter = float(((label == c) & (gt_mask == c)).sum())
            union = float(((label == c) | (gt_mask == c)).sum())
            want = round(inter / union, 4) if union else 0.0
            assert real[row]["per_class_iou"][str(c)] == pytest.approx(want, abs=IOU_TOL), row
        ious = real[row]["per_class_iou"].values()
        assert real[row]["miou"] == pytest.approx(sum(ious) / len(ious), abs=1e-4)


def test_server_loadtest_writes_the_jax_keys_and_measures_boots(scene, tiny_preset, tmp_path,
                                                                monkeypatch):
    out_path = str(tmp_path / "loadtest.json")
    rc, _ = _stdout(server_loadtest.main, [
        "--scene", scene["scene"], "--clients", "2", "--requests", "3",
        "--out", out_path] + scene["flags"])
    assert rc == 0
    report = json.loads(open(out_path).read())["cpu"]
    assert {"config", "warm_compile_s", "completed", "requests_per_sec", "latency_s",
            "queue_depth_on_arrival", "shed_503", "errors", "policy", "timestamp"} <= set(report)
    assert report["config"]["clients"] == 2 and report["config"]["max_queue"] == 1
    assert report["completed"] >= 3 and report["errors"] == []
    lat = report["latency_s"]
    assert 0 < lat["p50"] <= lat["p95"] <= lat["max"]
    # Two clients and one waiter allowed: a request finds at most one ahead.
    assert report["queue_depth_on_arrival"]["max"] <= 1
    assert report["shed_503"]["count"] == 0
    answer = report["response_pose_world"]
    assert set(answer) == {b[0] for b in BOXES}
    assert all(np.isfinite(answer[n]).all() and np.shape(answer[n]) == (4, 4) for n in answer)

    # measure-boots: the boot in a fresh process; here the child's command runs
    # in this process (the small preset is replaced here only).
    commands = []
    subprocess_run = server_loadtest.subprocess.run

    def run_here(cmd, **kw):
        if cmd[1:3] != ["-m", "physimglobalpose_tpu_torch.scripts.server_loadtest"]:
            return subprocess_run(cmd, **kw)  # another caller's command
        assert kw["cwd"] == server_loadtest.ROOT
        commands.append(cmd)
        rc, out = _stdout(server_loadtest.main, cmd[3:])
        return type("Done", (), {"returncode": rc, "stdout": out, "stderr": ""})

    monkeypatch.setattr(server_loadtest.subprocess, "run", run_here)
    rc, _ = _stdout(server_loadtest.main, [
        "--scene", scene["scene"], "--phase", "measure-boots",
        "--out", out_path] + scene["flags"])
    assert rc == 0 and len(commands) == 1 and "warm-boot" in commands[0]
    merged = json.loads(open(out_path).read())["cpu"]
    assert merged["completed"] == report["completed"]  # the load test's section stays
    boots = merged["warm_boots"]
    assert set(boots) == {"boot1", "note"}
    assert {"boot_s", "warmup_s", "warmup_compile_s", "warmup_run_s",
            "process_wall_s"} <= set(boots["boot1"])
    assert boots["boot1"]["warmup_s"] > 0


def test_eval_fcn_iou_is_the_jax_loop():
    # A fixed label pair: class 2 overlaps, 5 is missed, 7 exists in the
    # prediction only (not scored), 9 has an empty prediction.
    label = np.zeros((6, 8), np.int32)
    label[0:3, 0:4] = 2
    label[3:6, 4:8] = 5
    label[5, 0] = 9
    pred = np.zeros_like(label)
    pred[0:2, 0:5] = 2
    pred[3:6, 0:2] = 7

    want = []  # scripts/eval_fcn_checkpoints.py's loop, verbatim
    for cid in set(np.unique(label)) - {0}:
        inter = ((pred == cid) & (label == cid)).sum()
        union = ((pred == cid) | (label == cid)).sum()
        if union:
            want.append(inter / union)
    got = eval_fcn_checkpoints.per_class_iou(pred, label)
    assert list(got) == [2, 5, 9] and sorted(got.values()) == sorted(want)
    assert got == {2: 8 / 14, 5: 0.0, 9: 0.0}
    assert eval_fcn_checkpoints.per_class_iou(pred, label, [7, 2, 3]) == {7: 0.0, 2: 8 / 14, 3: 0.0}


def test_eval_fcn_scores_the_shipped_checkpoints(scene, monkeypatch):
    # One held-out scene a set: the table's figures for every checkpoint the
    # JAX script would find, at both serving scales, each held to the JAX
    # script's network (its `infer`) and loop on the same renders.
    monkeypatch.setattr(eval_fcn_checkpoints, "HELDOUT_SCENES", 1)
    names = [b[0] for b in BOXES]
    results, out = _stdout(eval_fcn_checkpoints.main, ["--objects", ",".join(names)]
                           + scene["flags"])
    assert [name for name, _ in eval_fcn_checkpoints.checkpoints()] == ["small"]
    assert list(results) == ["small"]
    assert results["small"]["model"] == "AtrousFCN_Vgg16_16s_small"
    lines = out.strip().splitlines()
    assert lines[0].split()[:2] == ["checkpoint", "model"] and lines[1].startswith("small")
    assert json.loads(lines[-1])["checkpoints"] == results

    meshes, class_ids = eval_fcn_checkpoints.load_meshes(
        scene["obj_config"], scene["model_dir"], names, scene["cache"])
    scene_sets = eval_fcn_checkpoints.heldout_scenes(meshes, class_ids, CPU)
    for name, path in eval_fcn_checkpoints.checkpoints():
        params, meta, jmodel = _jax_net(path)
        infer = jax.jit(lambda p, img: jnp.argmax(jmodel.apply({"params": p}, img[None])[0],
                                                  axis=-1))
        model, _ = eval_fcn_checkpoints.load_checkpoint(path, CPU)
        for (scale, dist), scenes in scene_sets.items():
            ious = []
            for c_img, l_img in scenes:
                pred = np.asarray(infer(params, jnp.asarray(c_img.astype(np.float32) / 255.0)))
                ours = eval_fcn_checkpoints.argmax_labels(model, c_img, CPU)
                assert ours.shape == pred.shape == l_img.shape
                assert (ours == pred).mean() >= LABEL_AGREEMENT, (name, scale, dist)
                for cid in set(np.unique(l_img)) - {0}:  # the JAX script's loop
                    inter = ((pred == cid) & (l_img == cid)).sum()
                    union = ((pred == cid) | (l_img == cid)).sum()
                    if union:
                        ious.append(inter / union)
            want = float(np.mean(ious)) if ious else 0.0
            got = results[name]["miou"][scale]["domain_random" if dist else "plain"]
            assert got == pytest.approx(want, abs=IOU_TOL), (name, scale, dist)


def test_no_default_output_is_a_file_of_the_repo():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for path in (whole_scene_bench.DEFAULT_OUT, server_loadtest.DEFAULT_OUT):
        assert path.startswith(tempfile.gettempdir()) and not path.startswith(root)
    args = whole_scene_bench.parse_args(["--scene", "s", "--model-dir", "m", "--obj-config", "c"])
    assert args.out == whole_scene_bench.DEFAULT_OUT and args.device == "cuda"


@pytest.mark.parametrize("tool", ["make_synthetic_scenes", "bench_scoring", "whole_scene_bench",
                                  "server_loadtest", "eval_fcn_checkpoints"])
def test_each_tool_defaults_to_the_card_and_raises_without_one(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run on it")
    argv = {
        "make_synthetic_scenes": ["--out", str(tmp_path), "--model-dir", "m", "--obj-config", "c"],
        "bench_scoring": [],
        "whole_scene_bench": ["--scene", "s", "--model-dir", "m", "--obj-config", "c"],
        "server_loadtest": ["--scene", "s", "--model-dir", "m", "--obj-config", "c"],
        "eval_fcn_checkpoints": ["--model-dir", "m", "--obj-config", "c"],
    }[tool]
    module = globals()[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv)
    assert not any(tmp_path.iterdir())
