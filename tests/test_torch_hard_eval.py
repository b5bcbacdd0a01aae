"""The port's hard-family accuracy tools on the CPU
(physimglobalpose_tpu_torch/scripts/{r4_hard_eval,r5_eval,r5_hard_miss_analysis}.py)
against the JAX package's scripts of the same names.

The JAX scripts are imported from scripts/ by path, their module globals
pointed at procedural box meshes under the test's temporary directory, and
the JAX script's fixed /tmp log paths redirected there. Held:
- the sections: with evaluate_scenes and load_object_db stubbed in both
  packages to the same rows, r4_hard_eval's "hard" section and each r5_eval
  family's are equal key for key and value for value, apart from backend,
  timestamp and wall_s;
- _detection_quality with the shipped detector on two generated scenes: the
  same instances, misses and hits, each box's IoU within DET_IOU_TOL (the
  detection network's float32 logits agree within 1e-4 of scale, which can
  move a box edge by a pixel);
- the joint cost substitution: the port's costs against JAX's
  mcts._poses_cost_jit on the same poses within TOL_COST pixels, at
  render_scale and at 1 (the leaf render's tolerance, test_torch_mcts.py);
- the miss report, verdict_hint included, on constructed numbers that reach
  each branch of the rule, with the pipeline stubbed in both packages;
- a port-only run of r4_hard_eval on one hard scene at a small search
  budget: the JAX section's keys, finite values, --out merged per mode.
"""

import builtins
import importlib.util
import json
import math
import os
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import CPU
from chip_smoke import BOXES, write_box_ply, write_obj_config
from physimglobalpose_tpu.models import objectdb as jobjectdb
from physimglobalpose_tpu.pipeline import api as japi
from physimglobalpose_tpu.pipeline import detector as jdetector
from physimglobalpose_tpu.pipeline import evaluate as jevaluate
from physimglobalpose_tpu.pipeline import mcts as jmcts
from physimglobalpose_tpu.pipeline import scene as jscene
from physimglobalpose_tpu.pipeline import segmentation as jsegmentation
from physimglobalpose_tpu_torch import config as tconfig
from physimglobalpose_tpu_torch.models import objectdb
from physimglobalpose_tpu_torch.pipeline import api, detector, evaluate, mcts, scene, segmentation
from physimglobalpose_tpu_torch.scripts import (
    make_synthetic_scenes,
    r4_hard_eval,
    r5_eval,
    r5_hard_miss_analysis as miss,
)
from test_torch_mcts import K_INTR, _cfgs, box_object, pose_at, render_obs

ROOT = pathlib.Path(__file__).resolve().parent.parent
NAMES = [b[0] for b in BOXES]
DET_IOU_TOL = 0.02
TOL_COST = 2.0  # pixels

# The small preset cut for CPU runs (tests/test_torch_eval_tools.py's TINY):
# 64 hypotheses an object, a search of 16 expansions in batches of 8.
TINY = tconfig.PipelineConfig(
    preprocess=tconfig.PreprocessConfig(max_segment_points=128),
    stocs=tconfig.StoCSConfig(num_bases=8, max_quads_per_base=8, max_pairs_per_ppf=32),
    mcts=tconfig.MCTSConfig(max_expansions=16, leaf_batch=8, leaf_batch_multi=16, branching=4),
    max_model_points=128, max_validation_points=256,
)


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """The three boxes' PLYs, their obj_config.yml, and two --hard and two
    plain scenes of them from the port's generator."""
    tmp = tmp_path_factory.mktemp("hard_eval")
    for name, _cls, size, *_rest in BOXES:
        write_box_ply(str(tmp / f"{name}.ply"), size)
    obj_cfg = write_obj_config(tmp)
    flags = ["--n", "2", "--objects", ",".join(NAMES), "--model-dir", str(tmp),
             "--obj-config", str(obj_cfg), "--device", "cpu"]
    make_synthetic_scenes.main(["--out", str(tmp / "hard"), "--hard"] + flags)
    make_synthetic_scenes.main(["--out", str(tmp / "plain")] + flags)
    return dict(dir=str(tmp), obj_config=str(obj_cfg), hard=str(tmp / "hard"),
                plain=[str(tmp / "plain" / f"scene_{i:04d}") for i in range(2)])


def _redirect_tmp(monkeypatch, module, tmp_path):
    """The JAX script's fixed /tmp/<name> files go to tmp_path/<name>: returns
    the mapping, installed as the module's `open`."""
    def where(path):
        path = str(path)
        return str(tmp_path / os.path.basename(path)) if os.path.dirname(path) == "/tmp" else path

    monkeypatch.setattr(module, "open", lambda path, *a, **k: builtins.open(where(path), *a, **k),
                        raising=False)
    return where


# --------------------------------------------------------------- sections


class _FakeDB:
    def __init__(self, only):
        self.names = list(only)

    def class_of(self, name):
        return self.names.index(name) + 1


def _fake_rows(scene_dirs, names, mode):
    """Fixed ADD-S values with more digits than the sections keep, differing
    by scene, object and mode; one miss over 2 cm a mode."""
    salt = {"LCP": 1, "MCTS": 2, "GREEDY": 3}[mode]
    return [{"scene": sd, "seconds": 1.0, "objects": {
        n: {"score": 0.5, "add_m": 0.01,
            "adds_m": 0.003 * math.sqrt(1 + i + 2 * j + salt) + (0.03 if (i, j) == (1, 2) else 0)}
        for j, n in enumerate(names)}} for i, sd in enumerate(scene_dirs)]


def _stub_pipeline(monkeypatch, where, records):
    """evaluate_scenes and load_object_db of both packages -> the same fakes;
    _detection_quality of both scripts recorded and fixed."""
    def load_object_db(config_yaml, model_dir, config=None, cache_dir=None, only=None, **_kw):
        return _FakeDB(only)

    def evaluate_scenes(scene_dirs, db, log_path, verification_mode="LCP", **_kw):
        rows = _fake_rows(scene_dirs, db.names, verification_mode)
        with builtins.open(where(log_path), "w") as fh:
            fh.writelines(json.dumps(r) + "\n" for r in rows)
        adds = np.asarray([e["adds_m"] for r in rows for e in r["objects"].values()])
        return {"scenes": float(len(rows)), "mean_adds_m": float(adds.mean()),
                "adds_within_2cm": float(np.mean(adds < 0.02))}

    for mod in (jobjectdb, objectdb):
        monkeypatch.setattr(mod, "load_object_db", load_object_db)
    for mod in (jevaluate, evaluate):
        monkeypatch.setattr(mod, "evaluate_scenes", evaluate_scenes)
    return load_object_db


def _comparable(section):
    out = {k: v for k, v in section.items() if k not in ("backend", "timestamp")}
    for mode in ("LCP", "MCTS", "GREEDY"):
        if mode in out:
            out[mode] = {k: v for k, v in out[mode].items() if k != "wall_s"}
    return out


@pytest.mark.parametrize("family", ["hard", "hard_ycb", "hard_six", "rcnn"])
def test_sections_equal_the_jax_scripts(meshes, family, tmp_path, monkeypatch):
    records = []
    if family == "hard":
        jax_mod = _jax_script("r4_hard_eval")
        monkeypatch.setattr(jax_mod, "OBJECTS", ",".join(NAMES))
        monkeypatch.setattr(jax_mod, "OBJ_CFG", meshes["obj_config"])
        jax_argv = ["--scenes", "2", "--dir", meshes["hard"]]
        port_argv = jax_argv + ["--objects", ",".join(NAMES)]
        port_main = r4_hard_eval.main
    else:
        jax_mod = _jax_script("r5_eval")
        for key in ("OBJ_CFG_APC", "OBJ_CFG_YCB"):
            monkeypatch.setattr(jax_mod, key, meshes["obj_config"])
        for fam in jax_mod.FAMILIES:
            monkeypatch.setitem(jax_mod.FAMILIES, fam, dict(
                jax_mod.FAMILIES[fam], objects=",".join(NAMES), obj_config=meshes["obj_config"]))

        def detection_quality(scene_dirs, db, class_ids, device=None):
            records.append((list(scene_dirs), list(class_ids)))
            return {"instances": 6, "mean_box_iou": 0.5, "recall_at_0.5": 0.5, "missed": 1}

        monkeypatch.setattr(jax_mod, "_detection_quality", detection_quality)
        monkeypatch.setattr(r5_eval, "_detection_quality", detection_quality)
        jax_argv = ["--family", family, "--scenes", "2", "--dir", meshes["hard"]]
        port_argv = jax_argv + ["--objects", ",".join(NAMES)]
        port_main = r5_eval.main
    monkeypatch.setattr(jax_mod, "MODELS", meshes["dir"])
    where = _redirect_tmp(monkeypatch, jax_mod, tmp_path)
    _stub_pipeline(monkeypatch, where, records)

    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port" / "synth_eval.json"
    jax_out.write_text("{}")  # the JAX script reads --out before it writes it
    assert jax_mod.main(jax_argv + ["--out", str(jax_out)]) == 0
    assert port_main(port_argv + ["--out", str(port_out), "--model-dir", meshes["dir"],
                                  "--obj-config", meshes["obj_config"], "--device", "cpu"]) == 0
    want = json.loads(jax_out.read_text())[family]
    got = json.loads(port_out.read_text())[family]
    assert _comparable(got) == _comparable(want)
    assert got["backend"] == {"device": "cpu"}
    modes = {"hard": ["LCP", "MCTS", "GREEDY"], "rcnn": ["LCP"]}.get(family, ["LCP", "MCTS"])
    assert [m for m in ("LCP", "MCTS", "GREEDY") if m in got] == modes
    assert got[modes[0]]["worst3"][0]["obj"] == NAMES[2]  # the planted miss
    if family == "rcnn":
        assert records[0] == records[1] and records[0][1] == [1, 2, 3]


# ---------------------------------------------------------- detection


def _recording(monkeypatch, module, boxes):
    """Wrap module.make_learned_detector: every answer is appended to boxes."""
    make = module.make_learned_detector

    def wrapped(*a, **k):
        det = make(*a, **k)

        def run(color, class_ids, **kw):
            out = det(color, class_ids, **kw)
            boxes.append(dict(out))
            return out
        return run

    monkeypatch.setattr(module, "make_learned_detector", wrapped)


def test_detection_quality_matches_jax(meshes, monkeypatch):
    from PIL import Image

    jax_boxes, port_boxes = [], []
    _recording(monkeypatch, jdetector, jax_boxes)
    _recording(monkeypatch, detector, port_boxes)
    want = _jax_script("r5_eval")._detection_quality(meshes["plain"], None, [1, 2, 3])
    got = r5_eval._detection_quality(meshes["plain"], None, [1, 2, 3], device="cpu")
    assert got["instances"] == want["instances"] == 6
    assert got["missed"] == want["missed"]
    assert got["recall_at_0.5"] == want["recall_at_0.5"]
    assert got["mean_box_iou"] == pytest.approx(want["mean_box_iou"], abs=DET_IOU_TOL)
    for sd, jb, pb in zip(meshes["plain"], jax_boxes, port_boxes):
        assert sorted(jb) == sorted(pb)
        mask = np.asarray(Image.open(os.path.join(sd, "frame-000000.mask.png")))
        for cid in jb:
            ys, xs = np.nonzero(mask == cid)
            gt = (xs.min(), ys.min(), xs.max(), ys.max())
            j_iou, p_iou = r5_eval.box_iou(gt, jb[cid]), r5_eval.box_iou(gt, pb[cid])
            assert p_iou == pytest.approx(j_iou, abs=DET_IOU_TOL), (sd, cid)
            assert (p_iou >= 0.5) == (j_iou >= 0.5)


def test_box_iou_is_the_jax_scripts_formula():
    assert r5_eval.box_iou((0, 0, 10, 10), (0, 0, 10, 10)) == 1.0
    assert r5_eval.box_iou((0, 0, 10, 10), (5, 0, 15, 10)) == pytest.approx(50 / 150)
    assert r5_eval.box_iou((0, 0, 10, 10), (20, 20, 30, 30)) == 0.0
    assert r5_eval.box_iou((0, 0, 10, 10), (8, 8, 4, 4)) == 0.0  # an inverted box


# ------------------------------------------------- joint cost substitution


def test_joint_cost_substitution_matches_poses_cost_jit():
    # Two boxes on test_torch_mcts.py's decoy table (world == camera); the
    # search's result has both off, "gt_*" swap one or both for the truth.
    a, b = box_object(0.06), box_object(0.05, seed=1)
    true = [pose_at(0.0, 0.0, 0.89), pose_at(0.09, 0.02, 0.885)]
    chosen = [pose_at(0.015, -0.01, 0.89), pose_at(0.07, 0.05, 0.885)]
    tcfg, jcfg = _cfgs()
    rows = {"chosen": np.stack(chosen).astype(np.float64),
            "gt_all": np.stack(true).astype(np.float64)}
    for i, name in enumerate(("a", "b")):
        sub = rows["chosen"].copy()
        sub[i] = true[i]
        rows[f"gt_{name}"] = sub
    hyp_world = np.stack([np.stack([c, t]) for c, t in zip(chosen, true)])  # [K, C, 4, 4]
    inputs = dict(obj_hulls=[a, b], hyp_world=hyp_world,
                  depth=render_obs([(a, true[0]), (b, true[1])]), intrinsics=K_INTR,
                  cam_pose=np.eye(4, dtype=np.float32), table_pose=pose_at(0.0, 0.0, 0.66),
                  rows=rows)
    got = miss.substitution_costs(inputs, tcfg, device="cpu")
    assert list(got) == [f"scale_{tcfg.mcts.render_scale}", "scale_1"]
    for scale in (jcfg.mcts.render_scale, 1):
        # The JAX script's step 5 loop on the same inputs.
        ev = jmcts.BatchedLeafEvaluator(
            inputs["obj_hulls"], hyp_world, inputs["depth"], K_INTR, inputs["cam_pose"],
            inputs["table_pose"], jcfg, render_scale=scale)
        act = np.ones(2, bool)
        for label, poses in rows.items():
            want = float(np.asarray(jmcts._poses_cost_jit(
                ev.consts_full, jcfg, ev.h, ev.w, ev.splat_radius,
                jnp.asarray(poses.astype(np.float32))[None], jnp.asarray(act)))[0])
            assert abs(got[f"scale_{scale}"][label] - want) <= TOL_COST, (scale, label)
    full = got["scale_1"]
    assert full["gt_all"] < full["gt_a"] < full["chosen"] and full["gt_b"] < full["chosen"]


# ------------------------------------------------------ the miss report


# (case, offsets (m) of the branch set from GT, of the three candidates from
# the chosen pose and their costs, of those from GT and their costs)
VERDICT_CASES = [
    ("hypothesis ceiling", [0.03, 0.05], ([0.03, 0.031, 0.04], [5, 4, 6]),
     ([0.002, 0.001, 0.003], [3, 2, 4])),
    ("data ceiling (GT-start refines away or costs more)", [0.03, 0.015],
     ([0.03, 0.031, 0.04], [5, 4, 6]), ([0.015, 0.012, 0.02], [5, 3, 6])),
    ("data ceiling (GT-start refines away or costs more)", [0.03, 0.015],
     ([0.03, 0.031, 0.04], [5, 4, 6]), ([0.002, 0.001, 0.003], [4, 4, 6])),
    ("search/refinement gap - fixable", [0.03, 0.015], ([0.03, 0.031, 0.04], [5, 4, 6]),
     ([0.002, 0.001, 0.003], [4, 3, 6])),
]


def _offset(dz):
    return pose_at(0.0, 0.0, 0.8 + dz)


class _FakeEvaluator:
    """The leaf evaluator with the case's final-pass answers: the first call
    (from the chosen pose) gets the first, the second (from GT) the other."""
    answers = []

    def __init__(self, obj_hulls, hyp_world, depth, intr, cam, table, cfg, render_scale=None,
                 device=None):
        self.consts_full, self.cfg, self.h, self.w, self.splat_radius = {}, cfg, 30, 40, 0
        self.device = CPU

    def evaluate_final_tricp(self, choices, active, seg_pts, seg_mask):
        offsets, costs = _FakeEvaluator.answers.pop(0)
        return (np.asarray(costs, np.float32),
                np.stack([_offset(dz)[None] for dz in offsets]))


def _pose_cost(poses):
    """The stubbed render cost of a pose set: its translations' sum, in mm."""
    return 1000.0 * float(np.abs(np.asarray(poses, np.float64)[..., :3, 3]).sum())


@pytest.mark.parametrize("case", range(len(VERDICT_CASES)))
def test_miss_report_and_verdict_match_jax(case, tmp_path, monkeypatch):
    hint, branch, from_chosen, from_gt = VERDICT_CASES[case]
    name, sd = "box_a", str(tmp_path / "scene_0003")
    gt = _offset(0.0)
    hyps = np.stack([_offset(dz) for dz in branch])
    est = types.SimpleNamespace(name=name, pose_cam=hyps[0], pose_world=hyps[0], hypotheses=hyps,
                                hypothesis_scores=np.array([0.9, 0.8], np.float32), score=0.9)
    res = types.SimpleNamespace(objects=[est], pose_of=lambda n: est)
    obj = types.SimpleNamespace(validation_pts=np.zeros((1, 3), np.float32), class_id=1,
                                symmetry=[180.0, 180.0, 180.0])
    sc = types.SimpleNamespace(cam_pose=np.eye(4, dtype=np.float32), gt_poses={name: gt},
                               depth=np.zeros((8, 8), np.float32), intrinsics=K_INTR,
                               class_mask=np.ones((8, 8), np.int32))
    seg_mask = np.arange(16) < 11
    log = tmp_path / "mcts.jsonl"
    log.write_text(json.dumps({"scene": sd, "objects": {name: {"adds_m": 0.0312},
                                                        "box_b": {"adds_m": 0.004}}}) + "\n")
    hulls = [{"hull_pts": np.zeros((8, 3), np.float32)}]

    def search_inputs(ests, sc_, db_, cfg_):
        return hyps[None], np.zeros((1, 2), np.float32), hulls

    # The same fakes in both packages, arrays of each package's kind.
    for arr, sc_mod, api_mod, seg_mod, mcts_mod, db_mod in (
            (jnp.asarray, jscene, japi, jsegmentation, jmcts, jobjectdb),
            (torch.as_tensor, scene, api, segmentation, mcts, objectdb)):
        monkeypatch.setattr(sc_mod, "load_scene", lambda *a, **k: sc)
        monkeypatch.setattr(sc_mod, "remove_table", lambda depth, intr, *a, arr=arr, **k: (
            arr(np.zeros((8, 8), np.float32)), arr(np.zeros(4, np.float32)),
            arr(np.eye(4, dtype=np.float32))))
        monkeypatch.setattr(seg_mod, "compute_3d_segment", lambda *a, arr=arr, **k: (
            types.SimpleNamespace(pts=arr(np.zeros((16, 3), np.float32)), mask=arr(seg_mask))))
        monkeypatch.setattr(api_mod, "estimate_pose", lambda *a, **k: res)
        monkeypatch.setattr(mcts_mod, "_scene_search_inputs", search_inputs)
        monkeypatch.setattr(mcts_mod, "BatchedLeafEvaluator", _FakeEvaluator)
        monkeypatch.setattr(db_mod, "load_object_db", lambda *a, **k: {name: obj})
    monkeypatch.setattr(jmcts, "_poses_cost_jit", lambda *a: np.array([_pose_cost(a[5])]))
    monkeypatch.setattr(mcts, "_render_cost_of_poses",
                        lambda *a: torch.tensor([_pose_cost(a[5])], dtype=torch.float64))

    jax_mod = _jax_script("r5_hard_miss_analysis")
    monkeypatch.setattr(jax_mod, "OBJECTS", [name])
    reports = []
    for run, argv in ((jax_mod.main, []), (miss.main, ["--model-dir", str(tmp_path),
                                                       "--obj-config", "unused.yml",
                                                       "--objects", name, "--device", "cpu"])):
        out = tmp_path / f"report_{len(reports)}.json"
        _FakeEvaluator.answers = [from_chosen, from_gt]
        assert run(["--log", str(log), "--out", str(out)] + argv) == 0
        assert _FakeEvaluator.answers == []
        reports.append(json.loads(out.read_text()))
    want, got = reports
    assert got["meta"].pop("backend") == {"device": "cpu"}
    assert got == want
    entry = got[f"scene_0003/{name}"]
    assert entry["verdict_hint"] == hint
    assert entry["segment_points"] == 11
    assert sorted(got) == ["meta", f"scene_0003/{name}", "scene_0003/joint_cost_substitution"]
    assert set(got["scene_0003/joint_cost_substitution"]) == {"scale_4", "scale_1"}


def test_verdict_hint_branches():
    lo = [{"cost": 3.0, "adds_m": 0.005}]
    assert miss.verdict_hint(np.array([0.021, 0.03]), lo, 0, lo, 0) == "hypothesis ceiling"
    far = [{"cost": 2.0, "adds_m": 0.0101}]
    assert miss.verdict_hint(np.array([0.02]), lo, 0, far, 0).startswith("data ceiling")
    assert miss.verdict_hint(np.array([0.02]), lo, 0, lo, 0).startswith("data ceiling")  # tie
    cheap = [{"cost": 2.9, "adds_m": 0.01}]
    assert miss.verdict_hint(np.array([0.02]), lo, 0, cheap, 0) == (
        "search/refinement gap - fixable")


# ------------------------------------------------------------ port only


def test_hard_eval_runs_on_one_scene_and_merges_per_mode(meshes, tmp_path):
    out = tmp_path / "out" / "synth_eval.json"
    kw = dict(objects=NAMES, scenes=1, scene_dir=str(tmp_path / "scenes"), out=str(out))
    r4_hard_eval.hard_eval(TINY, "cpu", meshes["dir"], meshes["obj_config"],
                           modes=("LCP", "MCTS"), **kw)
    first = json.loads(out.read_text())["hard"]
    r4_hard_eval.hard_eval(TINY, "cpu", meshes["dir"], meshes["obj_config"], modes=("GREEDY",),
                           **kw)
    section = json.loads(out.read_text())["hard"]
    assert section["LCP"] == first["LCP"] and section["MCTS"] == first["MCTS"]  # kept
    assert {"generator", "scenes", "instances", "occlusion_frac", "corruption", "backend",
            "timestamp", "LCP", "MCTS", "GREEDY"} == set(section)
    assert section["scenes"] == 1 and section["instances"] == 3
    assert section["backend"] == {"device": "cpu"}
    assert 0.0 <= section["occlusion_frac"]["mean"] <= section["occlusion_frac"]["max"] <= 1.0
    for mode in ("LCP", "MCTS", "GREEDY"):
        st = section[mode]
        assert set(st) == {"adds_within_2cm", "mean_adds_m", "max_adds_m",
                           "per_object_mean_adds_m", "wall_s", "worst3"}
        assert set(st["per_object_mean_adds_m"]) == set(NAMES) and len(st["worst3"]) == 3
        assert 0.0 <= st["adds_within_2cm"] <= 1.0
        assert all(math.isfinite(v) for v in [st["mean_adds_m"], st["max_adds_m"]]
                   + list(st["per_object_mean_adds_m"].values()))
        with open(tmp_path / "scenes" / f"hard_eval_{mode}_0.jsonl") as fh:
            [row] = [json.loads(line) for line in fh]
        assert sorted(row["objects"]) == sorted(NAMES)


@pytest.mark.parametrize("tool", ["r4_hard_eval", "r5_eval", "r5_hard_miss_analysis"])
def test_tools_need_a_card_unless_asked_for_the_cpu(tool, meshes, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run")
    main = {"r4_hard_eval": r4_hard_eval.main, "r5_eval": r5_eval.main,
            "r5_hard_miss_analysis": miss.main}[tool]
    argv = ["--model-dir", meshes["dir"], "--obj-config", meshes["obj_config"],
            "--out", str(tmp_path / "out.json")]
    if tool == "r5_eval":
        argv += ["--family", "rcnn"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv + (["--dir", str(tmp_path / "scenes")] if tool != "r5_hard_miss_analysis"
                     else []))
    assert not (tmp_path / "scenes").exists() and not (tmp_path / "out.json").exists()
