"""Port parity: utils/checkpoint.py (search snapshots, the train state),
mcts_select(snapshot_path=...) and utils/tracing.py (the span tracer and
device_trace) against the JAX package's. Mirrors tests/test_utils.py's
tracer, snapshot and train-state cases."""

import json
import os
import types

import numpy as np
import pytest
import torch

from physimglobalpose_tpu.pipeline import mcts as jmcts
from physimglobalpose_tpu.utils import checkpoint as jcheckpoint
from physimglobalpose_tpu_torch.models import detect
from physimglobalpose_tpu_torch.pipeline import mcts
from physimglobalpose_tpu_torch.utils import checkpoint, tracing
from test_torch_mcts import K_INTR, _cfgs, decoy, pose_at  # noqa: F401  (decoy is a fixture)
from test_torch_mcts_multi import _estimates


def test_tracer_spans_nest():
    tr = tracing.Tracer()
    with tracing.trace_span(tr, "outer"):
        with tracing.trace_span(tr, "inner"):
            pass
    assert len(tr.roots) == 1
    assert tr.roots[0].name == "outer"
    assert tr.roots[0].children[0].name == "inner"
    flat = tr.flat_timings()
    assert "outer" in flat and "outer/inner" in flat
    parsed = json.loads(tr.to_json())
    assert parsed[0]["name"] == "outer"


def test_search_snapshot_roundtrip(tmp_path):
    p = str(tmp_path / "snap.json")
    checkpoint.save_search_snapshot(p, "/scenes/0001", [2, 0, 1], 123.5, seed=7)
    snap = checkpoint.load_search_snapshot(p)
    assert snap["assignment"] == [2, 0, 1]
    assert snap["best_cost"] == 123.5
    assert checkpoint.load_search_snapshot(str(tmp_path / "missing.json")) is None
    # The JAX package's file and this one are the same JSON.
    jp = str(tmp_path / "jsnap.json")
    jcheckpoint.save_search_snapshot(jp, "/scenes/0001", np.array([2, 0, 1]), np.float32(123.5), 7)
    assert checkpoint.load_search_snapshot(jp) == snap == jcheckpoint.load_search_snapshot(p)


@pytest.mark.parametrize("search", ["uct", "greedy"])
def test_mcts_select_writes_a_snapshot(decoy, tmp_path, search):
    # test_torch_mcts_multi.py's decoy scene (world == camera, one box and
    # three hypotheses) through mcts_select in both packages with a
    # snapshot path: the same assignment, the best cost within the leaf
    # cost bar (2 pixels), the seed and the scene.
    s = decoy
    tcfg, jcfg = _cfgs(leaf_batch=4, branching=3, max_search_seconds=600.0, max_expansions=12)
    obj = s["obj"]
    db = {"box": types.SimpleNamespace(
        hull_pts=obj["hull_pts"], hull_mask=obj["hull_mask"], hull_eqs=obj["hull_eqs"],
        validation_pts=obj["render_pts"], validation_nrm=np.zeros_like(obj["render_pts"]))}
    sc = types.SimpleNamespace(intrinsics=K_INTR, cam_pose=s["cam_pose"], scene_dir="/scenes/decoy")
    hyps = [np.stack([pose_at(0.07, 0.05, 0.89), s["true_pose"], pose_at(-0.06, 0.03, 0.95)])]
    est = _estimates(hyps, [np.array([0.9, 0.5, 0.8], np.float32)], ["box"])
    path, jpath = str(tmp_path / "snap.json"), str(tmp_path / "jsnap.json")
    got = mcts.mcts_select(est, sc, db, s["table_pose"], s["obs"], tcfg, seed=3,
                           snapshot_path=path, search=search, device="cpu")
    jmcts.mcts_select(est, sc, db, s["table_pose"], s["obs"], jcfg, seed=3, snapshot_path=jpath,
                      search=search)
    snap, jsnap = checkpoint.load_search_snapshot(path), jcheckpoint.load_search_snapshot(jpath)
    assert snap.keys() == jsnap.keys() == {"scene", "assignment", "best_cost", "seed"}
    assert snap["scene"] == "/scenes/decoy" and snap["seed"] == 3
    assert snap["assignment"] == jsnap["assignment"] == [1]
    assert abs(snap["best_cost"] - jsnap["best_cost"]) <= 2.0
    assert np.linalg.norm(got[0].pose_world[:3, 3] - s["true_pose"][:3, 3]) < 0.01
    # Without a path nothing is written.
    mcts.mcts_select(est, sc, db, s["table_pose"], s["obs"], tcfg, seed=3, search=search,
                     device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["jsnap.json", "snap.json"]


def test_train_state_roundtrip(tmp_path):
    torch.manual_seed(0)
    model = detect.CenterNetDetector(num_classes=3, width=8)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    model(torch.rand(1, 3, 32, 32))[0].sum().backward()
    opt.step()
    path = str(tmp_path / "ckpt.pt")
    checkpoint.save_train_state(path, model, opt, step=42)
    model2 = detect.CenterNetDetector(num_classes=3, width=8)
    opt2 = torch.optim.Adam(model2.parameters(), lr=1e-3)
    assert checkpoint.load_train_state(path, model2, opt2) == 42
    for (k, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        assert torch.equal(a, b), k
    s1, s2 = opt.state_dict(), opt2.state_dict()
    assert s1["param_groups"] == s2["param_groups"]
    for i, st in s1["state"].items():
        assert torch.equal(st["exp_avg"], s2["state"][i]["exp_avg"])
        assert torch.equal(st["exp_avg_sq"], s2["state"][i]["exp_avg_sq"])
    assert checkpoint.load_train_state(path, detect.CenterNetDetector(num_classes=3, width=8)) == 42


def test_device_trace_writes_a_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with tracing.device_trace(log_dir) as prof:
        with torch.profiler.record_function("traced_block"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(os.path.join(log_dir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "traced_block" for e in events)
    assert any(e.key == "traced_block" for e in prof.key_averages())
