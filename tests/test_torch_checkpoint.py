"""Port parity: utils/checkpoint.py (search snapshots, the train state),
mcts_select(snapshot_path=...) and utils/tracing.py (the span tracer and
device_trace) against the JAX package's. Mirrors tests/test_utils.py's
tracer, snapshot and train-state cases; adds the port's request records
(ids, self time, threads, the ring's bound, the profiler's ranges)."""

import contextlib
import json
import os
import threading
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


def test_nested_spans_share_their_records_id():
    with tracing.span("call") as call:
        with tracing.span("stage") as stage:
            with tracing.span("step") as step:
                tracing.count(leaves=3)
                tracing.count(leaves=2, batches=1)
    assert call.request_id == stage.request_id == step.request_id
    assert step.parent is stage and stage.parent is call and call.parent is None
    assert step.counts == {"leaves": 5, "batches": 1}
    rec = tracing.record(call.request_id)
    assert rec.roots == [call] and rec.find("step") is step
    assert call.start_ns <= stage.start_ns <= step.start_ns <= step.end_ns <= call.end_ns
    with tracing.span("next call") as other:
        pass
    assert other.request_id != call.request_id and other.parent is None


def test_self_time_is_what_the_children_leave():
    tr = tracing.Tracer()
    root = tracing.Span("root", tr, None)
    root.start_ns, root.end_ns = 0, 10_000
    for a, b in ((1_000, 4_000), (3_000, 6_000), (8_000, 9_000)):  # two overlap
        c = tracing.Span("child", tr, root)
        c.start_ns, c.end_ns = a, b
    assert tracing.self_s(root) == pytest.approx(4e-6)  # 10 - (5 covered + 1)
    assert tracing.self_s(root.children[2]) == pytest.approx(1e-6)


def test_two_threads_build_separate_trees():
    # One thread waits inside its record while the other runs: each tree
    # holds only its own thread's spans.
    gate = threading.Barrier(2, timeout=30)
    got = {}

    def work(tag):
        with tracing.span(f"request {tag}") as req:
            with tracing.span(f"wait {tag}"):
                gate.wait()
            gate.wait()
            with tracing.span(f"run {tag}"):
                pass
        got[tag] = req

    threads = [threading.Thread(target=work, args=(k,)) for k in "ab"]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    assert got["a"].request_id != got["b"].request_id
    for k in "ab":
        assert [c.name for c in got[k].children] == [f"wait {k}", f"run {k}"]
        assert tracing.record(got[k].request_id).roots == [got[k]]


def test_the_ring_keeps_its_bound():
    first = None
    for k in range(tracing.RING_RECORDS + 50):
        with tracing.span("request") as req:
            pass
        first = req.request_id if first is None else first
    held = tracing.records()
    assert len(held) == tracing.RING_RECORDS
    assert held[-1].request_id == req.request_id
    assert tracing.record(first) is None and tracing.record(req.request_id) is held[-1]


def test_no_profiler_range_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or contextlib.nullcontext())
    with tracing.span("call"):
        with tracing.span("stage"):
            pass
        tracing.span("detached").open().close()
    assert opened == []
    # The same spans under a (stand-in) active profiler open their ranges.
    monkeypatch.setattr(tracing._autograd_profiler, "_is_profiler_enabled", True)
    with tracing.span("call"):
        with tracing.span("stage"):
            pass
    assert opened == ["pose::call", "pose::stage"]


def test_spans_are_profiler_ranges_that_nest():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            with tracing.span("inner"):
                (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    events = {e.name: e for e in prof.events()}
    outer, inner = events["pose::outer"], events["pose::inner"]
    assert inner.cpu_parent is outer
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert any(ch.name == "aten::matmul" for ch in inner.cpu_children)


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
