"""The readers of the sweep's shared search (metrics/search_ms.sweep,
leaf_host_ms.sweep, search_final_ms.sweep, leaf_fill.sweep), on the CPU:
the program's own multi-scene search (pipeline/mcts.mcts_select_multi:
uct_search_multi's shared rounds, then every scene's TrICP final pass) on
two scenes of test_gpubench_search_spans.py's two boxes, under a request
record as the sweep opens one (sweep, then sweep.search)."""

import types

import numpy as np
import pytest
import torch

from gpubench import search_reference as sr
from gpubench import spec
from gpubench.tests.test_gpubench_search_spans import H, K_INTR, REST, W, box, pose_at
from physimglobalpose_tpu_torch import config as tconfig
from physimglobalpose_tpu_torch.pipeline import mcts
from physimglobalpose_tpu_torch.pipeline.api import ObjectPoseEstimate
from physimglobalpose_tpu_torch.utils import tracing

ROUNDS = ("search.collect", "search.leaf_eval", "search.backup")
READERS = ("search_ms.sweep", "leaf_host_ms.sweep", "search_final_ms.sweep", "leaf_fill.sweep")


@pytest.fixture(scope="module")
def swept():
    """Two scenes' searches in shared batches under a sweep's record: (its
    sweep.search span, the answers, the truth)."""
    cfg = tconfig.PipelineConfig(
        render=tconfig.RenderConfig(width=W, height=H),
        mcts=tconfig.MCTSConfig(render_scale=1, leaf_batch=4, leaf_batch_multi=6, branching=3,
                                max_expansions=12, max_search_seconds=600.0))
    objs = [box(0), box(1)]
    truth = np.stack([pose_at(*p) for p in REST])
    hyps = np.stack([np.stack([pose_at(x + 0.03, y + 0.02, z), pose_at(x, y, z),
                               pose_at(x, y - 0.02, z + 0.04)]) for x, y, z in REST])
    table, cam = pose_at(0.0, 0.0, 0.66), np.eye(4, dtype=np.float32)
    ref = sr.scene(objs, hyps, np.zeros((H, W), np.float32), K_INTR, cam, table, cfg)
    obs = sr.render(ref, torch.as_tensor(truth), [True, True]).numpy()
    db = {f"box{i}": types.SimpleNamespace(
        hull_pts=o["hull_pts"], hull_mask=o["hull_mask"], hull_eqs=o["hull_eqs"],
        validation_pts=o["render_pts"], validation_nrm=np.zeros_like(o["render_pts"]))
        for i, o in enumerate(objs)}
    sc = types.SimpleNamespace(intrinsics=K_INTR, cam_pose=cam, scene_dir="/scenes/two_boxes")
    segs = [types.SimpleNamespace(pts=(o["render_pts"] + truth[i, :3, 3]).astype(np.float32),
                                  mask=np.ones(len(o["render_pts"]), bool))
            for i, o in enumerate(objs)]
    rows = []
    for order in ([0, 1, 2], [2, 0, 1]):  # the same boxes, their hypotheses in two orders
        est = [ObjectPoseEstimate(name=f"box{i}", pose_cam=hyps[i, order[0]],
                                  pose_world=hyps[i, order[0]], score=0.9,
                                  hypotheses=hyps[i, order],
                                  hypothesis_scores=np.array([0.9, 0.5, 0.8], np.float32)[order])
               for i in range(2)]
        rows.append((est, sc, table, obs))
    with tracing.span("sweep"):
        with tracing.span("sweep.search") as search:
            got = mcts.mcts_select_multi(rows, db, cfg, seed=3, segs_list=[segs, segs],
                                         device="cpu")
    return search, got, truth


def _run(*request_ids):
    return {"answered": [{"timings": {"request_id": rid}} for rid in request_ids]}


def test_the_readers_return_the_sweep_searchs_own_durations(swept):
    search, got, truth = swept
    run = _run(search.request_id, search.request_id)  # the call answers both its scenes
    [final] = search.find_all("search.final")
    assert 0.0 < final.duration < search.duration
    assert spec.metric_reader("search_ms.sweep")(run) == pytest.approx(1000.0 * search.duration)
    assert spec.metric_reader("search_final_ms.sweep")(run) == pytest.approx(
        1000.0 * final.duration)
    for answer in got:  # each scene's search found the boxes where they rest
        for i in range(2):
            assert np.linalg.norm(answer[i].pose_world[:3, 3] - truth[i, :3, 3]) < 0.01


def test_the_leaf_host_time_is_the_shared_rounds_over_the_leaf_batches(swept):
    search, _, _ = swept
    batches = search.counts["leaf_batches"]
    assert batches >= 4  # 2 x 12 leaves in shared batches of 6
    rounds = sum(s.duration for name in ROUNDS for s in search.find_all(name))
    assert 0.0 < rounds < search.duration
    assert spec.metric_reader("leaf_host_ms.sweep")(_run(search.request_id)) == pytest.approx(
        1000.0 * rounds / batches)


def test_the_leaf_fill_is_the_leaves_over_the_rows_queued(swept):
    search, _, _ = swept
    counts = search.counts
    assert counts["leaf_rows"] == 6 * counts["leaf_batches"]
    fill = spec.metric_reader("leaf_fill.sweep")(_run(search.request_id))
    assert fill == pytest.approx(counts["leaves"] / counts["leaf_rows"])
    assert 0.0 < fill <= 1.0


def _timed(span, start_us, end_us):
    span.start_ns, span.end_ns = start_us * 1000, end_us * 1000


def test_a_record_without_the_final_span_or_the_row_count_reads_neither():
    """A program whose sweep search has rounds but no search.final span and
    no leaf_rows counter (as before they came): those two read nothing, the
    others read."""
    with tracing.span("sweep"):
        with tracing.span("sweep.search") as search:
            for k in range(2):
                for name in ROUNDS:
                    with tracing.span(name) as sp:
                        pass
                    _timed(sp, 1000 * k, 1000 * k + 300)
            tracing.count(leaf_batches=2, leaves=900)
    _timed(search, 0, 20_000)
    run = _run(search.request_id)
    assert spec.metric_reader("search_final_ms.sweep")(run) is None
    assert spec.metric_reader("leaf_fill.sweep")(run) is None
    assert spec.metric_reader("search_ms.sweep")(run) == pytest.approx(20.0)
    assert spec.metric_reader("leaf_host_ms.sweep")(run) == pytest.approx(0.9)  # 3 x 0.3 ms


def test_calls_without_a_sweep_search_read_nothing():
    with tracing.span("sweep") as lcp_call:  # an LCP sweep: no search
        with tracing.span("sweep.jobs"):
            pass
    with tracing.span("serve.request") as request:  # a served search
        with tracing.span("search"):
            tracing.count(leaf_batches=2, leaves=8, leaf_rows=8)
    run = _run(lcp_call.request_id, request.request_id, None)
    run["answered"][2]["timings"] = {}
    for name in READERS:
        assert spec.metric_reader(name)(run) is None, name
