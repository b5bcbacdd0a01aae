"""The readers of the physics-aware search's spans (metrics/search_ms.serve,
leaf_host_ms.serve, search_final_ms.serve), on the CPU: the program's own
search (pipeline/mcts.mcts_select: uct_search's rounds, then the final
TrICP pass) on two 6 cm boxes resting on a table, world == camera, with a
160x120 render, under a request record as the service opens one."""

import types

import numpy as np
import pytest
import torch

from gpubench import search_reference as sr
from gpubench import spec
from physimglobalpose_tpu_torch import config as tconfig
from physimglobalpose_tpu_torch.pipeline import mcts
from physimglobalpose_tpu_torch.pipeline.api import ObjectPoseEstimate
from physimglobalpose_tpu_torch.utils import tracing

H, W = 120, 160
K_INTR = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], dtype=np.float32)
SIZE = 0.06
REST = [(-0.05, 0.0, 0.89), (0.05, 0.0, 0.89)]  # on the table's top at z 0.86
ROUNDS = ("search.collect", "search.leaf_eval", "search.backup")


def pose_at(x, y, z):
    p = np.eye(4, dtype=np.float32)
    p[:3, 3] = [x, y, z]
    return p


def box(seed, n_render=400):
    """A box's hull (8 corners, 6 faces padded to 12 rows as the object
    database pads them) and points on its faces."""
    rng = np.random.default_rng(seed)
    half = SIZE / 2
    eqs = np.tile(np.array([0, 0, 1, -1e9], np.float32), (12, 1))
    for axis in range(3):
        for j, sign in enumerate((1, -1)):
            eqs[2 * axis + j, axis] = sign
            eqs[2 * axis + j, 3] = -half
    face = rng.integers(0, 6, n_render)
    pts = rng.uniform(-half, half, (n_render, 3)).astype(np.float32)
    pts[np.arange(n_render), face // 2] = np.where(face % 2 == 0, 1, -1) * half
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float32)
    return dict(hull_pts=corners * half, hull_mask=np.ones(8, bool), hull_eqs=eqs,
                render_pts=pts, render_mask=np.ones(n_render, bool))


@pytest.fixture(scope="module")
def searched():
    """One search under a request record: (its `search` span, the answer)."""
    cfg = tconfig.PipelineConfig(
        render=tconfig.RenderConfig(width=W, height=H),
        mcts=tconfig.MCTSConfig(render_scale=1, leaf_batch=4, branching=3, max_expansions=12,
                                max_search_seconds=600.0))
    objs = [box(0), box(1)]
    truth = np.stack([pose_at(*p) for p in REST])
    # Three hypotheses an object: a decoy beside it, the truth, one lifted.
    hyps = np.stack([np.stack([pose_at(x + 0.03, y + 0.02, z), pose_at(x, y, z),
                               pose_at(x, y - 0.02, z + 0.04)]) for x, y, z in REST])
    table, cam = pose_at(0.0, 0.0, 0.66), np.eye(4, dtype=np.float32)
    ref = sr.scene(objs, hyps, np.zeros((H, W), np.float32), K_INTR, cam, table, cfg)
    obs = sr.render(ref, torch.as_tensor(truth), [True, True]).numpy()
    db = {f"box{i}": types.SimpleNamespace(
        hull_pts=o["hull_pts"], hull_mask=o["hull_mask"], hull_eqs=o["hull_eqs"],
        validation_pts=o["render_pts"], validation_nrm=np.zeros_like(o["render_pts"]))
        for i, o in enumerate(objs)}
    est = [ObjectPoseEstimate(name=f"box{i}", pose_cam=hyps[i, 0], pose_world=hyps[i, 0],
                              score=0.9, hypotheses=hyps[i],
                              hypothesis_scores=np.array([0.9, 0.5, 0.8], np.float32))
           for i in range(2)]
    segs = [types.SimpleNamespace(pts=(o["render_pts"] + truth[i, :3, 3]).astype(np.float32),
                                  mask=np.ones(len(o["render_pts"]), bool))
            for i, o in enumerate(objs)]
    sc = types.SimpleNamespace(intrinsics=K_INTR, cam_pose=cam, scene_dir="/scenes/two_boxes")
    with tracing.span("serve.request"):
        with tracing.span("estimate"):
            with tracing.span("search") as search:
                got = mcts.mcts_select(est, sc, db, table, obs, cfg, seed=3, search="uct",
                                       segs=segs, device="cpu")
    return search, got, truth


def _run(*request_ids):
    return {"answered": [{"timings": {"request_id": rid}} for rid in request_ids]}


def test_the_readers_return_the_search_spans_own_durations(searched):
    search, got, truth = searched
    run = _run(search.request_id)
    final = search.find("search.final")
    assert final is not None and 0.0 < final.duration < search.duration
    assert spec.metric_reader("search_ms.serve")(run) == pytest.approx(1000.0 * search.duration)
    assert spec.metric_reader("search_final_ms.serve")(run) == pytest.approx(
        1000.0 * final.duration)
    for i in range(2):  # the search found the boxes where they rest
        assert np.linalg.norm(got[i].pose_world[:3, 3] - truth[i, :3, 3]) < 0.01


def test_the_leaf_host_time_is_the_rounds_over_the_leaf_batches(searched):
    search, _, _ = searched
    batches = search.counts["leaf_batches"]
    assert batches >= 3  # 12 leaves in batches of 4
    rounds = sum(s.duration for name in ROUNDS for s in search.find_all(name))
    assert 0.0 < rounds < search.duration
    assert spec.metric_reader("leaf_host_ms.serve")(_run(search.request_id)) == pytest.approx(
        1000.0 * rounds / batches)


def _timed(span, start_us, end_us):
    span.start_ns, span.end_ns = start_us * 1000, end_us * 1000


def test_a_record_without_the_final_pass_span_reads_no_final_pass():
    """A program whose search has rounds but no search.final span (as before
    the span came): the final pass reads nothing, the others read."""
    with tracing.span("serve.request"):
        with tracing.span("search") as search:
            for k in range(2):
                for name in ROUNDS:
                    with tracing.span(name) as sp:
                        pass
                    _timed(sp, 1000 * k, 1000 * k + 200)
            tracing.count(leaf_batches=2, leaves=8)
    _timed(search, 0, 10_000)
    run = _run(search.request_id)
    assert spec.metric_reader("search_final_ms.serve")(run) is None
    assert spec.metric_reader("search_ms.serve")(run) == pytest.approx(10.0)
    assert spec.metric_reader("leaf_host_ms.serve")(run) == pytest.approx(0.6)  # 3 x 0.2 ms a batch


def test_requests_without_a_search_read_nothing():
    with tracing.span("serve.request") as req:
        with tracing.span("estimate"):
            pass
    run = _run(req.request_id, None)
    run["answered"][1]["timings"] = {}
    for name in ("search_ms.serve", "leaf_host_ms.serve", "search_final_ms.serve"):
        assert spec.metric_reader(name)(run) is None
