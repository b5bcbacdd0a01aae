"""The port's /pose_estimation HTTP service (physimglobalpose_tpu_torch/
pipeline/server.py) on the CPU: tests/test_server.py's six cases (healthz,
the endpoint, a bad request, an unknown path, the queue-depth header, 503
load shedding with a stubbed estimate_pose) against an in-process server on
a free port, on a scene directory with test_torch_e2e.py's two boxes; the
endpoint's poses equal a direct estimate_pose call with the same seed; and
warmup's three times."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from _torch_common import write_scene_dir
from chip_smoke import camera_pose
from physimglobalpose_tpu_torch import config as tconfig
from physimglobalpose_tpu_torch.models import objectdb
from physimglobalpose_tpu_torch.pipeline import api as api_mod, server as server_mod
from physimglobalpose_tpu_torch.utils import tracing
from test_torch_e2e import BOXES, _cfg

ST = dict(num_bases=16, max_quads_per_base=16, max_pairs_per_ppf=64)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("server")
    write_scene_dir(tmp / "scene", camera_pose(distance=0.6), BOXES, tmp)
    cfg = _cfg(tconfig, st_kw=ST)
    objs = {nm: objectdb.prepare_object(nm, str(tmp / f"{nm}.ply"), cls, [180, 180, 180],
                                        config=cfg, device="cpu")
            for nm, cls, *_ in BOXES}
    db = objectdb.ObjectDB(objs, {o.class_id: nm for nm, o in objs.items()})
    return dict(scene=str(tmp / "scene"), cfg=cfg, db=db)


@pytest.fixture(scope="module")
def service(setup):
    srv = server_mod.serve(setup["db"], setup["cfg"], port=0, device="cpu")  # a free port
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _post(url, payload, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def test_healthz(service):
    with urllib.request.urlopen(service + "/healthz") as r:
        body = json.loads(r.read())
    assert body["ok"] and body["objects"] == [b[0] for b in BOXES]
    assert body["queue_depth"] == 0 and body["warmup_s"] == 0.0


def test_pose_estimation_endpoint(service, setup):
    with _post(service + "/pose_estimation", {"scene_dir": setup["scene"], "dataset": "APC"}) as r:
        body = json.loads(r.read())
    want = api_mod.estimate_pose(setup["scene"], setup["db"], cfg=setup["cfg"], seed=0,
                                 write_result=False, device="cpu")
    assert [o["name"] for o in body["objects"]] == [o.name for o in want.objects]
    for obj, est in zip(body["objects"], want.objects):
        assert np.asarray(obj["pose_world"]).shape == (4, 4) and obj["score"] > 0.05
        np.testing.assert_allclose(obj["pose_world"], est.pose_world, atol=1e-6)
        np.testing.assert_allclose(obj["pose_cam"], est.pose_cam, atol=1e-6)
        assert obj["score"] == pytest.approx(est.score)
    assert body["timings"]["total_s"] > 0


def test_reply_names_its_request_record(service, setup):
    with _post(service + "/pose_estimation", {"scene_dir": setup["scene"], "dataset": "APC"}) as r:
        timings = json.loads(r.read())["timings"]
    assert timings["queue_wait_s"] >= 0
    rec = tracing.record(timings["request_id"])
    req = rec.roots[0]
    assert req.name == "serve.request"
    for _ in range(100):  # the handler closes the span after the reply's last byte
        if req.end_ns is not None:
            break
        time.sleep(0.02)
    names = [c.name for c in req.children]
    assert names == ["serve.parse", "serve.queue_wait", "estimate", "serve.reply"]
    est = req.children[2]
    assert [c.name for c in est.children][:4] == [
        "load_scene", "remove_table", "segmentation", "hypotheses"]
    # The timings are the spans' durations.
    assert timings["queue_wait_s"] == req.children[1].duration
    assert timings["hypothesis_s"] == est.find("hypotheses").duration
    assert timings["icp_refine_s"] == est.find("icp_refine").duration
    assert timings["total_s"] <= est.duration <= tracing.self_s(req) + est.duration


def test_bad_request(service):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(service + "/pose_estimation", {})
    assert err.value.code == 400
    assert "scene_dir" in json.loads(err.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(service + "/pose_estimation", {"scene_dir": "/nonexistent/scene"})
    assert err.value.code == 400
    assert "FileNotFoundError" in json.loads(err.value.read())["error"]


def test_unknown_path(service):
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(service + "/nope")
    assert err.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(service + "/nope", {})
    assert err.value.code == 404


def test_queue_depth_header(service, setup):
    with _post(service + "/pose_estimation", {"scene_dir": setup["scene"]}) as r:
        assert int(r.headers["X-Queue-Depth"]) >= 0
    # pending drops after the response is written: poll briefly.
    for _ in range(100):
        with urllib.request.urlopen(service + "/healthz") as r:
            body = json.loads(r.read())
        if body["queue_depth"] == 0:
            break
        time.sleep(0.02)
    assert body["queue_depth"] == 0 and body["ema_latency_s"] > 0


def test_load_shedding_503(monkeypatch):
    """Beyond max_queue waiters the server answers 503 + Retry-After (the
    single-flight policy); the pipeline is stubbed, admission is under test."""
    release = threading.Event()

    def slow_estimate(*a, **k):
        release.wait(timeout=30)
        return api_mod.PoseEstimationResult(objects=[], timings={})

    monkeypatch.setattr(api_mod, "estimate_pose", slow_estimate)

    class FakeDB:
        names = ["stub"]

    srv = server_mod.serve(FakeDB(), None, port=0, max_queue=0, device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    results = {}

    def first():
        with _post(base + "/pose_estimation", {"scene_dir": "/nonexistent"}, timeout=60) as r:
            results["first"] = r.status

    t = threading.Thread(target=first)
    t.start()
    try:
        for _ in range(200):  # until the first request holds the device
            with urllib.request.urlopen(base + "/healthz") as r:
                if json.loads(r.read())["queue_depth"] == 1:
                    break
            time.sleep(0.02)
        else:
            raise AssertionError("the first request never became in flight")
        last_id = tracing.records()[-1].request_id
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base + "/pose_estimation", {"scene_dir": "/nonexistent"}, timeout=60)
        assert err.value.code == 503
        assert int(err.value.headers["Retry-After"]) >= 1
        assert err.value.headers["X-Queue-Depth"] == "1"
        body = json.loads(err.value.read())
        assert body["error"] == "busy" and body["queue_depth"] == 1
        # The shed request has a record of its own, with no estimate.
        shed = [r for r in tracing.records() if r.request_id > last_id]
        assert len(shed) == 1 and shed[0].roots[0].name == "serve.request"
        assert [c.name for c in shed[0].roots[0].children] == ["serve.parse", "serve.reply"]
    finally:
        release.set()
        t.join(timeout=60)
        srv.shutdown()
        srv.server_close()
    assert results.get("first") == 200


def test_warmup_returns_three_times(setup):
    total_s, first_minus_second_s, run_s = server_mod.warmup(setup["db"], setup["cfg"],
                                                             device="cpu")
    assert total_s >= run_s > 0 and first_minus_second_s >= 0
    assert total_s >= first_minus_second_s
