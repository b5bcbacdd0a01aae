"""The metric arithmetic: percentiles, the rate to the last answer, a failed
request as a miss, the spread, and the traffic plan."""

import statistics

import numpy as np
import pytest

from gpubench import check, run, scenes, sets, spec, traffic


def _rec(i, scene, sent, done, ok=True, poses=None, shed=False):
    return {"i": i, "scene": scene, "due": sent, "sent": sent, "done": done, "ok": ok,
            "shed": shed, "error": None if ok else "500", "poses": poses or {},
            "timings": {}, "traced": False}


def _cell(names):
    return {"end_to_end": [{"name": n, "unit": "u"} for n in names]}


def test_latency_percentiles_over_answers_in_the_window():
    lat = [0.1 * k for k in range(1, 21)]  # 0.1 .. 2.0 s
    recs = [_rec(k, 0, 100.0 + k, 100.0 + k + lat[k]) for k in range(20)]
    answered = [r for r in recs if r["done"] <= 100.0 + 30]
    out = run._end_to_end(_cell(["request_p50_s", "request_p95_s"]),
                          {"answered": answered, "window": (100.0, 130.0)}, 1.0, 1.0)
    assert out["request_p50_s"]["value"] == pytest.approx(np.percentile(lat, 50))
    assert out["request_p95_s"]["value"] == pytest.approx(np.percentile(lat, 95))
    assert out["request_p50_s"]["unit"] == "u"


def test_scenes_per_s_ends_at_the_last_answer_inside_the_window():
    w0 = 10.0
    recs = [_rec(0, 0, w0, w0 + 4.0), _rec(1, 1, w0 + 4.0, w0 + 9.0),
            _rec(2, 2, w0 + 9.0, w0 + 13.0)]  # the third answers after a 12 s window
    answered = [r for r in recs if r["done"] <= w0 + 12.0]
    out = run._end_to_end(_cell(["scenes_per_s"]), {"answered": answered, "window": (w0, w0 + 12)},
                          1.0, 1.0)
    assert out["scenes_per_s"]["value"] == pytest.approx(2 / 9.0)


def test_a_metric_without_a_reading_fails_the_run():
    with pytest.raises(RuntimeError):
        run._end_to_end(_cell(["scenes_per_s"]), {"answered": [], "window": (0.0, 1.0)}, 1.0, 1.0)


@pytest.fixture(scope="module")
def pool_of_two():
    conf = spec.load_json(spec.ROOT / "gpubench/configs/apc3_gt.json")
    rng = np.random.default_rng(3)
    return conf, [scenes.generate(conf, rng) for _ in range(2)]


def test_a_failed_request_is_a_miss_for_each_of_its_objects(pool_of_two):
    conf, pool = pool_of_two
    truth = {n: p.tolist() for n, p in pool[0].poses.items()}
    recs = [_rec(0, 0, 0.0, 1.0, poses=truth), _rec(1, 1, 1.0, 2.0, ok=False)]
    mix = {"check_sample": 2, "verification_mode": "LCP"}
    correct, checks, readings, rate = check.judge(conf, mix, pool, recs, np.random.default_rng(0),
                                                  {"unanswered": 0})
    assert rate == pytest.approx(0.5)  # 3 of 6 objects
    assert readings["unanswered"] == 0.5 and not correct
    assert checks == {"unanswered": {"value": 0.5, "limit": 0}}


def test_exact_answers_read_zero_and_a_shifted_one_does_not(pool_of_two):
    conf, pool = pool_of_two
    truth = [{n: p.tolist() for n, p in sc.poses.items()} for sc in pool]
    shifted = {}
    for n, p in truth[1].items():
        moved = np.asarray(p)
        moved[0, 3] += 0.03  # 3 cm along the camera's x
        shifted[n] = moved.tolist()
    mix = {"check_sample": 2, "verification_mode": "LCP"}
    limits = {"unanswered": 0, "adds_p50_mm": 1.0, "adds_obj_p50_max_mm": 1.0, "fit_gap_p50": 0.01}
    ok = [_rec(0, 0, 0.0, 1.0, poses=truth[0]), _rec(1, 1, 1.0, 2.0, poses=truth[1])]
    correct, checks, readings, rate = check.judge(conf, mix, pool, ok, np.random.default_rng(0), limits)
    assert correct and rate == 1.0
    assert readings["adds_p50_mm"] == pytest.approx(0.0, abs=1e-6)
    assert readings["adds_obj_p50_max_mm"] == pytest.approx(0.0, abs=1e-5)
    assert readings["fit_gap_p50"] == 0.0
    bad = [_rec(0, 0, 0.0, 1.0, poses=truth[0]), _rec(1, 1, 1.0, 2.0, poses=shifted)]
    correct, checks, readings, _ = check.judge(conf, mix, pool, bad, np.random.default_rng(0), limits)
    assert not correct
    assert readings["adds_p50_mm"] > 1.0  # half the objects 30 mm off, the median between


def test_a_shed_request_is_answered_but_a_miss():
    conf = spec.load_json(spec.ROOT / "gpubench/configs/apc3_gt.json")
    pool = [scenes.generate(conf, np.random.default_rng(1))]
    truth = {n: p.tolist() for n, p in pool[0].poses.items()}
    recs = [_rec(0, 0, 0.0, 1.0, poses=truth), _rec(1, 0, 0.5, 0.6, ok=False, shed=True)]
    correct, _, readings, rate = check.judge(conf, {"check_sample": 4, "verification_mode": "LCP"},
                                             pool, recs, np.random.default_rng(0),
                                             {"unanswered": 0, "adds_p50_mm": 1.0})
    assert correct and readings["shed"] == 0.5 and rate == 0.5


def test_spread_is_the_quartile_distance_over_the_median_without_the_farthest_run():
    assert sets.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    vals = [10.0, 10.2, 9.8, 10.1, 9.9, 14.0]
    q = statistics.quantiles(vals, n=4)
    assert sets.spread(vals) < (q[2] - q[0]) / statistics.median(vals)  # leaving out 14.0 narrows it
    assert sets.spread([1.0, 2.0]) is None


def test_every_seed_gets_the_same_work_in_another_order():
    mix = {"pool_scenes": 8}
    a = traffic.plan(mix, np.random.default_rng(1), n=16)
    b = traffic.plan(mix, np.random.default_rng(2), n=16)
    for p in (a, b):
        assert sorted(p.scenes[:8]) == sorted(p.scenes[8:]) == list(range(8))
    assert list(a.scenes) != list(b.scenes)


def test_one_object_wrong_in_every_answer_moves_the_per_object_median(pool_of_two):
    """A third of the objects moved 30 mm leaves the median over all objects
    near 0; the largest per-object median sees it."""
    conf, pool = pool_of_two
    recs = []
    for k, sc in enumerate(pool):
        poses = {n: p.tolist() for n, p in sc.poses.items()}
        moved = np.asarray(poses["box_c"])
        moved[0, 3] += 0.03
        poses["box_c"] = moved.tolist()
        recs.append(_rec(k, k, float(k), k + 1.0, poses=poses))
    mix = {"check_sample": 2, "verification_mode": "LCP"}
    limits = {"unanswered": 0, "adds_p50_mm": 1.0, "adds_obj_p50_max_mm": 1.0}
    correct, checks, readings, rate = check.judge(conf, mix, pool, recs, np.random.default_rng(0),
                                                  limits)
    assert readings["adds_p50_mm"] == pytest.approx(0.0, abs=1e-5)
    assert readings["adds_obj_p50_max_mm"] == readings["adds_obj_p50_mm"]["box_c"] > 5.0
    assert not correct
    assert rate == 1.0  # ADD-S ~10 mm: within the 2 cm bar, so the rate does not see it either
