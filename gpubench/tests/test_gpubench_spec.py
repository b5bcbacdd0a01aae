"""The harness finds its pieces by name, and a new piece is new files only."""

import json
import shutil

from gpubench import spec


def test_every_cell_finds_its_files():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"]["entry"] in ("serve", "sweep")
        assert "unanswered" in cell["limits"]
        names = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert callable(spec.metric_reader(m["name"]))


def test_metrics_apply_by_workloads_or_by_what_they_move():
    bench = {
        "end_to_end": [{"name": "a_s", "workloads": ["x.one"]}, {"name": "setup_s"}],
        "per_layer": [],
    }
    one, two = {"name": "x.one"}, {"name": "x.two"}
    assert spec.applies({"name": "setup_s"}, two, bench)
    assert spec.applies(bench["end_to_end"][0], one, bench)
    assert not spec.applies(bench["end_to_end"][0], two, bench)
    moves_a = {"name": "m", "moves": "a_s"}
    assert spec.applies(moves_a, one, bench) and not spec.applies(moves_a, two, bench)


def test_a_new_cell_mix_and_metric_are_found_as_new_files(tmp_path):
    """A later change adds a configuration, a mix, a cell's limits and a
    metric by dropping files next to the others: nothing is edited."""
    root, base = tmp_path / "repo", tmp_path / "repo" / "gpubench"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    conf = spec.load_json(spec.ROOT / "gpubench/configs/apc3_gt.json")
    conf["name"] = "apc3_near"
    conf["pipeline"]["preprocess"]["max_segment_points"] = 4096
    (base / "configs" / "apc3_near.json").write_text(json.dumps(conf))
    mix = dict(spec.load_json(base / "traffic" / "serve_lcp.json"), clients=4)
    (base / "traffic" / "serve_lcp4.json").write_text(json.dumps(mix))
    (base / "limits" / "apc3_near.serve_lcp4.json").write_text(json.dumps({"unanswered": 0}))
    (base / "metrics" / "queue_wait_ms.four.py").write_text(
        "def read(run):\n    return 1.5\n")
    bench["configs"].append({"name": "apc3_near", "source": "x", "file": "gpubench/configs/apc3_near.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "apc3_near.serve_lcp4", "config": "apc3_near",
                               "traffic": "serve_lcp4", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "queue_wait_ms.four", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "service",
                               "moves": "request_p50_s", "workloads": ["apc3_near.serve_lcp4"]})
    bench["end_to_end"][0]["workloads"].append("apc3_near.serve_lcp4")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("apc3_near.serve_lcp4", root=root, base=base)
    assert cell["config"]["pipeline"]["preprocess"]["max_segment_points"] == 4096
    assert cell["traffic"]["clients"] == 4
    assert [m["name"] for m in cell["per_layer"]] == ["queue_wait_ms.four"]
    assert spec.metric_reader("queue_wait_ms.four", base / "metrics")(None) == 1.5
    # the cells that were there are unchanged
    old = spec.cell("apc3_gt.serve_lcp", root=root, base=base)
    assert "queue_wait_ms.four" not in [m["name"] for m in old["per_layer"]]
