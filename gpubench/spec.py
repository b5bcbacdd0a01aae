"""Find a cell's pieces by the names in BENCHMARK.json.

Every configuration, traffic mix, correctness limit and per-layer metric is
a file of its own, found by name, so a later change adds a cell, a mix or a
metric by adding files and entries and edits none:

- configs: the `file` that BENCHMARK.json gives the configuration;
- traffic: traffic/<mix>.json, read by the general generator (traffic.py);
- limits: limits/<config>.<mix>.json, the limits of the numbers that
  decide `correct` in that cell (check.py);
- per-layer metrics: metrics/<metric>.py, a module with read(run) that
  returns the number or None where the run has nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def applies(metric: dict, cell: dict, bench: dict) -> bool:
    """Whether `metric` is reported in `cell`: the cells its `workloads`
    lists, or else every cell that reports the end-to-end metric it moves
    (an end-to-end metric without `workloads` is in every cell)."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    if "moves" in metric:
        moved = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
        return applies(moved, cell, bench)
    return True


def metric_reader(name: str, base: Path = HERE / "metrics"):
    """The read(run) function of metrics/<name>.py."""
    path = Path(base) / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def cell(name: str, bench: dict | None = None, root: Path = ROOT, base: Path = HERE) -> dict:
    """Everything one cell needs: its entry, configuration, traffic mix,
    limits and the metrics it reports (end-to-end and per-layer)."""
    bench = benchmark(root) if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return {
        "name": name,
        "chips": entry["chips"],
        "config": load_json(Path(root) / conf["file"]),
        "traffic": load_json(Path(base) / "traffic" / f"{entry['traffic']}.json"),
        "limits": load_json(Path(base) / "limits" / f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, entry, bench)],
        "per_layer": [m for m in bench["per_layer"] if applies(m, entry, bench)],
    }
