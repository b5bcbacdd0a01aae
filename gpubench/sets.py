"""Run a list of benchmark runs one after another, each in a process of its
own, keep each run's output, and give every metric's spread.

    python3 -m gpubench.sets --out <dir> RUN [RUN ...]

RUN is cell:seed:seconds:trace. Each run's standard output and error go to
<dir>/<k>.out and <k>.err. The summary (<dir>/summary.json, and printed)
lists each run's result and diagnostics, and per cell the spread of each
metric over its untraced runs: the distance
between the quartiles (statistics.quantiles, n=4) as a share of the median,
leaving out the run farthest from the median where that narrows it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def spread(values) -> float | None:
    vals = [v for v in values if v is not None]
    if len(vals) < 3:
        return None
    med = statistics.median(vals)

    def iqr(v):
        q = statistics.quantiles(v, n=4)
        return (q[2] - q[0]) / abs(med) if med else None

    full = iqr(vals)
    far = max(range(len(vals)), key=lambda i: abs(vals[i] - med))
    rest = vals[:far] + vals[far + 1:]
    return min(full, iqr(rest)) if len(rest) >= 3 else full


def _last_json(text: str):
    for line in reversed(text.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    return None


def _diag(err: str) -> dict:
    for line in err.splitlines():
        if line.startswith("gpubench diag "):
            return json.loads(line[len("gpubench diag "):])
    return {}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("runs", nargs="+")
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    rows = []
    for k, spec in enumerate(args.runs):
        cell, seed, seconds, trace = spec.split(":")
        cmd = [sys.executable, "-m", "gpubench.run", "--workload", cell, "--seed", seed,
               "--seconds", seconds, "--trace", trace]
        t0 = time.monotonic()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1500)
        wall = time.monotonic() - t0
        with open(os.path.join(args.out, f"{k}.out"), "w") as fh:
            fh.write(proc.stdout)
        with open(os.path.join(args.out, f"{k}.err"), "w") as fh:
            fh.write(proc.stderr)
        res = _last_json(proc.stdout) if proc.returncode == 0 else None
        d = _diag(proc.stderr)
        row = {"k": k, "cell": cell, "seed": int(seed), "seconds": float(seconds),
               "trace": int(trace), "rc": proc.returncode, "wall_s": wall,
               "correct": res and res["correct"],
               "metrics": res and {m: v["value"] for m, v in res["metrics"].items()},
               "checks": res and {m: v["value"] for m, v in res["checks"].items()},
               "readings": d.get("readings"),
               "build_s": d.get("build_s"), "pool": d.get("pool"),
               "answered": sum(1 for r in d.get("requests", []) if r[3]),
               "peak": res and res["device"]["memory_peak_bytes"],
               "busy_s": res and res["device"].get("busy_s"),
               "window_s": res and res["device"].get("window_s")}
        if proc.returncode != 0:
            row["error_tail"] = proc.stderr[-1500:]
        rows.append(row)
        print(json.dumps(row), flush=True)
    groups = {}
    for r in rows:
        if r["metrics"] and not r["trace"]:
            groups.setdefault(r["cell"], []).append(r)
    spreads = {}
    for key, rs in groups.items():
        names = sorted({m for r in rs for m in r["metrics"]})
        spreads[key] = {m: {"spread": spread([r["metrics"].get(m) for r in rs]),
                            "median": statistics.median([r["metrics"][m] for r in rs
                                                         if m in r["metrics"]]),
                            "n": len(rs)} for m in names}
    print(json.dumps({"spreads": spreads}, indent=1))
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump({"runs": rows, "spreads": spreads}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
