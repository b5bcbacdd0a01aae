"""The benchmark of physimglobalpose_tpu_torch: one cell, one run.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks for.
A cell (BENCHMARK.json "workloads") is a configuration (configs/*.json: the
boxes, the scene family, the program's sizes) under a traffic mix
(traffic/*.json). The run:

1. set-up (setup_s): the host settings (hostenv.py), the program's kernels
   built or found in its build directory inside the checkout, the boxes'
   meshes prepared as its object database (asset cache inside the checkout,
   build/gpubench_assets/), a pool of scenes generated from the seed and written
   under the temporary directory, the program's entry warmed up with the
   cell's own mode on pool scenes;
2. the window: --seconds of the mix's requests against the program's entry
   (drive.py); with --trace 1 the profiler then records a few more
   requests (trace.py) and the line carries the per-layer metrics;
3. the check: every request sent in the window is waited for, judged by
   the plain reference (check.py), and each number compared is printed
   beside its limit, last on standard error and last in the result's line.

The last line of standard output is the result: correct, attempted, failed,
metrics, device (and with --trace 1 the breakdown). Without a card, with too
few cards, or with JAX or the JAX package loaded, the run prints no result
and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from gpubench import hostenv

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "physimglobalpose_tpu")
ASSET_CACHE = os.path.join("build", "gpubench_assets")  # under the checkout's root
TRACE_LIMIT_S = 120.0  # the traced part ends here if the mix's count is not reached


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return p.parse_args(argv)


def forbidden_loaded() -> list:
    """Modules of JAX or the JAX package in this process, by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device=None, pipeline=None,
             freeze_heap: bool = False, diag: dict | None = None) -> dict:
    """One run of `cell` (spec.cell). device / pipeline: the CPU and a
    smaller PipelineConfig, for the tests; freeze_heap: hostenv.freeze_heap
    at the end of set-up (the command's runs). Returns the result's fields
    and, under "checks", the numbers compared with their limits."""
    import numpy as np
    import torch

    from gpubench import check, drive, layers, scenes, spec, trace as trace_mod, traffic

    conf, mix = cell["config"], cell["traffic"]
    diag = {} if diag is None else diag
    t0 = time.perf_counter()
    workdir = os.path.join(tempfile.gettempdir(), "gpubench")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    lay = layers.Layers()
    load = None
    try:
        prog = drive.Program(conf, workdir, str(spec.ROOT / ASSET_CACHE), device, pipeline)
        diag["build_s"] = prog.build_s
        rng = np.random.default_rng(seed)
        t_pool = time.perf_counter()
        rays = scenes.camera_rays(conf)
        pool = [scenes.generate(conf, rng, rays) for _ in range(mix["pool_scenes"])]
        dirs = [os.path.join(workdir, "scenes", f"scene_{k:04d}") for k in range(len(pool))]
        for d, sc in zip(dirs, pool):
            scenes.write_scene(d, sc, conf)
        diag["pool"] = {"scenes": len(pool), "seconds": time.perf_counter() - t_pool}
        plan = traffic.plan(mix, rng)
        lay.install()
        load = drive.LOADS[mix["entry"]](prog, dirs, plan, mix)
        load.warm(mix["warmup"])
        if prog.device.type == "cuda":
            torch.cuda.synchronize()
        if freeze_heap:
            hostenv.freeze_heap()
        setup_s = time.perf_counter() - t0

        w0 = time.monotonic()
        records = load.window(seconds)
        w1 = w0 + seconds
        summary = None
        if trace:
            # The traced part follows the window: the profiler slows the
            # launches it records and leaves the process slower after it
            # stops, so the window's answers and timings stay untraced.
            tracer = trace_mod.Tracer()
            tracer.start()
            gate = trace_mod.TraceGate(tracer, mix["trace"], lay)
            load.window(TRACE_LIMIT_S, gate)
            gate.finish()
            summary = tracer.summary()
            summary["lcp_calls"] = lay.lcp_calls()
        peak = torch.cuda.max_memory_allocated() if prog.device.type == "cuda" else 0
        load.close()
        load = None
        lay.close()
        del prog
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

        correct, checks, readings, rate = check.judge(conf, mix, pool, records, rng,
                                                      cell["limits"])
        answered = [r for r in records if r["ok"] and r["done"] <= w1]
        run = {"records": records, "answered": answered, "window": (w0, w1), "trace": summary,
               "mix": mix, "conf": conf}
        diag.update({
            "requests": [[r["scene"], r["sent"] - w0 if r["sent"] else None,
                          None if r["done"] is None else r["done"] - (r["due"] or w0), r["ok"]]
                         for r in records],
            "readings": readings,
        })
        if trace:
            metrics = _per_layer(cell, run)
        else:
            metrics = _end_to_end(cell, run, setup_s, rate)
        out = {
            "correct": correct,
            "attempted": len(records),
            "failed": sum(not r["ok"] for r in records),
            "metrics": metrics,
            "device": _device(prog_device=device, peak=peak),
        }
        if summary is not None:
            out["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
            out["breakdown"] = {"device_ops": [list(kv) for kv in summary["device_ops"]],
                                "idle_gaps": [list(kv) for kv in summary["idle_gaps"]]}
            diag["trace"] = {k: summary[k] for k in ("busy_s", "window_s", "kernels", "ranges")}
        out["checks"] = checks
        return out
    finally:
        if load is not None:
            load.close()
        lay.close()
        shutil.rmtree(workdir, ignore_errors=True)


def _end_to_end(cell, run, setup_s, rate) -> dict:
    import numpy as np

    answered = run["answered"]
    lat = [r["done"] - r["due"] for r in answered]
    w0 = run["window"][0]
    values = {
        "setup_s": setup_s,
        "adds_2cm_rate": rate,
        "request_p50_s": float(np.percentile(lat, 50)) if lat else None,
        "request_p95_s": float(np.percentile(lat, 95)) if lat else None,
        "scenes_per_s": (len(answered) / (max(r["done"] for r in answered) - w0)
                         if answered else None),
    }
    out = {}
    for m in cell["end_to_end"]:
        if values.get(m["name"]) is None:
            raise RuntimeError(f"no reading of {m['name']} in this run")
        out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def _per_layer(cell, run) -> dict:
    from gpubench import spec

    out = {}
    for m in cell["per_layer"]:
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _device(prog_device, peak) -> dict:
    import torch

    if prog_device is not None and str(prog_device) == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak)}


def main(argv=None) -> int:
    args = parse_args(argv)
    hostenv.apply_early()

    import torch

    from gpubench import spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"gpubench: the cell needs {cell['chips']} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    hostenv.apply_torch()
    diag = {}
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), freeze_heap=True, diag=diag)
    print("gpubench diag " + json.dumps(diag, default=str), file=sys.stderr)
    found = forbidden_loaded()
    if found:
        print(f"gpubench: the process loaded {found}; no result", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
