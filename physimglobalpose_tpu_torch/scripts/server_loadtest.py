"""Service throughput under concurrent clients.

The port of the JAX package's scripts/server_loadtest.py. Starts the
/pose_estimation service (pipeline/server.py) in-process with the models
loaded once, at the small preset (the JAX load test's configuration,
config.PRESETS["small"]), fires --clients concurrent clients at it on one scene
directory, and records requests/s, latency percentiles, the queue depth each
request saw on arrival, the load shedding (503 + Retry-After once the
line exceeds --max-queue), and the poses of the last answered request
(response_pose_world, for a caller to grade). Client threads use urllib only and never touch
torch; the device stays single-flight behind the service's lock.

--phase measure-boots instead boots the service once in a fresh process (a
same-process boot would find everything warm) and records its warm-up. The
JAX script boots twice against its compile cache and reports the second
boot's speed-up; the port has no compile cache (its kernels are built once
into the git-ignored build directory, where a fresh process finds them), so
it has neither the second boot nor --compile-cache-dir.

The report is merged into --out under the device type ("cuda" or "cpu"), so
a card run keeps a CPU one and the reverse.

Usage (on the card; --device cpu for the CPU):
  python -m physimglobalpose_tpu_torch.scripts.server_loadtest --scene <dir> \\
      --obj-config <obj_config.yml> --model-dir <meshes> [--clients 4] [--requests 12] \\
      [--max-queue 1] [--phase measure-boots] [--out loadtest.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(tempfile.gettempdir(), "physimglobalpose_tpu_torch",
                           "server_loadtest.json")
POLICY = ("single-flight device; <= max_queue waiters; beyond that 503 + Retry-After = "
          "(depth+1) x EMA latency")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", required=True, help="scene directory the clients send")
    ap.add_argument("--model-dir", required=True, help="mesh directory")
    ap.add_argument("--obj-config", required=True, help="obj_config.yml path")
    ap.add_argument("--dataset", default="APC", choices=["APC", "YCB"])
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12,
                    help="total successful requests to collect")
    ap.add_argument("--max-queue", type=int, default=1)
    ap.add_argument("--phase", default="loadtest",
                    choices=["loadtest", "warm-boot", "measure-boots"],
                    help="warm-boot: one boot with its warm-up in this process (what "
                         "measure-boots runs in a fresh process); measure-boots: one "
                         "fresh-process boot, merged into --out as warm_boots")
    ap.add_argument("--cache-dir", default=None,
                    help="asset cache (default: the port's directory under the temporary one)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="serve on the card (default) or on the CPU")
    return ap.parse_args(argv)


def _load_db(args, cfg):
    from physimglobalpose_tpu_torch.models import objectdb
    from physimglobalpose_tpu_torch.pipeline import scene as scene_mod

    names = scene_mod.load_scene(args.scene, dataset=args.dataset, load_color=False).object_names
    return objectdb.load_object_db(
        args.obj_config, args.model_dir, config=cfg,
        cache_dir=args.cache_dir or objectdb.default_cache_dir(), only=names, device=args.device,
    )


def warm_boot(args) -> dict:
    """One boot of the service with its warm-up: the models loaded, the
    kernels found or built, two warm-up passes (pipeline/server.warmup)."""
    from physimglobalpose_tpu_torch.config import PRESETS
    from physimglobalpose_tpu_torch.pipeline import server as server_mod

    t0 = time.perf_counter()
    cfg = PRESETS["small"]
    srv = server_mod.serve(_load_db(args, cfg), cfg, port=0, warm=True, device=args.device)
    boot_s = time.perf_counter() - t0
    srv.server_close()
    return {"boot_s": round(boot_s, 3), "warmup_s": round(srv.warmup_s, 3),
            "warmup_compile_s": round(srv.warmup_compile_s, 3),
            "warmup_run_s": round(srv.warmup_run_s, 3)}


def measure_boot(args) -> dict:
    """One warm boot in a fresh process: warm_boot's figures and the
    process's wall time ("process_wall_s")."""
    path = os.path.abspath
    cmd = [sys.executable, "-m", "physimglobalpose_tpu_torch.scripts.server_loadtest",
           "--phase", "warm-boot", "--scene", path(args.scene), "--model-dir",
           path(args.model_dir), "--obj-config", path(args.obj_config), "--dataset",
           args.dataset, "--device", args.device]
    if args.cache_dir:
        cmd += ["--cache-dir", path(args.cache_dir)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=3600, cwd=ROOT, env=env)
    if proc.returncode != 0:
        raise RuntimeError(f"warm boot failed: {proc.stdout[-500:]} {proc.stderr[-2000:]}")
    warm = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"boot: warm-up {warm['warmup_s']:.2f} s (first pass minus second "
          f"{warm['warmup_compile_s']:.2f} s)", flush=True)
    return dict(warm, process_wall_s=round(time.monotonic() - t0, 3))


def loadtest(args) -> dict:
    """The service in a thread on a free local port, one warm request, then
    --clients threads until --requests have succeeded."""
    from physimglobalpose_tpu_torch import _torchcfg
    from physimglobalpose_tpu_torch.config import PRESETS
    from physimglobalpose_tpu_torch.pipeline import server as server_mod

    dev = _torchcfg.resolve_device(args.device)
    cfg = PRESETS["small"]
    srv = server_mod.serve(_load_db(args, cfg), cfg, port=0, max_queue=args.max_queue,
                           device=args.device)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/pose_estimation"
    payload = json.dumps({"scene_dir": os.path.abspath(args.scene),
                          "dataset": args.dataset}).encode()
    ok_lat: list = []  # (latency s, queue depth on arrival)
    answer: dict = {}  # the objects of the last answered request
    shed: list = []  # (queue depth, Retry-After s)
    errors: list = []
    lock = threading.Lock()
    try:
        # The first request builds what the path needs; not part of the measurement.
        t0 = time.monotonic()
        with urllib.request.urlopen(urllib.request.Request(url, data=payload, method="POST"),
                                    timeout=1800) as r:
            json.loads(r.read())
        warm_s = time.monotonic() - t0

        def client():
            while True:
                with lock:
                    if len(ok_lat) >= args.requests:
                        return
                t = time.monotonic()
                try:
                    req = urllib.request.Request(url, data=payload, method="POST")
                    with urllib.request.urlopen(req, timeout=1800) as r:
                        objects = json.loads(r.read())["objects"]
                        depth = int(r.headers.get("X-Queue-Depth", -1))
                    with lock:
                        ok_lat.append((time.monotonic() - t, depth))
                        answer.update({o["name"]: o["pose_world"] for o in objects})
                except urllib.error.HTTPError as e:
                    if e.code != 503:
                        with lock:
                            errors.append(f"{e.code}: {e.read()[:200]!r}")
                        return
                    body = json.loads(e.read())
                    with lock:
                        shed.append((body["queue_depth"], int(e.headers["Retry-After"])))
                    # Honour the backoff, scaled down (the EMA starts seconds long).
                    time.sleep(min(2.0, body["retry_after_s"] * 0.05))

        t_start = time.monotonic()
        threads = [threading.Thread(target=client) for _ in range(args.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        total_s = time.monotonic() - t_start
    finally:
        srv.shutdown()
        srv.server_close()

    lats = sorted(lat for lat, _ in ok_lat)
    depths = [d for _, d in ok_lat]
    n = len(lats)
    return {
        "config": {"clients": args.clients, "target_requests": args.requests,
                   "max_queue": args.max_queue, "device": dev.type,
                   "scene": os.path.abspath(args.scene)},
        **_torchcfg.describe_device(dev),
        "warm_compile_s": round(warm_s, 3),
        "completed": n,
        "requests_per_sec": round(n / total_s, 4),
        "latency_s": {"p50": round(lats[n // 2], 4) if n else None,
                      "p95": round(lats[min(n - 1, int(n * 0.95))], 4) if n else None,
                      "max": round(lats[-1], 4) if n else None},
        "queue_depth_on_arrival": {"max": max(depths, default=None),
                                   "mean": round(sum(depths) / n, 2) if n else None},
        "shed_503": {"count": len(shed), "retry_after_s": sorted({r for _, r in shed})},
        "errors": errors,
        "response_pose_world": answer,
        "policy": POLICY,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }


def _write_section(path: str, device: str, entries: dict) -> None:
    """Update this device's section of --out (read first, if it exists)."""
    merged = {}
    if os.path.exists(path):
        with open(path) as fh:
            merged = json.load(fh)
    merged.setdefault(device, {}).update(entries)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(merged, fh, indent=1)


def main(argv=None) -> int:
    from physimglobalpose_tpu_torch import _torchcfg

    args = parse_args(argv)
    _torchcfg.resolve_device(args.device)  # raises without a card, before any boot
    if args.phase == "warm-boot":
        print(json.dumps(warm_boot(args)))
        return 0
    if args.phase == "measure-boots":
        boots = {"boot1": measure_boot(args), "note": "one fresh-process service boot "
                 "(pipeline/server.serve with the boot warm-up pass); no second boot, as the "
                 "port keeps no compile cache for it to find"}
        _write_section(args.out, args.device, {"warm_boots": boots})
        print(json.dumps(boots, indent=1))
        return 0
    report = loadtest(args)
    # The section keeps a warm_boots entry of an earlier measure-boots run.
    _write_section(args.out, args.device, report)
    print(json.dumps(report, indent=1))
    return 0 if not report["errors"] else 1


if __name__ == "__main__":
    sys.exit(main())
