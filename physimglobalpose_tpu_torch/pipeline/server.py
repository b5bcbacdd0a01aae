"""HTTP service honoring the /pose_estimation contract.

The reference exposes the pipeline as a ROS service (main.cpp:210-212,
EstimateObjectPose.srv); here the same request shape is a JSON POST to a
long-running process that keeps the object models loaded and its kernels
built:

  POST /pose_estimation
  {"dataset": "APC", "scene_dir": "...", "segmentation_mode": "GT",
   "hypothesis_mode": "PCS", "verification_mode": "LCP", "seed": 0}
  -> {"objects": [{"name", "pose_world" (4x4), "pose_cam", "score"}, ...],
      "timings": {...}}

The timings are estimate_pose's (pipeline/api.py) and two of the service's:
request_id, the request's record in utils/tracing (spans serve.request ->
serve.parse, serve.queue_wait, estimate -> its stages, serve.reply), and
queue_wait_s, the seconds from admission to holding the device.

Queueing policy (the JAX package's, physimglobalpose_tpu/pipeline/server.py):
the device is single-flight, one scene at a time holds it. Up to max_queue
more requests wait in line (every response carries an X-Queue-Depth header
with the line it saw on arrival); beyond that the server sheds load with 503
and Retry-After = ceil((depth + 1) x the EMA request latency). /healthz
reports {queue_depth, ema_latency_s}. 400 answers a request that lacks a
field or names a missing scene; 500 any other failure.

The JAX service's --compile-cache-dir has no counterpart: the port has no
JIT cache, and its kernels build once into the git-ignored build directory
(physimglobalpose_tpu_torch/_build.py), where a re-boot finds them.

Run: python -m physimglobalpose_tpu_torch.pipeline.server --port 8080 \\
       --obj-config ... --model-dir ... [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def warmup(db, cfg, verification_mode: str = "LCP", device=None):
    """Run the serving path at boot instead of on the first request.

    Two passes of estimate_pose on a synthetic in-memory scene at the
    configured render size: the first builds what the request path needs (the
    CUDA kernels where build/kernels/ holds none yet, the cuDNN and allocator
    warm-up), the second runs warm. Returns (total_s, first pass minus
    second, second pass), each >= 0.
    """
    import numpy as np

    from physimglobalpose_tpu_torch.pipeline import api, scene as scene_mod

    t0 = time.monotonic()
    h, w = cfg.render.height, cfg.render.width
    intr = np.array([[600.0, 0, w / 2.0], [0, 600.0, h / 2.0], [0, 0, 1.0]], np.float32)
    depth = np.full((h, w), 0.8, np.float32)  # the table plane
    class_mask = np.zeros((h, w), np.int32)
    names = db.names[: min(3, len(db.names))]
    for i, n in enumerate(names):
        y0, x0 = h // 4 + (h // 8) * i, w // 6 + (w // 5) * i
        depth[y0: y0 + 80, x0: x0 + 80] = 0.68  # a 12 cm-proud blob
        class_mask[y0: y0 + 80, x0: x0 + 80] = db.class_of(n)
    sc = scene_mod.scene_from_arrays(
        color=np.zeros((h, w, 3), np.uint8), depth=depth, intrinsics=intr,
        cam_pose=np.eye(4, dtype=np.float32), object_names=list(names), class_mask=class_mask,
    )
    run = lambda: api.estimate_pose(  # noqa: E731
        "<warmup>", db, segmentation_mode="GT", verification_mode=verification_mode, cfg=cfg,
        scene=sc, write_result=False, device=device,
    )
    run()
    t1 = time.monotonic()
    run()
    t2 = time.monotonic()
    run_s = t2 - t1
    return t2 - t0, max(0.0, (t1 - t0) - run_s), run_s


def make_handler(db, default_cfg, max_queue: int = 4, warm_s: float = 0.0,
                 warm_compile_s: float = 0.0, device=None):
    from physimglobalpose_tpu_torch.pipeline import api
    from physimglobalpose_tpu_torch.utils import tracing

    lock = threading.Lock()  # one scene at a time through the device
    state = {"pending": 0, "ema_s": 30.0}  # the EMA starts at a cold guess
    state_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def handle_one_request(self):
            # One request record a request: from before the request line is
            # read until the reply is written. serve.parse is not the current
            # span (nothing nests in it), so a reply can close it wherever
            # the handler stops parsing.
            with tracing.span("serve.request") as self.request_span:
                self.parse_span = tracing.span("serve.parse").open()
                try:
                    super().handle_one_request()
                finally:
                    self._parsed()

        def _parsed(self):
            if self.parse_span.end_ns is None:
                self.parse_span.close()

        def _reply(self, code, payload, headers=()):
            self._parsed()
            with tracing.span("serve.reply"):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self._reply(404, {"error": "unknown path"})
                return
            with state_lock:
                depth, ema = state["pending"], state["ema_s"]
            self._reply(200, {
                "ok": True, "objects": db.names,
                "queue_depth": depth, "ema_latency_s": round(ema, 3),
                "warmup_s": round(warm_s, 2), "warmup_compile_s": round(warm_compile_s, 2),
            })

        def do_POST(self):
            if self.path != "/pose_estimation":
                self._reply(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except ValueError as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                return
            self._parsed()
            # Admission before joining the device line: max_queue callers
            # may wait, the rest get an explicit backoff.
            with state_lock:
                depth = state["pending"]
                if depth > max_queue:
                    retry = math.ceil((depth + 1) * state["ema_s"])
                    self._reply(
                        503, {"error": "busy", "queue_depth": depth, "retry_after_s": retry},
                        headers=[("Retry-After", str(retry)), ("X-Queue-Depth", str(depth))],
                    )
                    return
                state["pending"] += 1
            t0 = time.monotonic()
            try:
                with tracing.span("serve.queue_wait") as wait:
                    lock.acquire()
                try:
                    result = api.estimate_pose(
                        req["scene_dir"], db,
                        dataset=req.get("dataset", "APC"),
                        segmentation_mode=req.get("segmentation_mode", "GT"),
                        hypothesis_mode=req.get("hypothesis_mode", "PCS"),
                        verification_mode=req.get("verification_mode", "LCP"),
                        cfg=default_cfg,
                        seed=int(req.get("seed", 0)),
                        write_result=bool(req.get("write_result", False)),
                        device=device,
                    )
                finally:
                    lock.release()
                # The EMA counts successful requests only (an error answers
                # in milliseconds and would drag Retry-After to 0).
                dt = time.monotonic() - t0
                with state_lock:
                    state["ema_s"] = 0.7 * state["ema_s"] + 0.3 * dt
                self._reply(200, {
                    "objects": [
                        {"name": o.name, "pose_world": o.pose_world.tolist(),
                         "pose_cam": o.pose_cam.tolist(), "score": o.score}
                        for o in result.objects
                    ],
                    "timings": dict(result.timings, request_id=self.request_span.request_id,
                                    queue_wait_s=wait.duration),
                }, headers=[("X-Queue-Depth", str(depth))])
            except (KeyError, ValueError, FileNotFoundError) as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # noqa: BLE001 - the service boundary
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            finally:
                with state_lock:
                    state["pending"] -= 1

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def serve(db, cfg, port: int = 8080, host: str = "127.0.0.1", max_queue: int = 4,
          warm: bool = False, device=None):
    """Build the service and return it (serve_forever() runs it; port 0
    takes a free port). max_queue: waiters allowed behind the request in
    flight before 503 + Retry-After. warm: run warmup() at boot, so the
    first client pays no build; its times are on the server as warmup_s,
    warmup_compile_s (first pass minus second) and warmup_run_s. device:
    the card unless "cpu"."""
    total_s, compile_s, run_s = warmup(db, cfg, device=device) if warm else (0.0, 0.0, 0.0)
    server = ThreadingHTTPServer((host, port), make_handler(
        db, cfg, max_queue=max_queue, warm_s=total_s, warm_compile_s=compile_s, device=device,
    ))
    server.warmup_s = total_s
    server.warmup_compile_s = compile_s
    server.warmup_run_s = run_s
    return server


def main(argv=None):
    p = argparse.ArgumentParser(description="pose estimation HTTP service (PyTorch/CUDA)")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--obj-config", required=True)
    p.add_argument("--model-dir", required=True)
    p.add_argument("--cache-dir", default=None,
                   help="asset cache (default: physimglobalpose_tpu_torch_cache "
                        "under the temporary directory)")
    p.add_argument("--objects", nargs="*", default=None)
    p.add_argument("--max-queue", type=int, default=4,
                   help="waiters allowed behind the request in flight before "
                        "503 + Retry-After load shedding")
    p.add_argument("--no-warm", action="store_true",
                   help="skip the boot-time warm-up pass (the first request then pays it)")
    p.add_argument("--preset", default="default", choices=["default", "small"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="serve on the card (default) or on the CPU")
    args = p.parse_args(argv)

    from physimglobalpose_tpu_torch.config import PRESETS
    from physimglobalpose_tpu_torch.models import objectdb

    cfg = PRESETS[args.preset]
    db = objectdb.load_object_db(
        args.obj_config, args.model_dir, config=cfg,
        cache_dir=args.cache_dir or objectdb.default_cache_dir(), only=args.objects,
        device=args.device,
    )
    server = serve(db, cfg, port=args.port, host=args.host, max_queue=args.max_queue,
                   warm=not args.no_warm, device=args.device)
    if not args.no_warm:
        print(f"warm-up: {server.warmup_s:.1f} s")
    print(f"pose_estimation service on http://{args.host}:{server.server_address[1]}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
