"""The two loads on the program's entries, and the program's set-up.

- ServeLoad: the program's /pose_estimation service (pipeline/server.serve,
  the service's own threads and admission) on a local port, and clients
  that POST the plan's requests in a closed loop. The client threads use
  urllib only; the program runs in the service's threads.
- SweepLoad: the program's scene sweep (parallel/scene_sweep.sweep_scenes),
  calls of batch_scenes scenes back to back.

Each keeps one record a request (a sweep call answers each of its scenes at
once): the pool scene, when it was due and sent, when its answer came, the
status, the poses (camera frame) and the program's timings.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request

import torch

ANSWER_TIMEOUT_S = 600.0
LATE_WAIT_S = 60.0  # how long past the window's close an answer is waited for


class Program:
    """The program under test, set up for one configuration: its kernels
    built, the boxes' meshes written and prepared as its object database."""

    def __init__(self, conf: dict, workdir: str, asset_cache: str, device, pipeline=None):
        from physimglobalpose_tpu_torch import _build, _torchcfg
        from physimglobalpose_tpu_torch.models import objectdb

        from gpubench import scenes

        self.conf = conf
        self.device = _torchcfg.resolve_device(device)
        self.build_s = _build.build() if self.device.type == "cuda" else 0.0
        self.cfg = pipeline if pipeline is not None else make_pipeline_config(conf["pipeline"])
        obj_config = scenes.write_models(os.path.join(workdir, "models"), conf)
        self.db = objectdb.load_object_db(obj_config, os.path.join(workdir, "models"),
                                          config=self.cfg, cache_dir=asset_cache,
                                          device=self.device)

    def request(self, scene_dir: str, seed: int, mode: str) -> dict:
        c = self.conf
        return {"scene_dir": scene_dir, "dataset": c["dataset"],
                "segmentation_mode": c["segmentation_mode"],
                "hypothesis_mode": c["hypothesis_mode"], "verification_mode": mode,
                "seed": int(seed)}


def make_pipeline_config(values: dict):
    """The program's PipelineConfig with every field that the configuration
    file states set from it (sections as nested objects)."""
    import dataclasses

    from physimglobalpose_tpu_torch.config import PipelineConfig

    top = {}
    base = PipelineConfig()
    for key, val in values.items():
        if isinstance(val, dict):
            top[key] = dataclasses.replace(getattr(base, key), **{
                k: tuple(v) if isinstance(v, list) else v for k, v in val.items()})
        else:
            top[key] = val
    return dataclasses.replace(base, **top)


def _record(i, scene, due, sent) -> dict:
    return {"i": i, "scene": int(scene), "due": due, "sent": sent, "done": None,
            "ok": False, "shed": False, "error": None, "poses": {}, "timings": {}}


class ServeLoad:
    def __init__(self, prog: Program, dirs, plan, mix: dict):
        from physimglobalpose_tpu_torch.pipeline import server as server_mod

        self.prog, self.dirs, self.plan, self.mix = prog, dirs, plan, mix
        self.srv = server_mod.serve(prog.db, prog.cfg, port=0, max_queue=mix["max_queue"],
                                    warm=False, device=prog.device)
        self.thread = threading.Thread(target=self.srv.serve_forever, kwargs={"poll_interval": 0.1},
                                       name="gpubench-service", daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}/pose_estimation"

    def _send(self, rec: dict, seed: int) -> dict:
        body = json.dumps(self.prog.request(self.dirs[rec["scene"]], seed,
                                            self.mix["verification_mode"])).encode()
        req = urllib.request.Request(self.url, data=body, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=ANSWER_TIMEOUT_S) as r:
                answer = json.loads(r.read())
            rec["ok"] = True
            rec["poses"] = {o["name"]: o["pose_cam"] for o in answer["objects"]}
            rec["timings"] = answer["timings"]
        except urllib.error.HTTPError as e:
            rec["shed"] = e.code == 503  # the service's admission said busy
            rec["error"] = f"{e.code}: {e.read()[:300]!r}"
        except (urllib.error.URLError, OSError) as e:
            rec["error"] = f"{type(e).__name__}: {e}"
        rec["done"] = time.monotonic()
        return rec

    def warm(self, n: int) -> None:
        """n requests of the cell's own mode, one at a time (set-up; the
        window's answers are the ones judged)."""
        for k in range(n):
            self._send(_record(-1, k % len(self.dirs), None, time.monotonic()), k)

    def window(self, seconds: float, gate=None) -> list:
        """The plan's requests until `seconds` have passed; answers of
        requests sent inside the window are waited for up to LATE_WAIT_S
        past its close. gate: the trace.TraceGate of a traced run."""
        records: list = []
        lock = threading.Lock()
        end = time.monotonic() + seconds
        plan = self.plan
        counter = iter(range(len(plan.scenes)))

        def client():
            while time.monotonic() < end and not (gate is not None and gate.closed.is_set()):
                with lock:
                    i = next(counter)
                    now = time.monotonic()
                    rec = _record(i, plan.scenes[i], now, now)
                    records.append(rec)
                self._answer(rec, plan.seeds[i], records, gate)

        threads = [threading.Thread(target=client, name=f"gpubench-client{c}", daemon=True)
                   for c in range(self.mix["clients"])]
        for t in threads:
            t.start()
        for t in threads:
            while t.is_alive() and time.monotonic() < end + LATE_WAIT_S:
                if gate is not None and not gate.closed.is_set():
                    gate.poll()
                    t.join(timeout=0.01)
                else:
                    t.join(timeout=max(0.0, end + LATE_WAIT_S - time.monotonic()))
        return records

    def _answer(self, rec, seed, records, gate) -> None:
        self._send(rec, seed)
        if gate is not None:
            gate.after_answer(records)

    def close(self) -> None:
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=30)


class SweepLoad:
    def __init__(self, prog: Program, dirs, plan, mix: dict):
        self.prog, self.dirs, self.plan, self.mix = prog, dirs, plan, mix

    def _call(self, recs: list, seed: int) -> None:
        from physimglobalpose_tpu_torch.parallel import scene_sweep

        c = self.prog.conf
        dirs = [self.dirs[r["scene"]] for r in recs]
        try:
            with torch.profiler.record_function("gpubench::sweep"):
                res = scene_sweep.sweep_scenes(
                    None, dirs, self.prog.db, dataset=c["dataset"],
                    segmentation_mode=c["segmentation_mode"], hypothesis_mode=c["hypothesis_mode"],
                    cfg=self.prog.cfg, seed=int(seed),
                    verification_mode=self.mix["verification_mode"], device=self.prog.device)
            error = None
        except Exception as e:  # noqa: BLE001 - a failed call fails its scenes, the run goes on
            res, error = {}, f"{type(e).__name__}: {e}"
        done = time.monotonic()
        for r, d in zip(recs, dirs):
            r["done"] = done
            if d in res:
                r["ok"] = True
                r["poses"] = {o.name: o.pose_cam.tolist() for o in res[d].objects}
                r["timings"] = dict(res[d].timings)
            else:
                r["error"] = error or "no answer for this scene"

    def warm(self, n: int) -> None:
        b = self.mix["batch_scenes"]
        for k in range(n):
            self._call([_record(-1, (k * b + j) % len(self.dirs), None, None) for j in range(b)], k)

    def window(self, seconds: float, gate=None) -> list:
        records: list = []
        b = self.mix["batch_scenes"]
        plan = self.plan
        t0 = time.monotonic()
        k = 0
        while time.monotonic() < t0 + seconds and not (gate is not None and gate.closed.is_set()):
            now = time.monotonic()
            recs = [_record(k * b + j, plan.scenes[k * b + j], now, now) for j in range(b)]
            records.extend(recs)
            self._call(recs, plan.seeds[k])
            k += 1
            if gate is not None:
                gate.after_answer(records)
        return records

    def close(self) -> None:
        pass


LOADS = {"serve": ServeLoad, "sweep": SweepLoad}
