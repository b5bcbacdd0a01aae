"""The device trace of a --trace 1 run: torch.profiler over a few requests
that follow the window.

The profiler records every thread of the process (the service answers in
threads of its own), CPU operations and the card's activity. From it:

- busy_s: the union of the intervals in which a kernel, copy or fill ran;
- window_s: the host clock from the profiler's start to its stop;
- ranges: per "gpubench::<layer>" range (layers.py), the calls, the kernels
  launched inside them and those kernels' device seconds;
- breakdown: the ten device operations that took most time, and the idle
  gaps of the card summed by the host operation that was running (innermost)
  in the middle of each gap.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict

import torch

RANGE_PREFIX = "gpubench::"
NAME_CHARS = 120  # device-operation names are cut to this length in the breakdown
GAPS_ATTRIBUTED = 5000  # the longest gaps that are attributed to a host operation


class Tracer:
    def __init__(self):
        self.prof = None
        self.window_s = None
        self.t_start = None
        self.thread = None

    def start(self) -> None:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self.prof.__enter__()
        self.t_start = time.perf_counter()
        self.thread = threading.current_thread()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t_start
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        from torch.autograd import DeviceType

        events = self.prof.events()
        device, cpu = [], []
        for e in events:
            if e.device_type == DeviceType.CPU:
                cpu.append(e)
            elif not e.is_user_annotation:
                device.append(e)
        busy = _union([(e.time_range.start, e.time_range.end) for e in device])
        per_name = defaultdict(float)
        for e in device:
            per_name[e.name[:NAME_CHARS]] += (e.time_range.end - e.time_range.start) * 1e-6
        return {
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": self.window_s,
            "kernels": sum(1 for e in device if _is_kernel(e)),
            "ranges": _ranges(cpu, device),
            "device_ops": sorted(per_name.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": _idle_gaps(busy, cpu),
        }


class TraceGate:
    """Closes the traced requests after the mix's count of answers
    ("requests") or of sweep calls ("batches"). The thread that reaches the
    count waits until the thread that started the profiler (which polls) has
    stopped it, so that no call is cut in two; the starting thread stops it
    at once."""

    def __init__(self, tracer: Tracer, when: dict, lay):
        self.tracer, self.when, self.lay = tracer, when, lay
        self.pending = threading.Event()
        self.closed = threading.Event()
        lay.recording = True

    def _reached(self) -> None:
        if self.closed.is_set():
            return
        if threading.current_thread() is self.tracer.thread:
            self._stop()
        else:
            self.pending.set()
            self.closed.wait(timeout=600)

    def after_answer(self, records) -> None:
        if "requests" in self.when:
            done = sum(r["done"] is not None for r in records)
            if done >= self.when["requests"]:
                self._reached()
        elif "batches" in self.when:
            calls = len({r["sent"] for r in records if r["done"] is not None})
            if calls >= self.when["batches"]:
                self._reached()

    def poll(self) -> None:
        if self.pending.is_set() and not self.closed.is_set():
            self._stop()

    def finish(self) -> None:
        """Stop the profiler at the window's end if the count was not reached."""
        if not self.closed.is_set():
            self._stop()

    def _stop(self) -> None:
        self.lay.recording = False
        self.tracer.stop()
        self.closed.set()


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _is_kernel(e) -> bool:
    return not e.name.startswith(("Memcpy", "Memset"))


def _ranges(cpu, device) -> dict:
    """Per "gpubench::<layer>" range: its calls, the kernels launched inside
    it and the device seconds of every operation launched inside it. An
    operation belongs to a range when the runtime call that launched it
    (matched by its correlation id) started inside the range's interval;
    the program's own CUDA launches (ctypes) are matched as torch's are. The
    service answers one request at a time, so intervals do not overlap
    across threads."""
    by_corr = {e.id: e for e in device}
    launches = sorted((e.time_range.start, by_corr[e.id]) for e in cpu
                      if e.name.startswith("cu") and e.id in by_corr)
    starts = [t for t, _ in launches]
    out = {}
    for e in cpu:
        if not e.name.startswith(RANGE_PREFIX):
            continue
        r = out.setdefault(e.name[len(RANGE_PREFIX):], {"count": 0, "kernels": 0, "device_s": 0.0})
        r["count"] += 1
        lo = bisect.bisect_left(starts, e.time_range.start)
        hi = bisect.bisect_right(starts, e.time_range.end)
        for _, op in launches[lo:hi]:
            r["kernels"] += _is_kernel(op)
            r["device_s"] += (op.time_range.end - op.time_range.start) * 1e-6
    return out


def _idle_gaps(busy, cpu) -> list:
    """The card's idle gaps between its first and last operation, summed by
    the innermost host operation running at each gap's middle."""
    gaps = sorted(((busy[i + 1][0] - busy[i][1], (busy[i][1] + busy[i + 1][0]) / 2)
                   for i in range(len(busy) - 1)), reverse=True)[:GAPS_ATTRIBUTED]
    ops = sorted(((e.time_range.start, e.time_range.end, e.name) for e in cpu
                  if not e.name.startswith(RANGE_PREFIX)), key=lambda o: o[0])
    starts = [o[0] for o in ops]
    total = defaultdict(float)
    for length, mid in gaps:
        i = bisect.bisect_right(starts, mid) - 1
        name = "no host operation"
        for j in range(i, max(i - 200, -1), -1):  # innermost: the latest start that covers mid
            if ops[j][1] >= mid:
                name = ops[j][2]
                break
        total[name] += length * 1e-6
    return sorted(total.items(), key=lambda kv: -kv[1])[:10]
