"""The port's spans and counters: one request record a top-level call.

Replaces the reference's ad-hoc clock() prints scattered into text files
(match4pcsBase.cc:1916-1924 hardcodes an author-machine path; main.cpp:120-125
writes pipeline totals).

- A top-level call (a server request, a direct estimate_pose call, a
  sweep_scenes call) opens a request record (Tracer) with a fresh integer
  id; the spans opened inside it nest under its root and share that id. A
  span records its name, its parent, its start and end
  (time.perf_counter_ns) and the counts set on it.
- The current span is bound to the context (contextvars), never to a
  shared stack: two threads build two trees.
- Records go into a bounded ring (RING_RECORDS) when they open;
  record(request_id) finds one while it is in the ring.
- While a torch.profiler session is active, each span also opens
  record_function("pose::<name>"), so its range sits in the profiler's
  timeline, in the thread that ran it. Otherwise a span costs two clock
  reads, an append, one check of the profiler's flag and the context's
  set and reset.

Device-side timelines come from device_trace (torch.profiler) around a
block.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

RING_RECORDS = 4096  # request records kept for readers, oldest dropped first
RANGE_PREFIX = "pose::"  # the profiler ranges' names: "pose::<span name>"

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("physim_pose_span", default=None)
_IDS = itertools.count(1)
_RING: "OrderedDict[int, Tracer]" = OrderedDict()
_RING_LOCK = threading.Lock()
_now_ns = time.perf_counter_ns


class Span:
    """A timed interval of one record; also the context manager that opens
    it (entering makes it the context's current span). open() and close()
    time it without making it current, for an interval that nothing nests
    in or that does not nest (the service's parse, the pipelined sweep's
    chunks)."""

    __slots__ = ("name", "tracer", "parent", "start_ns", "end_ns", "children", "counts",
                 "_token", "_range")

    def __init__(self, name: str, tracer: "Tracer", parent: Optional["Span"]):
        self.name = name
        self.tracer = tracer
        self.parent = parent
        self.start_ns: Optional[int] = None
        self.end_ns: Optional[int] = None
        self.children: List[Span] = []
        self.counts: Optional[Dict[str, int]] = None  # made by the first count()
        self._range = None
        (parent.children if parent is not None else tracer.roots).append(self)

    @property
    def request_id(self) -> int:
        return self.tracer.request_id

    @property
    def duration(self) -> float:
        """Seconds; up to now while the span is open."""
        end = _now_ns() if self.end_ns is None else self.end_ns
        return (end - self.start_ns) * 1e-9

    def count(self, **counts: int) -> None:
        if self.counts is None:
            self.counts = {}
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    def _open_range(self) -> None:
        self._range = torch.profiler.record_function(RANGE_PREFIX + self.name)
        self._range.__enter__()

    def _close_range(self) -> None:
        self._range.__exit__(None, None, None)
        self._range = None

    def open(self) -> "Span":
        if _autograd_profiler._is_profiler_enabled:
            self._open_range()
        self.start_ns = _now_ns()
        return self

    def close(self) -> None:
        self.end_ns = _now_ns()
        if self._range is not None:
            self._close_range()

    # __enter__ and __exit__ repeat open() and close() inline: a span's cost
    # when no profiler is on is mostly Python calls.
    def __enter__(self) -> "Span":
        self._token = _CURRENT.set(self)
        if _autograd_profiler._is_profiler_enabled:
            self._open_range()
        self.start_ns = _now_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = _now_ns()
        if self._range is not None:
            self._close_range()
        _CURRENT.reset(self._token)

    def find(self, name: str) -> Optional["Span"]:
        """The first span named `name` in this subtree, depth first."""
        return next(iter(self.find_all(name)), None)

    def find_all(self, name: str) -> List["Span"]:
        out = [self] if self.name == name else []
        for c in self.children:
            out += c.find_all(name)
        return out

    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "duration_s": round(self.duration, 6),
            "children": [c.to_dict() for c in self.children],
        }
        if self.counts:
            out["counts"] = dict(self.counts)
        return out


class Tracer:
    """A request record: the span trees of one top-level call, under one id."""

    def __init__(self):
        self.request_id = next(_IDS)
        self.roots: List[Span] = []

    def find(self, name: str) -> Optional[Span]:
        return next(iter(self.find_all(name)), None)

    def find_all(self, name: str) -> List[Span]:
        return [s for r in self.roots for s in r.find_all(name)]

    def to_json(self) -> str:
        return json.dumps([r.to_dict() for r in self.roots], indent=2)

    def dump(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json())

    def flat_timings(self) -> dict:
        out = {}

        def walk(span, prefix=""):
            key = prefix + span.name
            out[key] = out.get(key, 0.0) + span.duration
            for c in span.children:
                walk(c, key + "/")

        for r in self.roots:
            walk(r)
        return out


def _admit(tracer: Tracer) -> None:
    with _RING_LOCK:
        _RING[tracer.request_id] = tracer
        if len(_RING) > RING_RECORDS:
            _RING.popitem(last=False)


def span(name: str) -> Span:
    """A span under the context's current span; with none current, the
    root of a new request record (a top-level call)."""
    cur = _CURRENT.get()
    if cur is not None:
        return Span(name, cur.tracer, cur)
    tracer = Tracer()
    _admit(tracer)
    return Span(name, tracer, None)


def trace_span(tracer: Tracer, name: str) -> Span:
    """A span of `tracer`: under the context's current span where that span
    belongs to `tracer`, else a root of it."""
    cur = _CURRENT.get()
    return Span(name, tracer, cur if cur is not None and cur.tracer is tracer else None)


def count(**counts: int) -> None:
    """Add counts to the context's current span (nothing without one)."""
    cur = _CURRENT.get()
    if cur is not None:
        cur.count(**counts)


def record(request_id) -> Optional[Tracer]:
    """The request record with this id, while the ring holds it."""
    with _RING_LOCK:
        return _RING.get(request_id)


def records() -> List[Tracer]:
    """The ring's records, oldest first."""
    with _RING_LOCK:
        return list(_RING.values())


def self_s(s: Span) -> float:
    """A span's duration minus the part of it that its children cover."""
    end = _now_ns() if s.end_ns is None else s.end_ns
    covered, reach = 0, s.start_ns
    for c in sorted(s.children, key=lambda c: c.start_ns):
        a = max(c.start_ns, reach)
        b = min(end if c.end_ns is None else c.end_ns, end)
        if b > a:
            covered += b - a
            reach = b
    return (end - s.start_ns - covered) * 1e-9


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a device-level trace (TensorBoard format) around a block.

    The spans above cover host phases (and appear in it as "pose::" ranges);
    this wraps torch.profiler.profile with CPU activity, and CUDA activity
    when a card is present, and writes the trace into log_dir through
    tensorboard_trace_handler. Yields the profiler, whose key_averages()
    and events() read the spans. After a process has profiled a large
    session, the profiler can drop device spans of later ones: count the
    kernels' launches beside the spans rather than trusting the spans alone.
    """
    from torch import profiler

    activities = [profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(profiler.ProfilerActivity.CUDA)
    with profiler.profile(activities=activities,
                          on_trace_ready=profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
