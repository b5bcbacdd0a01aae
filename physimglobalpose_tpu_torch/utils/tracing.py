"""Structured tracing: per-phase spans emitted as JSON.

Replaces the reference's ad-hoc clock() prints scattered into text files
(match4pcsBase.cc:1916-1924 hardcodes an author-machine path; main.cpp:120-125
writes pipeline totals). Spans nest, carry wall time, and can be dumped as
JSON. Device-side timelines come from device_trace (torch.profiler) around
a block.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch


@dataclass
class Span:
    name: str
    start: float
    end: Optional[float] = None
    children: List["Span"] = field(default_factory=list)

    @property
    def duration(self) -> float:
        return (self.end or time.perf_counter()) - self.start

    def to_dict(self):
        return {
            "name": self.name,
            "duration_s": round(self.duration, 6),
            "children": [c.to_dict() for c in self.children],
        }


class Tracer:
    def __init__(self):
        self.roots: List[Span] = []
        self._stack: List[Span] = []

    def begin(self, name: str) -> Span:
        span = Span(name=name, start=time.perf_counter())
        if self._stack:
            self._stack[-1].children.append(span)
        else:
            self.roots.append(span)
        self._stack.append(span)
        return span

    def finish(self) -> None:
        span = self._stack.pop()
        span.end = time.perf_counter()

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


_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    return _GLOBAL


def reset_tracer() -> Tracer:
    global _GLOBAL
    _GLOBAL = Tracer()
    return _GLOBAL


@contextlib.contextmanager
def trace_span(tracer: Tracer, name: str):
    tracer.begin(name)
    try:
        yield
    finally:
        tracer.finish()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a device-level trace (TensorBoard format) around a block.

    The structured-span Tracer covers host phases; this wraps
    torch.profiler.profile with CPU activity, and CUDA activity when a card
    is present, and writes the trace into log_dir through
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
