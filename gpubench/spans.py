"""The program's own spans of the window's answers, for the per-layer
metrics that read them (source "program_span").

The program keeps one request record a top-level call in a bounded ring
(physimglobalpose_tpu_torch/utils/tracing.py), and each answer's timings
carry its record's request_id: a service request, or the sweep call that
answered the scene. The metrics are read in the run's own process after
the window, so the records are looked up there. A program without such
records reads nothing.
"""

from __future__ import annotations

import numpy as np


def records(run) -> list:
    """The request records of the window's answers, one an id, in order."""
    from physimglobalpose_tpu_torch.utils import tracing

    find = getattr(tracing, "record", None)
    if find is None:
        return []
    out, seen = [], set()
    for r in run["answered"]:
        rid = r["timings"].get("request_id")
        if rid is None or rid in seen:
            continue
        seen.add(rid)
        rec = find(rid)
        if rec is not None:
            out.append(rec)
    return out


def total_s(rec, name: str) -> float | None:
    """The summed duration of a record's spans named `name`, None if it has none."""
    found = rec.find_all(name)
    return sum(s.duration for s in found) if found else None


def median_ms(values) -> float | None:
    return 1000.0 * float(np.median(values)) if values else None


def median_total_ms(run, name: str) -> float | None:
    """Median over the window's records of their spans named `name`, summed a record."""
    return median_ms([v for v in (total_s(rec, name) for rec in records(run)) if v is not None])
