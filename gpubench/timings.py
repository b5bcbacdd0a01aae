"""Medians of the program's own stage timings over the answers inside the
window, which the profiler does not slow (the per-layer metrics that read
them)."""

from __future__ import annotations

import numpy as np


def median_ms(run, key: str) -> float | None:
    vals = [r["timings"][key] for r in run["answered"] if key in r["timings"]]
    return 1000.0 * float(np.median(vals)) if vals else None


def idle_share(run) -> float | None:
    tr = run["trace"]
    if not tr or not tr["window_s"] or tr["busy_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
