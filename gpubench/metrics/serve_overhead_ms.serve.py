"""The service's own time a request: client latency minus the program's
timings.total_s (the HTTP exchange, JSON, the wait for the service's lock),
median ms."""

import numpy as np


def read(run):
    vals = [(r["done"] - r["due"] - r["timings"]["total_s"]) for r in run["answered"]
            if "total_s" in r["timings"]]
    return 1000.0 * float(np.median(vals)) if vals else None
