"""The host settings of the benchmark's process.

They are ones a deployment of the service would make for its own process,
and apply alike to every commit the benchmark measures:

- one thread for torch's intra-op and inter-op pools, and for OpenMP, MKL
  and OpenBLAS (set in the environment before numpy is imported);
- after set-up, Python's garbage collector moves every object alive into
  the permanent generation (gc.freeze), so the collections that the request
  path's allocations trigger do not walk the loaded models and scenes again.

No setting pins the process to cores: on these machines sysfs names no
cores local to the card.

This module imports no numpy at its top: `apply_early` has to run before it.
"""

from __future__ import annotations

import gc
import os

_THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                "NUMEXPR_NUM_THREADS", "VECLIB_MAXIMUM_THREADS")


def apply_early() -> None:
    """The thread counts, in the environment before numpy and torch are
    imported."""
    for var in _THREAD_VARS:
        os.environ[var] = "1"


def apply_torch() -> None:
    """One thread in torch's own pools, once torch is imported."""
    import torch

    torch.set_num_threads(1)
    try:
        torch.set_num_interop_threads(1)
    except RuntimeError:  # the inter-op pool has started already
        pass


def freeze_heap() -> None:
    """At the end of set-up."""
    gc.collect()
    gc.freeze()
