"""The general traffic generator: a mix's data file to a run's requests.

A mix (traffic/<name>.json) is parameters only:

- "entry": "serve" (POST /pose_estimation to the program's HTTP service)
  or "sweep" (the program's multi-scene sweep, batches back to back);
- "verification_mode": the program's mode, "LCP";
- "pool_scenes": distinct frames generated from the seed at set-up;
- "clients": callers of the serve entry in a closed loop, each sending its
  next request when its last is answered;
- "max_queue": the service's waiters behind the request in flight;
- "batch_scenes": scenes a sweep call takes (the sweep entry);
- "warmup": requests (or sweep calls) served at set-up, from the pool;
- "trace": when the traced requests of a --trace 1 run (after the window)
  end: after "requests" answers or "batches" sweep calls;
- "check_sample": the answers that the reference judges, drawn from the seed.

Every seed gets the same amount of work in another order: the pool's size
is fixed by the mix, the scenes, their order and the program's seed of each
request come from the run's seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SEED_SPACE = 2**31 - 1  # the program's per-request seed


@dataclass
class Plan:
    """The requests of one run, in the order they are sent."""

    scenes: np.ndarray  # [N] pool index of request i
    seeds: np.ndarray  # [N] the program's seed of request i


def plan(mix: dict, rng: np.random.Generator, n: int = 100_000) -> Plan:
    """The run's first `n` requests: the pool in a fresh shuffle each pass."""
    pool = mix["pool_scenes"]
    passes = -(-n // pool)
    scenes = np.concatenate([rng.permutation(pool) for _ in range(passes)])[:n]
    seeds = rng.integers(0, SEED_SPACE, size=n)
    return Plan(scenes=scenes, seeds=seeds)
