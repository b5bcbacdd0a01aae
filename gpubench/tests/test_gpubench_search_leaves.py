"""The timed path's own leaves of the search against the plain reference
(gpubench/search_reference.py), on the card, in the cell
hard3_occluded.serve_mcts at its sizes.

A run of the cell's window, as the command runs it, with two wrappers put
in from this test (none in the program): each BatchedLeafEvaluator keeps
the arguments it was built from, and the first leaf batch that
evaluate_async queues for each request of the window is kept, with the
costs and settled poses the card computed for it (copied on the card's
stream, so the search does not wait for them). After the run the reference
computes every kept leaf again, one at a time, in float32 with TF32 off,
and search_reference.compare holds the program to it (TOL, each with its
reason, and the reference's own spread where the settle amplifies
rounding).

What this comparison cannot see: a window run wholly with TF32 on passes
it too (the settle's and the render's products are small, and their TF32
rounding stays inside the spread); TF32 moves the answers elsewhere, and
the cell's `correct` and its control (test_gpubench_control_search.py)
are what catch it.

Every answer of the window must also have ended by the search's budget,
not by its 60 s deadline (the answer's timings.search_deadline_cut).

    python3 -m pytest gpubench/tests/test_gpubench_search_leaves.py -q -m card -s
"""

import json

import numpy as np
import pytest
import torch

from gpubench import drive, run, spec
from gpubench import search_reference as sr
from physimglobalpose_tpu_torch.pipeline import mcts

CELL = "hard3_occluded.serve_mcts"
SEED = 2**31 + 1807
SECONDS = 51.0
MIN_LEAVES = 512
MIN_REQUESTS = 4


@pytest.mark.card
def test_the_timed_paths_leaves_agree_with_the_reference(card, monkeypatch, capsys):
    state = {"window": False, "records": None}
    kept = []  # (evaluator's arguments, choices, active, device costs, device settled)

    init, evaluate_async = mcts.BatchedLeafEvaluator.__init__, mcts.BatchedLeafEvaluator.evaluate_async
    window = drive.ServeLoad.window

    def keeping_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self._kept_args = None
        if state["window"]:
            # The observed depth is a tensor on the card: a copy, on its stream.
            self._kept_args = (tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                     for a in args), kwargs)

    def keeping_evaluate_async(self, choices, active):
        costs, settled = evaluate_async(self, choices, active)
        if getattr(self, "_kept_args", None) is not None:
            kept.append((self._kept_args, np.array(choices), np.array(active),
                         costs.clone(), settled.clone()))
            self._kept_args = None  # the first batch of this request only
        return costs, settled

    def timed_window(self, seconds, gate=None):
        state["window"] = gate is None
        try:
            records = window(self, seconds, gate)
        finally:
            state["window"] = False
        if gate is None:
            state["records"] = records
        return records

    monkeypatch.setattr(mcts.BatchedLeafEvaluator, "__init__", keeping_init)
    monkeypatch.setattr(mcts.BatchedLeafEvaluator, "evaluate_async", keeping_evaluate_async)
    monkeypatch.setattr(drive.ServeLoad, "window", timed_window)
    out = run.run_cell(spec.cell(CELL), SEED, SECONDS, False)

    records = state["records"]
    assert records and all(r["ok"] for r in records)
    cut = [r["timings"].get("search_deadline_cut") for r in records]
    assert cut == [False] * len(records), cut

    leaves, requests = [], 0
    for (args, kwargs), choices, active, costs, settled in kept:
        if len(leaves) >= MIN_LEAVES and requests >= MIN_REQUESTS:
            break
        ref = sr.scene(*args, render_scale=kwargs.get("render_scale"), device=card)
        costs, settled = costs.cpu().numpy(), settled.cpu().numpy()
        # A batch is padded to its size by repeating its first row.
        rows = {}
        for b in range(len(choices)):
            rows.setdefault((choices[b].tobytes(), active[b].tobytes()), b)
        leaves += [(ref, choices[b], active[b], (costs[b], settled[b])) for b in rows.values()]
        requests += 1
    got = sr.compare(leaves)
    with capsys.disabled():
        print("leaves", CELL, SEED, requests, json.dumps(got), "correct", out["correct"],
              flush=True)
    assert requests >= MIN_REQUESTS and len(leaves) >= MIN_LEAVES, (requests, len(leaves))
    assert got["ok"], got
