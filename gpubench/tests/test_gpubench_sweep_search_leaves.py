"""The timed path's own leaves of the shared search against the plain
reference (gpubench/search_reference.py), on the card, in the cell
hard3_occluded.sweep_mcts at its sizes.

A run of the cell's window, as the command runs it, with wrappers put in
from this test (none in the program): each BatchedLeafEvaluator keeps the
arguments it was built from, each MultiSceneLeafEvaluator the kept
arguments of the scenes' evaluators it stacks, and the first shared leaf
batch that evaluate_async queues in each sweep call of the window is kept,
with the costs and settled poses the card computed for it (copied on the
card's stream, so the search does not wait for them). After the run the
reference computes every row of the kept batches again, one assignment at a
time, each on the constants of the scene the row names, in float32 with
TF32 off, and search_reference.compare holds the program to it (TOL, each
with its reason, and the reference's own spread where the settle amplifies
rounding). Batches are taken in the window's order until MIN_LEAVES
distinct rows are held.

What this comparison cannot see: a window run wholly with TF32 on passes it
too; the cell's `correct` and its control
(test_gpubench_control_sweep_search.py) are what catch it.

Every answer of the window must also have ended by the search's budget, not
by its 60 s deadline (the answer's timings.search_deadline_cut).

    python3 -m pytest gpubench/tests/test_gpubench_sweep_search_leaves.py -q -m card -s
"""

import json

import numpy as np
import pytest
import torch

from gpubench import drive, run, spec
from gpubench import search_reference as sr
from physimglobalpose_tpu_torch.pipeline import mcts

CELL = "hard3_occluded.sweep_mcts"
SEED = 2**31 + 2609
SECONDS = 51.0
MIN_LEAVES = 512


@pytest.mark.card
def test_the_shared_batches_rows_agree_with_the_reference(card, monkeypatch, capsys):
    state = {"window": False, "records": None}
    kept = []  # (scenes' arguments, scene_idx, choices, active, device costs, device settled)

    init = mcts.BatchedLeafEvaluator.__init__
    multi_init = mcts.MultiSceneLeafEvaluator.__init__
    evaluate_async = mcts.MultiSceneLeafEvaluator.evaluate_async
    window = drive.SweepLoad.window

    def keeping_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self._kept_args = None
        if state["window"]:
            # The observed depth is a tensor on the card: a copy, on its stream.
            self._kept_args = (tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                     for a in args), kwargs)

    def keeping_multi_init(self, evaluators, *args, **kwargs):
        multi_init(self, evaluators, *args, **kwargs)
        scenes = [getattr(ev, "_kept_args", None) for ev in evaluators]
        self._kept_scenes = scenes if all(a is not None for a in scenes) else None

    def keeping_evaluate_async(self, scene_idx, choices, active):
        costs, settled = evaluate_async(self, scene_idx, choices, active)
        if getattr(self, "_kept_scenes", None) is not None:
            kept.append((self._kept_scenes, np.array(scene_idx), np.array(choices),
                         np.array(active), costs.clone(), settled.clone()))
            self._kept_scenes = None  # the first shared batch of this call only
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
    monkeypatch.setattr(mcts.MultiSceneLeafEvaluator, "__init__", keeping_multi_init)
    monkeypatch.setattr(mcts.MultiSceneLeafEvaluator, "evaluate_async", keeping_evaluate_async)
    monkeypatch.setattr(drive.SweepLoad, "window", timed_window)
    out = run.run_cell(spec.cell(CELL), SEED, SECONDS, False)

    records = state["records"]
    assert records and all(r["ok"] for r in records)
    cut = [r["timings"].get("search_deadline_cut") for r in records]
    assert cut == [False] * len(records), cut

    leaves, calls = [], 0
    for scenes, scene_idx, choices, active, costs, settled in kept:
        if len(leaves) >= MIN_LEAVES:
            break
        refs = {}
        costs, settled = costs.cpu().numpy(), settled.cpu().numpy()
        # A batch is padded to its size by repeating its first row.
        rows = {}
        for b in range(len(scene_idx)):
            rows.setdefault((int(scene_idx[b]), choices[b].tobytes(), active[b].tobytes()), b)
        for (si, _c, _a), b in rows.items():
            if si not in refs:
                args, kwargs = scenes[si]
                refs[si] = sr.scene(*args, render_scale=kwargs.get("render_scale"), device=card)
            k = len(refs[si].hull_pts)  # the scene's objects; the rest is padding
            leaves.append((refs[si], choices[b, :k], active[b, :k], (costs[b], settled[b, :k])))
        calls += 1
    got = sr.compare(leaves)
    with capsys.disabled():
        print("leaves", CELL, SEED, calls, json.dumps(got), "correct", out["correct"],
              flush=True)
    assert len(leaves) >= MIN_LEAVES, (calls, len(leaves))
    assert got["ok"], got
