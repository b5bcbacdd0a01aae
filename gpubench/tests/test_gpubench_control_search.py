"""The TF32 control of the search cell hard3_occluded.serve_mcts, on the
card: the program with TF32 switched on in its matrix products (the nearest
precision below the float32 with TF32 off that the configuration states),
over a run's window at the cell's load, every answer judged as a run judges
it. It has to come out not correct on every seed; PERF.md gives the
readings beside the sound ones and the limits.

    python3 -m pytest gpubench/tests/test_gpubench_control_search.py -q -m card -s

Each run prints one line: control tf32 <cell> <seed> <readings as JSON>.
"""

import json

import pytest

from gpubench import run, spec
from gpubench.tests.test_gpubench_control import switch_on

CELL = "hard3_occluded.serve_mcts"
SEEDS = (2**31 + 911, 2**31 + 912, 2**31 + 913)
SECONDS = 51.0


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_the_tf32_control_of_the_search_is_not_correct(seed, card, monkeypatch, capsys):
    switch_on("tf32", monkeypatch)
    diag = {}
    out = run.run_cell(spec.cell(CELL), seed, SECONDS, False, diag=diag)
    with capsys.disabled():
        print("control tf32", CELL, seed, json.dumps(diag["readings"]), flush=True)
    assert not out["correct"], out["checks"]
