"""The controls of the shared search cell hard3_occluded.sweep_mcts, on the
card, over a run's window at the cell's load, every answer judged as a run
judges it. Each has to come out not correct; PERF.md gives the readings
beside the sound ones and the limits.

- tf32: the program with TF32 switched on in its matrix products (the
  nearest precision below the float32 with TF32 off that the configuration
  states), on 3 seeds;
- camera_frame_table: the sweep's searches handed remove_table's
  camera-frame table pose, as the JAX sweep hands it, in place of the
  world-frame box that estimate_pose gives its search (put in from this
  test: scene_sweep._search_tables replaced for the run).

    python3 -m pytest gpubench/tests/test_gpubench_control_sweep_search.py -q -m card -s

Each run prints one line: control <control> <cell> <seed> <readings as JSON>.
"""

import json

import pytest

from gpubench import run, spec
from gpubench.tests.test_gpubench_control import switch_on

CELL = "hard3_occluded.sweep_mcts"
SEEDS = (2**31 + 2711, 2**31 + 2712, 2**31 + 2713)
FAULT_SEED = 2**31 + 2714
SECONDS = 51.0


def _judged(control, seed, capsys):
    diag = {}
    out = run.run_cell(spec.cell(CELL), seed, SECONDS, False, diag=diag)
    with capsys.disabled():
        print("control", control, CELL, seed, json.dumps(diag["readings"]), flush=True)
    return out


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_the_tf32_control_of_the_shared_search_is_not_correct(seed, card, monkeypatch, capsys):
    switch_on("tf32", monkeypatch)
    out = _judged("tf32", seed, capsys)
    assert not out["correct"], out["checks"]


@pytest.mark.card
def test_the_camera_frame_table_is_not_correct(card, monkeypatch, capsys):
    from physimglobalpose_tpu_torch.parallel import scene_sweep

    monkeypatch.setattr(scene_sweep, "_search_tables",
                        lambda prepared, cfg: [pj.table_pose.cpu().numpy() for pj in prepared])
    out = _judged("camera_frame_table", FAULT_SEED, capsys)
    assert not out["correct"], out["checks"]
