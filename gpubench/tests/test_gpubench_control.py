"""The controls, on the card at each cell's own size, in a window that
compares as many answers as a run does (the serve cells judge every answer
of the window; the sweep a sample of 64), at the cell's own load:

- tf32: the program with TF32 switched on in its matrix products, the
  nearest precision below the float32 with TF32 off that the configuration
  states (the program sets it in physimglobalpose_tpu_torch/_torchcfg.py);
  it reaches the ICP polish and the normals;
- lcp_default: the program's own lowered LCP tier (ops/lcp.lcp_scores with
  matmul_precision="default": both operands of each product rounded to
  bf16) on every LCP scoring call, the hand-written lcp_segside kernel's
  tier 1.

The tf32 control has to come out not correct on every seed. The lowered
LCP tier cannot be told apart: the ICP polish re-converges from whichever
near hypothesis the rounded scores pick, so its answers read as sound ones
(PERF.md gives both controls' readings); its test records that, so that a
program change that lets the tier move the answers shows.

    python3 -m pytest gpubench/tests/test_gpubench_control.py -q -m card -s

Each run prints one line: control <control> <cell> <seed> <readings as JSON>.
"""

import json

import pytest

from gpubench import run, spec

SEEDS = (2**31 + 901, 2**31 + 902, 2**31 + 903)
SECONDS = {"apc3_gt.serve_lcp": 51.0, "hard3_occluded.serve_lcp": 51.0, "apc3_gt.sweep_lcp": 20.0}


def switch_on(control: str, monkeypatch) -> None:
    """Put the control in the program's place for the rest of the test."""
    import torch

    from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (TF32 off, as configured)
    from physimglobalpose_tpu_torch.ops import lcp

    if control == "tf32":
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    elif control == "lcp_default":
        orig = lcp.lcp_scores

        def lcp_scores(*args, **kwargs):
            kwargs["matmul_precision"] = "default"
            return orig(*args, **kwargs)

        monkeypatch.setattr(lcp, "lcp_scores", lcp_scores)
    else:
        raise ValueError(control)


def _runs(name, control, capsys) -> list:
    cell = spec.cell(name)
    outs = []
    for seed in SEEDS:
        diag = {}
        outs.append(run.run_cell(cell, seed, SECONDS[name], False, diag=diag))
        with capsys.disabled():
            print("control", control, name, seed, json.dumps(diag["readings"]), flush=True)
    return outs


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SECONDS))
def test_the_tf32_control_is_not_correct(name, card, monkeypatch, capsys):
    switch_on("tf32", monkeypatch)
    assert not any(o["correct"] for o in _runs(name, "tf32", capsys))


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SECONDS))
def test_the_lowered_lcp_tier_answers_as_the_program_does(name, card, monkeypatch, capsys):
    switch_on("lcp_default", monkeypatch)
    assert all(o["correct"] for o in _runs(name, "lcp_default", capsys))
