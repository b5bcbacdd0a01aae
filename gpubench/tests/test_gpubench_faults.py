"""The whole run on the CPU at a tiny size, the card's look skipped, with the
timed path broken underneath: `correct` has to come out false for each fault
a cell can have. (No cell spans chips, so none loses an exchange.)

- altered: each answer's poses moved 20 cm where the entry produces them;
- one_object: only the last object of each answer moved 20 cm;
- unchanged: the entry returns every object at the identity, the state it
  starts from;
- half: the sweep leaves half of its batch out of its answer.

The clean run beside them, under the same limits, is correct. The limits
here are the tiny size's (64 hypotheses an object), not the cells'. At that
size the cut program misses two of the three boxes of most occluded frames
(per-object medians of hundreds of mm), so the occluded cell is held to the
median over all objects alone, and its one_object fault cannot show: the
two cells of clear frames show it.
"""

import dataclasses

import numpy as np
import pytest

from gpubench import run
from gpubench.tests.tiny import tiny_cell, tiny_config

LIMITS = {"unanswered": 0, "adds_p50_mm": 100.0, "adds_obj_p50_max_mm": 100.0}
OCCLUDED_LIMITS = {"unanswered": 0, "adds_p50_mm": 100.0}
SEED = 2**31 + 77
CELLS = {"apc3_gt.serve_lcp": 4.0, "hard3_occluded.serve_lcp": 4.0,
         "apc3_gt.sweep_lcp": 8.0}  # window s: a few answers


def _broken(objects, fault):
    if fault == "one_object":
        return objects[:-1] + [_moved(objects[-1], [0.2, 0.0, 0.0])]
    by = [0.2, 0.0, 0.0] if fault == "altered" else None
    return [_moved(o, by) for o in objects]


def _moved(est, by):
    pose = np.asarray(est.pose_cam, np.float64).copy()
    if by is None:
        pose = np.eye(4)
    else:
        pose[:3, 3] += by
    return dataclasses.replace(est, pose_cam=pose.astype(np.float32))


def _break_serve(monkeypatch, fault):
    from physimglobalpose_tpu_torch.pipeline import api

    orig = api.estimate_pose

    def estimate_pose(*a, **kw):
        res = orig(*a, **kw)
        res.objects[:] = _broken(list(res.objects), fault)
        return res

    monkeypatch.setattr(api, "estimate_pose", estimate_pose)


def _break_sweep(monkeypatch, fault):
    from physimglobalpose_tpu_torch.parallel import scene_sweep

    orig = scene_sweep.sweep_scenes

    def sweep_scenes(mesh, dirs, *a, **kw):
        res = orig(mesh, dirs, *a, **kw)
        if fault == "half":
            return {d: res[d] for d in list(dirs)[: len(dirs) // 2] if d in res}
        for r in res.values():
            r.objects[:] = _broken(list(r.objects), fault)
        return res

    monkeypatch.setattr(scene_sweep, "sweep_scenes", sweep_scenes)


def _run(name):
    cell = tiny_cell(name, **(OCCLUDED_LIMITS if name.startswith("hard3") else LIMITS))
    return run.run_cell(cell, SEED, CELLS[name], False, device="cpu", pipeline=tiny_config())


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_clean_tiny_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name,fault", [
    (n, f) for n in sorted(CELLS)
    for f in ("altered", "unchanged") + (("half",) if "sweep" in n else ())
    + (() if n.startswith("hard3") else ("one_object",))])
def test_a_broken_path_is_not_correct(name, fault, monkeypatch):
    if "sweep" in name:
        _break_sweep(monkeypatch, fault)
    else:
        _break_serve(monkeypatch, fault)
    out = _run(name)
    assert not out["correct"], out["checks"]
