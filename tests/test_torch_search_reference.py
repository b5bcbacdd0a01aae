"""The port's leaf evaluator (pipeline/mcts.BatchedLeafEvaluator: settle,
render, pixel cost) against the benchmark's plain reference of the search's
leaf objective (gpubench/search_reference.py), on the CPU, on a scene of
three boxes on a table seen by a 160x120 camera, world == camera, as
tests/test_torch_mcts.py's decoy scene. Seeded random hypotheses near the
boxes' rest poses, and two placed on a neighbour, stand in for weights.

The tolerances are the reference's own (TOL in gpubench/search_reference.py,
each with its reason), and so is the rule for a leaf whose settle amplifies
rounding past them: there the program is held to the reference's own spread
under nudged inputs.
"""

import ast
import dataclasses

import numpy as np
import pytest
import torch

from gpubench import search_reference as sr
from physimglobalpose_tpu_torch import config as tconfig
from physimglobalpose_tpu_torch.pipeline import mcts

H, W = 120, 160
K_INTR = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], dtype=np.float32)
TABLE_TOP = 0.86
SIZES = [(0.06, 0.05, 0.04), (0.05, 0.04, 0.07), (0.07, 0.03, 0.03)]
REST_X = (-0.05, 0.01, 0.065)
HYPS = 5  # per object



def box_object(size, n_render, seed):
    """A box's hull (8 vertices, 6 faces padded to 12 rows as the object
    database pads them) and n_render points on its faces."""
    rng = np.random.default_rng(seed)
    half = np.asarray(size, np.float32) / 2
    eqs = np.tile(np.array([0, 0, 1, -1e9], np.float32), (12, 1))
    for axis in range(3):
        for j, sign in enumerate((1, -1)):
            eqs[2 * axis + j, axis] = sign
            eqs[2 * axis + j, 3] = -half[axis]
    face = rng.integers(0, 6, n_render)
    pts = rng.uniform(-half, half, (n_render, 3)).astype(np.float32)
    pts[np.arange(n_render), face // 2] = np.where(face % 2 == 0, 1, -1) * half[face // 2]
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)], np.float32)
    return dict(hull_pts=corners * half, hull_mask=np.ones(8, bool), hull_eqs=eqs,
                render_pts=pts, render_mask=np.ones(n_render, bool))


def rotation(rng, max_deg):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    t = np.radians(rng.uniform(-max_deg, max_deg))
    kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(t) * kx + (1 - np.cos(t)) * kx @ kx


@pytest.fixture(scope="module")
def boxes():
    return make_boxes()


def make_boxes():
    objs = [box_object(s, 400, seed=i) for i, s in enumerate(SIZES)]
    truth = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    for i, (s, x) in enumerate(zip(SIZES, REST_X)):
        truth[i, :3, 3] = [x, 0.0, TABLE_TOP + s[2] / 2]
    rng = np.random.default_rng(20221)
    hyp = np.tile(truth[:, None], (1, HYPS, 1, 1))
    for i in range(3):
        for c in range(HYPS):
            hyp[i, c, :3, :3] = rotation(rng, 20.0)
            hyp[i, c, :3, 3] += [rng.uniform(-0.02, 0.02), rng.uniform(-0.02, 0.02),
                                 rng.uniform(0.0, 0.015)]
    # Slot 0: object 0 at rest; objects 1 and 2 over the neighbour placed
    # before it, a little tilted, so that each comes to rest on that box's
    # top face.
    hyp[0, 0] = truth[0]
    for i, shift in ((1, 0.0), (2, 0.01)):
        below = truth[i - 1, :3, 3]
        hyp[i, 0, :3, :3] = rotation(rng, 3.0)
        hyp[i, 0, :3, 3] = [below[0] + shift, 0.0,
                            below[2] + SIZES[i - 1][2] / 2 + SIZES[i][2] / 2 + 0.006]
    table = np.eye(4, dtype=np.float32)
    table[2, 3] = TABLE_TOP - 0.2  # the table box's half height
    cam = np.eye(4, dtype=np.float32)
    cfg = config(1, True)
    blank = sr.scene(objs, hyp, np.zeros((H, W), np.float32), K_INTR, cam, table, cfg)
    obs = sr.render(blank, torch.as_tensor(truth), [True] * 3).numpy()
    return dict(objs=objs, hyp=hyp, truth=truth, table=table, cam=cam, obs=obs)


def config(scale, sequential):
    return tconfig.PipelineConfig(
        render=tconfig.RenderConfig(width=W, height=H),
        mcts=tconfig.MCTSConfig(render_scale=scale, sequential_settle=sequential),
    )


def both(s, cfg):
    args = (s["objs"], s["hyp"], s["obs"], K_INTR, s["cam"], s["table"], cfg)
    return mcts.BatchedLeafEvaluator(*args, device="cpu"), sr.scene(*args)


def assert_rows_match(s, cfg, choices, active):
    """Every row agrees with the reference; the program's (costs, settled)
    back."""
    ev, ref = both(s, cfg)
    costs, settled = ev.evaluate(choices, active)
    got = sr.compare([(ref, choices[b], active[b], (costs[b], settled[b]))
                      for b in range(len(choices))], share=0.0)
    assert got["ok"], got
    return costs, settled


def random_rows(seed, n):
    return np.random.default_rng(seed).integers(0, HYPS, (n, 3))


@pytest.mark.parametrize("scale,sequential", [(1, True), (2, True), (1, False)])
def test_full_rows_match_the_reference(boxes, scale, sequential):
    choices = np.concatenate([[[1, 0, 0], [2, 3, 0]], random_rows(5, 4)])
    assert_rows_match(boxes, config(scale, sequential), choices, np.ones_like(choices, bool))


@pytest.mark.parametrize("sequential", [True, False])
def test_partial_rows_match_the_reference(boxes, sequential):
    active = np.array([[1, 0, 0], [1, 1, 0], [0, 1, 1], [1, 0, 1], [0, 0, 1]], bool)
    choices = np.where(active, random_rows(6, len(active)), -1)
    choices[1, 1] = 0  # object 1 over object 0
    assert_rows_match(boxes, config(1, sequential), choices, active)


def test_a_row_with_nothing_placed_costs_the_whole_observation(boxes):
    active = np.zeros((1, 3), bool)
    costs, settled = assert_rows_match(boxes, config(1, True), np.full((1, 3), -1), active)
    assert costs[0] == (boxes["obs"] > 0).sum()
    np.testing.assert_allclose(settled[0], boxes["hyp"][:, 0], atol=1e-6)


def test_an_unplaced_object_is_absent_from_the_world_and_the_render(boxes):
    s = boxes
    cfg = config(1, True)
    _, ref = both(s, cfg)
    # Object 1 comes to rest on object 0 (slot 0 of both). With object 0
    # unplaced it falls to the table instead, and only object 1 shows in
    # the render.
    active = np.array([[True, True, False], [False, True, False]])
    choices = np.array([[0, 0, -1], [-1, 0, -1]])
    assert_rows_match(s, cfg, choices, active)
    on_box = sr.leaf(ref, choices[0], active[0])[1][1, 2, 3]
    on_table = sr.leaf(ref, choices[1], active[1])[1][1, 2, 3]
    assert float(on_table) == pytest.approx(TABLE_TOP + SIZES[1][2] / 2, abs=4e-3)
    # Held up by object 0, though not at its top face: a vertex that sinks
    # deeper than its distance to a side face is pushed out sideways (the
    # model's vertex-face contact), and object 1's corners lie 5 mm inside
    # object 0's sides.
    assert float(on_box) > float(on_table) + 0.01
    alone = sr.render(ref, sr.settle(ref, choices[1], active[1]), active[1])
    one = sr.render(ref, sr.settle(ref, choices[1], active[1]), [False, True, False])
    assert torch.equal(alone, one) and int((alone > 0).sum()) > 0


def test_the_sequential_settle_puts_later_objects_on_earlier_ones(boxes):
    """Sequential: object 1 settles on object 0 at rest. Single-dynamic:
    only the last placed object moves; the others keep their hypotheses'
    poses, so object 0 stays in the air where its hypothesis put it."""
    s = boxes
    choices, active = np.array([1, 0, 1]), np.ones(3, bool)
    seq = sr.settle(both(s, config(1, True))[1], choices, active)
    one = sr.settle(both(s, config(1, False))[1], choices, active)
    lift = s["hyp"][0, 1, 2, 3] - s["truth"][0, 2, 3]
    assert lift > 1e-3
    assert float(seq[0, 2, 3]) == pytest.approx(s["truth"][0, 2, 3], abs=3e-3)
    assert float(one[0, 2, 3]) == pytest.approx(s["hyp"][0, 1, 2, 3], abs=1e-5)
    assert float(seq[1, 2, 3]) > TABLE_TOP + SIZES[0][2]


def test_the_truth_explains_its_own_observation(boxes):
    s = boxes
    _, ref = both(s, config(1, True))
    assert sr.cost(ref, sr.render(ref, torch.as_tensor(s["truth"]), [True] * 3)) == 0.0


def test_a_leaf_is_held_to_the_references_own_spread(boxes):
    """The reference's answer agrees as it is; its answer to nudged inputs
    agrees at worst within its spread; an answer moved by 1 mm does not."""
    s = boxes
    _, ref = both(s, config(1, True))
    choices, active = np.array([3, 1, 4]), np.ones(3, bool)
    base = sr.leaf(ref, choices, active)
    assert sr.agree(ref, choices, active, (base[0], base[1].numpy()))[1] == "as_is"
    cost, settled = sr.leaf(sr.nudged(ref, 3), choices, active)
    assert sr.agree(ref, choices, active, (cost, settled.numpy()))[1] in ("as_is", "spread")
    moved = base[1].numpy().copy()
    moved[:, :3, 3] += 1e-3
    d, how = sr.agree(ref, choices, active, (base[0], moved))
    assert how is None and d["pos_m"] == pytest.approx(1e-3, rel=1e-3)
    assert sr.agree(ref, choices, active, (base[0], moved), nudges=0)[1] is None


def test_compare_fails_once_more_than_the_share_disagree(boxes):
    s = boxes
    _, ref = both(s, config(1, True))
    rows = [np.array(r) for r in ([1, 0, 0], [2, 3, 0], [0, 1, 1])]
    active = np.ones(3, bool)
    good = [(ref, r, active, tuple(x if i == 0 else x.numpy()
                                   for i, x in enumerate(sr.leaf(ref, r, active)))) for r in rows]
    bad = [(sc, r, a, (c + 5.0, st)) for sc, r, a, (c, st) in good]
    assert sr.compare(good, share=0.0)["ok"]
    got = sr.compare(good[:2] + bad[2:], share=0.0)
    assert not got["ok"] and got["disagree"] == 1 and got["max"]["cost_px"] == 5.0
    assert got["max_as_is"]["cost_px"] == 0.0 and got["as_is"] == 2 and got["spread"] == 0
    assert sr.compare(good[:1] + bad[2:], share=0.5)["ok"]  # 1 of 2 may disagree


def test_strict_fp32_turns_tf32_off_inside_and_restores_it(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with sr.strict_fp32():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_the_reference_imports_neither_jax_nor_the_program():
    tree = ast.parse(open(sr.__file__).read())
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names <= {"__future__", "contextlib", "dataclasses", "numpy", "torch"}, names


def test_the_reference_reads_the_programs_config_by_field_name(boxes):
    s = boxes
    cfg = config(2, False)
    cfg = dataclasses.replace(cfg, physics=dataclasses.replace(cfg.physics, steps=7))
    ref = both(s, cfg)[1]
    assert ref.physics["steps"] == 7 and not ref.sequential
    assert ref.obs.shape == (H // 2, W // 2) and ref.splat_radius == 0


def other_scene(s, seed, keep, shift_x):
    """Another scene of the same boxes: the objects `keep`, their rest poses
    moved shift_x along x, hypotheses redrawn from `seed` near them (slot 0
    at rest), and the observation rendered from that truth."""
    rng = np.random.default_rng(seed)
    objs = [s["objs"][i] for i in keep]
    truth = s["truth"][list(keep)].copy()
    truth[:, 0, 3] += shift_x
    hyp = np.tile(truth[:, None], (1, HYPS, 1, 1))
    for i in range(len(keep)):
        for c in range(1, HYPS):
            hyp[i, c, :3, :3] = rotation(rng, 20.0)
            hyp[i, c, :3, 3] += [rng.uniform(-0.02, 0.02), rng.uniform(-0.02, 0.02),
                                 rng.uniform(0.0, 0.015)]
    blank = sr.scene(objs, hyp, np.zeros((H, W), np.float32), K_INTR, s["cam"], s["table"],
                     config(1, True))
    obs = sr.render(blank, torch.as_tensor(truth), [True] * len(keep)).numpy()
    return dict(objs=objs, hyp=hyp, truth=truth, table=s["table"], cam=s["cam"], obs=obs)


def test_shared_batch_rows_match_the_reference_on_their_own_scenes(boxes):
    """A MultiSceneLeafEvaluator batch over three scenes (3, 2 and 3
    objects, so the scenes' constants are padded to a common shape): every
    row agrees with the reference of the scene it names, full and partial
    placements mixed."""
    cfg = config(1, True)
    scenes = [boxes, other_scene(boxes, 7, (1, 2), 0.0), other_scene(boxes, 8, (0, 1, 2), 0.01)]
    built = [both(sc, cfg) for sc in scenes]
    msev = mcts.MultiSceneLeafEvaluator([ev for ev, _ref in built])
    rng = np.random.default_rng(31)
    n = 12
    scene_idx = np.arange(n) % len(scenes)
    choices = np.full((n, msev.k_max), -1, np.int64)
    for b, si in enumerate(scene_idx):
        k = msev.ks[si]
        active = rng.random(k) < 0.8 if b >= len(scenes) else np.ones(k, bool)
        choices[b, :k] = np.where(active, rng.integers(0, HYPS, k), -1)
    active = choices >= 0
    costs, settled = msev.evaluate(scene_idx, choices, active)
    rows = []
    for b, si in enumerate(scene_idx):
        k = msev.ks[si]
        rows.append((built[si][1], choices[b, :k], active[b, :k], (costs[b], settled[b, :k])))
    got = sr.compare(rows, share=0.0)
    assert got["ok"], got
    # The rows did differ from scene to scene: the same placement costs
    # otherwise on another scene's observation.
    assert len({round(float(c), 3) for c in costs[:len(scenes)]}) == len(scenes)
