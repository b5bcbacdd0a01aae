"""The search's in-order leaf settle, ops/physics.settle_in_order: on the CPU
its plain version (settle_in_order_plain) against the settle loop that
pipeline/mcts._settle_render_cost ran before the op existed, bit for bit;
its route; the kernel wrapper's checks; its counters on the current span,
one launch a leaf batch and one for the final pass. Tests marked `card` hold
the kernel (csrc/settle_leaves.cu) to the plain version on the card and skip
without one:

    python -m pytest tests/test_torch_settle_in_order.py -q -m card --noconftest

(--noconftest: the suite's conftest sets JAX up, which the card's machine
need not have; this file imports no JAX.)
"""

import types

import numpy as np
import pytest
import torch

from physimglobalpose_tpu_torch import config, kernel_inputs
from physimglobalpose_tpu_torch.geometry import se3
from physimglobalpose_tpu_torch.ops import physics
from physimglobalpose_tpu_torch.pipeline import mcts
from physimglobalpose_tpu_torch.pipeline.api import ObjectPoseEstimate
from physimglobalpose_tpu_torch.utils import tracing

CPU = torch.device("cpu")
# The cell's physics (gpubench/configs/hard3_occluded_mcts.json): 30 steps of
# 2 substeps, the configuration's defaults otherwise.
PH = config.PhysicsConfig(steps=30, substeps=2)
KW = dict(object_mass=PH.object_mass, steps=PH.steps, substeps=PH.substeps, dt=PH.dt,
          gravity=PH.gravity, damping=PH.damping, friction=PH.friction,
          restitution=PH.restitution)
# The kernel against the plain version on the card, dynamic bodies. Both are
# float32, but the contact products and sums run in other orders (the plain
# version's through cuBLAS and PyTorch's reductions), and a contact settle
# amplifies a last-bit difference over its 60 dependent substeps where a box
# rocks on an edge or a vertex sits near the edge of a collider's face (it is
# pushed out through one face or the other). So a row is held to the leaf
# comparison's tolerance (gpubench/search_reference.py TOL: positions 1e-5 m,
# rotation matrix entries 5e-5), and at least CARD_ROW_SHARE of the rows must
# lie within it: the share of leaves that comparison holds to it.
TOL_POS_M = 1e-5
TOL_ROT = 5e-5
CARD_ROW_SHARE = 0.98


def _evaluator_loop(consts, quat, pos, active, sequential, ph=PH):
    """The settle of mcts._settle_render_cost as it was before
    settle_in_order: one settle_single_dynamic a placement position."""
    order_pos = torch.cumsum(active.to(torch.int64), dim=1) - 1

    def scene_for(inv_mass, placed):
        return physics.PhysicsScene(
            hull_pts=consts["hull_pts"],
            hull_mask=consts["hull_mask"] & placed[..., None],
            hull_eqs=consts["hull_eqs"],
            inv_mass=inv_mass,
            inv_inertia=consts["inv_inertia"],
            table_pose=consts["table_pose"],
            table_half_extents=consts["table_half_extents"],
            body_active=placed,
        )

    def run_settle(scene, q, p, is_dyn):
        dyn_idx = torch.where(
            torch.any(is_dyn, dim=1), torch.argmax(is_dyn.to(torch.uint8), dim=1), -1
        )
        return physics.settle_single_dynamic(
            scene, q, p, dyn_idx,
            steps=ph.steps, substeps=ph.substeps, dt=ph.dt,
            gravity=ph.gravity, damping=ph.damping,
            friction=ph.friction, restitution=ph.restitution,
        )

    if sequential:
        for d in range(active.shape[-1]):
            is_dyn = active & (order_pos == d)
            placed = active & (order_pos <= d)
            inv_mass = torch.where(is_dyn, 1.0 / ph.object_mass, 0.0)
            quat, pos = run_settle(scene_for(inv_mass, placed), quat, pos, is_dyn)
    else:
        last_idx = torch.amax(torch.where(active, order_pos, -1), dim=1, keepdim=True)
        is_dyn = active & (order_pos == last_idx)
        inv_mass = torch.where(is_dyn, 1.0 / ph.object_mass, 0.0)
        quat, pos = run_settle(scene_for(inv_mass, active), quat, pos, is_dyn)
    return quat, pos


@pytest.mark.parametrize("sequential", [True, False], ids=["sequential", "single"])
@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per_row"])
def test_plain_equals_the_evaluators_earlier_settle_loop(sequential, per_row):
    consts, quat, pos, dyn, placed = kernel_inputs.settle_inputs(
        11, 24, CPU, sequential=sequential, per_row=per_row)
    # The assignment's placed objects are those placed at the last position.
    want = _evaluator_loop(consts, quat, pos, placed[:, -1], sequential)
    for fn in (physics.settle_in_order_plain, physics.settle_in_order):
        got = fn(consts, quat, pos, dyn, placed, **KW)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    moved = (want[1] - pos).norm(dim=-1)
    assert float(moved.max()) > 1e-3  # the settle moved bodies
    assert torch.equal(want[1][dyn[:, 0] < 0], pos[dyn[:, 0] < 0])  # empty rows stay


@pytest.mark.parametrize("sequential", [True, False], ids=["sequential", "single"])
def test_placement_order_is_the_evaluators_earlier_one(sequential):
    # Rows of the tree (the first n objects placed), an empty row, a full row
    # and rows with gaps.
    active = torch.tensor([[True, False, False], [True, True, False], [True, True, True],
                           [False, False, False], [False, True, True], [True, False, True],
                           [False, False, True]])
    dyn, placed = mcts._placement_order(active, sequential)
    order_pos = torch.cumsum(active.to(torch.int64), dim=1) - 1
    if sequential:
        assert dyn.tolist() == [[0, -1, -1], [0, 1, -1], [0, 1, 2], [-1, -1, -1], [1, 2, -1],
                                [0, 2, -1], [2, -1, -1]]
        for d in range(3):
            assert torch.equal(placed[:, d], active & (order_pos <= d))
    else:
        assert dyn.tolist() == [[0], [1], [2], [-1], [2], [2], [2]]
        assert torch.equal(placed[:, 0], active)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    consts, quat, pos, dyn, placed = kernel_inputs.settle_inputs(12, 8, CPU)

    def no_kernel(*a, **kw):
        raise AssertionError("the CPU route launched the kernel")

    monkeypatch.setattr(physics, "settle_leaves", no_kernel)
    before = physics.settle_in_order.launches
    with tracing.span("search.leaf_eval") as sp:
        got = physics.settle_in_order(consts, quat, pos, dyn, placed, **KW)
    want = physics.settle_in_order_plain(consts, quat, pos, dyn, placed, **KW)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert physics.settle_in_order.launches == before and sp.counts is None
    assert not physics._settle_on_kernel(CPU)
    assert physics._settle_on_kernel(torch.device("cuda"))


def _fake_kernel(consts, quat, pos, dyn, placed, **kw):
    return physics.settle_in_order_plain(consts, quat, pos, dyn, placed, **kw)


def test_kernel_calls_count_on_the_current_span(monkeypatch):
    # The kernel path, with the launch replaced by the plain version: the
    # enclosing span counts the launches and the rows.
    consts, quat, pos, dyn, placed = kernel_inputs.settle_inputs(13, 8, CPU)
    monkeypatch.setattr(physics, "_settle_on_kernel", lambda device: True)
    monkeypatch.setattr(physics, "settle_leaves", _fake_kernel)
    before = physics.settle_in_order.launches
    with tracing.span("search.leaf_eval") as sp:
        got = physics.settle_in_order(consts, quat, pos, dyn, placed, **KW)
        physics.settle_in_order(consts, quat[:3], pos[:3], dyn[:3], placed[:3], **KW)
    assert sp.counts == {"settle_launches": 2, "settle_rows": 11}
    assert physics.settle_in_order.launches == before + 2
    want = physics.settle_in_order_plain(consts, quat, pos, dyn, placed, **KW)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _box_object(size, n_render=200, seed=0):
    rng = np.random.default_rng(seed)
    pts, _mask, eqs, _inertia = kernel_inputs.settle_hulls([(size, size, size)], p=8)
    return dict(hull_pts=pts[0], hull_mask=np.ones(8, bool), hull_eqs=eqs[0],
                render_pts=rng.uniform(-size / 2, size / 2, (n_render, 3)).astype(np.float32),
                render_mask=np.ones(n_render, bool))


# A search scene small enough for the CPU: boxes over a table whose top is at
# z = table_top, world == camera, a 40x30 render, three hypotheses an object
# (the second stacks box 1 on box 0).
INTR = np.array([[40.0, 0, 20], [0, 40.0, 15], [0, 0, 1]], np.float32)
SEARCH_CFG = config.PipelineConfig(
    render=config.RenderConfig(width=40, height=30), physics=PH,
    mcts=config.MCTSConfig(leaf_batch=4, branching=3, max_search_seconds=600.0,
                           max_expansions=12, render_scale=1))


def _search_scene(n_obj=2, table_top=0.86, seed=0):
    from physimglobalpose_tpu_torch.ops import raster

    sizes = (0.06, 0.05)[:n_obj]
    objs = [_box_object(sz, seed=seed + i) for i, sz in enumerate(sizes)]
    table = np.eye(4, dtype=np.float32)
    table[2, 3] = table_top - 0.2
    hyps = np.tile(np.eye(4, dtype=np.float32), (n_obj, 3, 1, 1))
    for i, sz in enumerate(sizes):
        z = table_top + sz / 2
        hyps[i, :, :3, 3] = [[0.07 * i, 0.0, z + 0.002], [0.005 * i, 0.0, z + 0.06 * i + 0.004],
                             [0.07 * i, 0.01, z + 0.03]]
    truth = torch.as_tensor(hyps[:, 0])
    obs = raster.render_scene_depth(
        truth, torch.as_tensor(np.stack([o["render_pts"] for o in objs])),
        torch.ones(n_obj, 200, dtype=torch.bool), torch.as_tensor(INTR), 30, 40).numpy()
    return objs, hyps, obs, table


def _evaluator(scene, device):
    objs, hyps, obs, table = scene
    return mcts.BatchedLeafEvaluator(objs, hyps, obs, INTR, np.eye(4, dtype=np.float32), table,
                                     SEARCH_CFG, device=device)


def _leaf_rows(k, c=3):
    """Every placement the tree can ask for: the first n objects placed."""
    rows = [np.array(ch + (-1,) * (k - n)) for n in range(1, k + 1)
            for ch in np.ndindex(*(c,) * n)]
    choices = np.stack(rows)
    return choices, choices >= 0


def _counts_below(span, key):
    return (span.counts or {}).get(key, 0) + sum(_counts_below(c, key) for c in span.children)


@pytest.mark.parametrize("search,with_segs", [("uct", True), ("uct", False), ("greedy", True)])
def test_a_search_launches_once_a_leaf_batch_and_once_for_its_final_pass(
        monkeypatch, search, with_segs):
    # Each leaf batch is one settle launch, on the span that enqueues it
    # (search.leaf_eval in the UCT search), and the final pass one more, on
    # search.final.
    monkeypatch.setattr(physics, "_settle_on_kernel", lambda device: True)
    monkeypatch.setattr(physics, "settle_leaves", _fake_kernel)
    objs, hyps, obs, table = _search_scene()
    db = {f"box{i}": types.SimpleNamespace(
        hull_pts=o["hull_pts"], hull_mask=o["hull_mask"], hull_eqs=o["hull_eqs"],
        validation_pts=o["render_pts"], validation_nrm=np.zeros_like(o["render_pts"]))
        for i, o in enumerate(objs)}
    est = [ObjectPoseEstimate(name=f"box{i}", pose_cam=hyps[i, 0], pose_world=hyps[i, 0],
                              score=0.9, hypotheses=hyps[i],
                              hypothesis_scores=np.array([0.9, 0.5, 0.8], np.float32))
           for i in range(len(objs))]
    sc = types.SimpleNamespace(intrinsics=INTR, cam_pose=np.eye(4, dtype=np.float32),
                               scene_dir="/scenes/two_boxes")
    segs = None
    if with_segs:
        segs = [types.SimpleNamespace(pts=o["render_pts"][:64] + e.pose_world[:3, 3],
                                      mask=np.ones(64, bool)) for o, e in zip(objs, est)]
    with tracing.span("search") as sp:
        mcts.mcts_select(est, sc, db, table, obs, SEARCH_CFG, seed=3, search=search, segs=segs,
                         device="cpu")
    final = sp.find("search.final")
    assert final.counts == {"settle_launches": 1, "settle_rows": 2 if with_segs else 1}
    launches = _counts_below(sp, "settle_launches")
    if search == "uct":
        batches = sp.counts["leaf_batches"]
        assert batches >= 2 and launches == batches + 1
        for leaf_eval in sp.find_all("search.leaf_eval"):
            assert leaf_eval.counts == {"settle_launches": 1, "settle_rows": 4}
    else:
        assert launches >= 2


@pytest.mark.parametrize(
    "fault, match",
    [
        ("cpu", "CUDA tensors"),
        ("float64", "float32"),
        ("dyn_dtype", "int64 dyn"),
        ("mask_dtype", "bool placed and hull_mask"),
        ("quat_shape", r"quat must be \[B, K, 4\]"),
        ("dyn_shape", r"dyn must be \[B, D\]"),
        ("placed_shape", r"placed \[B, D, K\]"),
        ("hull_eqs_shape", "hull_eqs must be"),
        ("table_pose_rows", "table_pose must be"),
        ("half_extents", "table_half_extents"),
        ("too_many_faces", "faces"),
        ("non_contiguous", "contiguous"),
        ("no_substeps", "substeps"),
    ],
)
def test_kernel_wrapper_refuses(fault, match):
    # Every input below is wrong in one way only; the well-formed CPU input
    # is refused for its device.
    consts, quat, pos, dyn, placed = kernel_inputs.settle_inputs(14, 4, CPU)
    kw = dict(KW)
    if fault == "float64":
        pos = pos.double()
    elif fault == "dyn_dtype":
        dyn = dyn.to(torch.int32)
    elif fault == "mask_dtype":
        placed = placed.to(torch.uint8)
    elif fault == "quat_shape":
        quat = quat[..., :3].contiguous()
    elif fault == "dyn_shape":
        dyn = dyn[:, :2].contiguous()
    elif fault == "placed_shape":
        placed = placed[..., :2].contiguous()
    elif fault == "hull_eqs_shape":
        consts["hull_eqs"] = consts["hull_eqs"][:2].contiguous()
    elif fault == "table_pose_rows":
        consts["table_pose"] = consts["table_pose"].expand(3, 4, 4).contiguous()
    elif fault == "half_extents":
        consts["table_half_extents"] = consts["table_half_extents"][None]
    elif fault == "too_many_faces":
        consts["hull_eqs"] = torch.zeros(3, physics.MAX_SETTLE_FACES + 1, 4)
    elif fault == "non_contiguous":
        quat = quat.transpose(0, 1).contiguous().transpose(0, 1)
    elif fault == "no_substeps":
        kw["substeps"] = 0
    with pytest.raises(ValueError, match=match):
        physics.settle_leaves(consts, quat, pos, dyn, placed, **kw)


# ------------------------------------------------------------------ on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _hold_to_plain(consts, quat, pos, dyn, placed):
    """The kernel's (quat, pos) against settle_in_order_plain's on the same
    card tensors, in one launch: statics bit-equal, every dynamic body finite
    and at least CARD_ROW_SHARE of the rows within the tolerance. Returns the
    share of rows within it and the largest deviations."""
    before = physics.settle_in_order.launches
    got = physics.settle_in_order(consts, quat, pos, dyn, placed, **KW)
    assert physics.settle_in_order.launches == before + 1
    want = physics.settle_in_order_plain(consts, quat, pos, dyn, placed, **KW)
    torch.cuda.synchronize()
    moved = torch.zeros(quat.shape[:2], dtype=torch.bool, device=quat.device)
    for d in range(dyn.shape[1]):
        j = dyn[:, d]
        moved |= (torch.arange(quat.shape[1], device=quat.device)[None] == j[:, None])
    assert torch.equal(got[0][~moved], quat[~moved]) and torch.equal(got[1][~moved], pos[~moved])
    assert torch.equal(want[0][~moved], quat[~moved])
    assert bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())
    dp = (got[1] - want[1]).abs().amax(dim=(1, 2))
    # Rotation matrix entries, as the leaf's settled poses carry them.
    dr = (se3.quat_to_matrix(got[0].double())
          - se3.quat_to_matrix(want[0].double())).abs().amax(dim=(1, 2, 3))
    within = (dp <= TOL_POS_M) & (dr <= TOL_ROT)
    share = float(within.double().mean())
    assert share >= CARD_ROW_SHARE, (share, dp.max(), dr.max())
    # The settle moved the dynamic bodies far beyond the tolerance.
    assert float((want[1] - pos).norm(dim=-1).max()) > 100 * TOL_POS_M
    return share, float(dp.max()), float(dr.max())


@pytest.mark.card
@pytest.mark.parametrize(
    "b, sequential, per_row, round_hulls",
    [(128, True, False, False), (128, False, False, False), (128, True, True, False),
     (512, True, True, False), (512, True, False, False), (128, True, False, True)],
    ids=["b128_sequential", "b128_single", "b128_sequential_per_row",
         "b512_sequential_per_row", "b512_sequential", "b128_round_hulls"],
)
def test_card_kernel_matches_plain(card, b, sequential, per_row, round_hulls):
    # The cell's shapes: K 3, P 64 (8 valid), F 96 (12 valid), 60 substeps;
    # round hulls fill P and F (more vertices than a warp has lanes). One
    # row in eight places nothing (every position -1) and the others place
    # random subsets.
    args = kernel_inputs.settle_inputs(40 + b, b, card, sequential=sequential, per_row=per_row,
                                       round_hulls=round_hulls)
    assert bool((args[3] < 0).any()) and bool((args[3] >= 0).any())
    _hold_to_plain(*args)


@pytest.mark.card
def test_card_kernel_rows_do_not_depend_on_padding_or_batch(card):
    # A row settles to the same bits alone, in its batch, and with its
    # constants padded to larger shapes and carried a row (the multi-scene
    # leaf batch pads hulls, faces and objects).
    consts, quat, pos, dyn, placed = kernel_inputs.settle_inputs(51, 32, card)
    got = physics.settle_in_order(consts, quat, pos, dyn, placed, **KW)
    one = physics.settle_in_order(consts, quat[5:6], pos[5:6], dyn[5:6], placed[5:6], **KW)
    k, p, f = consts["hull_pts"].shape[0], 80, 120
    padded = dict(consts)
    padded["hull_pts"] = torch.zeros(32, k + 1, p, 3, device=card)
    padded["hull_pts"][:, :k, :64] = consts["hull_pts"]
    padded["hull_mask"] = torch.zeros(32, k + 1, p, dtype=torch.bool, device=card)
    padded["hull_mask"][:, :k, :64] = consts["hull_mask"]
    far = torch.tensor([0.0, 0.0, 1.0, -1e9], device=card)
    padded["hull_eqs"] = far.expand(32, k + 1, f, 4).clone()
    padded["hull_eqs"][:, :k, :96] = consts["hull_eqs"]
    padded["inv_inertia"] = torch.ones(32, k + 1, 3, device=card)
    padded["inv_inertia"][:, :k] = consts["inv_inertia"]
    padded["table_pose"] = consts["table_pose"].expand(32, 4, 4).contiguous()
    pad_q = torch.cat([quat, torch.tensor([1.0, 0, 0, 0], device=card).expand(32, 1, 4)], 1)
    pad_p = torch.cat([pos, torch.zeros(32, 1, 3, device=card)], 1)
    pad_placed = torch.cat([placed, torch.zeros(32, placed.shape[1], 1, dtype=torch.bool,
                                                device=card)], 2)
    wide = physics.settle_in_order(padded, pad_q, pad_p, dyn, pad_placed, **KW)
    torch.cuda.synchronize()
    assert torch.equal(one[0][0], got[0][5]) and torch.equal(one[1][0], got[1][5])
    assert torch.equal(wide[0][:, :k], got[0]) and torch.equal(wide[1][:, :k], got[1])


@pytest.mark.card
def test_card_kernel_leaves_empty_rows_and_positions_as_they_are(card):
    consts, quat, pos, dyn, placed = kernel_inputs.settle_inputs(52, 64, card)
    dyn[:, 1] = -1  # no dynamic body at the second position of any row
    got = physics.settle_in_order(consts, quat, pos, dyn, placed, **KW)
    empty = (dyn < 0).all(dim=1)
    assert bool(empty.any())
    torch.cuda.synchronize()
    assert torch.equal(got[0][empty], quat[empty]) and torch.equal(got[1][empty], pos[empty])
    _hold_to_plain(consts, quat, pos, dyn, placed)


# The callers of the leaf settle against the same calls on the CPU, as
# chip_smoke.py [leaf] holds a leaf batch: costs within 2 pixels, settled
# positions within 1e-3 m and rotation entries within 1e-3 (the CPU's plain
# version sums in another order again, and the settle amplifies it).
TOL_LEAF_COST = 2.0
TOL_LEAF_POS_M = 1e-3
TOL_LEAF_ROT = 1e-3


def _assert_leaves_close(got, want):
    (c_g, s_g), (c_w, s_w) = got, want
    assert np.abs(c_g - c_w).max() <= TOL_LEAF_COST, (c_g, c_w)
    assert np.abs(s_g[..., :3, 3] - s_w[..., :3, 3]).max() <= TOL_LEAF_POS_M
    assert np.abs(s_g[..., :3, :3] - s_w[..., :3, :3]).max() <= TOL_LEAF_ROT


@pytest.mark.card
@pytest.mark.parametrize("call", ["evaluate", "evaluate_final", "evaluate_final_tricp"])
def test_card_leaf_evaluator_agrees_with_the_cpu(card, call):
    scene = _search_scene()
    ev, ev_cpu = _evaluator(scene, card), _evaluator(scene, CPU)
    objs, hyps = scene[0], scene[1]
    if call == "evaluate":
        args = _leaf_rows(len(objs))
    elif call == "evaluate_final":
        args = (np.array([[1, 1]]), np.ones((1, 2), bool))
    else:
        seg = np.stack([o["render_pts"][:64] + hyps[i, 1, :3, 3] for i, o in enumerate(objs)])
        args = (np.array([1, 1]), np.ones(2, bool), seg, np.ones((2, 64), bool))
    before = physics.settle_in_order.launches
    got = getattr(ev, call)(*args)
    assert physics.settle_in_order.launches == before + 1
    _assert_leaves_close(got, getattr(ev_cpu, call)(*args))


@pytest.mark.card
def test_card_greedy_search_agrees_with_the_cpu(card):
    from physimglobalpose_tpu_torch.pipeline import greedy_search

    scene = _search_scene()
    scores = np.array([[0.9, 0.5, 0.8], [0.7, 0.9, 0.6]], np.float32)
    before = physics.settle_in_order.launches
    got = greedy_search.greedy_bfs_search(_evaluator(scene, card), scores, SEARCH_CFG)
    launches = physics.settle_in_order.launches - before
    want = greedy_search.greedy_bfs_search(_evaluator(scene, CPU), scores, SEARCH_CFG)
    assert launches >= 2
    np.testing.assert_array_equal(got[0], want[0])
    assert abs(got[1] - want[1]) <= TOL_LEAF_COST


@pytest.mark.card
def test_card_multi_scene_batch_equals_each_scenes_own(card):
    # The sweep's multi-scene search: one batch of two scenes' rows, their
    # constants padded to common shapes and gathered a row, settles in one
    # launch to the bits of each scene's own evaluator.
    scenes = [_search_scene(), _search_scene(n_obj=1, table_top=0.84, seed=5)]
    evs = [_evaluator(sc, card) for sc in scenes]
    multi = mcts.MultiSceneLeafEvaluator(evs)
    rows = [_leaf_rows(ev.k) for ev in evs]
    scene_idx = np.concatenate([np.full(len(ch), s) for s, (ch, _) in enumerate(rows)])
    pad = lambda a, fill: np.pad(a, ((0, 0), (0, multi.k_max - a.shape[1])),  # noqa: E731
                                 constant_values=fill)
    choices = np.concatenate([pad(ch, -1) for ch, _ in rows])
    active = np.concatenate([pad(ac, False) for _, ac in rows])
    before = physics.settle_in_order.launches
    costs, settled = multi.evaluate(scene_idx, choices, active)
    assert physics.settle_in_order.launches == before + 1
    at = 0
    for ev, (ch, ac) in zip(evs, rows):
        c_own, s_own = ev.evaluate(ch, ac)
        n = len(ch)
        np.testing.assert_array_equal(costs[at:at + n], c_own)
        np.testing.assert_array_equal(settled[at:at + n, :ev.k], s_own)
        at += n
