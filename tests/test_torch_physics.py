"""The port's PBD settle (physimglobalpose_tpu_torch/ops/physics.py) on the
cases of tests/test_physics.py, and against the JAX settle on the same
scenes: settled positions within 1e-4 m, rotations within 1e-3 rad."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import n, t, tb
from physimglobalpose_tpu.ops import physics as jphysics
from physimglobalpose_tpu_torch.geometry import se3
from physimglobalpose_tpu_torch.ops import physics

TOL_POS = 1e-4  # m
TOL_ROT = 1e-3  # rad


def box_hull(size=(0.06, 0.06, 0.06)):
    sx, sy, sz = np.asarray(size) / 2
    pts = np.array(
        [[x, y, z] for x in (-sx, sx) for y in (-sy, sy) for z in (-sz, sz)], np.float32,
    )
    eqs = np.array(
        [[1, 0, 0, -sx], [-1, 0, 0, -sx], [0, 1, 0, -sy], [0, -1, 0, -sy],
         [0, 0, 1, -sz], [0, 0, -1, -sz]], np.float32,
    )
    return pts, eqs


def scene_arrays(k=1, table_z=0.5, mass=(10.0,), sizes=None, table_pose=None):
    """The numpy fields of tests/test_physics.py's make_scene (the inverse
    inertia by the box formula on the host)."""
    p = 16
    hull_pts = np.zeros((k, p, 3), np.float32)
    hull_mask = np.zeros((k, p), bool)
    hull_eqs = np.tile(np.array([0, 0, 1, -1e9], np.float32), (k, 96, 1))
    inv_mass = np.zeros(k, np.float32)
    inv_inertia = np.zeros((k, 3), np.float32)
    for i in range(k):
        size = sizes[i] if sizes else (0.06, 0.06, 0.06)
        pts, eqs = box_hull(size)
        hull_pts[i, :8] = pts
        hull_mask[i, :8] = True
        hull_eqs[i, :6] = eqs
        if mass[i] > 0:
            inv_mass[i] = 1.0 / mass[i]
            inv_inertia[i] = n(physics.box_inv_inertia(t(pts), tb(np.ones(8)), mass[i]))
    if table_pose is None:
        table_pose = np.eye(4, dtype=np.float32)
        table_pose[2, 3] = table_z - 0.2  # top face at z = table_z
    return dict(hull_pts=hull_pts, hull_mask=hull_mask, hull_eqs=hull_eqs, inv_mass=inv_mass,
                inv_inertia=inv_inertia, table_pose=table_pose,
                table_half_extents=np.array([0.4, 0.4, 0.2], np.float32))


def torch_scene(a, body_active=None):
    return physics.PhysicsScene(
        **{k: (tb(v) if v.dtype == bool else t(v)) for k, v in a.items()},
        body_active=None if body_active is None else tb(body_active),
    )


def jax_scene(a, body_active=None):
    return jphysics.PhysicsScene(
        **{k: jnp.asarray(v) for k, v in a.items()},
        body_active=None if body_active is None else jnp.asarray(body_active),
    )


def make_scene(**kw):
    return torch_scene(scene_arrays(**kw))


def rot_err(q_a, q_b):
    """Largest rotation angle between matching quaternions (rad)."""
    r = np.einsum("...ji,...jk->...ik", n(se3.quat_to_matrix(t(q_a))), n(se3.quat_to_matrix(t(q_b))))
    cos = np.clip((np.trace(r, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.max(np.arccos(cos)))


# ----------------------------------------------- tests/test_physics.py's cases


def test_box_falls_to_table():
    q2, p2 = physics.settle(make_scene(), t([[1.0, 0, 0, 0]]), t([[0.0, 0.0, 0.60]]), steps=120)
    p2 = n(p2)[0]
    assert abs(p2[0]) < 0.02 and abs(p2[1]) < 0.02
    np.testing.assert_allclose(p2[2], 0.53, atol=0.01)


def test_resting_box_stays():
    q2, p2 = physics.settle(make_scene(), t([[1.0, 0, 0, 0]]), t([[0.05, -0.03, 0.53]]), steps=60)
    np.testing.assert_allclose(n(p2)[0], [0.05, -0.03, 0.53], atol=0.008)
    assert n(se3.quat_to_matrix(q2[0]))[2, 2] > 0.99


def test_static_body_never_moves():
    scene = make_scene(k=1, mass=(0.0,))
    _, p2 = physics.settle(scene, t([[1.0, 0, 0, 0]]), t([[0.0, 0.0, 0.8]]), steps=60)
    np.testing.assert_allclose(n(p2)[0], [0.0, 0.0, 0.8], atol=1e-6)


def test_box_stacks_on_static_box():
    scene = make_scene(k=2, mass=(0.0, 10.0), sizes=((0.06,) * 3, (0.04,) * 3))
    quat = t([[1.0, 0, 0, 0], [1.0, 0, 0, 0]])
    _, p2 = physics.settle(scene, quat, t([[0.0, 0.0, 0.53], [0.005, 0.003, 0.60]]), steps=120)
    np.testing.assert_allclose(n(p2)[1][2], 0.58, atol=0.015)


def test_settle_batch_shapes():
    quat = t(np.tile([[1.0, 0, 0, 0]], (4, 1, 1)))
    pos = t(np.tile([[0.0, 0.0, 0.6]], (4, 1, 1)))
    q2, p2 = physics.settle_batch(make_scene(), quat, pos, steps=30)
    assert q2.shape == (4, 1, 4) and p2.shape == (4, 1, 3)


def test_inactive_body_is_not_a_collider():
    scene = make_scene(k=2, mass=(0.0, 10.0), sizes=((0.08,) * 3, (0.04,) * 3))
    active = tb([False, True])
    scene = scene._replace(body_active=active, hull_mask=scene.hull_mask & active[:, None])
    quat = t([[1.0, 0, 0, 0], [1.0, 0, 0, 0]])
    _, p2 = physics.settle(scene, quat, t([[0.0, 0.0, 0.54], [0.003, -0.002, 0.70]]), steps=150)
    np.testing.assert_allclose(n(p2)[1][2], 0.52, atol=0.015)


def _tilted_table(tilt):
    table_pose = np.eye(4, dtype=np.float32)
    table_pose[:3, :3] = np.array(
        [[math.cos(tilt), 0, math.sin(tilt)], [0, 1, 0], [-math.sin(tilt), 0, math.cos(tilt)]],
        np.float32,
    )
    table_pose[2, 3] = 0.3
    return table_pose


def test_friction_config_controls_sliding():
    tilt = math.radians(10.0)
    scene = make_scene(table_pose=_tilted_table(tilt))
    quat = t([[math.cos(tilt / 2), 0.0, math.sin(tilt / 2), 0.0]])
    pos = t([[0.0, 0.0, 0.56]])
    _, p_fric = physics.settle(scene, quat, pos, steps=90, friction=1.0)
    _, p_slip = physics.settle(scene, quat, pos, steps=90, friction=0.0)
    slide_fric, slide_slip = abs(float(p_fric[0, 0])), abs(float(p_slip[0, 0]))
    assert slide_slip > slide_fric + 0.005, (slide_slip, slide_fric)


def test_restitution_reflects_normal_velocity():
    for e in (0.0, 0.5):
        _, _, lv, _ = physics._apply_contact(
            t([0.0, 0, 0]), t([1.0, 0, 0, 0]), t([0.0, 0.0, -1.0]), t([0.0, 0, 0]), 0.1,
            t([1.0, 1, 1]), t([0.0, 0, 0]), t([0.0, 0.0, 1.0]), 0.001, True,
            friction=0.0, restitution=e,
        )
        np.testing.assert_allclose(float(lv[2]), e, atol=1e-5)


def test_off_table_box_falls():
    _, p2 = physics.settle(make_scene(), t([[1.0, 0, 0, 0]]), t([[0.9, 0.0, 0.6]]), steps=60)
    assert float(p2[0, 2]) < 0.45


def _three_body_state():
    arrays = scene_arrays(
        k=3, mass=(0.0, 10.0, 0.0),
        sizes=[(0.06, 0.06, 0.06), (0.05, 0.05, 0.08), (0.08, 0.04, 0.05)],
    )
    rng = np.random.default_rng(7)
    q_raw = rng.normal(size=(3, 4)).astype(np.float32)
    quat = q_raw / np.linalg.norm(q_raw, axis=1, keepdims=True)
    pos = np.array([[0.0, 0.0, 0.53], [0.012, 0.01, 0.60], [0.3, 0.2, 0.525]], np.float32)
    return arrays, quat, pos


def test_single_dynamic_matches_general_settle():
    arrays, quat, pos = _three_body_state()
    for active in (None, [False, True, True]):
        scene = torch_scene(arrays, active)
        q_gen, p_gen = physics.settle(scene, t(quat), t(pos), steps=60)
        q_one, p_one = physics.settle_single_dynamic(
            scene, t(quat), t(pos), torch.tensor(1), steps=60)
        np.testing.assert_allclose(n(p_one), n(p_gen), atol=1e-5)
        np.testing.assert_allclose(n(q_one), n(q_gen), atol=1e-5)
    q_one, p_one = physics.settle_single_dynamic(
        torch_scene(arrays), t(quat), t(pos), torch.tensor(-1), steps=60)
    np.testing.assert_array_equal(n(p_one), pos)
    np.testing.assert_array_equal(n(q_one), quat)


# ------------------------------------------------------- against the JAX settle


@pytest.mark.parametrize("active", [None, (False, True, True)])
def test_settle_matches_jax(active):
    arrays, quat, pos = _three_body_state()
    # Body 2 dynamic as well: two moving bodies exercise the Gauss-Seidel order.
    arrays = dict(arrays, inv_mass=np.array([0.0, 0.1, 0.1], np.float32),
                  inv_inertia=np.tile(arrays["inv_inertia"][1], (3, 1)))
    q_j, p_j = jphysics.settle(jax_scene(arrays, active), jnp.asarray(quat), jnp.asarray(pos),
                               steps=60)
    q_t, p_t = physics.settle(torch_scene(arrays, active), t(quat), t(pos), steps=60)
    assert np.abs(n(p_t) - np.asarray(p_j)).max() < TOL_POS
    assert rot_err(n(q_t), np.asarray(q_j)) < TOL_ROT


def test_settle_single_dynamic_matches_jax_rows():
    # One call of the port over four rows, each with its own dynamic body,
    # placement and active set, against one JAX call per row.
    arrays, quat, pos = _three_body_state()
    arrays = dict(arrays, inv_mass=np.full(3, 0.1, np.float32),
                  inv_inertia=np.tile(arrays["inv_inertia"][1], (3, 1)))
    rows = [(1, (True, True, True)), (0, (True, False, True)), (2, (False, True, True)),
            (-1, (True, True, True))]
    rng = np.random.default_rng(3)
    pos_rows = pos[None] + rng.normal(0, 0.01, (len(rows), 3, 3)).astype(np.float32)
    inv_mass, masks, actives, dyns = [], [], [], []
    want_q, want_p = [], []
    for (dyn, active), pos_r in zip(rows, pos_rows):
        act = np.asarray(active)
        im = np.where(np.arange(3) == dyn, 0.1, 0.0).astype(np.float32)
        hm = arrays["hull_mask"] & act[:, None]
        jscene = jax_scene(dict(arrays, inv_mass=im, hull_mask=hm), act)
        q_j, p_j = jphysics.settle_single_dynamic(
            jscene, jnp.asarray(quat), jnp.asarray(pos_r), jnp.asarray(dyn), steps=30)
        want_q.append(np.asarray(q_j))
        want_p.append(np.asarray(p_j))
        inv_mass.append(im), masks.append(hm), actives.append(act), dyns.append(dyn)
    scene = torch_scene(arrays)._replace(
        inv_mass=t(np.stack(inv_mass)), hull_mask=tb(np.stack(masks)),
        body_active=tb(np.stack(actives)),
    )
    q_t, p_t = physics.settle_single_dynamic(
        scene, t(np.tile(quat, (len(rows), 1, 1))), t(pos_rows), torch.tensor(dyns), steps=30)
    assert np.abs(n(p_t) - np.stack(want_p)).max() < TOL_POS
    assert rot_err(n(q_t), np.stack(want_q)) < TOL_ROT
    np.testing.assert_array_equal(n(p_t)[3], pos_rows[3])  # no dynamic body: a no-op


def test_box_inv_inertia_matches_jax():
    pts, _ = box_hull((0.05, 0.07, 0.11))
    mask = np.ones(8, bool)
    mask[3] = False
    want = np.asarray(jphysics.box_inv_inertia(jnp.asarray(pts), jnp.asarray(mask), 10.0))
    np.testing.assert_allclose(n(physics.box_inv_inertia(t(pts), tb(mask), 10.0)), want, rtol=1e-6)
