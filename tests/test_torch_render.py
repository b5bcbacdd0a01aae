"""The port's SE(3) remainder, splat renderer and pixel cost
(physimglobalpose_tpu_torch/geometry/se3.py, geometry/pointcloud.project_zmin,
ops/raster.py, ops/cost.py) against tests/test_se3.py's oracles and the JAX
functions on tests/test_render.py's cases.

Depth: equal at >= 99.9 % of pixels and within 1e-6 m where both are set. A
point whose projection lies within a float32 step of a pixel edge can round
to the neighbouring pixel when the products of the two packages differ in
the last bit. Costs: within 2 pixels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from _torch_common import n, t, tb
from physimglobalpose_tpu.geometry import pointcloud as jpointcloud
from physimglobalpose_tpu.ops import cost as jcost, raster as jraster
from physimglobalpose_tpu_torch.geometry import pointcloud, se3
from physimglobalpose_tpu_torch.ops import cost, raster

K = np.array([[300.0, 0, 64], [0, 300.0, 48], [0, 0, 1]], dtype=np.float32)
H, W = 96, 128
TOL_COST = 2.0  # pixels


def assert_depth_close(got, want):
    got, want = n(got), np.asarray(want)
    assert got.shape == want.shape
    same = (got > 0) == (want > 0)
    both = (got > 0) & (want > 0)
    close = same & (~both | (np.abs(got - want) <= 1e-6))
    assert close.mean() >= 0.999, (close.mean(), np.abs(got - want).max())


def grid_points_on_plane(z=0.6, half=0.04, n_side=24):
    xs = np.linspace(-half, half, n_side)
    gx, gy = np.meshgrid(xs, xs)
    return np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, z)], axis=1).astype(np.float32)


def random_rotations(count):
    return Rotation.random(count, random_state=np.random.RandomState(0)).as_matrix()


# ------------------------------------------------------- tests/test_se3.py's oracles


def test_quat_matrix_roundtrip():
    rots = random_rotations(64)
    q_scipy = Rotation.from_matrix(rots).as_quat()
    q = np.concatenate([q_scipy[:, 3:], q_scipy[:, :3]], axis=1)
    np.testing.assert_allclose(n(se3.quat_to_matrix(t(q))), rots, atol=1e-6)
    q_back = se3.matrix_to_quat(t(rots))
    np.testing.assert_allclose(n(se3.quat_to_matrix(q_back)), rots, atol=1e-6)


def test_matrix_to_quat_degenerate_traces():
    for axis in ["x", "y", "z"]:
        m = Rotation.from_euler(axis, 180, degrees=True).as_matrix()
        np.testing.assert_allclose(n(se3.quat_to_matrix(se3.matrix_to_quat(t(m)))), m, atol=1e-6)


def test_pose_compose_invert():
    rng = np.random.default_rng(0)
    pose = se3.pose_from_rot_trans(t(random_rotations(8)), t(rng.normal(size=(8, 3))))
    ident = n(se3.compose(pose, se3.invert_pose(pose)))
    np.testing.assert_allclose(ident, np.broadcast_to(np.eye(4), (8, 4, 4)), atol=1e-5)


def test_transform_and_rotate_match_numpy():
    rng = np.random.default_rng(0)
    rot, tr = random_rotations(1)[0], rng.normal(size=(3,))
    pts = rng.normal(size=(100, 3))
    pose = se3.pose_from_rot_trans(t(rot), t(tr))
    np.testing.assert_allclose(n(se3.transform_points(pose, t(pts))), pts @ rot.T + tr, atol=1e-5)
    np.testing.assert_allclose(n(se3.rotate_vectors(pose, t(pts))), pts @ rot.T, atol=1e-5)


def test_world_camera_roundtrip():
    rng = np.random.default_rng(0)
    rots = random_rotations(4)
    cam = se3.pose_from_rot_trans(t(rots[0]), t(rng.normal(size=3)))
    obj = se3.pose_from_rot_trans(t(rots[1]), t(rng.normal(size=3)))
    back = se3.to_camera(se3.to_world(obj, cam), cam)
    np.testing.assert_allclose(n(back), n(obj), atol=1e-5)


def test_pose_from_quat_trans_batched():
    q = t([[1.0, 0, 0, 0], [0.0, 1, 0, 0]])
    out = n(se3.pose_from_quat_trans(q, torch.zeros(2, 3)))
    assert out.shape == (2, 4, 4)
    np.testing.assert_allclose(out[1], np.diag([1.0, -1.0, -1.0, 1.0]), atol=1e-7)


# -------------------------------------------- tests/test_render.py's cases, with JAX


def test_splat_renders_square():
    pts = grid_points_on_plane()
    depth = raster.splat_depth(t(pts), tb(np.ones(len(pts))), t(K), H, W, radius=1)
    want = jraster.splat_depth(jnp.asarray(pts), jnp.ones(len(pts), bool), jnp.asarray(K), H, W, 1)
    assert_depth_close(depth, want)
    depth = n(depth)
    occupied = depth > 0
    assert occupied.sum() > 300
    np.testing.assert_allclose(depth[occupied], 0.6, atol=1e-5)
    rows, cols = np.where(occupied)
    assert abs(rows.mean() - 48) < 3 and abs(cols.mean() - 64) < 3


def test_zmin_between_two_planes():
    pts = np.concatenate([grid_points_on_plane(z=0.9), grid_points_on_plane(z=0.5)])
    depth = raster.splat_depth(t(pts), tb(np.ones(len(pts))), t(K), H, W, radius=1)
    want = jraster.splat_depth(jnp.asarray(pts), jnp.ones(len(pts), bool), jnp.asarray(K), H, W, 1)
    assert_depth_close(depth, want)
    depth = n(depth)
    np.testing.assert_allclose(depth[depth > 0], 0.5, atol=1e-5)


def test_max_depth_clamp():
    pts = grid_points_on_plane(z=1.5)
    depth = raster.render_object_depth(torch.eye(4), t(pts), tb(np.ones(len(pts))), t(K), H, W,
                                       max_depth=1.0)
    assert (n(depth) == 0).all()


def test_composite_min():
    a = np.array([[0.0, 0.5], [0.7, 0.0]], np.float32)
    b = np.array([[0.3, 0.0], [0.6, 0.0]], np.float32)
    out = n(raster.composite_min(t(a), t(b)))
    np.testing.assert_allclose(out, [[0.3, 0.5], [0.6, 0.0]])
    np.testing.assert_array_equal(out, np.asarray(jraster.composite_min(jnp.asarray(a), jnp.asarray(b))))


def test_render_cost_semantics():
    obs = np.zeros((4, 4), np.float32)
    ren = np.zeros((4, 4), np.float32)
    obs[0, 0] = 0.5
    ren[1, 1] = 0.5
    obs[2, 2], ren[2, 2] = 0.5, 0.505
    obs[3, 3], ren[3, 3] = 0.5, 0.8
    got = cost.render_cost(t(obs), t(ren), threshold=0.01)
    assert got.dtype == torch.float32 and float(got) == 3.0


def test_render_cost_batched():
    obs = np.random.default_rng(0).uniform(0.1, 1, size=(2, 8, 8)).astype(np.float32)
    out = n(cost.render_cost(t(obs), torch.zeros(2, 8, 8)))
    assert out.shape == (2,)
    np.testing.assert_allclose(out, (obs > 0).sum(axis=(1, 2)))


def test_pose_and_batch_render():
    pts = grid_points_on_plane(z=0.0)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 0.7
    poses = np.stack([pose, pose])
    poses[1][2, 3] = 0.4
    mask = np.ones(len(pts), bool)
    out = raster.render_objects_batch(t(poses), t(pts), tb(mask), t(K), H, W)
    want = jraster.render_objects_batch(jnp.asarray(poses), jnp.asarray(pts), jnp.asarray(mask),
                                        jnp.asarray(K), H, W)
    assert_depth_close(out, want)
    out = n(out)
    assert out.shape == (2, H, W)
    assert np.isclose(out[0][out[0] > 0].mean(), 0.7, atol=1e-4)
    assert np.isclose(out[1][out[1] > 0].mean(), 0.4, atol=1e-4)
    assert (out[1] > 0).sum() > (out[0] > 0).sum()


# ------------------------------------------------- a cluttered scene, with JAX


def _clutter(seed, k=3, npts=1500):
    """K random clouds in front of the camera, random poses and masks, and an
    observed depth of another pose set."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.04, 0.04, (k, npts, 3)).astype(np.float32)
    mask = rng.random((k, npts)) > 0.1

    def poses():
        rot = Rotation.random(k, random_state=rng.integers(1 << 30)).as_matrix()
        p = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
        p[:, :3, :3] = rot
        p[:, :3, 3] = np.c_[rng.uniform(-0.06, 0.06, (k, 2)), rng.uniform(0.45, 0.8, k)]
        return p

    return pts, mask, poses(), poses()


@pytest.mark.parametrize("radius", [0, 1])
def test_render_scene_depth_and_cost_match_jax(radius):
    pts, mask, poses, obs_poses = _clutter(seed=radius)
    got = raster.render_scene_depth(t(poses), t(pts), tb(mask), t(K), H, W, radius, max_depth=0.7)
    want = jraster.render_scene_depth(jnp.asarray(poses), jnp.asarray(pts), jnp.asarray(mask),
                                      jnp.asarray(K), H, W, radius, max_depth=0.7)
    assert_depth_close(got, want)
    # The scene in one scatter equals the per-object renders min-composited.
    comp = torch.zeros(H, W)
    for i in range(len(poses)):
        d = raster.render_object_depth(t(poses[i]), t(pts[i]), tb(mask[i]), t(K), H, W, radius,
                                       max_depth=0.7)
        comp = raster.composite_min(comp, d)
    np.testing.assert_array_equal(n(comp), n(got))
    # A batch of scenes shares one scatter and equals the scenes one by one.
    batch = raster.render_scene_depth(t(np.stack([poses, obs_poses])), t(pts), tb(mask), t(K),
                                      H, W, radius, max_depth=0.7)
    np.testing.assert_array_equal(n(batch[0]), n(got))

    obs = n(raster.render_scene_depth(t(obs_poses), t(pts), tb(mask), t(K), H, W, radius))
    c_got = n(cost.render_cost(t(obs), batch))
    c_want = np.asarray(jcost.render_cost(jnp.asarray(obs), jnp.asarray(n(batch))))
    np.testing.assert_array_equal(c_got, c_want)
    c_jax_render = float(jcost.render_cost(jnp.asarray(obs), want))
    assert abs(c_got[0] - c_jax_render) <= TOL_COST


def test_project_zmin_matches_jax():
    pts, mask, poses, _ = _clutter(seed=5, k=1)
    cloud = pts[0] @ poses[0, :3, :3].T + poses[0, :3, 3]
    got = pointcloud.project_zmin(t(cloud), tb(mask[0]), t(K), H, W)
    want = jpointcloud.project_zmin(jnp.asarray(cloud), jnp.asarray(mask[0]), jnp.asarray(K), H, W)
    assert_depth_close(got, want)
    assert (n(got)[0] == 0).all() and (n(got)[:, 0] == 0).all()  # exclusive-low bounds
