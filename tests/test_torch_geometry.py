"""Port parity: geometry/se3, geometry/depthio, geometry/pointcloud."""

import jax
import jax.numpy as jnp
import numpy as np
from scipy.spatial.transform import Rotation

from _torch_common import n, t, tb
from physimglobalpose_tpu.geometry import depthio as jdepth, pointcloud as jpc, se3 as jse3
from physimglobalpose_tpu_torch.geometry import depthio, pointcloud, se3

INTR = np.array([[300.0, 0, 40.5], [0, 310.0, 30.5], [0, 0, 1]], np.float32)


def _poses(rng, k):
    out = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    out[:, :3, :3] = Rotation.random(k, random_state=rng.integers(1 << 31)).as_matrix()
    out[:, :3, 3] = rng.uniform(-1, 1, size=(k, 3))
    return out


def test_matrix_to_quat_matches_jax(rng):
    rots = _poses(rng, 64)[:, :3, :3]
    # degenerate traces: 180-degree turns about each axis
    rots = np.concatenate([rots, np.stack([np.diag(d) for d in
                                           ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])]).astype(np.float32)])
    want = np.asarray(jse3.matrix_to_quat(jnp.asarray(rots)))
    np.testing.assert_allclose(n(se3.matrix_to_quat(t(rots))), want, atol=1e-5)


def test_to_world_matches_jax(rng):
    a, cam = _poses(rng, 8), _poses(rng, 1)[0]
    want = np.asarray(jse3.to_world(jnp.asarray(a), jnp.asarray(cam)))
    np.testing.assert_allclose(n(se3.to_world(t(a), t(cam))), want, atol=1e-5)


def test_depth_codecs_match_jax(rng, tmp_path):
    raw = rng.integers(0, 1 << 16, size=(24, 32), dtype=np.uint16)
    for rot in (True, False):
        np.testing.assert_array_equal(depthio.decode_depth(raw, rot), jdepth.decode_depth(raw, rot))
    depth = rng.uniform(0.2, 1.5, size=(24, 32)).astype(np.float32)
    for rot in (True, False):
        np.testing.assert_array_equal(depthio.encode_depth(depth, rot), jdepth.encode_depth(depth, rot))
    # PNG round trip through the APC bit rotation (PIL imported lazily).
    path = str(tmp_path / "d.png")
    depthio.write_depth_png(path, depth, bit_rotated=True)
    np.testing.assert_array_equal(depthio.read_depth_png(path), jdepth.read_depth_png(path))


def test_backproject_matches_jax(rng):
    depth = rng.uniform(0.0, 2.5, size=(60, 80)).astype(np.float32)
    want_p, want_v = jpc.backproject(jnp.asarray(depth), jnp.asarray(INTR))
    got_p, got_v = pointcloud.backproject(t(depth), t(INTR))
    np.testing.assert_array_equal(n(got_v), np.asarray(want_v))
    np.testing.assert_allclose(n(got_p), np.asarray(want_p), atol=1e-5)


def test_compact_masked_points_with_injected_priority(rng):
    m = 500
    pts = rng.normal(size=(m, 3)).astype(np.float32)
    mask = rng.uniform(size=m) < 0.6
    key = jax.random.key(3)
    for max_points in (128, 400):  # subsampled, and padded with invalid slots
        want_p, want_m = jpc.compact_masked_points(jnp.asarray(pts), jnp.asarray(mask), max_points, key)
        prio = jax.random.uniform(key, (m,))
        got_p, got_m = pointcloud.compact_masked_points(t(pts), tb(mask), max_points, priority=t(prio))
        np.testing.assert_array_equal(n(got_m), np.asarray(want_m))
        np.testing.assert_allclose(n(got_p), np.asarray(want_p), atol=1e-6)
    # No draw: first points in scan order, as the JAX linspace priority.
    want_i, _ = jpc.compact_mask_indices(jnp.asarray(mask), 64)
    got_i, _ = pointcloud.compact_mask_indices(tb(mask), 64)
    np.testing.assert_array_equal(n(got_i), np.asarray(want_i))


def test_crop_segment_with_injected_priority(rng):
    depth = rng.uniform(0.3, 1.2, size=(60, 80)).astype(np.float32)
    prob = np.zeros((60, 80), np.float32)
    prob[10:40, 20:60] = rng.uniform(0.2, 1.0, size=(30, 40))
    key = jax.random.key(5)
    want = jpc.crop_segment(jnp.asarray(depth), jnp.asarray(prob), jnp.asarray(INTR), 256, key)
    prio = jax.random.uniform(key, (60 * 80,))
    got = pointcloud.crop_segment(t(depth), t(prob), t(INTR), 256, priority=t(prio))
    np.testing.assert_array_equal(n(got[2]), np.asarray(want[2]))
    np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(n(got[1]), np.asarray(want[1]), atol=1e-6)
