"""Port parity: ops/voxel, ops/normals, ops/plane, pipeline/scene.remove_table
and pipeline/segmentation.compute_3d_segment, with the JAX draws injected."""

import jax
import jax.numpy as jnp
import numpy as np

from _torch_common import n, t, tb
from physimglobalpose_tpu.config import PipelineConfig as JCfg, PreprocessConfig as JPre
from physimglobalpose_tpu.ops import normals as jnormals, plane as jplane, voxel as jvoxel
from physimglobalpose_tpu.pipeline import scene as jscene, segmentation as jseg
from physimglobalpose_tpu_torch.config import PipelineConfig, PreprocessConfig
from physimglobalpose_tpu_torch.ops import normals, plane, voxel
from physimglobalpose_tpu_torch.pipeline import scene, segmentation

INTR = np.array([[200.0, 0, 79.5], [0, 200.0, 59.5], [0, 0, 1]], np.float32)


def _cloud(rng, m=600):
    pts = rng.uniform(-0.1, 0.1, size=(m, 3)).astype(np.float32) + [0, 0, 0.6]
    return pts.astype(np.float32), rng.uniform(size=m) < 0.85


def test_voxel_downsample_matches_jax(rng):
    pts, mask = _cloud(rng)
    extras = rng.uniform(size=(len(pts), 2)).astype(np.float32)
    for max_out in (512, 64):  # room for all voxels, and overflow
        want = jvoxel.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), 0.02, max_out,
                                       extras=jnp.asarray(extras))
        got = voxel.voxel_downsample(t(pts), tb(mask), 0.02, max_out, extras=t(extras))
        np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))
        np.testing.assert_allclose(n(got[0]), np.asarray(want[0]), atol=1e-5)
        np.testing.assert_allclose(n(got[2]), np.asarray(want[2]), atol=1e-5)


def test_pairwise_and_outlier_mask_match_jax(rng):
    pts, mask = _cloud(rng, 300)
    np.testing.assert_allclose(
        n(normals.pairwise_sq_dists(t(pts), t(pts[:50]))),
        np.asarray(jnormals.pairwise_sq_dists(jnp.asarray(pts), jnp.asarray(pts[:50]))),
        atol=1e-5,
    )
    want = jnormals.radius_outlier_mask(jnp.asarray(pts), jnp.asarray(mask), 0.03, 10)
    got = normals.radius_outlier_mask(t(pts), tb(mask), 0.03, 10)
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_knn_normals_match_jax(rng):
    # Points on a curved patch (well-defined normals) with some masked out.
    uv = rng.uniform(-0.05, 0.05, size=(400, 2))
    z = 0.6 + 2.0 * (uv ** 2).sum(-1)
    pts = np.concatenate([uv, z[:, None]], axis=1).astype(np.float32)
    mask = rng.uniform(size=400) < 0.9
    want = np.asarray(jnormals.knn_normals(jnp.asarray(pts), jnp.asarray(mask), k=16))
    got = n(normals.knn_normals(t(pts), tb(mask), k=16))
    np.testing.assert_array_equal(np.abs(got).sum(-1) > 0, mask)
    # Equal up to the sign of degenerate (near-isotropic) neighbourhoods:
    # both are unit and oriented toward the viewpoint.
    cos = np.abs(np.sum(got * want, axis=-1))[mask]
    np.testing.assert_allclose(cos, 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _table_depth(rng, h=120, w=160):
    """Tilted table plane with a box-shaped bump, in camera frame."""
    vv, uu = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    x = (uu - INTR[0, 2]) / INTR[0, 0]
    y = (vv - INTR[1, 2]) / INTR[1, 1]
    # plane through (0, 0, 0.8) with normal (0, -0.5, -0.866): depth per ray
    nrm = np.array([0.0, -0.5, -0.8660254])
    depth = (nrm @ [0, 0, 0.8]) / (nrm[0] * x + nrm[1] * y + nrm[2])
    depth[40:80, 50:110] -= 0.05  # an object on the table
    depth += rng.normal(scale=0.0005, size=depth.shape)
    return depth.astype(np.float32)


def test_fit_plane_with_injected_triplets(rng):
    pts, _ = _cloud(rng, 400)
    pts[:300, 2] = 0.7 + 0.1 * pts[:300, 0]  # a dominant plane + clutter
    mask = np.ones(400, bool)
    mask[-20:] = False
    key = jax.random.key(2)
    want_pl, want_in = jplane.fit_plane_ransac(jnp.asarray(pts), jnp.asarray(mask), key, iters=64)
    probs = jnp.asarray(mask, jnp.float32) / mask.sum()
    tri = jax.random.choice(key, len(pts), shape=(64, 3), p=probs)
    got_pl, got_in = plane.fit_plane_ransac(t(pts), tb(mask), iters=64,
                                            triplets=t(tri, dtype=None).long())
    np.testing.assert_array_equal(n(got_in), np.asarray(want_in))
    np.testing.assert_allclose(n(got_pl), np.asarray(want_pl), atol=1e-5)


def test_remove_table_with_injected_draws(rng):
    depth = _table_depth(rng)
    cfg, jcfg = PipelineConfig(), JCfg()
    key = jax.random.key(7)
    want_d, want_pl, want_pose = jscene.remove_table(jnp.asarray(depth), jnp.asarray(INTR), key, jcfg)
    # The JAX function's own draws, reproduced from its key.
    k1, k2 = jax.random.split(key)
    prio = jax.random.uniform(k1, (depth.size,))
    from physimglobalpose_tpu.geometry import pointcloud as jpc
    from physimglobalpose_tpu.ops import voxel as jvox
    pts, valid = jpc.backproject(jnp.asarray(depth), jnp.asarray(INTR))
    sub, sub_mask = jpc.compact_masked_points(pts.reshape(-1, 3), valid.reshape(-1), 16384, k1)
    _, vox_mask, _ = jvox.voxel_downsample(sub, sub_mask, cfg.preprocess.scene_voxel, 8192)
    probs = vox_mask.astype(jnp.float32) / jnp.maximum(vox_mask.sum(), 1)
    tri = jax.random.choice(k2, 8192, shape=(cfg.preprocess.plane_ransac_iters, 3), p=probs)

    got_d, got_pl, got_pose = scene.remove_table(
        t(depth), t(INTR), cfg, priority=t(prio), triplets=t(tri, dtype=None).long()
    )
    np.testing.assert_allclose(n(got_pl), np.asarray(want_pl), atol=1e-5)
    np.testing.assert_array_equal(n(got_d) == 0, np.asarray(want_d) == 0)
    np.testing.assert_allclose(n(got_d), np.asarray(want_d), atol=1e-5)
    np.testing.assert_allclose(n(got_pose), np.asarray(want_pose), atol=1e-5)


def test_compute_3d_segment_with_injected_priority(rng):
    depth = _table_depth(rng)
    prob = np.zeros_like(depth)
    prob[40:80, 50:110] = 1.0
    pre = dict(max_segment_points=256)
    cfg, jcfg = PipelineConfig(preprocess=PreprocessConfig(**pre)), JCfg(preprocess=JPre(**pre))
    key = jax.random.key(11)
    want = jseg.compute_3d_segment(jnp.asarray(depth), jnp.asarray(prob), jnp.asarray(INTR), key, jcfg)
    k1, _ = jax.random.split(key)
    prio = jax.random.uniform(k1, (depth.size,))
    got = segmentation.compute_3d_segment(t(depth), t(prob), t(INTR), cfg, priority=t(prio))
    np.testing.assert_array_equal(n(got.mask), np.asarray(want.mask))
    assert n(got.mask).sum() > 100
    np.testing.assert_allclose(n(got.pts), np.asarray(want.pts), atol=1e-5)
    np.testing.assert_allclose(n(got.prob), np.asarray(want.prob), atol=1e-5)
    cos = np.abs(np.sum(n(got.nrm) * np.asarray(want.nrm), -1))[n(got.mask)]
    np.testing.assert_allclose(cos, 1.0, atol=1e-5)


def test_gt_prob_images_and_strategy_dispatch():
    mask = np.array([[0, 1, 2], [2, 2, 0]], np.int32)
    got = segmentation.build_prob_images("GT", [1, 2], class_mask=mask)
    want = jseg.build_prob_images("GT", [1, 2], class_mask=mask)
    for c in (1, 2):
        np.testing.assert_array_equal(got[c], want[c])
    import pytest

    # The network strategies run (tests/test_torch_segmentation.py); without
    # their predictor or detector both packages raise ValueError.
    for strategy in ("FCN", "RCNN", "BOGUS"):
        for build in (segmentation.build_prob_images, jseg.build_prob_images):
            with pytest.raises(ValueError):
                build(strategy, [1], class_mask=mask)
