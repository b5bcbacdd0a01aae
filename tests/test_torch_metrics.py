"""Port parity: geometry/metrics (symmetry-folded pose error, ADD, ADD-S, the
EMD histograms with their Sinkhorn and exact-LP distances) and the se3
helpers they use, against the JAX package's functions on the same numpy
inputs, and against the oracles of the JAX package's own metric tests."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from _torch_common import n, t
from physimglobalpose_tpu.geometry import metrics as jmetrics, se3 as jse3
from physimglobalpose_tpu_torch.geometry import metrics, se3


def pose(rot=None, trans=(0, 0, 0)):
    out = np.eye(4, dtype=np.float32)
    if rot is not None:
        out[:3, :3] = rot
    out[:3, 3] = trans
    return out


def random_poses(rng, k):
    out = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    out[:, :3, :3] = Rotation.random(k, random_state=rng.integers(1 << 31)).as_matrix()
    out[:, :3, 3] = rng.uniform(-0.3, 0.3, size=(k, 3)) + [0, 0, 0.6]
    return out


def test_se3_helpers_match_jax(rng):
    poses = random_poses(rng, 32)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(n(se3.transform_points(t(poses), t(pts))),
                               np.asarray(jse3.transform_points(jnp.asarray(poses), jnp.asarray(pts))),
                               atol=1e-5)
    np.testing.assert_allclose(n(se3.matrix_to_euler_xyz(t(poses[:, :3, :3]))),
                               np.asarray(jse3.matrix_to_euler_xyz(jnp.asarray(poses[:, :3, :3]))),
                               atol=1e-4)
    # Oracle: scipy's extrinsic xyz angles, away from the pitch singularity.
    eul = np.array([[0.3, -0.7, 1.9], [-2.0, 0.4, 0.1]])
    rots = Rotation.from_euler("xyz", eul).as_matrix().astype(np.float32)
    np.testing.assert_allclose(n(se3.matrix_to_euler_xyz(t(rots))), eul, atol=1e-5)


@pytest.mark.parametrize("sym", [0, 90, 180, 360])
def test_fold_symmetry_matches_jax(sym):
    err = np.linspace(-180, 180, 73).astype(np.float32)[:, None].repeat(3, 1)
    sym_deg = np.array([sym, 0, sym], np.float32)
    want = np.asarray(jmetrics.fold_symmetry(jnp.asarray(err), jnp.asarray(sym_deg)))
    np.testing.assert_allclose(n(metrics.fold_symmetry(t(err), t(sym_deg))), want, atol=1e-5)


def test_pose_error_matches_jax(rng):
    a, b = random_poses(rng, 40), random_poses(rng, 40)
    for sym in ([0, 0, 0], [90, 180, 360], [180, 180, 180]):
        sym = np.array(sym, np.float32)
        want_r, want_t = jmetrics.pose_error(jnp.asarray(a), jnp.asarray(b), jnp.asarray(sym))
        got_r, got_t = metrics.pose_error(t(a), t(b), t(sym))
        # Degrees: the euler path amplifies float32 rounding near the pitch clamp.
        np.testing.assert_allclose(n(got_r), np.asarray(want_r), atol=2e-2)
        np.testing.assert_allclose(n(got_t), np.asarray(want_t), atol=1e-6)


def test_pose_error_oracles():
    # The JAX package's own cases: identity, a 3-4-5 translation, symmetry folds.
    p = pose()
    rot_err, trans_err = metrics.pose_error(t(p), t(p), t([0.0, 0.0, 0.0]))
    assert float(rot_err) < 1e-4 and float(trans_err) < 1e-7
    _, trans_err = metrics.pose_error(t(p), t(pose(trans=(0.03, 0.04, 0.0))), t(np.zeros(3)))
    np.testing.assert_allclose(float(trans_err), 0.05, atol=1e-6)
    half_turn = pose(Rotation.from_euler("z", 180, degrees=True).as_matrix())
    err_nosym, _ = metrics.pose_error(t(p), t(half_turn), t(np.zeros(3)))
    err_sym, _ = metrics.pose_error(t(p), t(half_turn), t([0.0, 0.0, 180.0]))
    assert float(err_nosym) > 30.0 and float(err_sym) < 1e-3
    any_rot = pose(Rotation.from_euler("xyz", [77, 13, -40], degrees=True).as_matrix())
    err, _ = metrics.pose_error(t(p), t(any_rot), t([360.0, 360.0, 360.0]))
    assert float(err) == 0.0


def test_add_and_adds_match_jax_and_the_exact_oracle(rng):
    model = rng.normal(scale=0.05, size=(300, 3)).astype(np.float32)
    a, b = random_poses(rng, 6), random_poses(rng, 6)
    b[:, :3, 3] = a[:, :3, 3] + rng.normal(scale=0.01, size=(6, 3))
    want_add = np.asarray(jmetrics.add_error(jnp.asarray(a), jnp.asarray(b), jnp.asarray(model)))
    np.testing.assert_allclose(n(metrics.add_error(t(a), t(b), t(model))), want_add, atol=1e-6)
    got = n(metrics.adds_error(t(a), t(b), t(model), chunk=128))  # 300 is no multiple of 128
    # Oracle in float64: mean over gt points of the nearest test point.
    pa = np.einsum("kij,nj->kni", a[:, :3, :3].astype(np.float64), model) + a[:, None, :3, 3]
    pb = np.einsum("kij,nj->kni", b[:, :3, :3].astype(np.float64), model) + b[:, None, :3, 3]
    oracle = np.linalg.norm(pb[:, :, None] - pa[:, None], axis=-1).min(-1).mean(-1)
    np.testing.assert_allclose(got, oracle, rtol=1e-4)
    # The JAX function expands |a|^2 + |b|^2 - 2ab in float32: looser.
    want = np.asarray(jmetrics.adds_error(jnp.asarray(a), jnp.asarray(b), jnp.asarray(model)))
    np.testing.assert_allclose(got, want, rtol=2e-3)
    assert (got <= want_add + 1e-6).all() and (got > 0).all()


def test_adds_of_identical_poses_is_zero(rng):
    model = rng.normal(size=(128, 3)).astype(np.float32)
    p = t(pose(trans=(0.1, 0.0, 0.7)))
    assert float(metrics.adds_error(p, p, t(model))) == 0.0


@pytest.fixture
def emd_case(rng):
    model = rng.uniform(-0.06, 0.06, size=(300, 3)).astype(np.float32)
    lo, hi = np.full(3, -0.25, np.float32), np.full(3, 0.25, np.float32)
    return model, lo, hi


def test_emd_histograms_match_jax(emd_case, rng):
    model, lo, hi = emd_case
    a = np.stack([pose(), pose(trans=(0.03, 0, 0))])
    b = np.stack([pose(trans=(0.0, -0.05, 0.02)), pose(trans=(0.3, 0, 0))])  # the last leaves the box
    want = jmetrics.emd_histograms(*(jnp.asarray(x) for x in (a, b, model, lo, hi)), bins=8)
    got = metrics.emd_histograms(t(a), t(b), t(model), t(lo), t(hi), bins=8)
    for g, w in zip(got, want):
        assert g.shape == (2, 512)
        np.testing.assert_array_equal(n(g), np.asarray(w))
    assert float(got[0].sum()) == 600.0 and float(got[1][1].sum()) < 300.0


def test_emd_approx_matches_jax(emd_case):
    # The JAX function takes one pose pair at a time (its k @ v is unbatched);
    # the port also takes a batch, which must equal the pairs one by one.
    model, lo, hi = emd_case
    a = np.stack([pose(), pose()])
    b = np.stack([pose(trans=(0.03, 0, 0)), pose(trans=(0.08, 0.04, 0))])
    want = np.array([float(jmetrics.emd_error_approx(
        *(jnp.asarray(x) for x in (a[i], b[i], model, lo, hi)), bins=8, sinkhorn_iters=50))
        for i in range(2)])
    got = n(metrics.emd_error_approx(t(a), t(b), t(model), t(lo), t(hi), bins=8,
                                     sinkhorn_iters=50))
    assert got.shape == (2,) and got[0] < got[1]
    np.testing.assert_allclose(got, want, rtol=1e-3)
    one = float(metrics.emd_error_approx(t(a[1]), t(b[1]), t(model), t(lo), t(hi), bins=8))
    np.testing.assert_allclose(one, got[1], rtol=1e-5)


def test_emd_exact_oracle_translation():
    # The JAX package's hand-checkable case: a pure-x translation by exactly
    # 2 bins moves every unit of mass an L2 bin-distance of 2.
    model = np.stack(np.meshgrid(*[np.linspace(-0.04, 0.04, 5)] * 3, indexing="ij"),
                     -1).reshape(-1, 3).astype(np.float32)
    lo, hi = np.full(3, -0.2, np.float32), np.full(3, 0.2, np.float32)
    p, moved = pose(), pose(trans=(0.10, 0.0, 0.0))
    got = metrics.emd_error_exact(p, moved, model, lo, hi, bins=8)
    np.testing.assert_allclose(got, 2.0, atol=1e-6)
    assert metrics.emd_error_exact(p, p, model, lo, hi, bins=8) == 0.0
    assert got == jmetrics.emd_error_exact(p, moved, model, lo, hi, bins=8)
    with pytest.raises(ValueError, match="unbatched"):
        metrics.emd_error_exact(np.stack([p, p]), np.stack([p, p]), model, lo, hi, bins=8)


def test_emd_sinkhorn_error_bounded_by_exact(emd_case):
    # The JAX package's documented bound: the eps = 0.5 Sinkhorn bias stays
    # under 0.75 bins against the exact LP on rigid perturbations.
    model, lo, hi = emd_case
    p = pose()
    for trans in [(0.03, 0.0, 0.0), (0.0, -0.05, 0.02), (0.08, 0.04, 0.0)]:
        moved = pose(trans=trans)
        exact = metrics.emd_error_exact(p, moved, model, lo, hi, bins=8)
        approx = float(metrics.emd_error_approx(t(p), t(moved), t(model), t(lo), t(hi), bins=8))
        assert exact > 0.0 and abs(approx - exact) < 0.75
