"""Port parity: the model-streaming ICP (ops/icp.refine_icp_stream and its
plain correspondence pass icp_stream_pass_plain) against the TPU kernel it
stands for (_icp_corr_kernel through _icp_pallas_pass / refine_icp_pallas, run
in Pallas interpret mode on the CPU). The CUDA kernel itself is held against
icp_stream_pass_plain on the card by chip_smoke.py.

The pass works in the scene frame, in float32: at camera distance (0.5 m) the
expansion |s|^2 + |p|^2 - 2 s.p carries about 1e-7 of rounding, so where two
model points are equally near a segment point to that precision the two
packages may pick different ones (they sum the terms in different orders).
The tight comparison therefore runs on a scene moved to the origin; the scene
at camera distance is held to the weight of a few correspondences.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import n, t, tb
from physimglobalpose_tpu.ops import icp as jicp
from physimglobalpose_tpu_torch import kernel_inputs
from physimglobalpose_tpu_torch.ops import icp
from test_icp import check_alignment
from test_torch_icp_segside import interpret, make_case, mean_displacement, two_inits


def jax_pass(tfs, seg, mask, model, mnrm, max_corr, nm_tile):
    """_icp_pallas_pass on the arrays refine_icp_pallas packs for it."""
    ns, nm = len(seg), len(model)
    pad_nm = (-nm) % min(nm_tile, nm)
    segcat = np.zeros((ns, 128), np.float32)
    segcat[:, 0:3], segcat[:, 3], segcat[:, 4], segcat[:, 6] = seg, (seg * seg).sum(-1), 1.0, mask
    modelcat = np.zeros((nm + pad_nm, 128), np.float32)
    modelcat[:nm, 0:3], modelcat[:nm, 3:6], modelcat[nm:, 0:3] = model, mnrm, 1e4
    a, b = interpret(jicp._icp_pallas_pass, jnp.asarray(tfs), jnp.asarray(segcat),
                     jnp.asarray(modelcat), max_corr, nm_tile)
    return np.asarray(a), np.asarray(b)


def port_pass(tfs, seg, mask, model, mnrm, max_corr, nm_tile):
    tr12 = t(tfs[:, :3, :].reshape(-1, 12))
    a, b = icp.icp_stream_pass(tr12, icp.pack_icp_stream_segment(t(seg), tb(mask)), t(model),
                               t(mnrm), max_corr, nm_tile)
    return n(a), n(b)


def pass_case(rng, at_origin):
    # Nm = 300 is no multiple of either tile; 20 masked segment points; the
    # third hypothesis is far from everything.
    model, mnrm, seg, true_pose, init = make_case(rng, n_model=300, n_seg=200)
    mask = np.ones(len(seg), bool)
    mask[rng.choice(len(seg), 20, replace=False)] = False
    tfs = np.stack([init, true_pose, np.eye(4, dtype=np.float32)]).astype(np.float32)
    if at_origin:
        centre = seg.mean(0)
        seg = (seg - centre).astype(np.float32)
        tfs[:, :3, 3] -= centre
    return tfs, seg, mask, model, mnrm


@pytest.mark.parametrize("nm_tile", [64, 256])
def test_stream_pass_matches_tpu_kernel_interpret(rng, nm_tile):
    # (A, b) within 1e-5 of the largest entry (5e-7 measured): the same
    # correspondences and weights, another order of the float32 sums.
    args = pass_case(rng, at_origin=True)
    a, b = jax_pass(*args, 0.02, nm_tile)
    pa, pb = port_pass(*args, 0.02, nm_tile)
    assert pa.shape == (3, 6, 6) and pb.shape == (3, 6)
    assert np.abs(a[0]).max() > 1.0 and np.abs(a[2]).max() == 0.0 == np.abs(pa[2]).max()
    assert np.abs(pa - a).max() <= 1e-5 * np.abs(a).max()
    assert np.abs(pb - b).max() <= 1e-5 * np.abs(b).max()
    np.testing.assert_allclose(pa, np.swapaxes(pa, 1, 2), atol=1e-5 * np.abs(a).max())


@pytest.mark.parametrize("nm_tile", [64, 256])
def test_stream_pass_at_camera_distance(rng, nm_tile):
    # The module note: 180 correspondences a hypothesis, a near-tie may fall
    # the other way, so (A, b) are held to 1e-2 of the largest entry (1.4e-3
    # measured, one correspondence).
    args = pass_case(rng, at_origin=False)
    a, b = jax_pass(*args, 0.02, nm_tile)
    pa, pb = port_pass(*args, 0.02, nm_tile)
    assert np.abs(pa - a).max() <= 1e-2 * np.abs(a).max()
    assert np.abs(pb - b).max() <= 1e-2 * np.abs(b).max()


def test_masked_points_carry_no_weight(rng):
    tfs, seg, mask, model, mnrm = pass_case(rng, at_origin=True)
    pa, pb = port_pass(tfs, seg, mask, model, mnrm, 0.02, 64)
    moved = seg.copy()
    moved[~mask] += 0.01  # still in range of the model, but masked
    qa, qb = port_pass(tfs, moved, mask, model, mnrm, 0.02, 64)
    np.testing.assert_array_equal(pa, qa)
    np.testing.assert_array_equal(pb, qb)
    ra, _ = port_pass(tfs, moved, np.ones_like(mask), model, mnrm, 0.02, 64)
    assert np.abs(ra - pa).max() > 1e-3


def tie_case():
    """One segment point at the origin under the identity pose; model points 0
    and 64 lie at the same place (the nearest) with normals +z and +x."""
    rng = np.random.default_rng(7)
    model = rng.uniform(0.05, 0.2, size=(130, 3)).astype(np.float32)
    model[0] = model[64] = [0.002, 0.001, 0.003]
    mnrm = np.tile(np.array([[0, 1.0, 0]], np.float32), (130, 1))
    mnrm[0], mnrm[64] = [0, 0, 1], [1, 0, 0]
    tfs = np.eye(4, dtype=np.float32)[None]
    return tfs, np.zeros((1, 3), np.float32), np.ones(1, bool), model, mnrm


@pytest.mark.parametrize("nm_tile", [64, 128], ids=["across_tiles", "one_tile"])
def test_cross_tile_ties_follow_the_tile_rule(nm_tile):
    # Tile 64: the tied model points lie in two tiles and the later one is
    # ignored: the matched normal is +z. Tile 128: one tile, the normal is the
    # mean (0.5, 0, 0.5), shorter than 1. A[3:, 3:] = w n n^T shows which.
    args = tie_case()
    a, _ = jax_pass(*args, 0.02, nm_tile)
    pa, _ = port_pass(*args, 0.02, nm_tile)
    w = np.exp(-np.float32(0.002**2 + 0.001**2 + 0.003**2) / (2 * 0.01**2))
    nrm = np.array([0, 0, 1.0]) if nm_tile == 64 else np.array([0.5, 0, 0.5])
    np.testing.assert_allclose(pa[0, 3:, 3:], w * np.outer(nrm, nrm), atol=1e-5)
    np.testing.assert_allclose(pa[0], a[0], atol=1e-5)


def test_refine_icp_stream_matches_jax(rng):
    # The bars of the JAX package's own test of refine_icp_pallas: both align
    # the model (within 4 mm of the truth) and land within 1 mm of each other,
    # over 8 iterations at a tile of 64.
    model, mnrm, seg, true_pose, init = make_case(rng)
    mask = np.ones(len(seg), bool)
    inits = two_inits(init)
    want = np.asarray(interpret(
        jicp.refine_icp_pallas.__wrapped__, jnp.asarray(inits), jnp.asarray(model),
        jnp.asarray(mnrm), jnp.asarray(seg), jnp.asarray(mask), iters=8, nm_tile=64))
    before = icp.icp_corr_stream.launches
    got = n(icp.refine_icp_stream(t(inits), t(model), t(mnrm), t(seg), tb(mask), iters=8,
                                  nm_tile=64))
    assert icp.icp_corr_stream.launches == before  # CPU tensors launch nothing
    for g, w in zip(got, want):
        assert mean_displacement(model, g, w) < 1e-3
        assert check_alignment(g, true_pose, model, tol=0.004)
    assert np.abs(got - inits).max() > 1e-3  # the poses moved


def test_refine_icp_stream_keeps_a_pose_without_correspondences(rng):
    model, mnrm, seg, _, init = make_case(rng)
    far = init.copy()
    far[:3, 3] += 1.0
    got = n(icp.refine_icp_stream(t(far[None]), t(model), t(mnrm), t(seg),
                                  tb(np.ones(len(seg), bool)), iters=2))
    np.testing.assert_allclose(got[0], far, atol=1e-6)


def test_stream_wrapper_takes_only_cuda_tensors():
    args = (torch.zeros(4, 12), torch.zeros(5000, 4), torch.zeros(9000, 3), torch.zeros(9000, 3))
    with pytest.raises(ValueError, match="CUDA"):
        icp.icp_corr_stream(*args)


def test_refine_icp_stream_is_non_finite_where_jax_is(rng):
    # refine_icp_pallas solves and composes with no finite guard, and so does
    # the port's refine_icp_stream (icp_update). Batch: a hypothesis near the
    # truth (many correspondences), one 1 m off (none: A = 1e-8 I, b = 0, the
    # pose stays) and kernel_inputs.with_singular_hypothesis's (one
    # correspondence and an exactly singular system: an exact zero pivot, a
    # non-finite pose in both packages). A system that is singular only up to
    # rounding does not do: on make_case's segment cut to one point, OpenBLAS's
    # LU (the JAX package's CPU LAPACK) meets an exact zero pivot where MKL's
    # (PyTorch's) leaves one of rounding noise, and the pose is NaN in the one
    # and finite in the other.
    model, mnrm, seg, true_pose, init = make_case(rng)
    far = init.copy()
    far[:3, 3] += 1.0
    inputs = kernel_inputs.with_singular_hypothesis(
        t(np.stack([init, far])), t(model), t(mnrm), t(seg), tb(np.ones(len(seg), bool)))
    tfs, model, mnrm, seg, mask = (n(x) for x in inputs)
    want = np.asarray(interpret(
        jicp.refine_icp_pallas.__wrapped__, jnp.asarray(tfs), jnp.asarray(model),
        jnp.asarray(mnrm), jnp.asarray(seg), jnp.asarray(mask), iters=2, nm_tile=64))
    got = n(icp.refine_icp_stream(*inputs, iters=2, nm_tile=64))
    finite = lambda x: np.isfinite(x).all(axis=(1, 2))
    np.testing.assert_array_equal(finite(want), [True, True, False])
    np.testing.assert_array_equal(finite(got), finite(want))
    assert mean_displacement(model, got[0], want[0]) < 1e-3
    assert mean_displacement(model, got[0], true_pose) < mean_displacement(model, init, true_pose)
    np.testing.assert_allclose(got[1], far, atol=1e-6)
    # The segment-stationary refiner keeps its guard: its update keeps the pose.
    a, b = icp.icp_stream_pass(inputs[0][:, :3, :].reshape(-1, 12).contiguous(),
                               icp.pack_icp_stream_segment(inputs[3], inputs[4]), inputs[1],
                               inputs[2])
    assert not np.isfinite(n(icp.icp_update(inputs[0], a, b))[2]).all()
    np.testing.assert_array_equal(n(icp.segside_update(inputs[0], a, b))[2], tfs[2])


def tie_args(nm_tile):
    tfs, model, mnrm, seg, mask = (n(x) for x in kernel_inputs.icp_tie_inputs(torch.device("cpu")))
    return tfs, seg, mask, model, mnrm, 0.02, nm_tile


TIE_TILES = [37, 64, 100, 256]  # 37 and 100 are no multiple of any kernel chunk


@pytest.mark.parametrize("nm_tile", TIE_TILES)
def test_stream_pass_on_exact_ties_matches_tpu_kernel(nm_tile):
    # Every d2 is exact in float32 (kernel_inputs.icp_tie_inputs), so both
    # packages find the same ties in the same tiles; only the float32 sums and
    # exp differ: (A, b) within 1e-5 of the largest entry.
    args = tie_args(nm_tile)
    a, b = jax_pass(*args)
    pa, pb = port_pass(*args)
    assert np.abs(a[:4]).max(axis=(1, 2)).min() > 0.0 and np.abs(pa[4]).max() == 0.0
    assert np.abs(pa - a).max() <= 1e-5 * np.abs(a).max()
    assert np.abs(pb - b).max() <= 1e-5 * np.abs(b).max()


def min_first_pass(tfs, seg, mask, model, mnrm, max_corr, nm_tile):
    """(A, b) by the rule the CUDA kernel applies, in float64: a segment
    point's d2* is its global minimum over the model, its tile the first tile
    of nm_tile points whose minimum equals it, its match the mean of (p, n)
    over that tile's ties, summed in index order. Also returns how many
    weighted points had tied nearest points, and how many had them in more
    than one tile."""
    a_out, b_out, tied, straddles = [], [], 0, 0
    nm = len(model)
    tile_of = np.arange(nm) // min(nm_tile, nm)
    for tf in tfs.astype(np.float64):
        p = model @ tf[:3, :3].T + tf[:3, 3]
        nn = mnrm @ tf[:3, :3].T
        d2 = ((seg[:, None, :] - p[None]) ** 2).sum(-1)
        a = np.zeros((6, 6))
        b = np.zeros(6)
        for j in range(len(seg)):
            best = d2[j].min()
            if not mask[j] or best > max_corr**2:
                continue
            ties = np.flatnonzero(d2[j] == best)
            tied += len(ties) > 1
            straddles += len(set(tile_of[ties])) > 1
            first = ties[tile_of[ties] == tile_of[ties[0]]]
            v = np.zeros(6)
            for i in first:
                v += np.concatenate([p[i], nn[i]])
            v /= len(first)
            w = np.exp(-best / (2 * (max_corr / 2) ** 2))
            col = np.concatenate([np.cross(v[:3], v[3:]), v[3:]])
            a += w * np.outer(col, col)
            b -= w * col * np.dot(v[:3] - seg[j], v[3:])
        a_out.append(a)
        b_out.append(b)
    return np.array(a_out), np.array(b_out), tied, straddles


@pytest.mark.parametrize("nm_tile", TIE_TILES)
def test_stream_pass_follows_the_min_first_rule(nm_tile):
    # The plain version (running tile minima, as the TPU kernel) against the
    # kernel's rule (global minimum first, then the first tile that reaches
    # it): the same matches, (A, b) within 1e-6 of the largest entry. Most
    # weighted points have tied nearest points and, below Nm = 216, some have
    # them in two tiles, so the rule is put to work.
    args = tie_args(nm_tile)
    a, b, tied, straddles = min_first_pass(*args)
    pa, pb = port_pass(*args)
    assert tied > 200 and (straddles > 20 or nm_tile >= 216)
    assert np.abs(pa - a).max() <= 1e-6 * np.abs(a).max()
    assert np.abs(pb - b).max() <= 1e-6 * np.abs(b).max()


def test_refine_icp_stream_near_singular_outcome_follows_the_lu_pivot(rng):
    # make_case's segment cut to one point: one correspondence, A of rank one,
    # and A + 1e-8 I singular up to rounding (1e-8 lies within a few float32
    # steps of A's largest entry). The two packages form the same system up to
    # the rounding of d2 at camera distance (2e-5 of the largest entry), and
    # whether the pose comes out finite is decided by the LU factorisation's
    # last pivot alone: a library that rounds it to exactly 0 gives a
    # non-finite pose, one that leaves rounding noise a finite one. The JAX
    # package's CPU LAPACK (OpenBLAS through SciPy) rounds it to 0 here and
    # PyTorch's (MKL) leaves -3e-9, so refine_icp_pallas gives NaN and
    # refine_icp_stream a finite pose. The test holds each package to its own
    # pivot, and PyTorch's LU to one outcome on both packages' systems: the
    # library decides, not the difference between the systems.
    import jax.scipy.linalg as jsl

    model, mnrm, seg, _, init = make_case(rng)
    mask = np.zeros(len(seg), bool)
    mask[0] = True
    tfs = init[None]
    want = np.asarray(interpret(
        jicp.refine_icp_pallas.__wrapped__, jnp.asarray(tfs), jnp.asarray(model),
        jnp.asarray(mnrm), jnp.asarray(seg), jnp.asarray(mask), iters=2, nm_tile=64))
    got = n(icp.refine_icp_stream(t(tfs), t(model), t(mnrm), t(seg), tb(mask), iters=2,
                                  nm_tile=64))
    args = (tfs, seg, mask, model, mnrm, 0.02, 64)
    a, b = jax_pass(*args)
    pa, pb = port_pass(*args)
    assert np.abs(pa - a).max() <= 1e-4 * np.abs(a).max()
    assert np.abs(pb - b).max() <= 1e-4 * np.abs(b).max()
    assert np.linalg.matrix_rank(a[0].astype(np.float64), tol=1e-6 * np.abs(a).max()) == 1
    noise = 8 * np.finfo(np.float32).eps * np.abs(a).max()
    assert 1e-8 < noise
    eye = 1e-8 * np.eye(6, dtype=np.float32)
    jax_pivot = np.abs(np.diag(np.asarray(jsl.lu_factor(jnp.asarray(a[0] + eye))[0]))).min()
    torch_pivot = lambda m: float(torch.linalg.lu_factor(t(m + eye))[0].diagonal().abs().min())
    port_pivot = torch_pivot(pa[0])
    assert jax_pivot <= noise and port_pivot <= noise
    assert (torch_pivot(a[0]) > 0.0) == (port_pivot > 0.0)
    assert np.isfinite(want).all() == (jax_pivot > 0.0)
    assert np.isfinite(got).all() == (port_pivot > 0.0)
