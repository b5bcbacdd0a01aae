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
