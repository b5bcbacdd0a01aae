"""Port parity: the segment-stationary ICP (ops/icp.refine_icp_segside and its
plain correspondence pass) against the TPU kernel it stands for
(_icp_corr_kernel_segside, run in Pallas interpret mode on the CPU). The CUDA
kernel itself is held against icp_segside_pass_plain on the card by
chip_smoke.py."""

import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from _torch_common import n, t, tb
from physimglobalpose_tpu.ops import icp as jicp
from physimglobalpose_tpu_torch.ops import icp, lcp


def make_case(rng, n_model=128, n_seg=96, perturb_deg=5.0, perturb_t=0.01):
    """Ellipsoid surface with true outward normals, a segment sampled from it
    under the true pose, and a perturbed initial pose (the case of the JAX
    package's segment-stationary ICP tests)."""
    d = rng.normal(size=(n_model, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    radii = np.array([0.08, 0.05, 0.03])
    model = (d * radii).astype(np.float32)
    g = model / radii**2
    mnrm = (g / np.linalg.norm(g, axis=1, keepdims=True)).astype(np.float32)
    true_pose = np.eye(4, dtype=np.float32)
    true_pose[:3, :3] = Rotation.from_euler("xyz", [30, -10, 50], degrees=True).as_matrix()
    true_pose[:3, 3] = [0.1, 0.0, 0.5]
    idx = rng.choice(n_model, n_seg, replace=False)
    seg = (model[idx] @ true_pose[:3, :3].T + true_pose[:3, 3]).astype(np.float32)
    drot = Rotation.from_euler(
        "xyz", rng.uniform(-perturb_deg, perturb_deg, 3), degrees=True).as_matrix()
    init = true_pose.copy()
    init[:3, :3] = drot @ true_pose[:3, :3]
    init[:3, 3] += rng.uniform(-perturb_t, perturb_t, 3)
    return model, mnrm, seg, true_pose, init.astype(np.float32)


def two_inits(init):
    init2 = init.copy()
    init2[:3, 3] += [0.008, -0.006, 0.004]
    return np.stack([init, init2])


def mean_displacement(model, pose_a, pose_b):
    a = model @ pose_a[:3, :3].T + pose_a[:3, 3]
    b = model @ pose_b[:3, :3].T + pose_b[:3, 3]
    return np.mean(np.linalg.norm(a - b, axis=1))


def interpret(fn, *args, **kw):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    with mock.patch.object(pl, "pallas_call", functools.partial(orig, interpret=True)):
        return fn(*args, **kw)


def jax_pass(inits_c, seg_c, mask, model, mnrm, max_corr, precision):
    """(A, b) of the TPU kernel for centred inputs, packed as
    refine_icp_pallas_segside packs them."""
    ns, nm = len(seg_c), len(model)
    pad_ns, pad_nm = (-ns) % 128, (-nm) % 128
    segcat = np.zeros((ns + pad_ns, 128), np.float32)
    segcat[:ns, 0:3] = seg_c
    segcat[:ns, 3] = np.where(mask, (seg_c * seg_c).sum(-1), 1e9)
    segcat[ns:, 3] = 1e9
    segcat[:, 4] = 1.0
    seg_t = np.zeros((128, ns + pad_ns), np.float32)
    seg_t[0:3, :ns] = np.where(mask, seg_c.T, 0.0)
    seg_t[4, :] = 1.0
    model_t = np.zeros((128, nm + pad_nm), np.float32)
    model_t[0:3, :nm] = model.T
    model_t[3, nm:] = 1e9
    model_t[4:7, :nm] = mnrm.T
    a, b = interpret(
        jicp._icp_segside_pass, jnp.asarray(inits_c), jnp.asarray(segcat), jnp.asarray(seg_t),
        jnp.asarray(model_t), max_corr, jicp._ICP_PRECISIONS[precision])
    return np.asarray(a), np.asarray(b)


@pytest.mark.parametrize("precision", [None, "default"])
def test_pass_plain_matches_tpu_kernel_interpret(rng, precision):
    # Tolerances, relative to the largest entry of A resp. b. float32: only
    # the order of the sums differs (1e-5; 7e-7 measured). "default": the same
    # bf16 roundings of d^2, w/ties, s and the Jacobian row, but the TPU kernel
    # also rounds W*col and g to bf16 (2^-9 relative per term, averaging out
    # over the sum) and takes the residual as W (u.n) - n.S instead of
    # sum w (u - s).n: 5e-3 (4e-4 measured).
    model, mnrm, seg, _, init = make_case(rng)
    inits = two_inits(init)
    mask = np.ones(len(seg), bool)
    mask[-5:] = False
    c = seg[mask].mean(0)
    seg_c = (seg - c).astype(np.float32)
    inits_c = inits.copy()
    inits_c[:, :3, 3] -= c
    want_a, want_b = jax_pass(inits_c, seg_c, mask, model, mnrm, 0.02, precision)
    got_a, got_b = icp.icp_segside_pass_plain(
        t(inits_c[:, :3, :].reshape(-1, 12)), icp.pack_icp_segment(t(seg_c), tb(mask)),
        t(model), t(mnrm), 0.02, precision)
    rel = 1e-5 if precision is None else 5e-3
    assert np.abs(want_a).max() > 1.0  # real correspondences
    np.testing.assert_allclose(n(got_a), want_a, atol=rel * np.abs(want_a).max())
    np.testing.assert_allclose(n(got_b), want_b, atol=rel * np.abs(want_b).max())


@pytest.mark.parametrize("precision", [None, "default"])
def test_refine_matches_tpu_refiner_interpret(rng, precision):
    model, mnrm, seg, true_pose, init = make_case(rng)
    inits = two_inits(init)
    mask = np.ones(len(seg), bool)
    mask[-5:] = False
    want = np.asarray(interpret(
        jicp.refine_icp_pallas_segside.__wrapped__, jnp.asarray(inits), jnp.asarray(model),
        jnp.asarray(mnrm), jnp.asarray(seg), jnp.asarray(mask), iters=8,
        matmul_precision=precision))
    got = n(icp.refine_icp_segside(t(inits), t(model), t(mnrm), t(seg), tb(mask), iters=8,
                                   matmul_precision=precision))
    for g, w in zip(got, want):
        assert mean_displacement(model, g, w) < 1e-3
        assert mean_displacement(model, g, true_pose) < 0.004


def test_refine_survives_clutter(rng):
    # Welsch weighting keeps the refiner convergent with a cluttered segment.
    model, mnrm, seg, true_pose, init = make_case(rng, perturb_deg=4, perturb_t=0.008)
    clutter = rng.uniform(-0.3, 0.3, size=(32, 3)).astype(np.float32) + true_pose[:3, 3]
    seg_all = np.concatenate([seg, clutter])
    mask = np.ones(len(seg_all), bool)
    got = n(icp.refine_icp_segside(t(init[None]), t(model), t(mnrm), t(seg_all), tb(mask),
                                   iters=10))[0]
    want = np.asarray(interpret(
        jicp.refine_icp_pallas_segside.__wrapped__, jnp.asarray(init[None]), jnp.asarray(model),
        jnp.asarray(mnrm), jnp.asarray(seg_all), jnp.asarray(mask), iters=10))[0]
    assert mean_displacement(model, got, true_pose) < 0.004
    assert mean_displacement(model, got, want) < 1e-3


@pytest.mark.parametrize("precision", [None, "default"])
def test_hypothesis_without_correspondences_keeps_its_pose(rng, precision):
    # No segment point within max_corr_dist: A = 0, b = 0, the regularised
    # solve gives a zero update and the pose comes back unchanged.
    model, mnrm, seg, _, init = make_case(rng)
    far = init.copy()
    far[:3, 3] += [0.5, 0.5, 0.0]
    inits = np.stack([init, far])
    mask = np.ones(len(seg), bool)
    seg_c, tr_c = lcp.center_at_segment(t(inits), t(seg), tb(mask))
    seg4 = icp.pack_icp_segment(seg_c, tb(mask))
    a, b = icp.icp_segside_pass_plain(tr_c[:, :3, :].reshape(-1, 12), seg4, t(model), t(mnrm),
                                      0.02, precision)
    assert float(a[0].abs().max()) > 0 and float(a[1].abs().max()) == 0
    assert float(b[1].abs().max()) == 0
    got = n(icp.refine_icp_segside(t(inits), t(model), t(mnrm), t(seg), tb(mask), iters=3,
                                   matmul_precision=precision))
    np.testing.assert_allclose(got[1], far, atol=1e-6)
    assert np.abs(got[0] - init).max() > 1e-3
    # A wholly masked segment moves nothing either.
    none = n(icp.refine_icp_segside(t(inits), t(model), t(mnrm), t(seg),
                                    tb(np.zeros(len(seg), bool)), iters=2))
    np.testing.assert_allclose(none, inits, atol=1e-6)


def test_refine_segside_equals_refine_icp(rng):
    # The same function as refine_icp(point_to_plane=True, exact_trim=False,
    # nn_refresh=1), computed in the centred frame: poses within 1e-4.
    model, mnrm, seg, _, init = make_case(rng)
    inits = two_inits(init)
    mask = np.ones(len(seg), bool)
    mask[-5:] = False
    args = (t(inits), t(model), t(mnrm), t(seg), tb(mask))
    want = n(icp.refine_icp(*args, iters=8, point_to_plane=True, exact_trim=False, nn_refresh=1))
    got = n(icp.refine_icp_segside(*args, iters=8))
    assert np.abs(want - inits).max() > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_kernel_wrapper_takes_only_cuda_tensors():
    args = (torch.zeros(2, 12), torch.zeros(5, 4), torch.zeros(7, 3), torch.zeros(7, 3))
    before = icp.icp_corr_segside.launches
    with pytest.raises(ValueError, match="CUDA"):
        icp.icp_corr_segside(*args)
    a, b = icp.icp_segside_pass(*args)  # CPU tensors: the plain version
    assert a.shape == (2, 6, 6) and b.shape == (2, 6)
    assert icp.icp_corr_segside.launches == before
    with pytest.raises(ValueError, match="matmul_precision"):
        icp.refine_icp_segside(torch.eye(4)[None], *args[2:], torch.zeros(5, 3),
                               torch.ones(5, dtype=torch.bool), matmul_precision="high3")


# ------------------------------------------- ragged shapes and constructed ties
# The cases chip_smoke.py ([icp]) holds the CUDA kernel to on the card, held
# here plain-against-TPU: models and segments that the kernel's tiling (four
# model slices, tiles of 512 segment points) makes ragged, a wholly masked
# segment, and model points that tie exactly across the slices.

# Ties at Nm = 256, where the kernel's slices start at 0, 64, 128 and 192:
# (copy, original), the copy at the original's coordinates with its own normal.
TIED_MODEL = ((64, 0), (127, 63), (255, 64), (192, 191), (150, 10))


def ragged_case(rng, n_model, n_seg, twist):
    model, mnrm, seg, true_pose, init = make_case(rng, n_model=max(n_model, n_seg), n_seg=n_seg)
    model, mnrm = model[:n_model].copy(), mnrm[:n_model].copy()
    mask = np.ones(n_seg, bool)
    if twist == "all_masked":
        mask[:] = False
    elif twist == "ties":
        for copy, orig in TIED_MODEL:
            model[copy] = model[orig]
    return model, mnrm, seg, two_inits(init), mask


# (n_model, n_seg, twist)
RAGGED = {
    "nm1": (1, 40, None),
    "nm33": (33, 60, None),
    "nm130": (130, 97, None),
    "ns1": (128, 1, None),
    "ns200": (256, 200, None),
    "all_masked": (128, 96, "all_masked"),
    "ties_across_slices": (256, 160, "ties"),
}


@pytest.mark.parametrize("precision", [None, "default"])
@pytest.mark.parametrize("name", list(RAGGED))
def test_pass_plain_matches_tpu_kernel_interpret_on_ragged_and_tied_cases(rng, name, precision):
    # The tolerances of test_pass_plain_matches_tpu_kernel_interpret.
    n_model, n_seg, twist = RAGGED[name]
    model, mnrm, seg, inits, mask = ragged_case(rng, n_model, n_seg, twist)
    c = seg[mask].mean(0) if mask.any() else np.zeros(3, np.float32)
    seg_c = (seg - c).astype(np.float32)
    inits_c = inits.copy()
    inits_c[:, :3, 3] -= c
    want_a, want_b = jax_pass(inits_c, seg_c, mask, model, mnrm, 0.02, precision)
    tr12 = t(inits_c[:, :3, :].reshape(-1, 12))
    seg4 = icp.pack_icp_segment(t(seg_c), tb(mask))
    got_a, got_b = icp.icp_segside_pass_plain(tr12, seg4, t(model), t(mnrm), 0.02, precision)
    rel = 1e-5 if precision is None else 5e-3
    if twist == "all_masked":
        assert np.abs(want_a).max() == 0.0 and float(got_a.abs().max()) == 0.0
        assert np.abs(want_b).max() == 0.0 and float(got_b.abs().max()) == 0.0
        return
    assert np.abs(want_a).max() > 0.0  # real correspondences
    np.testing.assert_allclose(n(got_a), want_a, atol=rel * np.abs(want_a).max())
    np.testing.assert_allclose(n(got_b), want_b, atol=rel * np.abs(want_b).max())
    if twist == "ties":
        # The copies' normals made the originals': A moves, so correspondences
        # really found the ties and shared their weight.
        same = mnrm.copy()
        for copy, orig in TIED_MODEL:
            same[copy] = mnrm[orig]
        moved = icp.icp_segside_pass_plain(tr12, seg4, t(model), t(same), 0.02, precision)[0]
        assert float((moved - got_a).abs().max()) > 1e-3 * float(got_a.abs().max())
