"""Port parity: ops/lcp.lcp_scores_plain against the JAX XLA scorer and
against the TPU kernel it replaces (_lcp_kernel_segside, run in Pallas
interpret mode on the CPU). The CUDA kernel itself is held against
lcp_scores_plain on the card by chip_smoke.py."""

import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from _torch_common import n, t, tb
from physimglobalpose_tpu.ops import lcp as jlcp
from physimglobalpose_tpu_torch.ops import lcp


def make_case(rng, n_model, n_seg, n_hyp, n_masked, jitter=0.05):
    """Model cloud, a noisy cluttered segment of it, hypotheses near the truth
    (rotation jitter in radians, translation jitter in 5 cm / 100 units)."""
    model = rng.uniform(-0.05, 0.05, size=(n_model, 3)).astype(np.float32)
    mn = rng.normal(size=(n_model, 3))
    mn = (mn / np.linalg.norm(mn, axis=1, keepdims=True)).astype(np.float32)
    rot = Rotation.from_euler("xyz", [10, 20, 30], degrees=True).as_matrix()
    tr = np.array([0.05, -0.03, 0.6])
    k = n_seg - n_seg // 5
    idx = rng.choice(n_model, size=k, replace=False)
    seg = model[idx] @ rot.T + tr + rng.normal(scale=0.001, size=(k, 3))
    clutter = rng.uniform(-0.2, 0.2, size=(n_seg - k, 3)) + tr
    seg_pts = np.concatenate([seg, clutter]).astype(np.float32)
    seg_nrm = np.concatenate([mn[idx] @ rot.T, rng.normal(size=(n_seg - k, 3))])
    seg_nrm = (seg_nrm / np.linalg.norm(seg_nrm, axis=1, keepdims=True)).astype(np.float32)
    seg_prob = rng.uniform(0.5, 1.0, size=n_seg).astype(np.float32)
    mask = np.ones(n_seg, bool)
    mask[rng.choice(n_seg, size=n_masked, replace=False)] = False
    tfs = np.tile(np.eye(4, dtype=np.float32), (n_hyp, 1, 1))
    jit = Rotation.from_rotvec(rng.normal(scale=jitter, size=(n_hyp, 3))).as_matrix()
    tfs[:, :3, :3] = jit @ rot
    tfs[:, :3, 3] = tr + rng.normal(scale=0.06 * jitter, size=(n_hyp, 3))
    tfs[-1] = np.eye(4)  # a hypothesis far from everything
    return tfs, model, mn, seg_pts, seg_nrm, seg_prob, mask


def _both(case):
    jargs = tuple(jnp.asarray(a) for a in case)
    targs = tuple(t(a) for a in case[:-1]) + (tb(case[-1]),)
    return jargs, targs


@pytest.mark.parametrize("weighted", [True, False])
def test_plain_matches_xla(rng, weighted):
    # Near-exact hypotheses (as tests/test_lcp.py uses): the XLA scorer works
    # in uncentred coordinates, so a point right at the delta radius may
    # round the other way there.
    case = make_case(rng, 300, 200, 21, 12, jitter=0.005)
    jargs, targs = _both(case)
    want = np.asarray(jlcp.lcp_scores_xla(*jargs, weighted=weighted))
    got = n(lcp.lcp_scores_plain(*targs, weighted=weighted, h_chunk=8))
    assert want.max() > 0.2  # the case exercises real matches
    np.testing.assert_allclose(got, want, atol=1e-5 if not weighted else 2.0 / 300)


def _interpret_segside(jargs, **kw):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    with mock.patch.object(pl, "pallas_call", functools.partial(orig, interpret=True)):
        return np.asarray(jlcp.lcp_scores_pallas_segside.__wrapped__(*jargs, **kw))


@pytest.mark.parametrize(
    "n_model,n_seg,n_hyp",
    [
        (128, 96, 11),  # 8 model copies fit the lane budget: the hypothesis-batched branch
        (2048, 768, 3),  # nv above the budget: the per-hypothesis tiled branch (main path's)
    ],
)
def test_plain_matches_tpu_kernel_interpret(rng, n_model, n_seg, n_hyp):
    case = make_case(rng, n_model, n_seg, n_hyp, 16)
    jargs, targs = _both(case)
    for weighted in (True, False):
        want = _interpret_segside(jargs, weighted=weighted)
        got = n(lcp.lcp_scores_plain(*targs, weighted=weighted))
        tol = 2.0 / n_model if weighted else 1e-5
        np.testing.assert_allclose(got, want, atol=tol)


def test_dispatch_uses_plain_on_cpu(rng):
    case = make_case(rng, 200, 150, 5, 5)
    _, targs = _both(case)
    before = lcp.lcp_segside.launches
    np.testing.assert_array_equal(n(lcp.lcp_scores(*targs)), n(lcp.lcp_scores_plain(*targs)))
    assert lcp.lcp_segside.launches == before


def test_kernel_wrapper_takes_only_cuda_tensors():
    tr12 = torch.zeros(4, 12)
    with pytest.raises(ValueError, match="CUDA"):
        lcp.lcp_segside(tr12, torch.zeros(8, 3), torch.zeros(8, 3), torch.zeros(5, 8),
                        2.5e-5, 0.866, True)


def test_tie_rule_takes_max_prob_and_max_normal():
    # Two segment points at exactly the same place: the model point matches
    # both; the score takes the larger probability.
    seg = np.array([[0, 0, 0.5], [0, 0, 0.5], [1, 1, 1]], np.float32)
    nrm = np.array([[0, 0, 1], [0, 0, 1], [1, 0, 0]], np.float32)
    prob = np.array([0.3, 0.9, 1.0], np.float32)
    tf = np.eye(4, dtype=np.float32)[None]
    got = lcp.lcp_scores_plain(t(tf), t([[0, 0, 0.5]]), t([[0, 0, 1]]), t(seg), t(nrm),
                               t(prob), tb([True, True, True]))
    np.testing.assert_allclose(n(got), [0.9], atol=1e-6)
