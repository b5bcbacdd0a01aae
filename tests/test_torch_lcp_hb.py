"""Port parity for the hypothesis-block LCP kernel (csrc/lcp_segside.cu,
lcp_segside_hb_kernel): its plain version agrees with the TPU kernel it stands
for (_lcp_kernel_segside_hb, run in Pallas interpret mode) on strained inputs:
model points at delta from a segment point, far hypotheses, a 1 m box, a
segment of one point, an all-masked segment and exact ties. The CUDA kernel is
held to the plain version on the same kinds of input on the card by
chip_smoke.py ([lcp-hb])."""

import functools
import math
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import CPU, n, t
from physimglobalpose_tpu.ops import lcp as jlcp
from physimglobalpose_tpu_torch import kernel_inputs as ki
from physimglobalpose_tpu_torch.ops import lcp

DELTA = 0.005


def _interpret_hb(jargs, **kw):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    with mock.patch.object(pl, "pallas_call", functools.partial(orig, interpret=True)):
        return np.asarray(jlcp.lcp_scores_pallas_segside.__wrapped__(
            *jargs, hb_lane_pack=True, **kw))


def _ties(args, offsets=(40,)):
    """The first 8 segment points placed again `offset` rows on, with their
    own normals and probabilities: exact ties of the nearest distance."""
    spts, smask = args[3], args[6]
    smask[:8] = True
    for off in offsets:
        spts[off:off + 8] = spts[:8]
        smask[off:off + 8] = True
    return args


def _masked(args):
    args[6][:] = False
    return args


# Small versions of the cases chip_smoke.py builds for [lcp-hb], on the CPU.
CASES = {
    "random": lambda: ki.lcp_inputs(80, 6, 64, 60, 4, CPU),
    "at_delta": lambda: ki.at_delta_inputs(CPU, h=4, n=64, delta=DELTA),
    "far_hypotheses": lambda: ki.far_hypotheses(ki.lcp_inputs(84, 6, 64, 60, 4, CPU)),
    "box_1m": lambda: ki.lcp_inputs(85, 4, 64, 60, 4, CPU, scale=8.0),
    "clutter_wide": lambda: ki.lcp_inputs(83, 4, 64, 60, 4, CPU, scale=3.0),
    "ns1": lambda: ki.lcp_inputs(86, 4, 64, 1, 0, CPU),
    "all_masked": lambda: _masked(ki.lcp_inputs(87, 4, 64, 60, 0, CPU)),
    "ties": lambda: _ties(ki.lcp_inputs(88, 4, 64, 96, 4, CPU)),
}


@pytest.mark.parametrize("tier", [None, "default"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_tpu_hypothesis_block_kernel_interpret(case, tier):
    # Tolerance 2/Nv as in test_torch_lcp.py: the packages sum d2 in other
    # orders, so a point on the delta threshold or an exact tie may flip.
    args = CASES[case]()
    nv = args[1].shape[0]
    jargs = tuple(jnp.asarray(n(a)) for a in args)
    for weighted in (True, False):
        want = _interpret_hb(jargs, weighted=weighted, matmul_precision=tier)
        got = n(lcp.lcp_scores_plain(*args, weighted=weighted, matmul_precision=tier))
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=2.0 / nv)
        if case == "all_masked":
            assert np.abs(got).max() == 0.0 and np.abs(want).max() == 0.0


def test_hb_wrapper_takes_only_cuda_tensors():
    args = (torch.zeros(4, 12), torch.zeros(8, 3), torch.zeros(8, 3), torch.zeros(5, 8),
            DELTA * DELTA, math.cos(math.radians(30.0)), True)
    before = lcp.lcp_segside_hb.launches
    with pytest.raises(ValueError, match="CUDA"):
        lcp.lcp_segside_hb(*args)
    with pytest.raises(ValueError, match="high3"):
        lcp.lcp_segside_hb(*args, matmul_precision="high3")
    assert lcp.lcp_segside_hb.launches == before
    # The dispatcher scores CPU tensors with the plain version.
    case = ki.lcp_inputs(89, 3, 40, 30, 2, CPU)
    assert lcp.uses_hypothesis_block(40, 30)
    np.testing.assert_array_equal(n(lcp.lcp_scores(*case, matmul_precision="default")),
                                  n(lcp.lcp_scores_plain(*case, matmul_precision="default")))
    assert lcp.lcp_segside_hb.launches == before


# Band cases (kernel_inputs.band_inputs): delta^2 on the nearest d2 of one row
# in the tier's plain arithmetic, or one float32 step to either side, with the
# nearest points tied in other 8-point column tiles and 256-point chunks.
@pytest.mark.parametrize("side", [0, 1, -1], ids=["at", "inside", "outside"])
@pytest.mark.parametrize("tier", [None, "default"])
def test_plain_matches_tpu_hypothesis_block_kernel_interpret_on_band_cases(tier, side):
    args = ki.band_inputs(CPU, h=4, n=64, ns=600)
    delta = ki.band_delta(args, tier, side)
    nv = args[1].shape[0]
    jargs = tuple(jnp.asarray(n(a)) for a in args)
    d2 = n(lcp.nearest_d2_plain(args[0], args[1], args[3], args[6], tier))
    on_edge = np.float32(delta * delta)
    # The row (and its twin under the other identity hypothesis) sits on the
    # edge as the side says: at it, one step within, one step beyond.
    assert ((d2 == on_edge) if side == 0 else (d2 < on_edge) if side > 0 else (d2 > on_edge)).any()
    for weighted in (True, False):
        want = _interpret_hb(jargs, delta=delta, weighted=weighted, matmul_precision=tier)
        got = n(lcp.lcp_scores_plain(*args, delta=delta, weighted=weighted, matmul_precision=tier))
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=2.0 / nv)


def test_band_cases_move_the_scores_where_they_should():
    # One float32 step of delta^2 takes the edge rows in or out, and the copies
    # of the nearest points decide the weighted score (the tie rule's max).
    args = ki.band_inputs(CPU, h=4, n=64, ns=600)
    for tier in (None, "default"):
        at, inside, outside = (lcp.lcp_scores_plain(
            *args, delta=ki.band_delta(args, tier, side), weighted=False, matmul_precision=tier)
            for side in (0, 1, -1))
        assert torch.equal(at, inside) and float((at - outside).max()) > 0.0
        delta = ki.band_delta(args, tier, 0)
        untied = list(args)
        untied[6] = args[6].clone()
        for off in ki.BAND_COPIES:
            untied[6][off:off + 8] = False
        w = lambda a: lcp.lcp_scores_plain(*a, delta=delta, matmul_precision=tier)
        assert float((w(args) - w(untied)).abs().max()) > 0.0


def test_filter_margin_bounds_the_chain_on_random_pairs():
    # The margin of the tensor-core filters (csrc/lcp_segside.cu, filter_eps):
    # for a pair within delta^2 the "default" chain's d2 is within eps / 2 of
    # the exact sum of the same bf16 products, eps = 32 * 2^-23 * (2|u| + delta)^2
    # with |u|^2 as the kernels round it. Pairs placed 0-2 delta apart, points
    # up to 0.4 m from the segment centre.
    rng = np.random.default_rng(7)
    h, nv, ns, delta = 64, 64, 256, 0.005
    seg = rng.uniform(-0.4, 0.4, size=(ns, 3)) * rng.uniform(0.05, 1.0, size=(ns, 1))
    tf = np.tile(np.eye(4), (h, 1, 1))
    tf[:, :3, 3] = rng.normal(scale=0.002, size=(h, 3))
    off = rng.normal(size=(nv, 3))
    off *= (rng.uniform(0, 2 * delta, size=nv) / np.linalg.norm(off, axis=1))[:, None]
    model = seg[rng.choice(ns, size=nv)] + off
    seg_c, tr, model_t = t(seg), t(tf), t(model)
    d2, _ = lcp._lowered_products(tr[:, :3, :3], tr[:, :3, 3], model_t, None, seg_c,
                                  (seg_c * seg_c).sum(-1), None, "default", False)
    u = lcp.rotate_points(tr[:, :3, :3], model_t, tr[:, :3, 3])
    usq = (u[..., 0] * u[..., 0] + u[..., 1] * u[..., 1]) + u[..., 2] * u[..., 2]
    r = lambda x: lcp.round_bf16(x).double()
    s, a = r(seg_c), r(-2.0 * u)
    exact = r((seg_c * seg_c).sum(-1)) + r(usq)[..., None] + torch.einsum("sk,hnk->hns", s, a)
    eps = 32 * 2.0 ** -23 * (2 * torch.sqrt(lcp.round_bf16(usq).double()) + delta) ** 2
    near = d2.double() <= delta * delta + eps[..., None]
    assert int(near.sum()) > 1000
    err = (d2.double() - exact).abs()
    assert bool((err[near] <= (eps[..., None] / 2).expand_as(err)[near]).all())


def test_hb_units_take_only_cuda_tensors():
    # The measurement entry points refuse CPU tensors and "high3" as the
    # wrapper does, and count nothing.
    args = (torch.zeros(4, 12), torch.zeros(8, 3), torch.zeros(8, 3), torch.zeros(5, 8),
            DELTA * DELTA, math.cos(math.radians(30.0)), False)
    before = lcp.lcp_segside_hb.launches
    for unit in (lcp._HB_UNIT_CUDA_CORES, lcp._HB_UNIT_TENSOR_CORES):
        with pytest.raises(ValueError, match="CUDA"):
            lcp._lcp_segside_hb_on_unit(unit, *args, matmul_precision="default")
        with pytest.raises(ValueError, match="high3"):
            lcp._lcp_segside_hb_on_unit(unit, *args, matmul_precision="high3")
    assert lcp.lcp_segside_hb.launches == before


def test_integer_min_of_d2_bits_clamped_at_zero_is_the_float_min_clamped():
    # What the tensor-core filter relies on (csrc/lcp_segside.cu, hb_min): the
    # signed-integer minimum of float32 bit patterns, clamped at 0, is
    # max(float minimum, 0), for rows with negative values (-0 included),
    # +inf padding and the masked points' 1e9.
    rng = np.random.default_rng(11)
    d2 = rng.normal(scale=1e-4, size=(4000, 64)).astype(np.float32)
    d2[::3] = np.abs(d2[::3])  # rows with no negative value
    d2[1::7, 5] = -0.0
    d2[2::5, 9] = np.inf
    d2[3::11, 13] = 1e9
    bits_min = d2.view(np.int32).min(axis=1)
    got = np.maximum(bits_min, 0).astype(np.int32).view(np.float32)
    want = np.maximum(d2.min(axis=1), np.float32(0.0))
    np.testing.assert_array_equal(got, want)
    assert (d2.min(axis=1) < 0).any() and (d2.min(axis=1) > 0).any()
