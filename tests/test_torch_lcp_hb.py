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

from _torch_common import CPU, n
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
