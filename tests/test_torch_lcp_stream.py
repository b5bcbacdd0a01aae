"""Port parity: the streaming LCP formulation (ops/lcp.lcp_scores_stream_plain,
lcp_scores_stream, lcp_scores_stream_wide) against the TPU kernels it stands
for, _lcp_kernel (lcp_scores_pallas) and the experimental _lcp_kernel_wide
(scripts/lcp_wide_kernel_experiment.py, loaded by path), both run in Pallas
interpret mode on the CPU; lcp_scores above the routing constant against the
XLA scorer. The CUDA kernels themselves are held against
lcp_scores_stream_plain on the card by chip_smoke.py.

On the CPU a float32 dot_general ignores Precision.DEFAULT: in interpret mode
the Pallas kernel's "default" tier comes out in full float32 (checked below).
The TPU's matrix unit takes bf16 operands at that precision, so the "default"
cases run the Pallas kernel with dot_general's operands rounded to bf16 and
the sum in float32 (bf16_operand_dot).
"""

import functools
import importlib.util
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import n, t, tb
from physimglobalpose_tpu.ops import lcp as jlcp
from physimglobalpose_tpu_torch.ops import lcp
from test_torch_lcp import RAGGED, _both, make_case, twisted_case

ROOT = pathlib.Path(__file__).resolve().parent.parent


@functools.lru_cache(maxsize=None)
def wide_script():
    path = ROOT / "scripts" / "lcp_wide_kernel_experiment.py"
    spec = importlib.util.spec_from_file_location("lcp_wide_kernel_experiment", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_dot_general = jax.lax.dot_general


def bf16_operand_dot(a, b, dims, precision=None, preferred_element_type=None):
    """dot_general as the TPU runs Precision.DEFAULT: bf16 operands, float32 sum."""
    if precision == jax.lax.Precision.DEFAULT:
        a = a.astype(jnp.bfloat16).astype(jnp.float32)
        b = b.astype(jnp.bfloat16).astype(jnp.float32)
        precision = jax.lax.Precision.HIGHEST
    return _dot_general(a, b, dims, precision=precision,
                        preferred_element_type=preferred_element_type)


def interpret(fn, jargs, lowered_dot=True, **kw):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    dot = bf16_operand_dot if lowered_dot else _dot_general
    with mock.patch.object(pl, "pallas_call", functools.partial(orig, interpret=True)), \
            mock.patch.object(jax.lax, "dot_general", dot):
        return np.asarray(fn.__wrapped__(*jargs, **kw))


# (Nv, Ns, H, masked points): ragged segment sizes, H not a multiple of 8;
# the second also gets a masked tail.
SHAPES = [(300, 200, 21, 12), (512, 333, 13, 40)]


@pytest.mark.parametrize("ns_tile", [64, 128])
@pytest.mark.parametrize("precision", [None, "default", "high3"])
@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "unweighted"])
@pytest.mark.parametrize("shape", SHAPES, ids=["ns200", "ns333"])
def test_stream_plain_matches_tpu_kernel_interpret(rng, shape, weighted, precision, ns_tile):
    # Tolerance 1.5 / Nv in every tier: the packages sum the d^2 terms in
    # different orders, so one point on the delta^2 threshold may flip (1e-5 / Nv
    # measured). "high3" runs in float32 in both packages.
    nv, ns, h, masked = shape
    case = make_case(rng, nv, ns, h, masked)
    if ns == 333:
        case[-1][-40:] = False  # a masked tail besides the scattered masked points
    jargs, targs = _both(case)
    want = interpret(jlcp.lcp_scores_pallas, jargs, weighted=weighted, ns_tile=ns_tile,
                     matmul_precision=precision)
    got = n(lcp.lcp_scores_stream_plain(*targs, weighted=weighted, ns_tile=ns_tile,
                                        matmul_precision=precision))
    assert want.max() > 0.05 and got.shape == (h,)
    np.testing.assert_allclose(got, want, atol=1.5 / nv)


def test_interpret_mode_ignores_default_precision_and_the_tier_is_really_lowered(rng):
    # What the module note says: without the bf16-operand dot the interpreted
    # "default" tier is the float32 one; with it, it is not, and neither is
    # the port's.
    case = make_case(rng, 512, 200, 24, 20)
    jargs, targs = _both(case)
    kw = dict(weighted=False, ns_tile=64)
    f32 = interpret(jlcp.lcp_scores_pallas, jargs, **kw)
    plain_cpu = interpret(jlcp.lcp_scores_pallas, jargs, lowered_dot=False,
                          matmul_precision="default", **kw)
    np.testing.assert_array_equal(plain_cpu, f32)
    lowered = interpret(jlcp.lcp_scores_pallas, jargs, matmul_precision="default", **kw)
    assert np.abs(lowered - f32).max() >= 2.0 / 512
    got = n(lcp.lcp_scores_stream_plain(*targs, matmul_precision="default", **kw))
    assert np.abs(got - n(lcp.lcp_scores_stream_plain(*targs, **kw))).max() >= 2.0 / 512
    np.testing.assert_allclose(got, lowered, atol=1.5 / 512)


def tie_case():
    """One model point at the origin, identity pose; segment points 0 and 64
    are the same place (the nearest), with different probabilities and
    normals: an exact tie of the nearest distance, 64 points apart."""
    rng = np.random.default_rng(5)
    seg = rng.uniform(0.05, 0.2, size=(130, 3)).astype(np.float32)
    seg[0] = seg[64] = [0.001, 0.002, 0.001]
    nrm = np.tile(np.array([[1.0, 0, 0]], np.float32), (130, 1))
    nrm[0] = [0, 0, 1]  # agrees with the model normal; point 64's does not
    prob = np.full(130, 0.5, np.float32)
    prob[0], prob[64] = 0.3, 0.9
    tf = np.eye(4, dtype=np.float32)[None]
    model, mn = np.zeros((1, 3), np.float32), np.array([[0, 0, 1]], np.float32)
    return tf, model, mn, seg, nrm, prob, np.ones(130, bool)


@pytest.mark.parametrize("ns_tile,want", [(64, 0.3), (128, 0.9)], ids=["across_tiles", "one_tile"])
def test_cross_tile_ties_follow_the_tile_rule(ns_tile, want):
    # Tile 64: the tied points lie in two tiles, the later one is ignored, so
    # the first point's probability and normal count (0.3). Tile 128: one
    # tile, max probability 0.9 and max |ndot| 1 over the ties. Both packages.
    case = tie_case()
    jargs, targs = _both(case)
    pallas = interpret(jlcp.lcp_scores_pallas, jargs, ns_tile=ns_tile)
    got = n(lcp.lcp_scores_stream_plain(*targs, ns_tile=ns_tile))
    np.testing.assert_allclose(pallas, [want], atol=1e-6)
    np.testing.assert_allclose(got, [want], atol=1e-6)
    # The segment-stationary formulation takes the max over all ties.
    np.testing.assert_allclose(n(lcp.lcp_scores_plain(*targs)), [0.9], atol=1e-6)


def test_all_masked_segment_scores_zero(rng):
    case = list(make_case(rng, 256, 200, 5, 0))
    case[-1] = np.zeros(200, bool)
    jargs, targs = _both(case)
    for precision in (None, "default"):
        for weighted in (True, False):
            got = lcp.lcp_scores_stream_plain(*targs, weighted=weighted, ns_tile=64,
                                              matmul_precision=precision)
            assert bool(torch.isfinite(got).all()) and float(got.abs().max()) == 0.0
            want = interpret(jlcp.lcp_scores_pallas, jargs, weighted=weighted, ns_tile=64,
                             matmul_precision=precision)
            assert np.abs(want).max() == 0.0


@pytest.mark.parametrize("precision", [None, "default"])
@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "unweighted"])
def test_wide_matches_tpu_wide_kernel_interpret_and_the_stream_kernel(rng, weighted, precision):
    # lcp_scores_stream_wide on the CPU (the wide kernel's plain version: the
    # streaming score at a tile of 128) against lcp_scores_pallas_wide, 1.5 / Nv
    # as above, and against the streaming plain version at the same tile,
    # exactly: one function.
    nv, ns, h = 300, 333, 11
    case = make_case(rng, nv, ns, h, 25)
    jargs, targs = _both(case)
    want = interpret(wide_script().lcp_scores_pallas_wide, jargs, weighted=weighted,
                     matmul_precision=precision)
    got = n(lcp.lcp_scores_stream_wide(*targs, weighted=weighted, matmul_precision=precision))
    assert want.max() > 0.05
    np.testing.assert_allclose(got, want, atol=1.5 / nv)
    same = n(lcp.lcp_scores_stream_plain(*targs, weighted=weighted, ns_tile=128,
                                         matmul_precision=precision))
    np.testing.assert_array_equal(got, same)


def test_wide_has_no_high3_and_stream_degrades_it(rng):
    case = make_case(rng, 128, 150, 5, 5)
    _, targs = _both(case)
    with pytest.raises(ValueError, match="high3"):
        lcp.lcp_scores_stream_wide(*targs, matmul_precision="high3")
    np.testing.assert_array_equal(
        n(lcp.lcp_scores_stream(*targs, matmul_precision="high3")),
        n(lcp.lcp_scores_stream(*targs)))
    with pytest.raises(ValueError, match="matmul_precision"):
        lcp.lcp_scores_stream(*targs, matmul_precision="bf16")


def large_segment_case(rng, n_model, n_seg, n_hyp, n_masked):
    """make_case with more segment points than model points: the object part
    of the segment draws model points with replacement, each with its own
    noise, and the hypotheses sit near the truth."""
    tfs, model, mn, seg, seg_nrm, prob, mask = make_case(rng, n_model, n_model, n_hyp, 0,
                                                         jitter=0.005)
    rot, tr = tfs[0, :3, :3].astype(np.float64), tfs[0, :3, 3].astype(np.float64)
    extra = n_seg - n_model
    idx = rng.choice(n_model, size=extra)
    more = (model[idx] @ rot.T + tr + rng.normal(scale=0.001, size=(extra, 3))).astype(np.float32)
    seg = np.concatenate([seg, more])
    seg_nrm = np.concatenate([seg_nrm, (mn[idx] @ rot.T).astype(np.float32)])
    prob = np.concatenate([prob, rng.uniform(0.5, 1.0, size=extra).astype(np.float32)])
    mask = np.ones(n_seg, bool)
    mask[rng.choice(n_seg, size=n_masked, replace=False)] = False
    return tfs, model, mn, seg, seg_nrm, prob, mask


@pytest.mark.parametrize("n_seg", [2049, 4096])
def test_lcp_scores_above_the_routing_constant_matches_xla(rng, n_seg):
    # Near-exact hypotheses, as test_plain_matches_xla: 1e-4 unweighted,
    # 2 / Nv weighted (the XLA scorer takes the single argmin on a tie).
    nv = 256
    case = large_segment_case(rng, nv, n_seg, 9, 60)
    jargs, targs = _both(case)
    before = lcp.lcp_stream.launches
    for weighted in (True, False):
        want = np.asarray(jlcp.lcp_scores_xla(*jargs, weighted=weighted))
        got = n(lcp.lcp_scores(*targs, weighted=weighted))
        assert want.max() > 0.2
        np.testing.assert_allclose(got, want, atol=2.0 / nv if weighted else 1e-4)
        np.testing.assert_array_equal(got, n(lcp.lcp_scores_stream_plain(*targs, weighted=weighted)))
    assert lcp.lcp_stream.launches == before  # CPU tensors launch nothing


class _Routed(Exception):
    pass


def _jax_route(ns, hb_lane_pack=None):
    """The function jlcp.lcp_scores hands a segment of ns points on its
    kernel branch."""
    def record(name):
        def raise_it(*_a, **_k):
            raise _Routed(name)
        return raise_it

    args = (jnp.zeros((1, 4, 4)), jnp.zeros((8, 3)), jnp.zeros((8, 3)), jnp.zeros((ns, 3)),
            jnp.zeros((ns, 3)), jnp.zeros(ns), jnp.ones(ns, bool))
    with mock.patch.object(jlcp, "lcp_scores_pallas", record("stream")), \
            mock.patch.object(jlcp, "lcp_scores_pallas_segside", record("segside")):
        with pytest.raises(_Routed) as info:
            jlcp.lcp_scores(*args, use_pallas=True, hb_lane_pack=hb_lane_pack)
    return str(info.value)


def _port_route(ns, hb_lane_pack=None):
    def record(name):
        def raise_it(*_a, **_k):
            raise _Routed(name)
        return raise_it

    args = (torch.zeros(1, 4, 4), torch.zeros(8, 3), torch.zeros(8, 3), torch.zeros(ns, 3),
            torch.zeros(ns, 3), torch.zeros(ns), torch.ones(ns, dtype=torch.bool))
    with mock.patch.object(lcp, "lcp_scores_stream", record("stream")), \
            mock.patch.object(lcp, "lcp_scores_plain", record("segside")):
        with pytest.raises(_Routed) as info:
            lcp.lcp_scores(*args, hb_lane_pack=hb_lane_pack)
    return str(info.value)


@pytest.mark.parametrize("ns,want", [(2048, "segside"), (2049, "stream"), (4096, "stream")])
def test_routing_predicate_matches_jax(ns, want):
    assert lcp.MAX_SEGMENT_POINTS == 2048
    for hb_lane_pack in (None, True):  # hb_lane_pack does not apply above the constant
        assert _jax_route(ns, hb_lane_pack) == want
        assert _port_route(ns, hb_lane_pack) == want


def test_stream_tile_defaults_match_the_tpu_wrappers():
    # lcp_scores_pallas: ns_tile = min(1024, pad128(Ns)); the wide wrapper: 128.
    assert [lcp.stream_ns_tile(ns) for ns in (1, 128, 200, 1024, 2049, 4096)] == \
        [128, 128, 256, 1024, 1024, 1024]
    assert lcp.stream_ns_tile(200, 64) == 64
    assert lcp.STREAM_WIDE_NS_TILE == 128


def test_stream_wrappers_take_only_cuda_tensors():
    args = (torch.zeros(4, 12), torch.zeros(8, 3), torch.zeros(8, 3), torch.zeros(3000, 8),
            2.5e-5, 0.866, True)
    for fn in (lcp.lcp_stream, lcp.lcp_stream_wide):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
        with pytest.raises(ValueError, match="high3"):
            fn(*args, matmul_precision="high3")
    # The segment-stationary wrapper names the kernel that takes a larger segment.
    with pytest.raises(ValueError, match="CUDA"):
        lcp.lcp_segside(*args)


def test_fma_is_a_single_rounding():
    # x * y + z rounded once: differs from the twice-rounded float32 expression
    # exactly where the product needs more than 24 bits.
    x = torch.tensor([1.0 + 2.0 ** -12], dtype=torch.float32)
    y = torch.tensor([1.0 + 2.0 ** -12], dtype=torch.float32)
    z = torch.tensor([-1.0], dtype=torch.float32)
    fused = float(lcp.fma(x, y, z))
    assert fused == 2.0 ** -11 + 2.0 ** -24
    assert float(x * y + z) == 2.0 ** -11


# ------------------------------------------- ragged shapes and constructed ties
# The cases chip_smoke.py holds kernel-against-plain on the card, held here
# plain-against-JAX (test_torch_lcp.RAGGED, at a tile of 64 segment points).


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "unweighted"])
@pytest.mark.parametrize("precision", [None, "default"])
@pytest.mark.parametrize("name", list(RAGGED))
def test_stream_plain_matches_tpu_kernel_interpret_on_ragged_and_tied_cases(rng, name, precision,
                                                                            weighted):
    # Tolerance 1.5 / Nv as above. At a tile of 64 the copies of
    # "tie_one_chunk" (16 rows on) tie inside a tile, those of the other tie
    # cases (40 and 70 rows on) fall into later tiles and are ignored.
    nv, ns, h, masked, twist = RAGGED[name]
    case = twisted_case(rng, nv, ns, h, masked, twist)
    jargs, targs = _both(case)
    kw = dict(weighted=weighted, ns_tile=64, matmul_precision=precision)
    want = interpret(jlcp.lcp_scores_pallas, jargs, **kw)
    got = n(lcp.lcp_scores_stream_plain(*targs, **kw))
    assert got.shape == (h,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1.5 / nv)
    if twist == "all_masked":
        assert np.abs(got).max() == 0.0 and np.abs(want).max() == 0.0


@pytest.mark.parametrize("other,ns_tile,want", [(5, 128, 0.9), (40, 128, 0.9), (40, 32, 0.3)],
                         ids=["one_chunk", "two_chunks_one_tile", "two_tiles"])
def test_ties_join_inside_a_tile_only(other, ns_tile, want):
    # tie_case with the second copy of the nearest point `other` rows on: 5
    # rows on it shares a chunk of 32 staged points with the first, 40 rows on
    # it lies in the next chunk; both join while one tile holds them (max
    # probability 0.9, max |ndot| 1), and not across a tile edge (the first
    # copy's 0.3 stays). Both packages.
    tf, model, mn, seg, nrm, prob, mask = tie_case()
    seg[64], nrm[64], prob[64] = seg[65], nrm[65], prob[65]  # undo tie_case's copy at row 64
    seg[other], nrm[other], prob[other] = seg[0], [1.0, 0, 0], 0.9
    jargs, targs = _both((tf, model, mn, seg, nrm, prob, mask))
    for precision in (None, "default"):
        kw = dict(ns_tile=ns_tile, matmul_precision=precision)
        pallas = interpret(jlcp.lcp_scores_pallas, jargs, **kw)
        np.testing.assert_allclose(pallas, [want], atol=1e-6)
        np.testing.assert_allclose(n(lcp.lcp_scores_stream_plain(*targs, **kw)), [want], atol=1e-6)


# Exact ties for the wide kernel (tiles of 128 segment points, chunks of 32 in
# csrc/lcp_stream.cu): the first 8 segment points again at rows 28-35 (across
# a chunk edge inside tile 0), at 124-131 (across the tile edge) and at
# 28, 124 and 200 together.
WIDE_TIES = {"across_chunks": (28,), "across_tile_edge": (124,),
             "chunks_and_tiles": (28, 124, 200)}


@pytest.mark.parametrize("precision", [None, "default"])
@pytest.mark.parametrize("name", list(WIDE_TIES))
def test_wide_ties_match_tpu_wide_kernel_interpret(rng, name, precision):
    # Weighted (where ties decide), 1.5 / Nv as above; the ties must move the
    # plain version's scores, or the case tests nothing.
    nv, ns, h = 256, 300, 33
    case = twisted_case(rng, nv, ns, h, 6, WIDE_TIES[name])
    jargs, targs = _both(case)
    want = interpret(wide_script().lcp_scores_pallas_wide, jargs, matmul_precision=precision)
    got = n(lcp.lcp_scores_stream_wide(*targs, matmul_precision=precision))
    assert got.shape == (h,) and want.max() > 0.05
    np.testing.assert_allclose(got, want, atol=1.5 / nv)
    untied = list(targs)
    untied[6] = targs[6].clone()
    for off in WIDE_TIES[name]:
        untied[6][off:off + 8] = False
    moved = np.abs(n(lcp.lcp_scores_stream_wide(*untied, matmul_precision=precision)) - got).max()
    assert moved > 0.0
