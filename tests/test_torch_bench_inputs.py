"""Port parity: bench_inputs (inputs, production flags, fidelity gates of the
scoring benchmark) against the JAX package's bench.py."""

import numpy as np
import pytest
import torch

import bench
from _torch_common import n, scoring_inputs
from physimglobalpose_tpu_torch import bench_inputs
from physimglobalpose_tpu_torch.ops import scoring

SMALL = dict(h=384, nv=512, nm=128, ns=128)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("clutter", [False, True], ids=["easy", "clutter"])
def test_make_inputs_equals_bench(seed, clutter):
    want = bench.make_inputs(seed=seed, clutter=clutter, **SMALL)
    got = bench_inputs.make_inputs(seed=seed, clutter=clutter, **SMALL)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_constants_and_prod_flags_equal_bench():
    for name in ("H", "NV", "NM", "NS", "ICP_ITERS", "PROD_ICP_ITERS"):
        assert getattr(bench_inputs, name) == getattr(bench, name)
    want = bench.prod_flags(True)
    del want["use_pallas"]  # the tensors' device decides in the port
    assert bench_inputs.prod_flags() == want


def test_to_tensors_keeps_dtypes_and_asks_for_a_device():
    arrays = bench_inputs.make_inputs(**SMALL)
    tensors = bench_inputs.to_tensors(arrays, "cpu")
    assert [x.dtype for x in tensors] == [torch.float32] * 8 + [torch.bool]
    for x, a in zip(tensors, arrays):
        np.testing.assert_array_equal(n(x), a)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bench_inputs.to_tensors(arrays)


@pytest.mark.parametrize("clutter", [False, True], ids=["easy", "clutter"])
def test_fidelity_gate_passes_on_production_and_raises_on_bad(clutter):
    arrays = bench_inputs.make_inputs(seed=0, clutter=clutter, **SMALL)
    inputs = scoring_inputs(arrays)
    flags = dict(bench_inputs.prod_flags(), top_k=256, coarse_subsample=2, coarse_seg_stride=1)
    prod = scoring.score_refine_pipeline(*inputs, **flags)
    got = bench_inputs.fidelity_gate(inputs, prod, clutter)
    assert got["drift_m"] < 0.002
    assert bench_inputs.fidelity_gate(arrays, prod, clutter, device="cpu") == got  # arrays too

    # A deliberately bad production result: the winner moved by 1 cm ...
    moved = prod.top_transforms.clone()
    moved[0, :3, 3] += torch.tensor([0.01, 0.0, 0.0])
    with pytest.raises(AssertionError, match="drifts"):
        bench_inputs.fidelity_gate(inputs, prod._replace(top_transforms=moved), clutter)
    if clutter:
        # ... a coarse ranking that prefers the garbage hypotheses ...
        bad = prod._replace(coarse_scores=-prod.coarse_scores)
        with pytest.raises(AssertionError, match="survive"):
            bench_inputs.fidelity_gate(inputs, bad, clutter)
    else:
        # ... or a winner whose score fell.
        bad = prod._replace(top_scores=prod.top_scores - 0.01)
        with pytest.raises(AssertionError, match="trails"):
            bench_inputs.fidelity_gate(inputs, bad, clutter)
