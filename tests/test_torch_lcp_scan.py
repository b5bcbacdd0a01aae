"""lcp_segside's scan of the valid segment points (csrc/lcp_segside.cu): the
kernel stages only a segment's valid points (|s|^2 not ops/lcp._BIG) in index
order and scans to their count rounded up to ops/lcp.SCAN_CHUNK; it adds the
points it scanned to the device's scan counter (ops/lcp.take_scan_counts).

Tests marked `card` hold the kernel on the card to itself on the same rows of
the packed segment packed densely (the valid rows in order, then masked rows up
to a multiple of 128), bit for bit, on the CUDA cores in every tier, weighted
and not, and to lcp_scores_plain; and the counter to the mask. They skip
without a card:

    python -m pytest tests/test_torch_lcp_scan.py -q -m card --noconftest

(--noconftest: the suite's conftest sets JAX up, which the card's machine need
not have; this file imports no JAX.) The CPU test holds the counters of an
estimate_pose's hypotheses span to the segments it scored.
"""

import math

import pytest
import torch

from physimglobalpose_tpu_torch.ops import lcp


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _dense(segcat):
    """The valid rows of a packed segment in order, then masked rows (|s|^2
    _BIG, all else 0) up to a multiple of 128 (128 when none is valid)."""
    rows = segcat[segcat[:, 3] != lcp._BIG]
    pad = torch.zeros((-rows.shape[0]) % 128 or (128 if rows.shape[0] == 0 else 0), 8,
                      dtype=segcat.dtype, device=segcat.device)
    pad[:, 3] = lcp._BIG
    return torch.cat([rows, pad]).contiguous()


def _valid_case(name, device):
    """lcp_inputs args of a named case: "interleaved" (700 of 1,024 masked at
    random), "masked_first" (the first 400 of 600), "valid_<n>" (n valid rows
    at random among 1,024, or 2,048 for n above 1,000), and the tie rows of
    chip_smoke.RAGGED_LCP with every third row between the tied points masked."""
    from chip_smoke import RAGGED_LCP, ragged_lcp_inputs
    from physimglobalpose_tpu_torch import kernel_inputs

    if name == "interleaved":
        return kernel_inputs.lcp_inputs(41, 64, 1000, 1024, 700, device), []
    if name == "masked_first":
        args = kernel_inputs.lcp_inputs(42, 64, 1000, 600, 0, device)
        args[6][:400] = False
        return args, []
    if name.startswith("valid_"):
        n_valid = int(name[len("valid_"):])
        ns = 2048 if n_valid > 1000 else 1024
        return kernel_inputs.lcp_inputs(43 + n_valid, 64, 1000, ns, ns - n_valid, device), []
    _label, seed, h, nv, ns, masked, twist = next(r for r in RAGGED_LCP if r[0] == name)
    args, copies = ragged_lcp_inputs(seed, h, nv, ns, masked, twist, device)
    tied = set(range(16)) | set(copies)
    holes = [r for r in range(1, max(copies)) if r % 3 == 1 and r not in tied]
    args[6][holes] = False
    return args, copies


VALID_CASES = ("interleaved", "masked_first", "valid_0", "valid_1", "valid_31", "valid_32",
               "valid_33", "valid_1023", "valid_1024", "tie_one_chunk", "tie_two_chunks",
               "tie_three_chunks", "tie_shared_bit")


@pytest.mark.card
@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "unweighted"])
@pytest.mark.parametrize("precision", [None, "default", "high3"])
@pytest.mark.parametrize("name", VALID_CASES)
def test_card_scan_of_valid_points_equals_the_dense_segment(card, name, precision, weighted):
    from physimglobalpose_tpu_torch import kernel_inputs

    args, copies = _valid_case(name, card)
    tr12, mpts, mnrm, segcat, delta2, cos_gate = kernel_inputs.packed_lcp_args(args)
    dense = _dense(segcat)
    assert dense.shape[0] % 128 == 0 and dense.shape[0] < segcat.shape[0] + 128

    def run(seg):
        return lcp._lcp_segside_on_unit(lcp._UNIT_CUDA_CORES, tr12, mpts, mnrm, seg, delta2,
                                        cos_gate, weighted, precision)

    got, want = run(segcat), run(dense)
    assert torch.equal(got, want)
    # And the plain version within 2 / Nv (its float32 d2 rounds otherwise).
    plain = lcp.lcp_scores_plain(*args, weighted=weighted, matmul_precision=precision)
    assert float((got - plain).abs().max()) <= 2.0 / mpts.shape[0]
    n_valid = int(args[6].sum())
    if n_valid == 0:
        assert float(got.abs().max()) == 0.0
    elif n_valid >= 31:
        assert float(got.max()) > 0.0
    if copies and weighted:  # the ties decide the scores
        keep = args[6].clone()
        keep[copies] = False
        untied = lcp.lcp_scores_plain(*args[:6], keep, weighted=True, matmul_precision=precision)
        assert float((plain - untied).abs().max()) > 0.0


@pytest.mark.card
@pytest.mark.parametrize("name", ["interleaved", "valid_0", "valid_33", "valid_1024"])
def test_card_scan_counter_counts_the_valid_points(card, name):
    args, _ = _valid_case(name, card)
    lcp.take_scan_counts(card)
    lcp.lcp_scores(*args)
    lcp.lcp_scores(*args, weighted=False, matmul_precision="high3")
    torch.cuda.synchronize()
    n_valid, ns = int(args[6].sum()), args[3].shape[0]
    scan = math.ceil(n_valid / lcp.SCAN_CHUNK) * lcp.SCAN_CHUNK
    assert lcp.take_scan_counts(card) == {"lcp_scan_points": 2 * scan, "lcp_slot_points": 2 * ns}
    assert lcp.take_scan_counts(card) == {}
    from physimglobalpose_tpu_torch import _build

    assert _build.load("lcp_segside").lcp_segside_scan_step() == lcp.SCAN_CHUNK


# test_torch_e2e.py's two boxes: (name, class id, extents, centre on the table, yaw deg).
BOXES = (
    ("box_a", 1, (0.12, 0.08, 0.06), (-0.08, 0.02), 25.0),
    ("box_b", 2, (0.07, 0.05, 0.14), (0.07, -0.03), -40.0),
)


def test_hypotheses_span_counts_the_lcp_scan(tmp_path, monkeypatch):
    # A small CPU estimate_pose: its hypotheses span holds the segment points
    # the LCP scan covers (each object's valid count rounded up to a chunk of
    # 32) and the segments' slots, as the kernel counts them on the card.
    from _torch_common import write_scene_dir
    from chip_smoke import camera_pose
    from physimglobalpose_tpu_torch import config as tconfig
    from physimglobalpose_tpu_torch.models import objectdb
    from physimglobalpose_tpu_torch.pipeline import api
    from physimglobalpose_tpu_torch.utils import tracing

    write_scene_dir(tmp_path / "scene", camera_pose(distance=0.6), BOXES, tmp_path)
    cfg = tconfig.PipelineConfig(
        preprocess=tconfig.PreprocessConfig(max_segment_points=384),
        stocs=tconfig.StoCSConfig(num_bases=16, max_quads_per_base=16, max_pairs_per_ppf=64),
        max_model_points=384, max_validation_points=768)
    objs = {nm: objectdb.prepare_object(nm, str(tmp_path / f"{nm}.ply"), cls, [180, 180, 180],
                                        config=cfg, device="cpu")
            for nm, cls, *_ in BOXES}
    db = objectdb.ObjectDB(objs, {o.class_id: nm for nm, o in objs.items()})
    calls = []
    orig = lcp.lcp_scores

    def spy(*args, **kwargs):
        calls.append((int(args[6].sum()), args[6].shape[0]))
        return orig(*args, **kwargs)

    monkeypatch.setattr(lcp, "lcp_scores", spy)
    lcp.take_scan_counts("cpu")  # what earlier tests of this process left
    res = api.estimate_pose(str(tmp_path / "scene"), db, cfg=cfg, seed=0, write_result=False,
                            device="cpu")
    hyp = tracing.record(res.timings["request_id"]).roots[0].find("hypotheses")
    assert len(calls) == len(BOXES)
    assert all(0 < v <= ns for v, ns in calls)
    assert hyp.counts["lcp_scan_points"] == sum(math.ceil(v / 32) * 32 for v, _ in calls)
    assert hyp.counts["lcp_slot_points"] == sum(ns for _, ns in calls)
