"""Port parity: the network strategies of pipeline/segmentation.py
(build_prob_images in FCN, FCNThreshold, RCNN and RCNNThreshold mode,
threshold_prob_images, bbox_prob_images, segment_count) against the JAX
package, mirroring tests/test_segmentation_semantics.py. The masks are flat
{0, 1} images on the host: held exactly."""

import numpy as np
import pytest
import torch

from physimglobalpose_tpu.models import fcn as jfcn
from physimglobalpose_tpu.pipeline import segmentation as jseg
from physimglobalpose_tpu_torch.models import fcn
from physimglobalpose_tpu_torch.pipeline import segmentation


def _both(strategy, ids, **kw):
    got = segmentation.build_prob_images(strategy, ids, **kw)
    want = jseg.build_prob_images(strategy, ids, **kw)
    assert set(got) == set(want)
    for c in want:
        assert got[c].dtype == np.float32
        np.testing.assert_array_equal(got[c], want[c])
    return got


def _predictor_with_sentinels(prob_by_class, label, bg):
    def predictor(color, wanted_ids):
        out = {c: prob_by_class[c] for c in wanted_ids}
        out[fcn.PREDICTOR_LABEL_KEY] = label
        out[fcn.PREDICTOR_BACKGROUND_KEY] = bg
        return out
    return predictor


def test_sentinel_keys_match_jax():
    assert (fcn.PREDICTOR_LABEL_KEY, fcn.PREDICTOR_BACKGROUND_KEY) == \
        (jfcn.PREDICTOR_LABEL_KEY, jfcn.PREDICTOR_BACKGROUND_KEY)


def test_plain_fcn_uses_flat_argmax_masks():
    h, w = 4, 6
    label = np.zeros((h, w), np.int32)
    label[:, :3], label[:, 3:] = 1, 2
    pred = _predictor_with_sentinels({1: np.full((h, w), 0.7, np.float32),
                                      2: np.full((h, w), 0.9, np.float32)},
                                     label, np.zeros((h, w), np.float32))
    out = _both("FCN", [1, 2], nn_predictor=pred, color=np.zeros((h, w, 3), np.uint8))
    assert set(np.unique(out[1])) <= {0.0, 1.0}
    assert out[1][:, :3].all() and not out[1][:, 3:].any()
    assert out[2][:, 3:].all() and not out[2][:, :3].any()


def test_fcn_threshold_gates_on_net_background_channel():
    h, w = 4, 6
    p1 = np.zeros((h, w), np.float32)
    p1[:, :4] = 0.6
    bg = np.zeros((h, w), np.float32)
    bg[:, 2:] = 0.95
    pred = _predictor_with_sentinels({1: p1}, np.zeros((h, w), np.int32), bg)
    out = _both("FCNThreshold", [1], nn_predictor=pred, color=np.zeros((h, w, 3), np.uint8),
                threshold=0.8)
    assert out[1][:, :2].all() and not out[1][:, 2:].any()


def test_fcn_threshold_derived_background_fallback():
    h, w = 3, 4
    p1 = np.zeros((h, w), np.float32)
    p1[:, :2] = 0.9
    out = _both("FCNThreshold", [1], nn_predictor=lambda c, ids: {1: p1},
                color=np.zeros((h, w, 3), np.uint8), threshold=0.8)
    assert out[1][:, :2].all() and not out[1][:, 2:].any()


def test_plain_fcn_fallback_thresholds_soft_maps():
    h, w = 3, 4
    p1 = np.zeros((h, w), np.float32)
    p1[:, 0], p1[:, 1] = 0.5, 0.1
    out = _both("FCN", [1], nn_predictor=lambda c, ids: {1: p1},
                color=np.zeros((h, w, 3), np.uint8))
    assert out[1][:, 0].all() and not out[1][:, 1:].any()


def test_threshold_prob_images_matches_jax(rng):
    maps = {c: np.where(rng.uniform(size=(20, 30)) > 0.5, rng.uniform(size=(20, 30)), 0.0)
            .astype(np.float32) for c in (1, 4)}
    bg = rng.uniform(size=(20, 30)).astype(np.float32)
    for thr in (0.5, 0.8):
        got = segmentation.threshold_prob_images(maps, bg, thr)
        want = jseg.threshold_prob_images(maps, bg, thr)
        for c in maps:
            np.testing.assert_array_equal(got[c], want[c])
    got = segmentation.threshold_prob_images(maps, bg)
    assert np.array_equal(got[1] > 0, (maps[1] > 0) & (bg < 0.8))


def test_bbox_prob_images_matches_jax():
    boxes = {2: (3, 4, 10, 8), 5: (0.0, 0.0, 19.6, 2.2), 7: (15, 10, 40, 40)}
    for scores in (None, {2: 0.5}):
        got = segmentation.bbox_prob_images(boxes, 16, 20, scores)
        want = jseg.bbox_prob_images(boxes, 16, 20, scores)
        for c in boxes:
            np.testing.assert_array_equal(got[c], want[c])
    got = segmentation.bbox_prob_images(boxes, 16, 20)
    assert got[2].sum() == 8 * 5 and got[2][4:9, 3:11].all()  # inclusive corners


@pytest.mark.parametrize("strategy", ["RCNN", "RCNNThreshold"])
def test_rcnn_strategies_fill_boxes(strategy):
    color = np.zeros((30, 40, 3), np.uint8)
    out = _both(strategy, [1, 3, 6], color=color,
                detector=lambda c, ids: {1: (2, 3, 12, 9), 6: (30, 20, 39, 29)})
    assert out[1].sum() == 11 * 7 and not out[3].any()  # undetected: empty mask
    assert out[6][20:, 30:].all()


def test_unknown_and_incomplete_strategies_raise():
    with pytest.raises(ValueError, match="unknown"):
        segmentation.build_prob_images("BOGUS", [1])
    for strategy in ("GT", "FCN", "RCNN"):
        with pytest.raises(ValueError):
            segmentation.build_prob_images(strategy, [1])


def test_segment_count():
    seg = segmentation.Segment3D(torch.zeros(5, 3), torch.zeros(5, 3), torch.zeros(5),
                                 torch.tensor([True, False, True, True, False]))
    assert int(segmentation.segment_count(seg)) == 3
