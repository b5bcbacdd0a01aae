"""Port parity: models/detect.py (the CenterNet detector from the converted
shipped weights, decode_boxes with its ties, the box predictor) and
pipeline/detector.py (connected components, depth proposals, size matching,
NMS, the learned and FCN detectors) against the JAX package, on numpy inputs
from a seed and on chip_smoke.py's ray-cast three-box scene in the training
renders' colours.

Tolerances: the bf16 forward's heat and size within 5e-2 of the largest
|output| (tests/test_torch_fcn.py's bf16 bar); decoding exact on exact
inputs; the shipped box predictor's top box per class within 1 px wherever
its score is >= 0.05, scores within 1e-2; the host helpers exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from chip_smoke import camera_pose, render_scene, shade_scene
from physimglobalpose_tpu.models import detect as jdetect
from physimglobalpose_tpu.pipeline import detector as jdetector
from physimglobalpose_tpu_torch.models import detect, fcn
from physimglobalpose_tpu_torch.pipeline import detector

TOL_BF16 = 5e-2


@pytest.fixture(scope="module")
def scene_image():
    depth, label = render_scene(camera_pose())
    return shade_scene(depth, label), label


def test_centernet_forward_from_shipped_weights(rng):
    flat, meta = fcn.load_params_npz(detect.shipped_checkpoint_path())
    assert meta["model"] == "CenterNetDetector" and meta["input_size"] == [240, 320]
    jparams, _ = jdetect.load_params_npz(jdetect.shipped_checkpoint_path())
    jmodel = jdetect.CenterNetDetector(num_classes=meta["num_classes"], width=meta["width"])
    model = fcn.load_flax_params(detect.CenterNetDetector(meta["num_classes"], meta["width"]), flat)
    x = rng.uniform(size=(1, 96, 136, 3)).astype(np.float32)  # 96 x 136: odd grids at /8
    jheat, jsize = jmodel.apply({"params": jparams}, jnp.asarray(x))
    with torch.no_grad():
        heat, size = model(torch.as_tensor(x).permute(0, 3, 1, 2))
    for got, want in ((heat, jheat), (size, jsize)):
        got, want = got.permute(0, 2, 3, 1).numpy(), np.asarray(want)
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.abs(got - want).max() <= TOL_BF16 * np.abs(want).max()


def test_centernet_forward_float32_matches_flax(rng):
    # Random weights at width 8, float32: the layers and the SAME padding of
    # the three stride-2 blocks, without bf16 rounding.
    jmodel = jdetect.CenterNetDetector(num_classes=detect.NUM_CLASSES, width=8, dtype=jnp.float32)
    x = rng.uniform(size=(1, 64, 80, 3)).astype(np.float32)
    params = jmodel.init(jax.random.key(0), jnp.asarray(x))["params"]
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    model = fcn.load_flax_params(
        detect.CenterNetDetector(detect.NUM_CLASSES, width=8, dtype=torch.float32), flat)
    jheat, jsize = jmodel.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        heat, size = model(torch.as_tensor(x).permute(0, 3, 1, 2))
    assert heat.shape == (1, detect.NUM_CLASSES, 8, 10)
    np.testing.assert_allclose(heat.permute(0, 2, 3, 1).numpy(), np.asarray(jheat), atol=1e-4)
    np.testing.assert_allclose(size.permute(0, 2, 3, 1).numpy(), np.asarray(jsize), atol=1e-4)


def _decode_both(logits, size, top=9):
    jb, js = jdetect.decode_boxes(jnp.asarray(logits), jnp.asarray(size), top=top)
    tb_, ts = detect.decode_boxes(torch.as_tensor(logits), torch.as_tensor(size), top=top)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tb_.numpy(), np.asarray(jb), atol=1e-4)
    return tb_.numpy(), ts.numpy()


def test_decode_inverts_targets():
    label = np.zeros((240, 320), np.int32)
    label[60:120, 80:200] = 3
    label[150:200, 30:90] = 8
    heat, size, _ = jdetect.make_targets(label, detect.NUM_CLASSES)
    h = np.clip(heat, 1e-5, 1 - 1e-5)
    boxes, scores = _decode_both(np.log(h / (1 - h)).astype(np.float32), size)
    assert boxes.shape == (detect.NUM_CLASSES, 9, 4) and scores.shape == (detect.NUM_CLASSES, 9)
    for cid, gt in [(3, (80, 60, 199, 119)), (8, (30, 150, 89, 199))]:
        assert scores[cid - 1, 0] > 0.9
        np.testing.assert_allclose(boxes[cid - 1, 0], gt, atol=1.5 * detect.STRIDE)


def test_decode_ties_keep_jax_order(rng):
    # Plateaus of equal logits (every cell of a plateau is its own 3x3
    # maximum, so each is a peak of the same score) and all-equal channels:
    # the top 9 are decided by index order alone.
    logits = np.full((12, 16, 4), -3.0, np.float32)
    logits[2:5, 3:7, 0] = 2.0  # a 3x4 plateau: 12 tied peaks
    logits[:, :, 1] = 0.5  # one flat channel: every cell ties
    logits[6, 6, 2], logits[9, 12, 2] = 1.0, 1.0  # two tied isolated peaks
    logits[:, :, 3] = rng.choice([-1.0, 1.0], size=(12, 16))
    size = rng.normal(0, 0.5, size=(12, 16, 2)).astype(np.float32)
    _, scores = _decode_both(logits, size)
    assert (scores[0] == scores[0, 0]).all() and (scores[1] == scores[1, 0]).all()


def test_shipped_box_predictor_matches_jax(scene_image):
    img, label = scene_image
    jboxes, jscores = jdetect.load_shipped_box_predictor()(img)
    boxes, scores = detect.load_shipped_box_predictor(device="cpu")(img)
    assert boxes.shape == jboxes.shape == (detect.NUM_CLASSES, 9, 4)
    assert np.abs(scores - jscores).max() <= 1e-2
    fired = jscores[:, 0] >= 0.05
    assert fired[1] and fired.sum() >= 2  # box_b (class 2) at least
    assert np.abs(boxes[fired, 0] - jboxes[fired, 0]).max() <= 1.0
    assert (boxes[..., 0::2] <= 639).all() and (boxes[..., 1::2] <= 479).all() and (boxes >= 0).all()
    ys, xs = np.nonzero(label == 2)
    tl, br = boxes[1, 0, :2], boxes[1, 0, 2:]
    assert tl[0] < xs.mean() < br[0] and tl[1] < ys.mean() < br[1]


def test_connected_components_and_depth_proposals(rng):
    mask = rng.uniform(size=(24, 30)) > 0.55
    np.testing.assert_array_equal(detector.connected_components(mask),
                                  jdetector.connected_components(mask))
    depth = np.zeros((64, 80), np.float32)
    depth[8:24, 8:28] = 0.5
    depth[40:52, 50:62] = 0.6
    depth[30:33, 2:4] = 0.7  # below min_pixels
    intr = np.array([[100.0, 0, 40], [0, 100.0, 32], [0, 0, 1]])
    got = detector.depth_cluster_boxes(depth, intr, min_pixels=50)
    assert got == jdetector.depth_cluster_boxes(depth, intr, min_pixels=50) and len(got) == 2


class _Obj:
    def __init__(self, diameter):
        self.diameter = diameter


class _DB:
    """The two fields make_size_matching_detector reads of an ObjectDB."""

    def __init__(self, diameters):
        self.objs = {f"obj{c}": _Obj(d) for c, d in diameters.items()}

    def __getitem__(self, name):
        return self.objs[name]

    def name_for_class(self, c):
        return f"obj{c}"


def test_size_matching_detector_matches_jax():
    depth = np.zeros((96, 128), np.float32)
    depth[8:40, 8:56] = 0.5  # ~0.24 m across at fx 100
    depth[60:76, 90:106] = 0.5  # ~0.08 m
    intr = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    db = _DB({1: 0.09, 2: 0.25, 3: 0.5})
    args = (np.zeros((96, 128, 3), np.uint8), [1, 2, 3])
    got = detector.make_size_matching_detector(db, lambda: (depth, intr))(*args)
    assert got == jdetector.make_size_matching_detector(db, lambda: (depth, intr))(*args)
    # Largest diameter first: class 3 takes the nearer extent, class 2 the
    # other proposal, class 1 is left without one.
    assert set(got) == {2, 3} and got[3][0] == 8


def test_nms_boxes_matches_jax(rng):
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60], [0, 0, 10, 10]], float)
    scores = np.array([0.9, 0.8, 0.7, 0.95])
    keep = detector.nms_boxes(boxes, scores, iou_threshold=0.3)
    np.testing.assert_array_equal(keep, jdetector.nms_boxes(boxes, scores, iou_threshold=0.3))
    assert list(keep) == [3, 2]
    xy = rng.uniform(0, 80, size=(40, 2))
    many = np.concatenate([xy, xy + rng.uniform(5, 30, size=(40, 2))], axis=1)
    s = rng.uniform(size=40)
    for thr in (0.1, 0.3, 0.8):
        np.testing.assert_array_equal(detector.nms_boxes(many, s, thr),
                                      jdetector.nms_boxes(many, s, thr))


def test_learned_detector_callable_contract():
    def fake_predictor(color):
        boxes = np.zeros((detect.NUM_CLASSES, 9, 4))
        scores = np.zeros((detect.NUM_CLASSES, 9))
        boxes[2, 0] = [10, 20, 100, 120]
        scores[2, 0] = 0.9
        scores[7, 0] = 0.01  # below min_score
        return boxes, scores

    img = np.zeros((240, 320, 3), np.uint8)
    got = detector.make_learned_detector(box_predictor=fake_predictor)(img, [3, 8], fcn_fallback=False)
    want = jdetector.make_learned_detector(box_predictor=fake_predictor)(img, [3, 8],
                                                                         fcn_fallback=False)
    assert got == want == {3: (10, 20, 100, 120)}


def test_shipped_learned_detector_with_fcn_fallback_matches_jax(scene_image):
    # The shipped networks on the CPU: the detector for the classes it finds,
    # the prior FCN with TTA for the rest (class 1 scores below 0.05 here).
    img, _ = scene_image
    ids = [1, 2, 3]
    got = detector.make_learned_detector(device="cpu")(img, ids)
    want = jdetector.make_learned_detector()(img, ids)
    assert set(got) == set(want) and 2 in got
    for c in got:
        assert np.abs(np.subtract(got[c], want[c])).max() <= 1, c


def test_fcn_detector_matches_jax():
    h, w = 60, 80
    maps = {c: np.zeros((h, w), np.float32) for c in (2, 3, 5)}
    maps[2][10:30, 10:40] = 0.9
    maps[3][11:29, 11:39] = 0.6  # IoU ~0.84 with class 2: suppressed
    maps[5][50:52, 70:72] = 0.99  # below min_pixels
    pred = lambda color, ids: {c: maps[c] for c in ids}  # noqa: E731
    args = (np.zeros((h, w, 3), np.uint8), [2, 3, 5])
    got = detector.make_fcn_detector(predictor=pred, prob_threshold=0.5, min_pixels=50)(*args)
    assert got == jdetector.make_fcn_detector(predictor=pred, prob_threshold=0.5,
                                              min_pixels=50)(*args)
    assert got == {2: (10, 10, 39, 29)}
