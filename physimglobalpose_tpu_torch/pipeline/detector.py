"""Detection-based segmentation support (the RCNN strategy's detector slot).

The reference's RCNN path calls a Faster-RCNN ROS service that returns
per-class bounding boxes (bin/detect_bbox, recognition.py:27-61); the C++
side fills rectangular masks from them (Segmentation.cpp:25-94). A detector
is a callable `(color, class_ids) -> {class: box}`:
- make_learned_detector: the shipped CenterNet detector (models/detect.py),
  with the shipped FCN as region scorer for classes it does not find;
- make_fcn_detector: thresholded FCN blobs, NMS'd;
- make_size_matching_detector: connected components of the table-removed
  depth, matched to the objects by physical size (no weights).
The host-side helpers are numpy copies of the JAX package's; the networks
run on the device they were built on.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def connected_components(mask: np.ndarray) -> np.ndarray:
    """4-connected component labeling (two-pass union-find), host-side."""
    h, w = mask.shape
    labels = np.zeros((h, w), np.int32)
    parent: List[int] = [0]

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    nxt = 1
    for r in range(h):
        for c in range(w):
            if not mask[r, c]:
                continue
            up = labels[r - 1, c] if r > 0 else 0
            left = labels[r, c - 1] if c > 0 else 0
            if up == 0 and left == 0:
                labels[r, c] = nxt
                parent.append(nxt)
                nxt += 1
            elif up and left:
                ru, rl = find(up), find(left)
                labels[r, c] = min(ru, rl)
                parent[max(ru, rl)] = min(ru, rl)
            else:
                labels[r, c] = up or left
    flat = labels.reshape(-1)
    for i in range(len(flat)):
        if flat[i]:
            flat[i] = find(flat[i])
    return labels


def depth_cluster_boxes(
    depth: np.ndarray,
    intrinsics: np.ndarray,
    min_pixels: int = 200,
    max_components: int = 8,
) -> List[Tuple[Tuple[int, int, int, int], float]]:
    """Object proposals from the table-removed depth map.

    Returns [(tl_x, tl_y, br_x, br_y), metric_extent] sorted by area -
    the detector-free stand-in for region proposals.
    """
    # Downsample 4x for the labeling pass (host loop), then scale boxes up.
    d4 = depth[::4, ::4]
    occ = d4 > 0
    labels = connected_components(occ)
    out = []
    for lab in np.unique(labels):
        if lab == 0:
            continue
        ys, xs = np.where(labels == lab)
        if len(ys) * 16 < min_pixels:
            continue
        tl_x, br_x = int(xs.min() * 4), int(xs.max() * 4 + 3)
        tl_y, br_y = int(ys.min() * 4), int(ys.max() * 4 + 3)
        z = float(np.median(d4[ys, xs]))
        # Metric extent of the box at that depth.
        fx = float(intrinsics[0, 0])
        extent = max(br_x - tl_x, br_y - tl_y) * z / fx
        out.append(((tl_x, tl_y, br_x, br_y), extent))
    out.sort(key=lambda e: -(e[0][2] - e[0][0]) * (e[0][3] - e[0][1]))
    return out[:max_components]


def make_size_matching_detector(db, depth_provider):
    """Detector callable assigning proposals to classes by physical size.

    Args:
      db: ObjectDB (for per-object diameters).
      depth_provider: () -> table-removed depth + intrinsics, evaluated lazily
        so the detector sees the current scene's preprocessed depth.
    Returns:
      detector(color, class_ids) -> {class_id: (tl_x, tl_y, br_x, br_y)}.
    """

    def detector(color: np.ndarray, class_ids: Sequence[int]) -> Dict[int, tuple]:
        depth, intrinsics = depth_provider()
        proposals = depth_cluster_boxes(np.asarray(depth), np.asarray(intrinsics))
        wanted = [(c, db[db.name_for_class(c)].diameter) for c in class_ids]
        out: Dict[int, tuple] = {}
        used = set()
        # Greedy match: each class takes the unused proposal whose metric
        # extent is closest to the object's diameter.
        for c, diam in sorted(wanted, key=lambda e: -e[1]):
            best, best_err = None, np.inf
            for i, (box, extent) in enumerate(proposals):
                if i in used:
                    continue
                err = abs(extent - diam)
                if err < best_err:
                    best, best_err = i, err
            if best is not None:
                used.add(best)
                out[c] = proposals[best][0]
        return out

    return detector


def nms_boxes(
    boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.3
) -> np.ndarray:
    """Greedy non-maximum suppression over [N, 4] (tl_x, tl_y, br_x, br_y).

    The detection package's core post-processing (the reference vendors CPU/
    Cython/CUDA variants of exactly this, rcnn lib/nms/*). Returns kept
    indices in descending score order.
    """
    boxes = np.asarray(boxes, np.float64)
    scores = np.asarray(scores, np.float64)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = np.maximum(x2 - x1 + 1, 0) * np.maximum(y2 - y1 + 1, 0)
    order = np.argsort(-scores)
    keep = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(xx2 - xx1 + 1, 0) * np.maximum(yy2 - yy1 + 1, 0)
        iou = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][iou <= iou_threshold]
    return np.asarray(keep, np.int64)




def make_learned_detector(box_predictor=None, top: int = 9, min_score: float = 0.05,
                          device=None):
    """Detector callable around the trained detection network
    (models/detect.load_shipped_box_predictor, built on `device`, the card
    unless device="cpu"). The network returns the top-`top` scored boxes per
    class (recognition.py:27-61); the best one per requested class is taken,
    as Segmentation.cpp:46-51 consumes the service response.

    Returns detector(color, class_ids, fcn_fallback=True) -> {class_id:
    (tl_x, tl_y, br_x, br_y)}. Classes whose best score falls below
    min_score are resolved by the FCN region scorer instead (the "prior"
    checkpoint with TTA 0.5, 0.75, 1.0 when it ships), on the same device:
    the JAX package's serving split between the two networks.
    """
    state = {"fallback": None}

    def detector(color: np.ndarray, class_ids: Sequence[int],
                 fcn_fallback: bool = True) -> Dict[int, tuple]:
        nonlocal box_predictor
        if box_predictor is None:
            from physimglobalpose_tpu_torch.models import detect as detect_mod

            box_predictor = detect_mod.load_shipped_box_predictor(top=top, device=device)
        boxes, scores = box_predictor(color)  # [C, top, 4], [C, top]
        out: Dict[int, tuple] = {}
        missing = []
        for c in class_ids:
            ch = c - 1  # channel = class id - 1 (background has no channel)
            if ch < 0 or ch >= boxes.shape[0] or scores[ch, 0] < min_score:
                missing.append(c)
                continue
            b = boxes[ch, 0]
            out[c] = (int(b[0]), int(b[1]), int(b[2]), int(b[3]))
        if missing and fcn_fallback:
            if state["fallback"] is None:
                import os

                from physimglobalpose_tpu_torch.models import fcn as fcn_mod

                pred = None
                if os.path.exists(fcn_mod.shipped_checkpoint_path("prior")):
                    pred = fcn_mod.load_shipped_predictor(
                        variant="prior", tta_scales=(0.5, 0.75, 1.0), device=device
                    )
                state["fallback"] = make_fcn_detector(predictor=pred, device=device)
            out.update(state["fallback"](color, missing))
        return out

    return detector


def make_fcn_detector(predictor=None, prob_threshold: float = 0.5, min_pixels: int = 100,
                      device=None):
    """Neural detector from a segmentation predictor (the shipped FCN on
    `device` by default): per-class probability maps -> thresholded blobs ->
    NMS'd bounding boxes. Returns detector(color, class_ids) -> {class_id:
    (tl_x, tl_y, br_x, br_y)}."""

    def detector(color: np.ndarray, class_ids: Sequence[int]) -> Dict[int, tuple]:
        nonlocal predictor
        if predictor is None:
            from physimglobalpose_tpu_torch.models import fcn as fcn_mod

            predictor = fcn_mod.load_shipped_predictor(device=device)
        probs = predictor(color, class_ids)
        boxes, scores, classes = [], [], []
        for c in class_ids:
            hard = probs[c] >= prob_threshold
            if hard.sum() < min_pixels:
                continue
            ys, xs = np.nonzero(hard)
            boxes.append((int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())))
            scores.append(float(probs[c][hard].mean()))
            classes.append(c)
        if not boxes:
            return {}
        keep = nms_boxes(np.asarray(boxes, np.float64), np.asarray(scores), iou_threshold=0.8)
        return {classes[i]: boxes[i] for i in keep}

    return detector
