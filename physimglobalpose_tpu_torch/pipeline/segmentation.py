"""Segmentation strategies: per-object probability images + 3D segments.

Reference (Segmentation.cpp): five strategies selected by request string -
GT (class mask -> probability 1.0 inside the object, :187-206), FCN /
FCNThreshold (the NN service's maps, background gate < 0.8, :96-182), RCNN /
RCNNThreshold (detector boxes -> rectangular masks, :25-94).
compute3dSegment (:211-252) converts mask x depth into a voxel-downsampled
cloud with normals; here compute_3d_segment runs crop -> 1 cm voxel
(probabilities averaged alongside) -> radius outlier removal -> k-NN PCA
normals flipped to the viewpoint. The network strategies take a callable
predictor or detector (models/fcn.py, pipeline/detector.py, or any
precomputed masks); the probability images are numpy arrays on the host.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Sequence

import numpy as np
import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)
from physimglobalpose_tpu_torch.config import PipelineConfig, DEFAULT_CONFIG
from physimglobalpose_tpu_torch.geometry import pointcloud
from physimglobalpose_tpu_torch.models.fcn import PREDICTOR_BACKGROUND_KEY, PREDICTOR_LABEL_KEY
from physimglobalpose_tpu_torch.ops import normals as normals_mod
from physimglobalpose_tpu_torch.ops import voxel


class Segment3D(NamedTuple):
    """Fixed-size 3D segment of one object (the StoCS input)."""

    pts: torch.Tensor  # [N, 3]
    nrm: torch.Tensor  # [N, 3]
    prob: torch.Tensor  # [N]
    mask: torch.Tensor  # [N] bool


def gt_prob_images(
    class_mask: np.ndarray, class_ids: Sequence[int]
) -> Dict[int, np.ndarray]:
    """GT strategy: probability 1.0 where the class mask matches."""
    return {c: (class_mask == c).astype(np.float32) for c in class_ids}


def threshold_prob_images(
    prob_maps: Dict[int, np.ndarray],
    background_prob: np.ndarray,
    threshold: float = 0.8,
) -> Dict[int, np.ndarray]:
    """FCNThreshold strategy: a flat 1.0 mask where the class has any
    probability and the background is not confident (the reference sets
    objMask = 1.0, not the soft value, Segmentation.cpp:165-175)."""
    return {
        c: np.where((p > 0) & (background_prob < threshold), 1.0, 0.0).astype(np.float32)
        for c, p in prob_maps.items()
    }


def bbox_prob_images(
    boxes: Dict[int, tuple], height: int, width: int, scores: Dict[int, float] | None = None
) -> Dict[int, np.ndarray]:
    """RCNN strategy: filled rectangles from detector boxes
    (Segmentation.cpp:25-94). boxes[c] = (tl_x, tl_y, br_x, br_y), inclusive."""
    out = {}
    for c, (tlx, tly, brx, bry) in boxes.items():
        img = np.zeros((height, width), np.float32)
        img[int(tly) : int(bry) + 1, int(tlx) : int(brx) + 1] = (
            scores.get(c, 1.0) if scores else 1.0
        )
        out[c] = img
    return out


def compute_3d_segment(
    depth: torch.Tensor,
    prob_img: torch.Tensor,
    intrinsics: torch.Tensor,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    generator: torch.Generator | None = None,
    priority: torch.Tensor | None = None,
) -> Segment3D:
    """mask x depth -> fixed-size segment cloud with normals + probabilities.

    priority is the optional injected [H*W] uniform draw that picks the raw
    crop's subset (see pointcloud.compact_mask_indices).
    """
    pre = cfg.preprocess
    n_out = pre.max_segment_points
    # Oversample the raw crop 4x before voxel thinning.
    raw_pts, raw_prob, raw_mask = pointcloud.crop_segment(
        depth, prob_img, intrinsics, max_points=4 * n_out, generator=generator,
        depth_min=pre.depth_min, depth_max=pre.depth_max, priority=priority,
    )
    vox_pts, vox_mask, vox_prob = voxel.voxel_downsample(
        raw_pts, raw_mask, pre.segment_voxel, n_out, extras=raw_prob[:, None]
    )
    keep = normals_mod.radius_outlier_mask(
        vox_pts, vox_mask, pre.outlier_radius, pre.outlier_min_neighbors
    )
    nrm = normals_mod.knn_normals(vox_pts, keep, k=pre.normal_k)
    return Segment3D(
        pts=torch.where(keep[:, None], vox_pts, 0.0),
        nrm=nrm,
        prob=torch.where(keep, vox_prob[:, 0], 0.0),
        mask=keep,
    )


def segment_count(seg: Segment3D) -> torch.Tensor:
    return torch.sum(seg.mask)


PROB_STRATEGIES = ("GT", "FCN", "FCNThreshold", "RCNN", "RCNNThreshold")

def build_prob_images(
    strategy: str,
    class_ids: Sequence[int],
    class_mask: np.ndarray | None = None,
    nn_predictor: Callable[[np.ndarray, Sequence[int]], Dict[int, np.ndarray]] | None = None,
    color: np.ndarray | None = None,
    background_prob: np.ndarray | None = None,
    detector: Callable[[np.ndarray, Sequence[int]], Dict[int, tuple]] | None = None,
    threshold: float = 0.8,
) -> Dict[int, np.ndarray]:
    """Strategy dispatch (SceneCfg::perfromSegmentation, SceneCfg.cpp:356-372).

    FCN: a flat 1.0 mask where the predictor's argmax class image is the
    class (Segmentation.cpp:118-131), or, for a predictor without that
    output, where the class map is >= 0.15. FCNThreshold: threshold_prob_images
    gated on the net's background map, or on 1 - max of the class maps when
    the predictor gives none. RCNN / RCNNThreshold: the detector's boxes, an
    empty mask for a class it did not find (the pipeline then returns the
    identity for the degenerate segment).
    """
    if strategy == "GT":
        if class_mask is None:
            raise ValueError("GT segmentation needs a class mask")
        return gt_prob_images(class_mask, class_ids)
    if strategy in ("FCN", "FCNThreshold"):
        if nn_predictor is None or color is None:
            raise ValueError("FCN segmentation needs a predictor and color image")
        probs = nn_predictor(color, class_ids)
        label = probs.get(PREDICTOR_LABEL_KEY)
        bg = probs.get(PREDICTOR_BACKGROUND_KEY)
        if strategy == "FCNThreshold":
            if background_prob is None:
                if bg is not None:
                    background_prob = bg
                else:
                    background_prob = 1.0 - np.stack([probs[c] for c in class_ids]).max(axis=0)
            return threshold_prob_images(
                {c: probs[c] for c in class_ids}, background_prob, threshold
            )
        if label is not None:
            return {c: (label == c).astype(np.float32) for c in class_ids}
        return {c: np.where(probs[c] >= 0.15, 1.0, 0.0).astype(np.float32) for c in class_ids}
    if strategy in ("RCNN", "RCNNThreshold"):
        if detector is None or color is None:
            raise ValueError("RCNN segmentation needs a detector and color image")
        boxes = detector(color, class_ids)
        out = bbox_prob_images(boxes, color.shape[0], color.shape[1])
        for c in class_ids:
            out.setdefault(c, np.zeros(color.shape[:2], np.float32))
        return out
    raise ValueError(f"unknown segmentation strategy {strategy!r}")
