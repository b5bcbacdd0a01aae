"""Segmentation: per-object probability images + fixed-size 3D segments.

Reference (Segmentation.cpp): the GT strategy turns the class mask into
probability 1.0 inside the object (:187-206); compute3dSegment (:211-252)
converts mask x depth into a voxel-downsampled cloud with normals. Here
compute_3d_segment runs crop -> 1 cm voxel (probabilities averaged
alongside) -> radius outlier removal -> k-NN PCA normals flipped to the
viewpoint. Only the GT strategy is ported so far; the network strategies
(FCN, FCNThreshold, RCNN, RCNNThreshold) raise NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)
from physimglobalpose_tpu_torch.config import PipelineConfig, DEFAULT_CONFIG
from physimglobalpose_tpu_torch.geometry import pointcloud
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


PROB_STRATEGIES = ("GT", "FCN", "FCNThreshold", "RCNN", "RCNNThreshold")


def build_prob_images(
    strategy: str,
    class_ids: Sequence[int],
    class_mask: np.ndarray | None = None,
) -> Dict[int, np.ndarray]:
    """Strategy dispatch (SceneCfg::perfromSegmentation); GT only so far."""
    if strategy == "GT":
        if class_mask is None:
            raise ValueError("GT segmentation needs a class mask")
        return gt_prob_images(class_mask, class_ids)
    if strategy in PROB_STRATEGIES:
        raise NotImplementedError(f"segmentation strategy {strategy!r} is not ported yet")
    raise ValueError(f"unknown segmentation strategy {strategy!r}")
