"""Scene loading + table removal.

Reference: SceneCfg and its APC/YCB subclasses (SceneCfg.cpp:162-252) read
frame-000000.{color,depth}.png + gt_info.yml (camera pose/intrinsics, object
list); removeTable (SceneCfg.cpp:38-82) plane-fits the support surface and
zeroes its depth pixels. The scene is a host-side dataclass of numpy arrays;
table removal runs on the device (backproject -> voxel downsample -> MSAC
plane -> depth zeroing). yaml and PIL are imported only by load_scene.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)
from physimglobalpose_tpu_torch.config import PipelineConfig, DEFAULT_CONFIG
from physimglobalpose_tpu_torch.geometry import depthio, pointcloud, se3
from physimglobalpose_tpu_torch.ops import plane, voxel


@dataclasses.dataclass
class Scene:
    scene_dir: str
    dataset: str  # "APC" | "YCB" | "CAM"
    color: np.ndarray  # [H, W, 3] uint8
    depth: np.ndarray  # [H, W] float32 meters (raw, table not removed)
    intrinsics: np.ndarray  # [3, 3]
    cam_pose: np.ndarray  # [4, 4] camera-to-world
    object_names: List[str]
    class_mask: Optional[np.ndarray] = None  # [H, W] int32 GT class ids
    table_pose: Optional[np.ndarray] = None  # [4, 4] from gt_info rest_surface
    dependency_order: Optional[list] = None
    gt_poses: Optional[Dict[str, np.ndarray]] = None
    depth_raw16: Optional[np.ndarray] = None  # de-rotated uint16 codec values


def _pose_from_tq(vals) -> np.ndarray:
    """gt_info.yml pose format: [x y z qw qx qy qz]."""
    t = np.asarray(vals[:3], np.float64)
    q = np.asarray(vals[3:7], np.float64)
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.asarray(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float32,
    )
    pose[:3, 3] = t.astype(np.float32)
    return pose


def load_scene(
    scene_dir: str,
    dataset: str = "APC",
    frame: str = "frame-000000",
    load_color: bool = True,
) -> Scene:
    """Load a reference-layout scene directory (needs PyYAML and Pillow)."""
    import yaml

    with open(os.path.join(scene_dir, "gt_info.yml")) as fh:
        info = yaml.safe_load(fh)
    cam = info["camera"]
    intr = np.asarray(cam["camera_intrinsics"], np.float32)
    cam_pose = _pose_from_tq(cam["camera_pose"])
    color = (
        depthio.read_color_png(os.path.join(scene_dir, f"{frame}.color.png"))
        if load_color
        else None
    )
    depth_raw16 = depthio.read_depth_png_raw(
        os.path.join(scene_dir, f"{frame}.depth.png"), bit_rotated=(dataset == "APC")
    )
    depth = depth_raw16.astype(np.float32) / depthio.DEPTH_SCALE
    mask_path = os.path.join(scene_dir, f"{frame}.mask.png")
    class_mask = depthio.read_class_mask_png(mask_path) if os.path.exists(mask_path) else None

    sc = info.get("scene", {})
    n_obj = int(sc.get("num_objects", 0))
    names = [sc[f"object_{i}"]["name"] for i in range(1, n_obj + 1)]
    gt_poses = None
    if n_obj and "pose" in sc.get("object_1", {}):
        gt_poses = {
            sc[f"object_{i}"]["name"]: _pose_from_tq(sc[f"object_{i}"]["pose"])
            for i in range(1, n_obj + 1)
        }

    table_pose = None
    rest = info.get("rest_surface")
    if rest and "surface_pose" in rest:
        table_pose = _pose_from_tq(rest["surface_pose"])

    return Scene(
        scene_dir=scene_dir,
        dataset=dataset,
        color=color,
        depth=depth,
        intrinsics=intr,
        cam_pose=cam_pose,
        object_names=names,
        class_mask=class_mask,
        table_pose=table_pose,
        dependency_order=sc.get("dependency_order"),
        gt_poses=gt_poses,
        depth_raw16=depth_raw16,
    )


def remove_table(
    depth: torch.Tensor,
    intrinsics: torch.Tensor,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    generator: torch.Generator | None = None,
    priority: torch.Tensor | None = None,
    triplets: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Table removal (SceneCfg.cpp:38-82 semantics).

    priority / triplets are the optional injected draws of the point
    subsample and of the MSAC trials (see compact_mask_indices and
    fit_plane_ransac); they come from `generator` when not given.
    Returns (cleaned depth [H, W], plane [4], table_pose [4, 4]).
    """
    pre = cfg.preprocess
    pts, valid = pointcloud.backproject(depth, intrinsics, pre.depth_min, pre.depth_max)
    sub, sub_mask = pointcloud.compact_masked_points(
        pts.reshape(-1, 3), valid.reshape(-1), 16384, generator, priority
    )
    vox, vox_mask, _ = voxel.voxel_downsample(sub, sub_mask, pre.scene_voxel, 8192)
    pl4, inliers = plane.fit_plane_ransac(
        vox, vox_mask, generator, threshold=pre.plane_dist_threshold,
        iters=pre.plane_ransac_iters, triplets=triplets,
    )
    # Orient the plane normal toward the camera (-z side) for a stable frame.
    pl4 = torch.where(pl4[2] > 0, -pl4, pl4)
    cleaned = plane.remove_table_depth(depth, pts, valid, pl4, pre.plane_dist_threshold)
    anchor = torch.sum(torch.where(inliers[:, None], vox, 0.0), dim=0) / torch.clamp(
        torch.sum(inliers), min=1
    )
    return cleaned, pl4, plane.table_pose_from_plane(pl4, anchor)


def refine_table_pose_from_depth(
    depth: torch.Tensor,
    intrinsics: torch.Tensor,
    plane4: torch.Tensor,
    table_pose: torch.Tensor,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    generator: torch.Generator | None = None,
    priority: torch.Tensor | None = None,
) -> torch.Tensor:
    """getTableParams parity (SceneCfg.cpp:87-157): ICP-refine the table
    frame against up to 4,096 of the raw depth's plane-inlier points (camera
    frame). priority is the optional injected draw of the subsample (see
    compact_mask_indices); it comes from `generator` when not given."""
    return refine_table_poses_from_depth(
        [(depth, intrinsics, plane4, table_pose, generator, priority)], cfg)[0]


def refine_table_poses_from_depth(scenes, cfg: PipelineConfig = DEFAULT_CONFIG) -> list:
    """refine_table_pose_from_depth of several scenes, (depth, intrinsics,
    plane4, table_pose, generator, priority) each: each subsample drawn as
    that function draws it, then the refinements together
    (plane.refine_table_poses), each answer the one it gets alone."""
    pre = cfg.preprocess
    tables = []
    for depth, intrinsics, plane4, table_pose, generator, priority in scenes:
        pts, valid = pointcloud.backproject(depth, intrinsics, pre.depth_min, pre.depth_max)
        flat_pts = pts.reshape(-1, 3)
        dist = torch.abs(flat_pts @ plane4[:3] + plane4[3])
        inl = valid.reshape(-1) & (dist < pre.plane_dist_threshold)
        sub, sub_mask = pointcloud.compact_masked_points(flat_pts, inl, 4096, generator, priority)
        tables.append((table_pose, sub, sub_mask, plane4))
    return plane.refine_table_poses(tables, cfg.physics.table_half_extents,
                                    threshold=pre.plane_dist_threshold)


def physics_table_pose(depth, intr, plane4, table_pose, cam_pose, cfg, gen) -> np.ndarray:
    """The table box for the search's settle, in the world frame, on the
    host; physics_table_poses of one scene."""
    return physics_table_poses([(depth, intr, plane4, table_pose, cam_pose, gen)], cfg)[0]


def physics_table_poses(scenes, cfg: PipelineConfig) -> List[np.ndarray]:
    """The table boxes for the searches' settles of several scenes, (depth,
    intr, plane4, table_pose, cam_pose, gen) each, in the world frame, on
    the host. Each table frame is ICP-refined against its raw depth's plane
    inliers (refine_table_poses_from_depth, the subsample drawn from `gen`;
    the scenes' refinements together, each answer the one it gets alone).
    remove_table fits it in the camera frame; physics needs it in the world
    frame (gravity along world -z) with its local z up (the contact model's
    top face is local +z), and the box is centred on its pose
    (PhySim.cpp:22-48), so its origin moves down by the half extent from the
    surface."""
    refined = refine_table_poses_from_depth(
        [(depth, intr, plane4, table_pose, gen, None)
         for depth, intr, plane4, table_pose, _cam, gen in scenes], cfg)
    boxes = []
    for r, (*_, cam_pose, _gen) in zip(refined, scenes):
        world = se3.to_world(r, cam_pose).cpu().numpy()
        if world[2, 2] < 0:
            world[:3, 1] *= -1.0  # flip y and z columns:
            world[:3, 2] *= -1.0  # still right-handed
        world[:3, 3] -= cfg.physics.table_half_extents[2] * world[:3, 2]
        boxes.append(world)
    return boxes


def scene_from_arrays(
    color: np.ndarray,
    depth: np.ndarray,
    intrinsics: np.ndarray,
    cam_pose: np.ndarray,
    object_names: List[str],
    dataset: str = "CAM",
    class_mask: Optional[np.ndarray] = None,
    table_pose: Optional[np.ndarray] = None,
) -> Scene:
    """Build a Scene from in-memory arrays (the live-capture path,
    CAMSceneCfg analogue)."""
    return Scene(
        scene_dir="<memory>",
        dataset=dataset,
        color=np.asarray(color),
        depth=np.asarray(depth, np.float32),
        intrinsics=np.asarray(intrinsics, np.float32),
        cam_pose=np.asarray(cam_pose, np.float32),
        object_names=list(object_names),
        class_mask=None if class_mask is None else np.asarray(class_mask, np.int32),
        table_pose=None if table_pose is None else np.asarray(table_pose, np.float32),
    )
