"""Generate synthetic evaluation scenes with exact ground-truth poses.

The port of the JAX package's scripts/make_synthetic_scenes.py. Scenes with
known truth are what accuracy figures (ADD/ADD-S) need: object meshes are
rendered with the package's triangle rasterizer (ops/raster_tri, z-min
composited) above a synthetic table plane, and depth, mask, colour and
gt_info.yml are written in the reference's scene layout, so
pipeline/evaluate.py can sweep them. Mask class ids come from the
obj_config.yml, and multi-object scenes place every listed object at a
non-overlapping slot with a random yaw, resting upright.

Families: plain; --stack (the second object rests ON the first, the
dependency_order case); --hard (a camera tilted 55 degrees, the objects
packed in a line along the view direction so they occlude each other,
touching footprints, depth dropout and Gaussian depth noise before the codec
write, and an unlabeled duplicate of the first object that is in the depth
but background in the mask; hard_stats.json holds each scene's occlusion
fractions). --dataset APC stores depth bit-rotated, YCB in plain units of
0.1 mm.

Every placement draw comes from one np.random.default_rng(seed), consumed
call for call in the JAX script's order, so a seed gives the JAX script's
poses. Only the renders differ (this package's rasterizer against JAX's,
equal up to pixels on shared triangle edges). In the --hard family a
placement is redrawn while an object keeps fewer than 250 visible pixels,
and the occlusion fractions count pixels, so a differing edge pixel can
reach those two places (the tests hold both to the JAX script).

Usage (on the card; --device cpu for the CPU):
  python -m physimglobalpose_tpu_torch.scripts.make_synthetic_scenes --out scenes --n 8 \\
      --objects a,b,c --model-dir <meshes> --obj-config <obj_config.yml> [--hard]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

# The reference's Primesense intrinsics and frame size.
INTRINSICS = np.array([[613.998, 0.0, 320.0], [0.0, 613.998, 240.0], [0.0, 0.0, 1.0]], np.float32)
HEIGHT, WIDTH = 480, 640
CAM_HEIGHT = 1.5  # m above the world origin; the table is table_z below the camera
MIN_VISIBLE_PX = 250  # --hard: each object's visible pixels before dropout
MAX_REDRAWS = 20  # --hard: redraws of one scene before a placement is kept as it is


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=4)
    p.add_argument("--object", default=None,
                   help="single object (back-compat alias for --objects)")
    p.add_argument("--objects", default="kleenex_tissue_box",
                   help="comma-separated object names, all placed per scene")
    p.add_argument("--model-dir", required=True, help="mesh directory")
    p.add_argument("--obj-config", required=True,
                   help="obj_config.yml (the mask class ids)")
    p.add_argument("--dataset", default="APC", choices=["APC", "YCB"],
                   help="scene layout codec: APC stores depth bit-rotated, YCB plain (pass "
                        "the matching obj-config for YCB class ids)")
    p.add_argument("--table-z", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stack", action="store_true",
                   help="place the SECOND object resting ON the first (gt_info "
                        "dependency_order semantics); the rest on the table at side slots")
    p.add_argument("--hard", action="store_true",
                   help="hard family: tilted camera + line packing (occlusion), touching "
                        "footprints, depth dropout + noise, duplicate-geometry distractor "
                        "(see the module docstring); the knobs below override")
    p.add_argument("--tilt-deg", type=float, default=None,
                   help="camera tilt from straight-down (hard default 55)")
    p.add_argument("--dropout", type=float, default=None,
                   help="fraction of valid depth pixels zeroed (hard default 0.15)")
    p.add_argument("--noise-mm", type=float, default=None,
                   help="Gaussian depth noise sigma in mm (hard default 3)")
    p.add_argument("--distractor", action="store_true", default=None,
                   help="add an unlabeled duplicate of the first object (depth only, mask "
                        "background; hard default on)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="render on the card (default) or on the CPU")
    return p.parse_args(argv)


def camera_pose(tilt_deg: float, table_z_world: float) -> np.ndarray:
    """Camera-to-world pose. Straight down (tilt 0): x_cam -> +x, y_cam -> -y,
    z_cam -> -z, so world gravity points into the observed surface. Tilted:
    1 m from the table centre along the view axis, pitched tilt_deg from
    straight down toward +y, where objects packed along +y occlude each
    other."""
    if tilt_deg <= 0:
        return np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, CAM_HEIGHT], [0, 0, 0, 1]],
                        np.float32)
    th = np.deg2rad(tilt_deg)
    z_cam = np.array([0.0, np.sin(th), -np.cos(th)], np.float32)
    eye = np.array([0.0, 0.0, table_z_world], np.float32) - 1.0 * z_cam
    x_cam = np.array([1.0, 0.0, 0.0], np.float32)
    y_cam = np.cross(z_cam, x_cam)
    cam_pose = np.eye(4, dtype=np.float32)
    cam_pose[:3, 0], cam_pose[:3, 1], cam_pose[:3, 2] = x_cam, y_cam, z_cam
    cam_pose[:3, 3] = eye
    return cam_pose


def table_depth_map(tilt_deg: float, table_z: float, table_z_world: float,
                    cam_pose: np.ndarray) -> np.ndarray:
    """Per-pixel camera-frame depth of the table plane z_world ==
    table_z_world (0 where the ray never meets it)."""
    intr = INTRINSICS
    if tilt_deg <= 0:
        return np.full((HEIGHT, WIDTH), np.float32(table_z))
    us, vs = np.meshgrid(np.arange(WIDTH), np.arange(HEIGHT))
    d = np.stack(
        [(us - intr[0, 2]) / intr[0, 0], (vs - intr[1, 2]) / intr[1, 1],
         np.ones_like(us, np.float32)], -1,
    ).astype(np.float32)  # camera-frame ray with unit z: depth == s
    dir_w = d @ cam_pose[:3, :3].T
    denom = dir_w[..., 2]
    s = np.where(
        denom < -1e-6,
        (table_z_world - cam_pose[2, 3]) / np.where(denom < -1e-6, denom, -1.0),
        0.0,
    )
    return np.where(s > 0, s, 0.0).astype(np.float32)


def _yaw(rng) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    return Rotation.from_euler(
        "xyz", [0, 0, rng.uniform(0, 360)], degrees=True).as_matrix().astype(np.float32)


def gt_info_lines(cam_pose, table_z_world, gt_entries) -> list:
    """gt_info.yml: the camera, the table and every object's world pose as
    [x y z qw qx qy qz]."""
    from scipy.spatial.transform import Rotation

    intr = INTRINSICS
    cam_t = cam_pose[:3, 3]
    cam_q = Rotation.from_matrix(cam_pose[:3, :3]).as_quat()  # [x, y, z, w]
    lines = [
        "camera:\n",
        f"  camera_pose: [{cam_t[0]}, {cam_t[1]}, {cam_t[2]}, "
        f"{cam_q[3]}, {cam_q[0]}, {cam_q[1]}, {cam_q[2]}]\n",
        f"  camera_intrinsics: [[{intr[0,0]}, 0.0, {intr[0,2]}],"
        f"[0.0, {intr[1,1]}, {intr[1,2]}],[0.0, 0.0, 1.0]]\n",
        "rest_surface:\n",
        "  type: table\n",
        f"  surface_pose: [0, 0, {table_z_world}, 1, 0, 0, 0]\n",
        "scene:\n",
        f"  num_objects: {len(gt_entries)}\n",
    ]
    for i, (name, pose) in enumerate(gt_entries, start=1):
        pose_world = cam_pose @ pose
        t_w = pose_world[:3, 3]
        q = Rotation.from_matrix(pose_world[:3, :3]).as_quat()
        lines += [
            f"  object_{i}:\n",
            f"    name: '{name}'\n",
            f"    pose: [{t_w[0]}, {t_w[1]}, {t_w[2]}, {q[3]}, {q[0]}, {q[1]}, {q[2]}]\n",
        ]
    return lines


def main(argv=None) -> int:
    args = parse_args(argv)
    names = (args.object or args.objects).split(",")
    if args.hard and args.stack:
        raise SystemExit("--hard and --stack are separate families")
    tilt_deg = args.tilt_deg if args.tilt_deg is not None else (55.0 if args.hard else 0.0)
    dropout = args.dropout if args.dropout is not None else (0.15 if args.hard else 0.0)
    noise_mm = args.noise_mm if args.noise_mm is not None else (3.0 if args.hard else 0.0)
    distractor = args.distractor if args.distractor is not None else args.hard

    import torch
    import yaml
    from PIL import Image

    from physimglobalpose_tpu_torch import _torchcfg
    from physimglobalpose_tpu_torch.geometry import depthio
    from physimglobalpose_tpu_torch.models import assets
    from physimglobalpose_tpu_torch.models.objectdb import _find_mesh
    from physimglobalpose_tpu_torch.ops import raster_tri
    from physimglobalpose_tpu_torch.utils import synthdata

    dev = _torchcfg.resolve_device(args.device)
    with open(args.obj_config) as fh:
        objcfg = yaml.safe_load(fh)["objects"]
    class_ids = {
        objcfg[f"object_{i}"]["name"]: int(objcfg[f"object_{i}"]["classId"])
        for i in range(1, int(objcfg["num_objects"]) + 1)
    }
    h, w = HEIGHT, WIDTH
    table_z_world = CAM_HEIGHT - args.table_z
    cam_pose = camera_pose(tilt_deg, table_z_world)
    cam_pose_inv = np.eye(4, dtype=np.float32)
    cam_pose_inv[:3, :3] = cam_pose[:3, :3].T
    cam_pose_inv[:3, 3] = -cam_pose[:3, :3].T @ cam_pose[:3, 3]

    meshes, half_heights = {}, {}
    for name in names:
        meshes[name] = assets.decimate_to_max_faces(
            assets.load_mesh(_find_mesh(args.model_dir, name)), 4000)
        v = meshes[name].vertices
        half_heights[name] = (v[:, 2].max() - v[:, 2].min()) / 2
    mesh_t = {
        name: (torch.as_tensor(m.vertices, device=dev), torch.as_tensor(m.faces, device=dev),
               torch.ones(len(m.faces), dtype=torch.bool, device=dev))
        for name, m in meshes.items()
    }
    intr_t = torch.as_tensor(INTRINSICS, device=dev)

    def render_cam_depth(name, pose_cam):
        verts, faces, face_mask = mesh_t[name]
        return raster_tri.render_mesh_depth(
            torch.as_tensor(pose_cam, device=dev), verts, faces, face_mask, intr_t, h, w,
        ).cpu().numpy()

    # Non-overlapping XY slots: fixed grid cells jittered per scene (16 cm
    # pitch keeps footprints of <= ~12 cm apart without physics).
    pitch = 0.16
    cols = int(np.ceil(np.sqrt(len(names))))
    rows = max(1, (len(names) + cols - 1) // cols)
    slots = [np.array([(i % cols - (cols - 1) / 2) * pitch, (i // cols - (rows - 1) / 2) * pitch])
             for i in range(len(names))]

    rng = np.random.default_rng(args.seed)
    k = attempt = 0
    while k < args.n:
        order = rng.permutation(len(names))
        depth = table_depth_map(tilt_deg, args.table_z, table_z_world, cam_pose)
        mask = np.zeros((h, w), np.uint16)
        gt_entries, alone_px = [], {}
        base_xy = None
        for idx, name in enumerate(names):
            slot = slots[order[idx]]
            if args.hard:
                # Line packing along the camera's ground direction (+y): nearer
                # objects occlude farther ones under the tilted camera; a pitch
                # of 0.11 m leaves the largest footprints touching.
                yq = (order[idx] - (len(names) - 1) / 2) * 0.11
                pose_w = np.eye(4, dtype=np.float32)
                pose_w[:3, :3] = _yaw(rng)
                pose_w[:3, 3] = [
                    rng.uniform(-0.02, 0.02),
                    yq + rng.uniform(-0.01, 0.01),
                    table_z_world + half_heights[name] + 0.001,
                ]
                pose = (cam_pose_inv @ pose_w).astype(np.float32)
                depth_obj = render_cam_depth(name, pose)
                alone_px[name] = int((depth_obj > 0).sum())
                # The tilted table map can be 0 (no table): objects win there too.
                closer = (depth_obj > 0) & ((depth_obj < depth) | (depth <= 0))
                depth = np.where(closer, depth_obj, depth)
                mask = np.where(closer, np.uint16(class_ids[name]), mask)
                gt_entries.append((name, pose))
                continue
            rot = _yaw(rng)
            if args.stack and idx == 0:
                # The stack's base: the centred slot, so the top object stays
                # inside its footprint.
                base_xy = np.array([rng.uniform(-0.02, 0.02), rng.uniform(-0.02, 0.02)])
                t = np.array([base_xy[0], base_xy[1],
                              args.table_z - half_heights[name] - 0.001], np.float32)
            elif args.stack and idx == 1:
                # Rests ON the base: its bottom at the base's top surface
                # (camera depth decreases upward), xy within ~1 cm of the base.
                t = np.array(
                    [base_xy[0] + rng.uniform(-0.01, 0.01),
                     base_xy[1] + rng.uniform(-0.01, 0.01),
                     args.table_z - 2 * half_heights[names[0]] - half_heights[name] - 0.002],
                    np.float32,
                )
            else:
                # Stack mode widens the side slots 1.5x to clear the centred stack.
                s = slot * (1.5 if args.stack else 1.0)
                t = np.array([s[0] + rng.uniform(-0.02, 0.02), s[1] + rng.uniform(-0.02, 0.02),
                              args.table_z - half_heights[name] - 0.001], np.float32)
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = rot
            pose[:3, 3] = t
            depth_obj = render_cam_depth(name, pose)
            closer = (depth_obj > 0) & (depth_obj < depth)  # z-min composite
            depth = np.where(closer, depth_obj, depth)
            mask = np.where(closer, np.uint16(class_ids[name]), mask)
            gt_entries.append((name, pose))

        if distractor:
            # An extra, unlabeled instance of the first object beside the line:
            # in the depth, background in the mask (it also takes mask pixels
            # from whatever is behind it).
            dname = names[0]
            pose_w = np.eye(4, dtype=np.float32)
            pose_w[:3, :3] = _yaw(rng)
            pose_w[:3, 3] = [
                0.12 * (1 if rng.uniform() < 0.5 else -1) + rng.uniform(-0.01, 0.01),
                rng.uniform(-0.06, 0.06),
                table_z_world + half_heights[dname] + 0.001,
            ]
            depth_obj = render_cam_depth(dname, (cam_pose_inv @ pose_w).astype(np.float32))
            closer = (depth_obj > 0) & ((depth_obj < depth) | (depth <= 0))
            depth = np.where(closer, depth_obj, depth)
            mask = np.where(closer, np.uint16(0), mask)

        stats = None
        if args.hard:
            # Hard, not impossible: redraw while an object is nearly hidden.
            min_vis = min(int((mask == class_ids[n]).sum()) for n, _ in gt_entries)
            if min_vis < MIN_VISIBLE_PX and attempt < MAX_REDRAWS:
                attempt += 1
                continue
            stats = {
                "tilt_deg": tilt_deg, "dropout": dropout, "noise_mm": noise_mm,
                "distractor": bool(distractor),
                "occlusion_frac": {
                    name: round(1.0 - float((mask == class_ids[name]).sum())
                                / max(alone_px.get(name, 1), 1), 3)
                    for name, _ in gt_entries
                },
            }

        # Sensor corruption after compositing, before the codec write: the
        # poses stay exact, only the observation degrades.
        valid = depth > 0
        if noise_mm > 0:
            depth = np.where(
                valid,
                depth + rng.normal(0.0, noise_mm / 1000.0, depth.shape).astype(np.float32),
                depth,
            ).astype(np.float32)
        if dropout > 0:
            drop = valid & (rng.uniform(size=depth.shape) < dropout)
            depth = np.where(drop, np.float32(0.0), depth)

        sd = os.path.join(args.out, f"scene_{k:04d}")
        os.makedirs(sd, exist_ok=True)
        depthio.write_depth_png(os.path.join(sd, "frame-000000.depth.png"), depth,
                                bit_rotated=(args.dataset == "APC"))
        Image.fromarray(mask).save(os.path.join(sd, "frame-000000.mask.png"))
        # A colour frame in the networks' training appearance (palette, depth
        # shading, noise); the distractor paints as background.
        color_rng = np.random.default_rng(args.seed * 100003 + k)
        color_img = synthdata.colorize_from_label_depth(mask.astype(np.int32), depth, color_rng)
        Image.fromarray(color_img).save(os.path.join(sd, "frame-000000.color.png"))
        if stats is not None:
            with open(os.path.join(sd, "hard_stats.json"), "w") as fh:
                json.dump(stats, fh, indent=1)
        with open(os.path.join(sd, "gt_info.yml"), "w") as fh:
            fh.writelines(gt_info_lines(cam_pose, table_z_world, gt_entries))
        extra = f", max occlusion {max(stats['occlusion_frac'].values()):.2f}" if stats else ""
        print(f"wrote {sd} ({len(gt_entries)} objects{extra})")
        k += 1
        attempt = 0
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
