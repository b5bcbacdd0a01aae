"""Synthetic RGB-D scenes of boxes with exact ground truth.

The benchmark's own copy of the port's scene generator
(physimglobalpose_tpu_torch/scripts/make_synthetic_scenes.py): the plain
family (top-down camera, objects upright on a table at jittered grid slots,
random yaw) and the hard family (a camera tilted from straight down, the
objects packed in a line along the view direction so that they occlude each
other, depth dropout and Gaussian noise, and an unlabeled duplicate of the
first object). The objects are boxes, so every depth pixel is ray-cast
exactly here in numpy; the program under test is not used to make its
inputs. A configuration file names the family's knobs (configs/*.json).

Scenes are written in the reference's layout (frame-000000.{depth,mask,
color}.png and gt_info.yml), with the object names but without their poses:
the truth stays with the benchmark.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

DEPTH_SCALE = 10000.0  # the reference's depth codec: metres x 10,000 in 16 bits
MIN_VISIBLE_PX = 250  # hard family: each object's visible pixels before dropout
MAX_REDRAWS = 20  # hard family: redraws of one scene before a placement is kept


@dataclass
class Scene:
    """One generated frame: what the program reads and the exact truth."""

    depth: np.ndarray  # [H, W] float32 metres, as observed (noise and dropout applied)
    mask: np.ndarray  # [H, W] uint16 class ids (0 = background and distractor)
    cam_pose: np.ndarray  # [4, 4] camera to world
    poses: Dict[str, np.ndarray]  # object name -> [4, 4] camera-frame pose (truth)
    table_depth: np.ndarray  # [H, W] depth of the table plane alone (0 where none)
    distractor: np.ndarray | None = None  # [4, 4] camera-frame pose of the duplicate
    occlusion: Dict[str, float] = field(default_factory=dict)


def intrinsics(cfg: dict) -> np.ndarray:
    return np.asarray(cfg["scene"]["intrinsics"], np.float32)


def camera_rays(cfg: dict) -> np.ndarray:
    """[H, W, 3] camera-frame ray of each pixel centre with unit z, so the
    parameter of a hit along it is the pixel's depth."""
    sc = cfg["scene"]
    k = intrinsics(cfg)
    us, vs = np.meshgrid(np.arange(sc["width"]), np.arange(sc["height"]))
    return np.stack([(us - k[0, 2]) / k[0, 0], (vs - k[1, 2]) / k[1, 1],
                     np.ones(us.shape)], -1).astype(np.float32)


def raycast_box(rays: np.ndarray, pose: np.ndarray, size) -> np.ndarray:
    """Depth [H, W] of a box of full extents `size` (m) centred at `pose`
    (camera frame), seen from the camera origin; 0 where the ray misses.
    The slab test in float64, on the pixels of the box's projected bounds."""
    rot, t = pose[:3, :3].astype(np.float64), pose[:3, 3].astype(np.float64)
    half = np.asarray(size, np.float64) / 2.0
    out = np.zeros(rays.shape[:2], np.float32)
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]) * half
    cam = corners @ rot.T + t
    if np.any(cam[:, 2] <= 1e-6):
        y0, y1, x0, x1 = 0, rays.shape[0], 0, rays.shape[1]  # the box reaches behind the camera
    else:
        # pixel (u, v) lies on the ray (x, y) = ((u - cx) / fx, (v - cy) / fy): bound
        # the corners' rays and find the pixels between them on the rays' grid
        ray_x, ray_y = cam[:, 0] / cam[:, 2], cam[:, 1] / cam[:, 2]
        xs, ys = rays[0, :, 0], rays[:, 0, 1]
        x0 = max(int(np.searchsorted(xs, ray_x.min())) - 1, 0)
        x1 = min(int(np.searchsorted(xs, ray_x.max())) + 1, rays.shape[1])
        y0 = max(int(np.searchsorted(ys, ray_y.min())) - 1, 0)
        y1 = min(int(np.searchsorted(ys, ray_y.max())) + 1, rays.shape[0])
        if x0 >= x1 or y0 >= y1:
            return out
    sub = rays[y0:y1, x0:x1]
    d = sub.reshape(-1, 3).astype(np.float64) @ rot  # box-frame directions (R^T d)
    o = -(rot.T @ t)  # box-frame origin
    d = np.where(np.abs(d) < 1e-12, 1e-12, d)
    t1, t2 = (-half - o) / d, (half - o) / d
    near = np.minimum(t1, t2).max(axis=1)
    far = np.maximum(t1, t2).min(axis=1)
    hit = (far >= near) & (near > 0)
    out[y0:y1, x0:x1] = np.where(hit, near, 0.0).reshape(sub.shape[:2])
    return out


def composite(depth: np.ndarray, layer: np.ndarray) -> np.ndarray:
    """Where `layer` is nearer than `depth` (or `depth` is empty)."""
    return (layer > 0) & ((layer < depth) | (depth <= 0))


def render_objects(rays, poses: Dict[str, np.ndarray], sizes: Dict[str, tuple],
                   base: np.ndarray) -> np.ndarray:
    """The z-min composite of the boxes at `poses` over the depth `base`."""
    depth = base.copy()
    for name, pose in poses.items():
        d = raycast_box(rays, pose, sizes[name])
        depth = np.where(composite(depth, d), d, depth)
    return depth


def camera_pose(tilt_deg: float, table_z_world: float, cam_height: float) -> np.ndarray:
    """Camera to world. Straight down (tilt 0): x_cam -> +x, y_cam -> -y,
    z_cam -> -z. Tilted: 1 m from the table centre along the view axis,
    pitched tilt_deg from straight down toward +y."""
    if tilt_deg <= 0:
        return np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, cam_height], [0, 0, 0, 1]],
                        np.float32)
    th = np.deg2rad(tilt_deg)
    z_cam = np.array([0.0, np.sin(th), -np.cos(th)], np.float32)
    x_cam = np.array([1.0, 0.0, 0.0], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2] = x_cam, np.cross(z_cam, x_cam), z_cam
    pose[:3, 3] = np.array([0.0, 0.0, table_z_world], np.float32) - z_cam
    return pose


def table_depth_map(rays, tilt_deg, table_z, table_z_world, cam_pose) -> np.ndarray:
    """Camera-frame depth of the plane z_world == table_z_world (0 where the
    ray never meets it)."""
    if tilt_deg <= 0:
        return np.full(rays.shape[:2], np.float32(table_z))
    denom = (rays @ cam_pose[:3, :3].T)[..., 2]
    ok = denom < -1e-6
    s = np.where(ok, (table_z_world - cam_pose[2, 3]) / np.where(ok, denom, -1.0), 0.0)
    return np.where(s > 0, s, 0.0).astype(np.float32)


def _yaw(rng) -> np.ndarray:
    a = np.deg2rad(rng.uniform(0, 360))
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _inverse(pose: np.ndarray) -> np.ndarray:
    inv = np.eye(4, dtype=np.float32)
    inv[:3, :3] = pose[:3, :3].T
    inv[:3, 3] = -pose[:3, :3].T @ pose[:3, 3]
    return inv


def generate(cfg: dict, rng: np.random.Generator, rays: np.ndarray | None = None) -> Scene:
    """One scene of the configuration's family, drawn from `rng`."""
    sc = cfg["scene"]
    objs = cfg["objects"]
    names = [o["name"] for o in objs]
    sizes = {o["name"]: tuple(o["size_m"]) for o in objs}
    cls = {o["name"]: o["class_id"] for o in objs}
    half_h = {n: sizes[n][2] / 2.0 for n in names}
    rays = camera_rays(cfg) if rays is None else rays
    hard = sc["family"] == "hard"
    tilt, table_z = sc["tilt_deg"], sc["table_z"]
    table_z_world = sc["cam_height"] - table_z
    cam_pose = camera_pose(tilt, table_z_world, sc["cam_height"])
    cam_inv = _inverse(cam_pose)
    table = table_depth_map(rays, tilt, table_z, table_z_world, cam_pose)
    pitch = 0.16  # plain family: grid slots 16 cm apart keep the footprints apart
    cols = int(np.ceil(np.sqrt(len(names))))
    rows = max(1, (len(names) + cols - 1) // cols)
    slots = [np.array([(i % cols - (cols - 1) / 2) * pitch, (i // cols - (rows - 1) / 2) * pitch])
             for i in range(len(names))]

    for attempt in range(MAX_REDRAWS + 1):
        order = rng.permutation(len(names))
        depth, mask = table.copy(), np.zeros(table.shape, np.uint16)
        poses, alone_px = {}, {}
        for idx, name in enumerate(names):
            if hard:
                # Line packing along +y: nearer objects occlude farther ones;
                # 0.11 m apart leaves the largest footprints touching.
                pose_w = np.eye(4, dtype=np.float32)
                pose_w[:3, :3] = _yaw(rng)
                pose_w[:3, 3] = [rng.uniform(-0.02, 0.02),
                                 (order[idx] - (len(names) - 1) / 2) * 0.11
                                 + rng.uniform(-0.01, 0.01),
                                 table_z_world + half_h[name] + 0.001]
                pose = (cam_inv @ pose_w).astype(np.float32)
            else:
                slot = slots[order[idx]]
                pose = np.eye(4, dtype=np.float32)
                pose[:3, :3] = _yaw(rng)
                pose[:3, 3] = [slot[0] + rng.uniform(-0.02, 0.02),
                               slot[1] + rng.uniform(-0.02, 0.02),
                               table_z - half_h[name] - 0.001]
            d = raycast_box(rays, pose, sizes[name])
            alone_px[name] = int((d > 0).sum())
            near = composite(depth, d)
            depth = np.where(near, d, depth)
            mask = np.where(near, np.uint16(cls[name]), mask)
            poses[name] = pose
        distractor = None
        if sc["distractor"]:
            # An unlabeled instance of the first object beside the line: in
            # the depth, background in the mask.
            first = names[0]
            pose_w = np.eye(4, dtype=np.float32)
            pose_w[:3, :3] = _yaw(rng)
            pose_w[:3, 3] = [0.12 * (1 if rng.uniform() < 0.5 else -1) + rng.uniform(-0.01, 0.01),
                             rng.uniform(-0.06, 0.06), table_z_world + half_h[first] + 0.001]
            distractor = (cam_inv @ pose_w).astype(np.float32)
            d = raycast_box(rays, distractor, sizes[first])
            near = composite(depth, d)
            depth = np.where(near, d, depth)
            mask = np.where(near, np.uint16(0), mask)
        visible = {n: int((mask == cls[n]).sum()) for n in names}
        if not hard or min(visible.values()) >= MIN_VISIBLE_PX or attempt == MAX_REDRAWS:
            break

    # Sensor corruption after compositing: the poses stay exact.
    valid = depth > 0
    if sc["noise_mm"] > 0:
        noise = rng.normal(0.0, sc["noise_mm"] / 1000.0, depth.shape).astype(np.float32)
        depth = np.where(valid, depth + noise, depth).astype(np.float32)
    if sc["dropout"] > 0:
        depth = np.where(valid & (rng.uniform(size=depth.shape) < sc["dropout"]),
                         np.float32(0.0), depth)
    occl = {n: 1.0 - visible[n] / max(alone_px[n], 1) for n in names}
    return Scene(depth=depth.astype(np.float32), mask=mask, cam_pose=cam_pose, poses=poses,
                 table_depth=table, distractor=distractor, occlusion=occl)


def encode_depth(depth_m: np.ndarray, bit_rotated: bool) -> np.ndarray:
    """Metres -> the reference's uint16 codec; APC files store it rotated
    left by 3 bits (their reader rotates left by 13)."""
    raw = (depth_m * DEPTH_SCALE).astype(np.uint16)
    return ((raw << 3) | (raw >> 13)).astype(np.uint16) if bit_rotated else raw


def _quat_wxyz(rot: np.ndarray) -> List[float]:
    """Unit quaternion (w, x, y, z) of a rotation matrix (Shepperd)."""
    m = rot.astype(np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
        q = [0.0] * 4
        q[0] = (m[k, j] - m[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (m[j, i] + m[i, j]) / s
        q[1 + k] = (m[k, i] + m[i, k]) / s
    return [float(v) for v in q]


def write_scene(scene_dir: str, scene: Scene, cfg: dict) -> None:
    """The reference's scene layout, object names without their poses."""
    from PIL import Image

    os.makedirs(scene_dir, exist_ok=True)
    sc = cfg["scene"]
    rotated = cfg["dataset"] == "APC"
    Image.fromarray(encode_depth(scene.depth, rotated)).save(
        os.path.join(scene_dir, "frame-000000.depth.png"), compress_level=1)
    Image.fromarray(scene.mask).save(
        os.path.join(scene_dir, "frame-000000.mask.png"), compress_level=1)
    Image.fromarray(np.zeros((sc["height"], sc["width"], 3), np.uint8)).save(
        os.path.join(scene_dir, "frame-000000.color.png"), compress_level=1)
    k = intrinsics(cfg)
    t = scene.cam_pose[:3, 3]
    q = _quat_wxyz(scene.cam_pose[:3, :3])
    lines = [
        "camera:\n",
        f"  camera_pose: [{t[0]}, {t[1]}, {t[2]}, {q[0]}, {q[1]}, {q[2]}, {q[3]}]\n",
        f"  camera_intrinsics: [[{k[0, 0]}, 0.0, {k[0, 2]}],[0.0, {k[1, 1]}, {k[1, 2]}],"
        "[0.0, 0.0, 1.0]]\n",
        "rest_surface:\n",
        "  type: table\n",
        f"  surface_pose: [0, 0, {sc['cam_height'] - sc['table_z']}, 1, 0, 0, 0]\n",
        "scene:\n",
        f"  num_objects: {len(scene.poses)}\n",
    ]
    for i, name in enumerate(scene.poses, start=1):
        lines += [f"  object_{i}:\n", f"    name: '{name}'\n"]
    with open(os.path.join(scene_dir, "gt_info.yml"), "w") as fh:
        fh.writelines(lines)


def write_models(model_dir: str, cfg: dict) -> str:
    """Each box as a closed PLY mesh centred at its origin (faces wound
    outward) and the obj_config.yml that lists them; returns its path."""
    os.makedirs(model_dir, exist_ok=True)
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                       np.float64)
    for obj in cfg["objects"]:
        verts = corners * (np.asarray(obj["size_m"]) / 2.0)
        tris = []
        for axis in range(3):
            for sign in (-1, 1):
                a, b, c, d = [i for i, v in enumerate(corners) if v[axis] == sign]
                for tri in ((a, b, d), (a, d, c)):
                    p = verts[list(tri)]
                    n = np.cross(p[1] - p[0], p[2] - p[0])
                    tris.append(tri if n[axis] * sign > 0 else (tri[0], tri[2], tri[1]))
        with open(os.path.join(model_dir, obj["name"] + ".ply"), "w") as fh:
            fh.write("ply\nformat ascii 1.0\n")
            fh.write(f"element vertex {len(verts)}\nproperty float x\nproperty float y\n"
                     "property float z\n")
            fh.write(f"element face {len(tris)}\nproperty list uchar int vertex_indices\n"
                     "end_header\n")
            fh.writelines(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n" for v in verts)
            fh.writelines(f"3 {a} {b} {c}\n" for a, b, c in tris)
    path = os.path.join(model_dir, "obj_config.yml")
    with open(path, "w") as fh:
        fh.write(f"objects:\n  num_objects: {len(cfg['objects'])}\n  modelDiscretization: 0.01\n")
        for i, obj in enumerate(cfg["objects"], start=1):
            fh.write(f"  object_{i}:\n    name: {obj['name']}\n    classId: {obj['class_id']}\n"
                     f"    symmetry: {obj['symmetry']}\n")
    return path
