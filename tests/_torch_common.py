"""Shared setup for the port's CPU parity tests (not collected by pytest).

The tests run under pytest-xdist with several workers on a shared host:
torch gets one thread per worker. Inputs are made with numpy from a seed and
handed to both packages; JAX stays on the CPU (tests/conftest.py). Procedural
box meshes and the scene camera come from chip_smoke.py, which drives the
same kind of scene on the card.
"""

import numpy as np
import torch

from chip_smoke import ellipsoid_mesh  # noqa: F401  (the tests' second mesh shape)

torch.set_num_threads(1)

CPU = torch.device("cpu")


def t(a, dtype=torch.float32):
    """numpy (or JAX) array -> CPU torch tensor."""
    return torch.as_tensor(np.array(a), dtype=dtype)


def tb(a):
    return t(a, torch.bool)


def n(x):
    """torch tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def jax_object_fields(obj):
    """The JAX ObjectModel's arrays as the dict objectdb.from_numpy takes."""
    tab = obj.ppf_table
    return dict(
        name=obj.name, class_id=obj.class_id, symmetry=obj.symmetry,
        mesh_vertices=obj.mesh.vertices, mesh_faces=obj.mesh.faces,
        search_pts=obj.search_pts, search_nrm=obj.search_nrm, search_mask=obj.search_mask,
        validation_pts=obj.validation_pts, validation_nrm=obj.validation_nrm,
        hull_pts=obj.hull_pts, hull_mask=obj.hull_mask, hull_eqs=obj.hull_eqs,
        presence=np.asarray(tab.presence), offsets=np.asarray(tab.offsets),
        counts=np.asarray(tab.counts), pairs=np.asarray(tab.pairs), diameter=obj.diameter,
    )


def scoring_inputs(arrays):
    """The nine arrays of bench.make_inputs (JAX or numpy arrays: transforms,
    search cloud + normals, validation cloud + normals, segment points,
    normals, probabilities, mask) as the port's CPU tensors, so that both
    packages score the same inputs."""
    *floats, mask = arrays
    return tuple(t(a) for a in floats) + (tb(mask),)


def write_scene_dir(scene_dir, cam, boxes, tmp):
    """A scene directory in the reference layout (gt_info.yml with the camera
    and the objects' ground-truth poses, frame-000000.{depth,mask,color}.png)
    of test_torch_e2e.py's ray-cast camera: `boxes` (name, class id, full
    extents, centre (x, y) on the table, yaw deg) on a 0.8 m table, each
    box's PLY written to tmp. Returns {name: world pose}."""
    import json

    from PIL import Image
    from scipy.spatial.transform import Rotation

    from chip_smoke import box_pose_world, write_box_ply
    from physimglobalpose_tpu_torch.geometry import depthio
    from test_torch_e2e import H, INTR, W, _render

    def tq(pose):  # gt_info.yml pose format: [x y z qw qx qy qz]
        x, y, z, w = Rotation.from_matrix(pose[:3, :3]).as_quat()
        return [float(v) for v in pose[:3, 3]] + [float(w), float(x), float(y), float(z)]

    scene_dir.mkdir()
    inv = np.linalg.inv(cam)
    table_v = np.array([[-0.4, -0.4, 0], [0.4, -0.4, 0], [0.4, 0.4, 0], [-0.4, 0.4, 0]], np.float32)
    layers = [(_render(inv, table_v, np.array([[0, 1, 2], [0, 2, 3]], np.int32)), 0)]
    gt, objects = {}, {}
    for i, (name, cls, size, xy, yaw) in enumerate(boxes):
        gt[name] = box_pose_world(size, xy, yaw)
        verts, faces = write_box_ply(str(tmp / f"{name}.ply"), size)
        layers.append((_render(inv @ gt[name], verts, faces), cls))
        objects[f"object_{i + 1}"] = {"name": name, "pose": tq(gt[name])}
    stack = np.stack([np.where(d > 0, d, np.inf) for d, _ in layers])
    depth = stack.min(0)
    label = np.asarray([c for _, c in layers])[stack.argmin(0)]
    label = np.where(np.isfinite(depth), label, 0)
    depth = np.where(np.isfinite(depth), depth, 0.0).astype(np.float32)
    depthio.write_depth_png(str(scene_dir / "frame-000000.depth.png"), depth, bit_rotated=True)
    Image.fromarray(label.astype(np.uint8)).save(scene_dir / "frame-000000.mask.png")
    Image.fromarray(np.zeros((H, W, 3), np.uint8)).save(scene_dir / "frame-000000.color.png")
    info = {
        "camera": {"camera_intrinsics": INTR.tolist(), "camera_pose": tq(cam)},
        "scene": {"num_objects": len(boxes), **objects},
    }
    (scene_dir / "gt_info.yml").write_text(json.dumps(info))  # JSON is YAML
    return gt


def write_ply_binary(path, verts, faces):
    """A binary little-endian PLY of (verts [V, 3], faces [F, 3]) with an
    extra per-vertex property and a per-face list the loaders must skip."""
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\nproperty float x\nproperty float y\nproperty float z\n"
        "property uchar red\n"
        f"element face {len(faces)}\nproperty list uchar int vertex_indices\n"
        "property list uchar float texcoord\nend_header\n"
    )
    vdt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("r", "u1")])
    vrec = np.zeros(len(verts), vdt)
    vrec["x"], vrec["y"], vrec["z"] = verts[:, 0], verts[:, 1], verts[:, 2]
    vrec["r"] = np.arange(len(verts)) % 256
    fdt = np.dtype([("n", "u1"), ("i", "<i4", 3), ("m", "u1"), ("uv", "<f4", 2)])
    frec = np.zeros(len(faces), fdt)
    frec["n"], frec["i"], frec["m"], frec["uv"] = 3, faces, 2, 0.5
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(vrec.tobytes())
        fh.write(frec.tobytes())
