"""The plain reference and the scene generator against the port, at a tiny
size on the CPU: the same boxes, the same frames, the same distances."""

import os

import numpy as np
import pytest
import torch

from gpubench import reference, scenes, spec


@pytest.fixture(scope="module")
def conf():
    return spec.load_json(spec.ROOT / "gpubench/configs/hard3_occluded.json")


def _small(conf, w=80, h=60):
    """The configuration at a w x h frame (focal length scaled alike)."""
    c = dict(conf, scene=dict(conf["scene"], width=w, height=h))
    s = w / conf["scene"]["width"]
    k = np.asarray(conf["scene"]["intrinsics"]) * s
    k[2, 2] = 1.0
    c["scene"]["intrinsics"] = k.tolist()
    return c


def test_the_projected_bounds_change_no_pixel_of_the_raycast(conf):
    rays = scenes.camera_rays(conf)
    rng = np.random.default_rng(0)
    for _ in range(3):
        sc = scenes.generate(conf, rng, rays)
        for name, pose in sc.poses.items():
            size = next(o["size_m"] for o in conf["objects"] if o["name"] == name)
            bounded = scenes.raycast_box(rays, pose, size)
            rot, t = pose[:3, :3].astype(np.float64), pose[:3, 3].astype(np.float64)
            d = rays.reshape(-1, 3).astype(np.float64) @ rot
            d = np.where(np.abs(d) < 1e-12, 1e-12, d)
            o, half = -(rot.T @ t), np.asarray(size) / 2
            t1, t2 = (-half - o) / d, (half - o) / d
            near, far = np.minimum(t1, t2).max(1), np.maximum(t1, t2).min(1)
            full = np.where((far >= near) & (near > 0), near, 0.0).reshape(bounded.shape)
            assert np.array_equal(bounded, full.astype(np.float32))


def test_the_raycast_matches_the_ports_triangle_render(conf, tmp_path):
    from physimglobalpose_tpu_torch.models import assets
    from physimglobalpose_tpu_torch.ops import raster_tri

    c = _small(conf)
    scenes.write_models(str(tmp_path), c)
    sc = scenes.generate(c, np.random.default_rng(4))
    rays = scenes.camera_rays(c)
    k = torch.as_tensor(scenes.intrinsics(c))
    for obj in c["objects"]:
        mesh = assets.load_mesh(os.path.join(tmp_path, obj["name"] + ".ply"))
        pose = sc.poses[obj["name"]]
        ours = scenes.raycast_box(rays, pose, obj["size_m"])
        theirs = raster_tri.render_mesh_depth(
            torch.as_tensor(pose), torch.as_tensor(mesh.vertices), torch.as_tensor(mesh.faces),
            torch.ones(len(mesh.faces), dtype=torch.bool), k, 60, 80).numpy()
        both = (ours > 0) & (theirs > 0)
        assert both.sum() > 20
        assert np.abs(ours[both] - theirs[both]).max() < 1e-4
        assert ((ours > 0) != (theirs > 0)).sum() <= 0.1 * both.sum()  # edge pixels only


def test_the_written_scene_reads_back_through_the_ports_loader(conf, tmp_path):
    from physimglobalpose_tpu_torch.pipeline import scene as scene_mod

    for c in (conf, spec.load_json(spec.ROOT / "gpubench/configs/apc3_gt.json")):
        sc = scenes.generate(c, np.random.default_rng(7))
        d = str(tmp_path / c["name"])
        scenes.write_scene(d, sc, c)
        got = scene_mod.load_scene(d, dataset=c["dataset"])
        assert np.abs(got.depth - sc.depth).max() <= 1.0001e-4  # the codec's 0.1 mm
        assert np.array_equal(got.class_mask, sc.mask.astype(np.int32))
        assert np.allclose(got.intrinsics, scenes.intrinsics(c))
        assert np.allclose(got.cam_pose, sc.cam_pose, atol=1e-5)
        assert got.object_names == [o["name"] for o in c["objects"]]
        assert got.gt_poses is None  # the truth stays with the benchmark


def test_adds_matches_the_ports_adds_on_dense_samples():
    from physimglobalpose_tpu_torch.geometry import metrics

    size = (0.12, 0.08, 0.06)
    dense = reference.box_surface_points(size, step=0.002)
    rng = np.random.default_rng(2)
    truth = np.eye(4)
    truth[:3, 3] = [0.05, -0.02, 0.7]
    for shift_mm in (0.0, 3.0, 12.0):
        pose = truth.copy()
        a = rng.uniform(0, 0.2)
        pose[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        pose[:3, 3] += rng.normal(size=3) * shift_mm / 1000.0
        ours = reference.adds_m(pose, truth, size, reference.box_surface_points(size))
        theirs = float(metrics.adds_error(torch.as_tensor(pose, dtype=torch.float32),
                                          torch.as_tensor(truth, dtype=torch.float32),
                                          torch.as_tensor(dense, dtype=torch.float32)))
        # the port's nearest sample lies within half a 2 mm grid cell of the surface
        assert abs(ours - theirs) < 1.0e-3


def test_the_truth_explains_a_clean_frame():
    c = spec.load_json(spec.ROOT / "gpubench/configs/apc3_gt.json")
    sc = scenes.generate(c, np.random.default_rng(5))
    k = scenes.intrinsics(c)
    for o in c["objects"]:
        pts = reference.observed_points(sc, o["class_id"], k)
        assert reference.lcp_fit(pts, sc.poses[o["name"]], o["size_m"], 0.005) > 0.99
        away = sc.poses[o["name"]].copy()
        away[2, 3] += 0.02  # 2 cm along the view axis
        assert reference.lcp_fit(pts, away, o["size_m"], 0.005) < 0.5
