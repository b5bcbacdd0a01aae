"""ops/raster_tri.render_mesh_depth (plain PyTorch) against the JAX
package's XLA rasterizer, and models/assets' decimation against its numpy
original, on procedural meshes. Mirrors tests/test_raster_tri.py.

Coverage at a pixel on a shared triangle edge is decided by an edge function
at exactly 0, and the order of the multiply-adds moves those bits: the bar
is >= 99.9 % of pixels with the same coverage, and depth within 1e-5
relative where both cover (the splat render's bar, ROADMAP.md)."""

import jax.numpy as jnp
import numpy as np
import torch
from scipy.spatial.transform import Rotation

from _torch_common import ellipsoid_mesh, n, t
from chip_smoke import write_box_ply
from physimglobalpose_tpu.models import assets as jassets
from physimglobalpose_tpu.ops import raster_tri as jraster_tri
from physimglobalpose_tpu_torch.models import assets
from physimglobalpose_tpu_torch.ops import raster, raster_tri

K = np.array([[200.0, 0, 40], [0, 200.0, 30], [0, 0, 1]], dtype=np.float32)
H, W = 60, 80


def _render(pose, verts, faces, k=K, h=H, w=W, px_tile=512):
    return n(raster_tri.render_mesh_depth(
        t(pose), t(verts), torch.as_tensor(faces), torch.ones(len(faces), dtype=torch.bool),
        t(k), h, w, px_tile=px_tile))


def _render_jax(pose, verts, faces, k=K, h=H, w=W, px_tile=512):
    return np.asarray(jraster_tri.render_mesh_depth(
        jnp.asarray(pose, jnp.float32), jnp.asarray(verts, jnp.float32), jnp.asarray(faces),
        jnp.ones(len(faces), bool), jnp.asarray(k), h, w, px_tile=px_tile))


def _assert_same_render(got, want):
    occ_g, occ_w = got > 0, want > 0
    assert occ_w.sum() > 100
    assert (occ_g == occ_w).mean() >= 0.999
    both = occ_g & occ_w
    np.testing.assert_allclose(got[both], want[both], rtol=1e-5)


def test_single_triangle():
    # A big triangle facing the camera at z=0.5.
    verts = np.array([[-0.05, -0.05, 0.5], [0.05, -0.05, 0.5], [0.0, 0.08, 0.5]], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    depth = _render(np.eye(4), verts, faces)
    occ = depth > 0
    assert occ.sum() > 100
    np.testing.assert_allclose(depth[occ], 0.5, atol=1e-4)
    # Centroid of coverage near the projected triangle centroid.
    rows, cols = np.where(occ)
    assert abs(cols.mean() - 40) < 4
    # Outside the triangle: empty corners.
    assert depth[0, 0] == 0 and depth[-1, -1] == 0
    _assert_same_render(depth, _render_jax(np.eye(4), verts, faces))


def test_depth_interpolation_slanted():
    # A slanted quad: depth varies across the surface; nearest face wins.
    verts = np.array([[-0.06, -0.06, 0.4], [0.06, -0.06, 0.6], [0.06, 0.06, 0.6],
                      [-0.06, 0.06, 0.4]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    depth = _render(np.eye(4), verts, faces)
    occ = depth > 0
    assert 0.39 < depth[occ].min() < 0.45
    assert 0.55 < depth[occ].max() < 0.61
    _assert_same_render(depth, _render_jax(np.eye(4), verts, faces))


def test_procedural_meshes_match_jax(tmp_path):
    # A box and an ellipsoid of 720 faces, turned, at 120 x 160 over several
    # pixel tiles (the last one ragged), against the JAX rasterizer; also a
    # pose with vertices behind the camera (the z > 1e-6 guard) and one
    # face masked out.
    k = K * np.array([[2.0], [2.0], [1.0]], np.float32)
    box_v, box_f = write_box_ply(str(tmp_path / "box.ply"), (0.1, 0.06, 0.04))
    ell_v, ell_f = ellipsoid_mesh(n_lat=16, n_lon=24)
    assert len(ell_f) == 720
    for i, (verts, faces) in enumerate(((box_v, box_f), (ell_v, ell_f))):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = Rotation.from_euler("xyz", [20 + 10 * i, 30, -15], degrees=True).as_matrix()
        pose[:3, 3] = [0.01, -0.005, 0.45]
        _assert_same_render(_render(pose, verts, faces, k, 120, 160, 4096),
                            _render_jax(pose, verts, faces, k, 120, 160, 4096))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.0, 0.0, 0.03]  # the ellipsoid straddles the image plane
    _assert_same_render(_render(pose, ell_v, ell_f, k, 120, 160),
                        _render_jax(pose, ell_v, ell_f, k, 120, 160))
    mask = np.ones(len(box_f), bool)
    mask[3] = False
    pose[:3, 3] = [0.0, 0.0, 0.4]
    args = (box_v, box_f[mask])
    np.testing.assert_array_equal(_render(pose, *args) > 0, _render_jax(pose, *args) > 0)


def test_mesh_render_matches_splat_coverage(tmp_path):
    # A box facing the camera rendered as triangles and as a dense point
    # splat: the same silhouette, and the triangle depth the nearest surface
    # except where a pixel centre lies on the front face's shared diagonal:
    # the edge functions have no tie rule, so both of its triangles can miss
    # it by a rounding and the back face shows through, in both packages.
    verts, faces = write_box_ply(str(tmp_path / "box.ply"), (0.12, 0.08, 0.06))
    mesh = assets.Mesh(verts, faces)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.0, 0.0, 0.5]
    depth_tri = _render(pose, verts, faces)
    pts, _ = assets.sample_surface(mesh, 4000)
    depth_splat = n(raster.render_object_depth(t(pose), t(pts), torch.ones(len(pts), dtype=torch.bool),
                                               t(K), H, W, radius=1))
    tri_occ, splat_occ = depth_tri > 0, depth_splat > 0
    assert (tri_occ & splat_occ).sum() / (tri_occ | splat_occ).sum() > 0.8
    both = tri_occ & splat_occ
    holes = both & (depth_tri > depth_splat + 0.01)
    assert holes.sum() <= 0.001 * both.sum()
    np.testing.assert_allclose(depth_tri[holes], _render_jax(pose, verts, faces)[holes], rtol=1e-5)
    assert (np.abs(depth_tri[both] - depth_splat[both]) < 0.01).mean() > 0.85


def test_decimation_bounds_faces():
    # A 12,800-face ellipsoid decimated to 2,000 faces: the same mesh as the
    # JAX package's decimation (numpy copies), extents kept.
    verts, faces = ellipsoid_mesh(n_lat=81, n_lon=80)
    mesh = assets.Mesh(verts, faces)
    assert len(mesh.faces) > 10000
    dec = assets.decimate_to_max_faces(mesh, 2000)
    assert 50 < len(dec.faces) <= 2000
    np.testing.assert_allclose(verts.max(0) - verts.min(0), dec.vertices.max(0) - dec.vertices.min(0),
                               rtol=0.15)
    want = jassets.decimate_to_max_faces(jassets.Mesh(verts, faces), 2000)
    np.testing.assert_array_equal(dec.vertices, want.vertices)
    np.testing.assert_array_equal(dec.faces, want.faces)
    assert assets.decimate_to_max_faces(mesh, len(faces)) is mesh
