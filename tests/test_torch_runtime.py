"""The port's native runtime (runtime/physim_runtime.cc through ctypes,
built with g++ into build/runtime/) against the pure-Python paths and the
JAX package's numpy oracles. Mirrors tests/test_runtime_native.py on
procedural meshes."""

import numpy as np
import pytest

from _torch_common import ellipsoid_mesh, write_ply_binary
from chip_smoke import write_box_ply
from physimglobalpose_tpu.models import assets as jassets
from physimglobalpose_tpu.ops import ppf as jppf
from physimglobalpose_tpu_torch import runtime
from physimglobalpose_tpu_torch.models import assets
from physimglobalpose_tpu_torch.ops import ppf


@pytest.fixture(scope="module")
def lib():
    lib = runtime.get_lib()
    assert lib is not None, f"the native runtime did not build: {runtime.BUILD_LOG}"
    return lib


def test_library_builds_under_build_dir(lib):
    path = runtime.library_path()
    assert path.exists() and path.parent.name == "runtime" and path.parent.parent.name == "build"
    assert not (runtime.SOURCE.parent / "libphysim_runtime.so").exists()


@pytest.mark.parametrize("kind", ["ascii_box", "binary_ellipsoid"])
def test_native_ply_matches_python(lib, tmp_path, kind):
    path = str(tmp_path / f"{kind}.ply")
    if kind == "ascii_box":
        write_box_ply(path, (0.1, 0.06, 0.04))
    else:
        write_ply_binary(path, *ellipsoid_mesh(n_lat=12, n_lon=16))
    py = assets.load_ply(path)
    nat = runtime.load_mesh_native(path)
    assert nat is not None
    np.testing.assert_allclose(nat[0], py.vertices, atol=0)
    np.testing.assert_array_equal(nat[1], py.faces)
    # load_mesh prefers the native parser; the JAX package's parser agrees.
    mesh = assets.load_mesh(path)
    np.testing.assert_array_equal(mesh.faces, jassets.load_ply(path).faces)
    np.testing.assert_array_equal(mesh.vertices, jassets.load_ply(path).vertices)


def test_native_obj_matches_python(lib, tmp_path):
    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 3 4\n")
    py = assets.load_obj(str(obj))
    nat = runtime.load_mesh_native(str(obj))
    np.testing.assert_allclose(nat[0], py.vertices)
    np.testing.assert_array_equal(nat[1], py.faces)
    assert len(py.faces) == 2  # fan triangulation of the quad
    assert runtime.load_mesh_native(str(tmp_path / "missing.ply")) is None


def test_native_ppf_matches_numpy(lib):
    rng = np.random.default_rng(0)
    n = 60
    pts = rng.uniform(-0.05, 0.05, size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)

    nat = runtime.build_ppf_native(pts, nrm, 5, 10, 640)
    assert nat is not None
    offsets_n, counts_n, pairs_n = nat

    # numpy oracle (the ops/ppf.py fallback path, bypassing the native hook)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    mask = ii != jj
    ii, jj = ii[mask], jj[mask]
    bins = jppf.ppf_bins_np(pts[ii], nrm[ii], pts[jj], nrm[jj])
    keep = bins >= 0
    ii, jj, bins = ii[keep], jj[keep], bins[keep]

    # Same totals and per-bin counts.
    assert counts_n.sum() == len(bins)
    np.testing.assert_array_equal(counts_n, np.bincount(bins, minlength=len(counts_n)))
    # Same pair sets per bin (order within a bin may differ).
    nz = np.nonzero(counts_n)[0]
    for b in nz[:20]:
        got = {tuple(p) for p in pairs_n[offsets_n[b]: offsets_n[b] + counts_n[b]]}
        want = {(int(a), int(c)) for a, c in zip(ii[bins == b], jj[bins == b])}
        assert got == want
    # build_ppf_table takes the native path and gives the JAX package's table.
    tab, jtab = ppf.build_ppf_table(pts, nrm, device="cpu"), jppf.build_ppf_table(pts, nrm)
    np.testing.assert_array_equal(tab.counts.numpy(), np.asarray(jtab.counts))
    np.testing.assert_array_equal(tab.offsets.numpy(), np.asarray(jtab.offsets))
    np.testing.assert_array_equal(tab.pairs.numpy(), np.asarray(jtab.pairs))
    with pytest.raises(ValueError):
        runtime.build_ppf_native(pts[:, :2], nrm[:, :2], 5, 10, 640)
