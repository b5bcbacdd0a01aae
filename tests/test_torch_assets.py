"""Port parity: models/assets, ops/ppf, models/objectdb (the .npz cache, apart from the JAX package's)."""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_common import jax_object_fields, n, t
from chip_smoke import write_box_ply
from physimglobalpose_tpu.config import PipelineConfig as JCfg
from physimglobalpose_tpu.models import assets as jassets, objectdb as jobjectdb
from physimglobalpose_tpu.ops import ppf as jppf
from physimglobalpose_tpu_torch.config import PipelineConfig
from physimglobalpose_tpu_torch.models import assets, objectdb
from physimglobalpose_tpu_torch.ops import ppf

SMALL = dict(max_model_points=256, max_validation_points=512)


def _unit(rng, k):
    v = rng.normal(size=(k, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_mesh_parse_and_sampling_match_jax(tmp_path):
    path = str(tmp_path / "box.ply")
    verts, tris = write_box_ply(path, (0.1, 0.06, 0.04))
    mesh = assets.load_mesh(path)
    np.testing.assert_array_equal(mesh.vertices, verts)
    np.testing.assert_array_equal(mesh.faces, tris)
    jmesh = jassets.load_ply(path)
    for nn in (64, 500):
        a, b = assets.sample_surface(mesh, nn, seed=3), jassets.sample_surface(jmesh, nn, seed=3)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(assets.convex_hull_planes(verts), jassets.convex_hull_planes(verts))
    np.testing.assert_array_equal(assets.convex_hull_points(verts, 6), jassets.convex_hull_points(verts, 6))


def test_ppf_bins_torch_match_jax(rng):
    k = 2000
    p1 = rng.uniform(-0.2, 0.2, size=(k, 3)).astype(np.float32)
    p2 = rng.uniform(-0.2, 0.2, size=(k, 3)).astype(np.float32)
    n1, n2 = _unit(rng, k), _unit(rng, k)
    want = np.asarray(jppf.ppf_bins_jax(*(jnp.asarray(a) for a in (p1, n1, p2, n2))))
    got = n(ppf.ppf_bins_torch(t(p1), t(n1), t(p2), t(n2)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ppf.ppf_bins_np(p1, n1, p2, n2), jppf.ppf_bins_np(p1, n1, p2, n2))


def test_ppf_table_and_gather_pairs_match_jax(rng):
    pts = rng.uniform(-0.05, 0.05, size=(60, 3)).astype(np.float32)
    nrm = _unit(rng, 60)
    tab = ppf.build_ppf_table(pts, nrm)
    jtab = jppf.build_ppf_table(pts, nrm)
    np.testing.assert_array_equal(n(tab.presence), np.asarray(jtab.presence))
    np.testing.assert_array_equal(n(tab.offsets), np.asarray(jtab.offsets))
    np.testing.assert_array_equal(n(tab.counts), np.asarray(jtab.counts))
    np.testing.assert_array_equal(n(tab.pairs), np.asarray(jtab.pairs))
    occupied = np.flatnonzero(np.asarray(jtab.counts))
    bins = np.concatenate([occupied[:40], [-1, 0, occupied[-1]]]).astype(np.int32)
    got_p, got_m = ppf.gather_pairs(tab, t(bins, None), 4)
    for i, b in enumerate(bins):
        want_p, want_m = jppf.gather_pairs(jtab, jnp.asarray(b), 4)
        np.testing.assert_array_equal(n(got_p[i]), np.asarray(want_p))
        np.testing.assert_array_equal(n(got_m[i]), np.asarray(want_m))


@pytest.fixture(scope="module")
def box_ply(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh") / "box.ply")
    write_box_ply(path, (0.12, 0.08, 0.05))
    return path


def test_prepare_object_matches_jax(box_ply):
    got = objectdb.prepare_object("box", box_ply, 3, [180, 180, 180],
                                  config=PipelineConfig(**SMALL), device="cpu")
    want = jobjectdb.prepare_object("box", box_ply, 3, [180, 180, 180], config=JCfg(**SMALL))
    fields = jax_object_fields(want)
    for key in ("search_pts", "search_nrm", "search_mask", "validation_pts", "validation_nrm",
                "hull_pts", "hull_mask", "hull_eqs"):
        np.testing.assert_array_equal(getattr(got, key), fields[key], err_msg=key)
    assert got.diameter == want.diameter
    for key in ("presence", "offsets", "counts", "pairs"):
        np.testing.assert_array_equal(n(getattr(got.ppf_table, key)), fields[key], err_msg=key)


def test_npz_cache_shared_with_jax(box_ply, tmp_path):
    cache = str(tmp_path / "cache")
    want = jobjectdb.prepare_object("box", box_ply, 3, [0, 0, 0], config=JCfg(**SMALL),
                                    cache_dir=cache)
    import os

    # A directory shared with the JAX package: the port writes its own file
    # beside the JAX package's and never reads that one; its second call
    # reads its own file back.
    built = objectdb.prepare_object("box", box_ply, 3, [0, 0, 0], config=PipelineConfig(**SMALL),
                                    cache_dir=cache, device="cpu")
    assert len(os.listdir(cache)) == 2
    stamps = {f: os.stat(os.path.join(cache, f)).st_mtime_ns for f in os.listdir(cache)}
    got = objectdb.prepare_object("box", box_ply, 3, [0, 0, 0], config=PipelineConfig(**SMALL),
                                  cache_dir=cache, device="cpu")
    assert {f: os.stat(os.path.join(cache, f)).st_mtime_ns for f in os.listdir(cache)} == stamps
    for model in (built, got):
        np.testing.assert_array_equal(model.validation_pts, want.validation_pts)
        np.testing.assert_array_equal(n(model.ppf_table.pairs), np.asarray(want.ppf_table.pairs))


def test_from_numpy_carries_jax_assets(box_ply):
    want = jobjectdb.prepare_object("box", box_ply, 3, [180, 0, 0], config=JCfg(**SMALL))
    got = objectdb.from_numpy(jax_object_fields(want), PipelineConfig(**SMALL), device="cpu")
    assert (got.name, got.class_id) == ("box", 3)
    np.testing.assert_array_equal(got.symmetry, want.symmetry)
    np.testing.assert_array_equal(got.mesh.faces, want.mesh.faces)
    np.testing.assert_array_equal(got.search_pts, want.search_pts)
    np.testing.assert_array_equal(n(got.ppf_table.counts), np.asarray(want.ppf_table.counts))
    assert got.ppf_table.trans_disc == want.ppf_table.trans_disc


def test_entry_points_refuse_a_missing_card(box_ply):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        objectdb.prepare_object("box", box_ply, 3, [0, 0, 0], config=PipelineConfig(**SMALL))
