"""Port parity: utils/segdata.py and utils/synthdata.py against the JAX
package's, on procedural meshes (the reference meshes are absent). Mirrors
tests/test_utils.py's segdata cases and the contracts of
tests/test_synthdata_transfer.py.

Both generators draw from one np.random.Generator in the same order; only
the renders differ (the port's render_mesh_depth against the JAX one, equal
up to edge pixels). A pixel count that depends on such a pixel can move a
later draw, so crop_batch and colorize_from_label_depth are held on
identical inputs, bit for bit, and whole scenes by their labels (>= 99.9 %
of pixels) and poses."""

import colorsys

import numpy as np
import pytest

from _torch_common import ellipsoid_mesh
from physimglobalpose_tpu.utils import segdata as jsegdata, synthdata as jsynthdata
from physimglobalpose_tpu_torch.models import assets
from physimglobalpose_tpu_torch.utils import segdata, synthdata

OBJECTS = {
    "kleenex_tissue_box": 8,
    "expo_dry_erase_board_eraser": 2,
    "folgers_classic_roast_coffee": 3,
}
INTR = np.array([[307.0, 0.0, 160.0], [0.0, 307.0, 120.0], [0.0, 0.0, 1.0]], np.float32)


def _box(size):
    half = np.asarray(size, np.float32) / 2
    v = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                 np.float32) * half
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return assets.Mesh(v, f)


def procedural_meshes():
    """Stand-ins of the three objects' sizes: two boxes and a can-like
    ellipsoid of 480 faces."""
    return {
        "kleenex_tissue_box": _box((0.24, 0.12, 0.09)),
        "expo_dry_erase_board_eraser": _box((0.13, 0.05, 0.035)),
        "folgers_classic_roast_coffee": assets.Mesh(*ellipsoid_mesh((0.065, 0.065, 0.08), 16, 16)),
    }


@pytest.fixture(scope="module")
def meshes():
    return procedural_meshes()


def test_segdata_batches():
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, size=(40, 50, 3), dtype=np.uint8) for _ in range(4)]
    labs = [rng.integers(0, 3, size=(40, 50)).astype(np.uint8) for _ in range(4)]
    labs[0][:5] = 255
    cfg = segdata.AugmentConfig(target_size=(32, 32), ignore_label=255)
    it = segdata.batches(imgs, labs, num_classes=3, batch_size=2, cfg=cfg, epochs=1)
    b_img, b_lab = next(it)
    assert b_img.shape == (2, 32, 32, 3) and b_img.dtype == np.float32
    assert b_lab.shape == (2, 32, 32) and b_lab.dtype == np.int32
    assert b_img.max() <= 1.0
    assert b_lab.max() <= 3  # ignore label remapped to num_classes
    # The numpy copy yields the JAX package's batches from the same seed.
    jcfg = jsegdata.AugmentConfig(target_size=(32, 32), ignore_label=255)
    got = list(segdata.batches(imgs, labs, 3, 2, cfg, seed=5, epochs=2))
    want = list(jsegdata.batches(imgs, labs, 3, 2, jcfg, seed=5, epochs=2))
    assert len(got) == len(want) == 4
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_segdata_pad_uses_ignore():
    rng = np.random.default_rng(1)
    img = np.zeros((10, 10, 3), np.uint8)
    lab = np.zeros((10, 10), np.uint8)
    out_img, out_lab = segdata.pad_or_crop(img, lab, (16, 16), rng, mode="none", ignore_label=255)
    assert out_lab.shape == (16, 16)
    assert (out_lab[12:, :] == 255).all()
    zi, zl = segdata.random_zoom(np.arange(300).reshape(10, 10, 3), lab + 1, 1.5)
    wi, wl = jsegdata.random_zoom(np.arange(300).reshape(10, 10, 3), lab + 1, 1.5)
    np.testing.assert_array_equal(zi, wi)
    np.testing.assert_array_equal(zl, wl)


def test_crop_batch_and_colorize_match_jax():
    rng = np.random.default_rng(2)
    colors = [rng.integers(0, 255, size=(60, 80, 3), dtype=np.uint8) for _ in range(3)]
    labels = [np.zeros((60, 80), np.int32) for _ in range(3)]
    labels[0][10:30, 20:50] = 3
    labels[2][40:55, 5:25] = 8
    depth = rng.uniform(0.6, 0.8, size=(60, 80)).astype(np.float32)
    for seed in range(3):
        got = synthdata.crop_batch(colors, labels, np.random.default_rng(seed), 5, 32)
        want = jsynthdata.crop_batch(colors, labels, np.random.default_rng(seed), 5, 32)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for dr in (False, True):
            np.testing.assert_array_equal(
                synthdata.colorize_from_label_depth(labels[0], depth, np.random.default_rng(seed), dr),
                jsynthdata.colorize_from_label_depth(labels[0], depth, np.random.default_rng(seed), dr))
    np.testing.assert_array_equal(synthdata.class_color(5), jsynthdata.class_color(5))


@pytest.mark.parametrize("kind", ["palette", "palette_dr", "transfer", "prior"])
def test_scenes_match_jax(meshes, kind):
    def render(mod, seed):
        rng = np.random.default_rng(seed)
        if kind.startswith("palette"):
            out = mod.render_scene(meshes, OBJECTS, rng, INTR, 240, 320,
                                   domain_random=kind == "palette_dr",
                                   **({"device": "cpu"} if mod is synthdata else {}))
        else:
            out = mod.render_scene_transfer(
                meshes, OBJECTS, rng, INTR, 240, 320,
                color_priors=synthdata.PRODUCT_COLOR_PRIORS if kind == "prior" else None,
                **({"device": "cpu"} if mod is synthdata else {}))
        return out, rng.random()

    for seed in (0, 1):
        (color, label, poses, depth), tail = render(synthdata, seed)
        (jcolor, jlabel, jposes, jdepth), jtail = render(jsynthdata, seed)
        assert (label == jlabel).mean() >= 0.999
        assert poses.keys() == jposes.keys()
        for k in poses:
            np.testing.assert_allclose(poses[k], jposes[k], atol=1e-6)
        both = (depth > 0) & (jdepth > 0)
        np.testing.assert_allclose(depth[both], jdepth[both], rtol=1e-5)
        assert color.shape == jcolor.shape and color.dtype == jcolor.dtype == np.uint8
        if (label == jlabel).all():  # then every draw is the same
            assert tail == jtail


def test_transfer_scene_contract(meshes):
    rng = np.random.default_rng(3)
    color, label, poses, depth = synthdata.render_scene_transfer(
        meshes, OBJECTS, rng, INTR, 240, 320, device="cpu")
    assert color.shape == (240, 320, 3) and color.dtype == np.uint8
    assert label.shape == (240, 320) and depth.shape == (240, 320)
    placed = {OBJECTS[n] for n in poses}
    assert set(np.unique(label)) - {0} == placed
    for c in placed:
        assert (label == c).sum() >= 50
    assert (depth[label > 0] > 0.1).all()
    for pose in poses.values():
        assert 0.3 < pose[2, 3] < 2.0


def test_transfer_appearance_is_class_agnostic(meshes):
    # The dominant colour's hue of a class across scenes is stable for the
    # palette generator and not for the transfer generator.
    def dominant_hues(render, n_scenes):
        out = []
        for s in range(n_scenes):
            color, label, _, _ = render(np.random.default_rng(100 + s))
            sel = label == OBJECTS["folgers_classic_roast_coffee"]
            if sel.sum() < 100:
                continue
            px = color[sel].astype(np.float32) / 255.0
            q = np.clip((px * 3).astype(int), 0, 2)
            bins = q[:, 0] * 9 + q[:, 1] * 3 + q[:, 2]
            dom = np.bincount(bins, minlength=27).argmax()
            hue, sat, _ = colorsys.rgb_to_hsv(*px[bins == dom].mean(0))
            if sat > 0.25:
                out.append(hue)
        return np.asarray(out)

    def circ_std(h):
        return float(np.sqrt(-2 * np.log(np.abs(np.exp(2j * np.pi * h).mean()))))

    transfer = dominant_hues(lambda rng: synthdata.render_scene_transfer(
        meshes, OBJECTS, rng, INTR, 240, 320, device="cpu"), 14)
    palette = dominant_hues(lambda rng: synthdata.render_scene(
        meshes, OBJECTS, rng, INTR, 240, 320, device="cpu"), 14)
    assert len(transfer) >= 5 and len(palette) >= 5
    assert circ_std(palette) < 0.15, f"palette hue drifts: {circ_std(palette):.3f}"
    assert circ_std(transfer) > 0.3, f"transfer hue too stable: {circ_std(transfer):.3f}"


def test_prior_appearance_keys_product_colors(meshes):
    f_red, k_red = [], []
    for s in range(16):
        color, label, _, _ = synthdata.render_scene_transfer(
            meshes, OBJECTS, np.random.default_rng(200 + s), INTR, 240, 320,
            color_priors=synthdata.PRODUCT_COLOR_PRIORS, device="cpu")
        for name, acc in (("folgers_classic_roast_coffee", f_red), ("kleenex_tissue_box", k_red)):
            sel = label == OBJECTS[name]
            if sel.sum() < 100:
                continue
            px = color[sel].astype(np.float32) / 255.0
            acc.append(float((px[:, 0] - px[:, 1:].max(1)).mean()))
    assert len(f_red) >= 6 and len(k_red) >= 6
    fm, km = float(np.mean(f_red)), float(np.mean(k_red))
    assert fm > km + 0.05, f"prior lost product color keying: {fm:.3f} vs {km:.3f}"
    assert km < 0.02, f"kleenex reads red: {km:.3f}"


def test_transfer_background_split(meshes):
    color, label, _, depth = synthdata.render_scene_transfer(
        meshes, OBJECTS, np.random.default_rng(11), INTR, 240, 320, device="cpu")
    bg = label == 0
    sky, table = bg & (depth <= 0), bg & (depth > 0)
    assert sky.sum() > 500 and table.sum() > 500
    lum = color.astype(np.float32).mean(-1)
    assert lum[table].mean() > lum[sky].mean()


def test_write_scene_dir_reads_back(meshes, tmp_path):
    from physimglobalpose_tpu_torch.pipeline import scene

    color, label, poses, depth = synthdata.render_scene(
        meshes, OBJECTS, np.random.default_rng(4), INTR, 240, 320, device="cpu")
    gt = synthdata.write_scene_dir(str(tmp_path / "s"), color, depth, label, INTR, poses)
    sc = scene.load_scene(str(tmp_path / "s"))
    assert sc.object_names == list(poses)
    np.testing.assert_allclose(sc.depth, depth, atol=1e-4)
    np.testing.assert_array_equal(sc.color, color)
    for name, pw in gt.items():
        np.testing.assert_allclose(sc.cam_pose @ poses[name], pw, atol=1e-5)
