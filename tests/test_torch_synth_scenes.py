"""Port parity: scripts/make_synthetic_scenes.py of the port against the JAX
package's scripts/make_synthetic_scenes.py, on procedural box meshes (the
reference meshes are absent).

Both generators consume one np.random.Generator call for call; only the
renders differ (the port's render_mesh_depth against JAX's, equal up to
pixels on shared triangle edges, depth within 1e-5 relative elsewhere).
Each family at --n 1 is held scene by scene: gt_info.yml and its poses
equal, masks and decoded depth equal at >= 99.9 % of pixels, every other
mask pixel on an edge of either package's mask and every other depth pixel
there too or one codec step (0.1 mm) apart (the codec truncates, so a last
bit of a slanted face's depth can cross a step), hard_stats.json within
1e-6, and the scene read back through the port's loader."""

import json
import os
import sys

import numpy as np
import pytest
from PIL import Image

from chip_smoke import BOXES, write_box_ply, write_obj_config
from physimglobalpose_tpu_torch.geometry import depthio
from physimglobalpose_tpu_torch.pipeline import scene as scene_mod
from physimglobalpose_tpu_torch.scripts import make_synthetic_scenes

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

OBJECTS = ",".join(b[0] for b in BOXES)
FAMILIES = {
    "plain": [],
    "stack": ["--stack"],
    "hard": ["--hard"],
    "ycb": ["--dataset", "YCB"],
}


# --hard with a 3 cm cube in the packed line: it hides behind the others
# often enough that placements are redrawn (a decision on rendered pixels).
HIDDEN_BOXES = (("big", 1, (0.16, 0.10, 0.12)), ("mid", 2, (0.12, 0.08, 0.10)),
                ("tiny", 3, (0.03, 0.03, 0.02)))


def _write_assets(tmp, boxes):
    for name, _cls, size, *_rest in boxes:
        write_box_ply(str(tmp / f"{name}.ply"), size)
    return tmp, write_obj_config(tmp, boxes)


@pytest.fixture(scope="module")
def assets_dir(tmp_path_factory):
    return _write_assets(tmp_path_factory.mktemp("boxes"), BOXES)


def _generate(tmp_path, assets_dir, extra, seed=0, n=1, objects=OBJECTS):
    import make_synthetic_scenes as jax_generator

    model_dir, obj_cfg = assets_dir
    argv = ["--n", str(n), "--objects", objects, "--model-dir", str(model_dir),
            "--obj-config", str(obj_cfg), "--seed", str(seed)] + extra
    want, got = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_generator.main(["--out", want, "--platform", "cpu"] + argv)
    assert make_synthetic_scenes.main(["--out", got, "--device", "cpu"] + argv) == 0
    return [(os.path.join(got, f"scene_{k:04d}"), os.path.join(want, f"scene_{k:04d}"))
            for k in range(n)]


def _assert_same_scene(got_dir, want_dir, dataset, tie_class=None):
    """gt_info.yml equal, the images as _assert_same_images holds them,
    hard_stats.json within 1e-6; an occlusion fraction may move further by
    the share of its object's pixels that differ (see tie_class), plus
    JAX's rounding to 3 places."""
    with open(os.path.join(got_dir, "gt_info.yml")) as fh_g, \
            open(os.path.join(want_dir, "gt_info.yml")) as fh_w:
        assert fh_g.read() == fh_w.read()
    differ, mask_g, mask_w = _assert_same_images(got_dir, want_dir, dataset == "APC", tie_class)
    hard = os.path.join(want_dir, "hard_stats.json")
    assert os.path.exists(os.path.join(got_dir, "hard_stats.json")) == os.path.exists(hard)
    if os.path.exists(hard):
        with open(os.path.join(got_dir, "hard_stats.json")) as fh_g, open(hard) as fh_w:
            got, want = json.load(fh_g), json.load(fh_w)
        assert got.keys() == want.keys()
        assert got["occlusion_frac"].keys() == want["occlusion_frac"].keys()
        classes = {b[0]: b[1] for b in BOXES + HIDDEN_BOXES}
        for name, frac in want["occlusion_frac"].items():
            cls = classes[name]
            moved_px = int((differ & ((mask_g == cls) | (mask_w == cls))).sum())
            alone_px = max((mask_w == cls).sum(), 1) / max(1.0 - frac, 1e-3)
            tol = 1e-6 if moved_px == 0 else moved_px / alone_px + 5e-4 + 1e-6
            assert abs(got["occlusion_frac"][name] - frac) <= tol
        for key in ("tilt_deg", "dropout", "noise_mm", "distractor"):
            assert got[key] == want[key]
    return differ


def _edge(mask):
    """Pixels whose label differs from one of their 8 neighbours'."""
    pad = np.pad(mask, 1, mode="edge")
    h, w = mask.shape
    out = np.zeros(mask.shape, bool)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            out |= pad[dy:dy + h, dx:dx + w] != mask
    return out


def _assert_same_images(got_dir, want_dir, bit_rotated, tie_class=None):
    """Masks and decoded depth equal at >= 99.9 % of pixels, every other
    pixel on an edge or hole of JAX's mask (a depth pixel may also be one
    codec step off); colour at >= 99.9 %. tie_class: the first object's
    class, whose mask pixels may also differ from JAX's where the distractor
    (its duplicate, of the same height on the same table) covers it: the two
    top faces are coplanar, and the composite's `depth_obj < depth` there
    is decided by the renders' last bits. Those pixels are between that
    class and 0 and hold the same depth in both packages. Returns the
    pixels where the masks differ."""
    read = lambda d, kind: np.asarray(  # noqa: E731
        Image.open(os.path.join(d, f"frame-000000.{kind}.png"))).astype(np.int32)
    mask_g, mask_w = read(got_dir, "mask"), read(want_dir, "mask")
    raw = lambda d: depthio.read_depth_png_raw(  # noqa: E731
        os.path.join(d, "frame-000000.depth.png"), bit_rotated).astype(np.int32)
    depth_g, depth_w = raw(got_dir), raw(want_dir)
    assert mask_g.shape == (480, 640) and len(np.unique(mask_w)) > 1
    assert (depth_w > 0).mean() > 0.5
    tied = np.zeros(mask_g.shape, bool)
    if tie_class is not None:
        tied = ((np.minimum(mask_g, mask_w) == 0) & (np.maximum(mask_g, mask_w) == tie_class)
                & (depth_g == depth_w))
    allowed = _edge(mask_w) | tied  # JAX's own edges and holes
    for got, want, step in ((mask_g, mask_w, 0), (depth_g, depth_w, 1)):
        differ = got != want
        assert differ.mean() <= 1e-3
        assert not (differ & ~allowed & (np.abs(got - want) > step)).any()
    color_g, color_w = read(got_dir, "color"), read(want_dir, "color")
    assert color_g.shape == (480, 640, 3) and (color_g != color_w).any(-1).mean() <= 1e-3
    return mask_g != mask_w, mask_g, mask_w


@pytest.mark.parametrize("family", list(FAMILIES))
def test_generator_matches_jax(tmp_path, assets_dir, family):
    [(got_dir, want_dir)] = _generate(tmp_path, assets_dir, FAMILIES[family])
    dataset = "YCB" if family == "ycb" else "APC"
    _assert_same_scene(got_dir, want_dir, dataset)

    # The port's loader reads the scene back: names, poses, the depth codec.
    sc = scene_mod.load_scene(got_dir, dataset=dataset)
    assert sc.object_names == [b[0] for b in BOXES]
    assert sc.depth.shape == (480, 640) and sc.class_mask.shape == (480, 640)
    d = sc.depth[sc.depth > 0]
    assert 0.5 < d.min() and d.max() < (3.0 if family == "hard" else 0.81)  # a tilted table recedes
    table_z = float(sc.table_pose[2, 3])
    for name, pose in sc.gt_poses.items():
        assert pose[2, 3] > table_z - 0.01
        assert (sc.class_mask == dict((b[0], b[1]) for b in BOXES)[name]).sum() > 0
    if family == "stack":
        base, top = sc.gt_poses[BOXES[0][0]], sc.gt_poses[BOXES[1][0]]
        assert top[2, 3] > base[2, 3] + 0.02 and np.linalg.norm(top[:2, 3] - base[:2, 3]) < 0.05
    if family == "hard":
        assert abs(sc.cam_pose[2, 2] + 1.0) > 0.1 and (sc.depth == 0).mean() > 0.05


def test_hard_redraws_follow_jax(tmp_path, monkeypatch):
    # Two --hard scenes whose placements are redrawn while the cube is hidden:
    # each redraw decision reads rendered pixels, and the draws after it (the
    # second scene's too) stay the JAX script's: the same number of
    # placements drawn, the same poses.
    import make_synthetic_scenes as jax_generator

    model_dir, obj_cfg = _write_assets(tmp_path, HIDDEN_BOXES)
    names = [b[0] for b in HIDDEN_BOXES]
    argv = ["--n", "2", "--objects", ",".join(names), "--model-dir", str(model_dir),
            "--obj-config", str(obj_cfg), "--seed", "0", "--hard"]
    placements = []
    default_rng = np.random.default_rng

    class Counted:  # counts the placements drawn (one permutation each)
        def __init__(self, seed):
            self.rng = default_rng(seed)

        def permutation(self, n):
            placements[-1] += 1
            return self.rng.permutation(n)

        def __getattr__(self, name):
            return getattr(self.rng, name)

    monkeypatch.setattr(np.random, "default_rng", Counted)
    placements.append(0)
    jax_generator.main(["--out", str(tmp_path / "jax"), "--platform", "cpu"] + argv)
    placements.append(0)
    make_synthetic_scenes.main(["--out", str(tmp_path / "torch"), "--device", "cpu"] + argv)
    assert placements[0] == placements[1] > 2  # redrawn at least once, in both

    tied = 0
    for k in range(2):
        got_dir, want_dir = (str(tmp_path / side / f"scene_{k:04d}") for side in ("torch", "jax"))
        tied += int(_assert_same_scene(got_dir, want_dir, "APC",
                                       tie_class=HIDDEN_BOXES[0][1]).sum())
    assert tied > 0  # the coplanar tie shows in this stream (77 pixels of scene 0)


def test_generator_consumes_jax_draws_over_scenes(tmp_path, assets_dir):
    # Three plain scenes from one stream: the draws of scenes 2 and 3 follow
    # from the first's, so equal poses there mean the stream was consumed in
    # the JAX script's order.
    import make_synthetic_scenes as jax_generator

    model_dir, obj_cfg = assets_dir
    argv = ["--n", "3", "--objects", OBJECTS, "--model-dir", str(model_dir),
            "--obj-config", str(obj_cfg), "--seed", "7"]
    jax_generator.main(["--out", str(tmp_path / "jax"), "--platform", "cpu"] + argv)
    make_synthetic_scenes.main(["--out", str(tmp_path / "torch"), "--device", "cpu"] + argv)
    for k in range(3):
        got = scene_mod.load_scene(str(tmp_path / "torch" / f"scene_{k:04d}"), load_color=False)
        want = scene_mod.load_scene(str(tmp_path / "jax" / f"scene_{k:04d}"), load_color=False)
        for name in want.gt_poses:
            np.testing.assert_array_equal(got.gt_poses[name], want.gt_poses[name])


def test_generator_needs_its_inputs_and_the_card(tmp_path, assets_dir):
    model_dir, obj_cfg = assets_dir
    with pytest.raises(SystemExit):  # --model-dir and --obj-config have no default
        make_synthetic_scenes.parse_args(["--out", str(tmp_path)])
    with pytest.raises(SystemExit, match="separate"):
        make_synthetic_scenes.main(["--out", str(tmp_path), "--hard", "--stack", "--device", "cpu",
                                    "--model-dir", str(model_dir), "--obj-config", str(obj_cfg)])
    assert make_synthetic_scenes.parse_args(
        ["--out", "x", "--model-dir", "m", "--obj-config", "c"]).device == "cuda"
