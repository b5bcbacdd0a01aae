"""End-to-end on test_torch_e2e.py's two-box scene: the port's estimate_pose
in the SUPER4PCS, V4PCS and PPF_VOTING hypothesis modes and in the FCN,
FCNThreshold and RCNN segmentation modes (with a predictor and a detector
made from the ground truth), on the CPU against the JAX package's, and the
CLI in PPF_VOTING mode. No draws are injected end to end (the packages'
random streams differ): the outcomes are held, and the probability images
exactly. Exact parity with injected draws is held module by module
(test_torch_generators.py, test_torch_fcn.py, test_torch_detect.py,
test_torch_segmentation.py)."""

import numpy as np
import pytest

from _torch_common import jax_object_fields
from physimglobalpose_tpu import config as jconfig
from physimglobalpose_tpu.models import objectdb as jobjectdb
from physimglobalpose_tpu.pipeline import api as japi, scene as jscene
from physimglobalpose_tpu_torch import config as tconfig
from physimglobalpose_tpu_torch.models import objectdb
from physimglobalpose_tpu_torch.pipeline import api, scene
from test_torch_e2e import BOXES, H, INTR, ST_KW, W, _adds, _cfg, setup  # noqa: F401


def _dbs(s, cfg):
    jdb = jobjectdb.ObjectDB(s["jobjs"], {o.class_id: n for n, o in s["jobjs"].items()})
    tobjs = {n: objectdb.from_numpy(jax_object_fields(o), cfg, device="cpu")
             for n, o in s["jobjs"].items()}
    return jdb, objectdb.ObjectDB(tobjs, {o.class_id: n for n, o in tobjs.items()})


def _hold_outcomes(s, got, want, result_path=None):
    """The same objects as JAX; every object JAX puts within ADD-S 1 cm, the
    port puts there too; a result.txt row per object."""
    names = [b[0] for b in BOXES]
    assert [o.name for o in got.objects] == [o.name for o in want.objects] == names
    for est, jest in zip(got.objects, want.objects):
        pts = s["jobjs"][est.name].validation_pts[::2]
        assert np.isfinite(est.pose_cam).all()
        if _adds(jest.pose_cam, s["gt"][est.name], pts) < 0.01:
            assert _adds(est.pose_cam, s["gt"][est.name], pts) < 0.01, est.name
        np.testing.assert_allclose(est.pose_world, s["cam"] @ est.pose_cam, atol=1e-5)
    if result_path is not None:
        rows = [r.split() for r in open(result_path).read().splitlines()]
        assert [r[0] for r in rows] == names and all(len(r) == 8 for r in rows)


@pytest.mark.parametrize("mode", ["SUPER4PCS", "V4PCS", "PPF_VOTING"])
def test_hypothesis_modes_match_jax_on_box_scene(setup, mode):
    # SUPER4PCS and V4PCS take the batched branch (uniform bases, distance
    # pair lists over the 384-point search cloud), PPF_VOTING the per-object
    # one (64 reference points, the top 256 poses). No draws are injected;
    # outcomes are held (_hold_outcomes). Uniform bases need more of them
    # than StoCS's weighted ones: at 48 bases both packages left 2 of 12
    # (object, seed) draws over seeds 0-5 beyond 1 cm in SUPER4PCS mode, at
    # 96 none (measured on the CPU). So the distance modes run 96 bases of
    # 16 quads: the same 1,536 hypotheses an object as the PCS case.
    s = setup
    names = [b[0] for b in BOXES]
    st_kw = ST_KW if mode == "PPF_VOTING" else dict(ST_KW, num_bases=96, max_quads_per_base=16)
    jdb, tdb = _dbs(s, _cfg(tconfig))
    kw = dict(color=np.zeros((H, W, 3), np.uint8), depth=s["depth"], intrinsics=INTR,
              cam_pose=s["cam"], object_names=names, class_mask=s["label"])
    want = japi.estimate_pose("<memory>", jdb, scene=jscene.scene_from_arrays(**kw),
                              cfg=_cfg(jconfig, st_kw=st_kw), seed=0, hypothesis_mode=mode,
                              write_result=False)
    result_path = str(s["tmp"] / f"result_{mode}.txt")
    got = api.estimate_pose("<memory>", tdb, scene=scene.scene_from_arrays(**kw),
                            cfg=_cfg(tconfig, st_kw=st_kw), seed=0, hypothesis_mode=mode,
                            result_path=result_path, device="cpu")
    for jest in want.objects:
        pts = s["jobjs"][jest.name].validation_pts[::2]
        assert _adds(jest.pose_cam, s["gt"][jest.name], pts) < 0.01, (mode, jest.name)
    _hold_outcomes(s, got, want, result_path)
    assert all(o.hypotheses.shape == (25, 4, 4) and o.score > 0.1 for o in got.objects)


def _gt_networks(s):
    """A predictor and a detector made from the scene's ground truth: the
    class maps (1 inside the class, 0 elsewhere), the argmax label image and
    the background map, the three outputs of models/fcn.make_predictor; the
    boxes of the class masks."""
    label = s["label"]

    def predictor(color, ids, keys=(-1, -2)):
        out = {c: (label == c).astype(np.float32) for c in ids}
        out[keys[0]] = label.astype(np.int32)
        out[keys[1]] = np.where(label == 0, 1.0, 0.1).astype(np.float32)
        return out

    def detector(color, ids):
        out = {}
        for c in ids:
            ys, xs = np.nonzero(label == c)
            out[c] = (int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max()))
        return out

    return predictor, detector


@pytest.mark.parametrize("mode", ["FCN", "FCNThreshold", "RCNN"])
def test_neural_modes_with_injected_networks_match_jax(setup, mode, monkeypatch):
    # The probability images estimate_pose builds from an injected predictor
    # or detector equal the JAX package's exactly; the outcomes are held as
    # above. RCNN's box masks include the table inside each box, so JAX's
    # pose may miss 1 cm there; the port is held to 1 cm where JAX is.
    from physimglobalpose_tpu.pipeline import segmentation as jseg
    from physimglobalpose_tpu_torch.pipeline import segmentation as tseg

    s = setup
    names = [b[0] for b in BOXES]
    jdb, tdb = _dbs(s, _cfg(tconfig))
    predictor, detector = _gt_networks(s)
    kw = dict(color=np.zeros((H, W, 3), np.uint8), depth=s["depth"], intrinsics=INTR,
              cam_pose=s["cam"], object_names=names, class_mask=None)
    seen = {}

    def spy(mod, tag):
        real = mod.build_prob_images

        def wrapped(*a, **k):
            seen[tag] = real(*a, **k)
            return seen[tag]

        monkeypatch.setattr(mod, "build_prob_images", wrapped)

    spy(jseg, "jax")
    spy(tseg, "port")
    nets = dict(nn_predictor=predictor, detector=detector)
    want = japi.estimate_pose("<memory>", jdb, scene=jscene.scene_from_arrays(**kw),
                              cfg=_cfg(jconfig), seed=0, segmentation_mode=mode,
                              write_result=False, **nets)
    got = api.estimate_pose("<memory>", tdb, scene=scene.scene_from_arrays(**kw), cfg=_cfg(tconfig),
                            seed=0, segmentation_mode=mode, write_result=False, device="cpu",
                            **nets)
    assert set(seen["port"]) == set(seen["jax"]) == {1, 2}
    for c in (1, 2):
        np.testing.assert_array_equal(seen["port"][c], seen["jax"][c])
        assert seen["port"][c].sum() > 800
    _hold_outcomes(s, got, want)
    if mode != "RCNN":
        for est in got.objects:
            pts = s["jobjs"][est.name].validation_pts[::2]
            assert _adds(est.pose_cam, s["gt"][est.name], pts) < 0.01, est.name


def test_cli_drives_ppf_voting_on_the_cpu(setup, capsys):
    # `cli --hypothesis PPF_VOTING` on a CAM npz of one box, the small preset.
    from physimglobalpose_tpu_torch import cli

    s, tmp = setup, setup["tmp"]
    name, cls = BOXES[1][0], BOXES[1][1]
    np.savez(tmp / "scene_vote.npz", color=np.zeros((H, W, 3), np.uint8), depth=s["depth"],
             intrinsics=INTR, cam_pose=s["cam"], object_names=np.array([name]),
             class_mask=np.where(s["label"] == cls, cls, 0))
    (tmp / "obj_config_vote.yml").write_text(
        "objects:\n  num_objects: 1\n  modelDiscretization: 0.01\n"
        f"  object_1:\n    name: {name}\n    classId: {cls}\n    symmetry: [180, 180, 180]\n"
    )
    rc = cli.main([
        "--dataset", "CAM", "--scene", str(tmp / "scene_vote.npz"), "--obj-config",
        str(tmp / "obj_config_vote.yml"), "--model-dir", str(tmp), "--cache-dir",
        str(tmp / "cache_vote"), "--preset", "small", "--device", "cpu",
        "--hypothesis", "PPF_VOTING", "--result", str(tmp / "cli_vote.txt"),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.startswith(f"{name}: t=(") and '"hypothesis_s"' in out
    rows = (tmp / "cli_vote.txt").read_text().splitlines()
    assert len(rows) == 1 and rows[0].split()[0] == name
    t_world = np.array([float(x) for x in rows[0].split()[1:4]])
    assert np.linalg.norm(t_world - (s["cam"] @ s["gt"][name])[:3, 3]) < 0.01
