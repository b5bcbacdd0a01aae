"""Port parity: models/fcn.py (the FCN zoo, the weight converter, the serving
predictor with its three outputs and TTA, the labeler) against the JAX
package's Flax modules and predictors, on numpy inputs from a seed.

Tolerances (max abs difference of the logits over the largest |logit|):
float32 1e-4 (measured ~1e-5 for the ResNets, ~1e-6 for the VGGs); bf16
5e-2 (measured 0.5-0.9 % for the VGGs, 2.3 % for the ResNets: bf16 keeps 8
significant bits and the two packages round 20-50 convolutions in different
orders). Shipped checkpoints through both predictors: maps and background
within 2e-2 (float16 outputs, bf16 nets), label images agreeing on >= 99 %
of pixels. Small canvases keep the CPU time down (the shipped net at 640x640
is ~10 GFLOP a frame)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from physimglobalpose_tpu.models import fcn as jfcn
from physimglobalpose_tpu_torch.models import fcn

TOL_F32, TOL_BF16 = 1e-4, 5e-2
TOL_MAPS, MIN_LABEL_AGREEMENT = 2e-2, 0.99
CANVAS = (128, 160)


def _flat(params):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def _image(seed, h=120, w=160):
    """Seeded uint8 frame: a few flat-coloured rectangles on noise."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(40, 120, size=(h, w, 3))
    for _ in range(4):
        y, x = rng.integers(0, h - 30), rng.integers(0, w - 40)
        img[y:y + 30, x:x + 40] = rng.uniform(0, 255, size=3)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(jfcn.MODEL_ZOO))
def test_model_zoo_matches_flax(name, dtype, rng):
    # Full-width VGG entries run at a quarter of their width (width_scale is
    # a field of the same module); the ResNets have no width option.
    kw = dict(width_scale=0.25) if "Vgg16" in name and not name.endswith("_small") else {}
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jmodel = jfcn.MODEL_ZOO[name](num_classes=5, dtype=jdt, **kw)
    x = rng.uniform(size=(1, 64, 96, 3)).astype(np.float32)
    params = jmodel.init(jax.random.key(0), jnp.asarray(x))["params"]
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model = fcn.load_flax_params(fcn.MODEL_ZOO[name](num_classes=5, dtype=tdt, **kw), _flat(params))
    with torch.no_grad():
        got = model(torch.as_tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 64, 96, 5) and got.dtype == np.float32
    tol = TOL_F32 if dtype == "float32" else TOL_BF16
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_converter_carries_every_shipped_parameter():
    flat, meta = fcn.load_params_npz(fcn.shipped_checkpoint_path("small"))
    jflat, jmeta = jfcn.load_params_npz(jfcn.shipped_checkpoint_path("small"))
    assert meta == jmeta and meta["model"] == "AtrousFCN_Vgg16_16s_small"
    assert set(flat) == set(_flat(jflat))
    sd = fcn.flax_to_state_dict(flat)
    model = fcn.build_model(meta["model"], meta["num_classes"])
    assert set(sd) == set(model.state_dict())
    # HWIO -> OIHW.
    k = flat["fc6/kernel"]
    assert k.shape == (7, 7, 64, 512) and sd["fc6.weight"].shape == (512, 64, 7, 7)
    np.testing.assert_array_equal(sd["fc6.weight"][5, 3].numpy(), k[:, :, 3, 5])
    np.testing.assert_array_equal(sd["VGGBlock_0.block1_conv1.bias"].numpy(),
                                  flat["VGGBlock_0/block1_conv1/bias"])
    gn = {"G/GroupNorm_0/scale": np.ones(4, np.float32), "G/GroupNorm_0/bias": np.zeros(4, np.float32)}
    assert set(fcn.flax_to_state_dict(gn)) == {"G.GroupNorm_0.weight", "G.GroupNorm_0.bias"}
    with pytest.raises(ValueError):
        fcn.flax_to_state_dict({"a/b/embedding": np.zeros(2, np.float32)})


def test_same_padding_matches_lax():
    for size, k, stride, dil in ((8, 3, 2, 1), (9, 3, 2, 1), (8, 7, 2, 1), (20, 7, 1, 2),
                                 (15, 3, 2, 1), (64, 1, 1, 1)):
        want = jax.lax.padtype_to_pads((size,), ((k - 1) * dil + 1,), (stride,), "SAME")[0]
        assert fcn.same_pads(size, k, stride, dil) == tuple(want), (size, k, stride, dil)


def _both_predictors(variant, tta):
    jpred = jfcn.load_shipped_predictor(input_size=CANVAS, variant=variant, tta_scales=tta)
    tpred = fcn.load_shipped_predictor(input_size=CANVAS, variant=variant, tta_scales=tta,
                                       device="cpu")
    return jpred, tpred


@pytest.mark.parametrize("tta", [(1.0,), (0.5, 0.75, 1.0)], ids=["native", "tta"])
@pytest.mark.parametrize("variant", ["small", "prior"])
def test_shipped_predictor_matches_jax(variant, tta):
    jpred, tpred = _both_predictors(variant, tta)
    img = _image(3)
    want, got = jpred(img, [1, 2, 5]), tpred(img, [1, 2, 5])
    assert set(got) == set(want) == {1, 2, 5, fcn.PREDICTOR_LABEL_KEY, fcn.PREDICTOR_BACKGROUND_KEY}
    for c in (1, 2, 5, fcn.PREDICTOR_BACKGROUND_KEY):
        assert got[c].shape == img.shape[:2] and got[c].dtype == np.float32
        assert np.abs(got[c] - want[c]).max() <= TOL_MAPS, c
    label = got[fcn.PREDICTOR_LABEL_KEY]
    assert label.dtype == np.int32 and label.max() < 12
    assert (label == want[fcn.PREDICTOR_LABEL_KEY]).mean() >= MIN_LABEL_AGREEMENT


def test_predictor_interface():
    # tests/test_fcn.py::test_predictor_interface on the port, and against JAX.
    jmodel = jfcn.build_model("FCN_Vgg16_32s_small", num_classes=4)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"]
    model = fcn.load_flax_params(fcn.build_model("FCN_Vgg16_32s_small", num_classes=4), _flat(params))
    pred = fcn.make_predictor(model, input_size=(32, 32))
    color = np.random.default_rng(1).integers(0, 256, (24, 28, 3)).astype(np.uint8)
    out = pred(color, [1, 2])
    want = jfcn.make_predictor(jmodel, params, [1, 2], input_size=(32, 32))(color, [1, 2])
    assert set(out) == {1, 2, fcn.PREDICTOR_LABEL_KEY, fcn.PREDICTOR_BACKGROUND_KEY}
    label = out[fcn.PREDICTOR_LABEL_KEY]
    assert label.shape == (24, 28) and label.dtype == np.int32 and 0 <= label.min() <= label.max() <= 3
    for c in (1, 2, fcn.PREDICTOR_BACKGROUND_KEY):
        assert out[c].shape == (24, 28) and 0 <= out[c].min() and out[c].max() <= 1.0 + 1e-5
        assert np.abs(out[c] - want[c]).max() <= TOL_MAPS
    assert (label == want[fcn.PREDICTOR_LABEL_KEY]).mean() >= MIN_LABEL_AGREEMENT
    with pytest.raises(ValueError, match="1.0"):
        fcn.make_predictor(model, tta_scales=(0.5,))


def test_make_labeler_matches_jax():
    flat, meta = fcn.load_params_npz(fcn.shipped_checkpoint_path("prior"))
    jparams, _ = jfcn.load_params_npz(jfcn.shipped_checkpoint_path("prior"))
    jmodel = jfcn.build_model(meta["model"], meta["num_classes"])
    model = fcn.load_flax_params(fcn.build_model(meta["model"], meta["num_classes"]), flat)
    img = _image(5)
    kw = dict(input_size=CANVAS, tta_scales=(0.5, 1.0))
    want = jfcn.make_labeler(jmodel, 120, 160, **kw)(jparams, img)
    got = fcn.make_labeler(model, 120, 160, **kw)(img)
    assert got.shape == (120, 160) and (got == want).mean() >= MIN_LABEL_AGREEMENT
    assert len(np.unique(got)) > 1


def test_full_variant_ships_no_checkpoint():
    with pytest.raises(FileNotFoundError):
        fcn.load_shipped_predictor(variant="full", device="cpu")
