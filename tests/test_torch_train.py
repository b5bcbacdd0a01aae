"""Port parity: the training halves of models/fcn.py and models/detect.py
(the losses, the Adam train steps, make_targets, save_params_npz) against
the JAX package's, and a port-trained checkpoint served by both packages.
Mirrors tests/test_fcn.py and tests/test_detector_net.py.

Tolerances:
- losses in float32 nets on the CPU: rtol 1e-4;
- Adam's update is lr m/(sqrt(v) + eps): on the first step lr g/(|g| + eps),
  so a gradient whose sign is rounding noise moves a parameter by up to lr
  either way in either package. So the gradients are held first, each
  tensor within 1e-4 of its largest magnitude (an element that is a sum
  cancelling to rounding noise has no relative accuracy), and the updated
  parameters only where the gradient element is within rtol 1e-4 itself,
  there within 2 lr x 1e-4: the first update's derivative in g is
  lr eps / (|g| + eps)^2, so a relative change r of g moves it by at most
  lr r / 4;
- bf16 logits of a port-trained checkpoint within 5 % of scale (the nets'
  serving bar, test_torch_fcn.py); float32 labels agreeing on >= 99.9 % of
  pixels."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from _torch_common import n
from physimglobalpose_tpu.models import detect as jdetect, fcn as jfcn
from physimglobalpose_tpu_torch.models import detect, fcn

LR = 1e-3
ADAM_ATOL = 2 * LR * 1e-4


def _fcn_pair(dtype="float32", name="AtrousFCN_Vgg16_16s_small", classes=5):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    model = fcn.init_like_flax(fcn.build_model(name, classes, dtype=tdt), seed=1)
    return model, jfcn.MODEL_ZOO[name](num_classes=classes, dtype=jdt)


def _det_pair(dtype="float32"):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    model = fcn.init_like_flax(detect.CenterNetDetector(detect.NUM_CLASSES, width=8, dtype=tdt), 2)
    return model, jdetect.CenterNetDetector(num_classes=detect.NUM_CLASSES, width=8, dtype=jdt)


def _jax_params(model):
    flat = fcn.state_dict_to_flax(model.state_dict())
    return traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def _fcn_batch(rng, classes=5, b=2, h=64, w=64):
    x = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    y = rng.integers(0, classes + 1, size=(b, h, w)).astype(np.int32)  # classes = ignore
    return x, y


def _det_batch(rng):
    label = np.zeros((96, 128), np.int32)
    label[30:60, 40:90] = 2
    label[70:90, 10:40] = 7
    heat, size, pos = detect.make_targets(label, detect.NUM_CLASSES)
    img = rng.uniform(size=(1, 96, 128, 3)).astype(np.float32)
    return img, heat[None], size[None], pos[None]


def test_loss_ignores_last_label():
    logits = torch.zeros(1, 4, 4, 3)
    l1 = float(fcn.softmax_xent_ignore_last(logits, torch.zeros(1, 4, 4, dtype=torch.int32)))
    l2 = float(fcn.softmax_xent_ignore_last(logits, torch.full((1, 4, 4), 3)))  # == num_classes
    assert abs(l1 - np.log(3)) < 1e-5
    assert l2 == 0.0
    rng = np.random.default_rng(0)
    lg = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    lab = rng.integers(0, 5, size=(2, 8, 8)).astype(np.int32)
    np.testing.assert_allclose(float(fcn.softmax_xent_ignore_last(torch.tensor(lg), torch.tensor(lab))),
                               float(jfcn.softmax_xent_ignore_last(jnp.asarray(lg), jnp.asarray(lab))),
                               rtol=1e-6)


@pytest.mark.parametrize("net", ["fcn", "detector"])
def test_train_step_reduces_loss(net):
    rng = np.random.default_rng(0)
    if net == "fcn":
        model, _ = _fcn_pair("bfloat16", "FCN_Vgg16_32s_small", 3)
        x = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
        batch = (x, (rng.uniform(size=(2, 32, 32)) * 3).astype(np.int32))
        step = fcn.make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR))
    else:
        model, _ = _det_pair("bfloat16")
        batch = _det_batch(rng)
        step = detect.make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR))
    losses = [float(step(*batch)) for _ in range(8)]
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"


def test_make_targets_center_and_size():
    label = np.zeros((240, 320), np.int32)
    label[60:120, 80:200] = 3  # 60x120 box, center (140, 90)
    heat, size, pos = detect.make_targets(label, detect.NUM_CLASSES)
    gh, gw = 240 // detect.STRIDE, 320 // detect.STRIDE
    assert heat.shape == (gh, gw, detect.NUM_CLASSES)
    cy, cx = np.unravel_index(np.argmax(heat[:, :, 2]), (gh, gw))
    assert (cy, cx) == (int(89.5 / detect.STRIDE), int(139.5 / detect.STRIDE))
    assert pos[cy, cx]
    bw, bh = np.exp(size[cy, cx])
    np.testing.assert_allclose(bw * detect.STRIDE, 120, atol=detect.STRIDE)
    np.testing.assert_allclose(bh * detect.STRIDE, 60, atol=detect.STRIDE)
    assert heat[:, :, 0].max() == 0.0
    # The numpy copy gives the JAX function's arrays, tiny blobs and ids
    # past num_classes skipped.
    label[0:2, 0:3] = 5
    label[200:230, 250:300] = 12
    for got, want in zip(detect.make_targets(label, 11), jdetect.make_targets(label, 11)):
        np.testing.assert_array_equal(got, want)


def test_decode_inverts_targets():
    label = np.zeros((240, 320), np.int32)
    label[60:120, 80:200] = 3
    label[150:200, 30:90] = 8
    heat, size, _pos = detect.make_targets(label, detect.NUM_CLASSES)
    h = np.clip(heat, 1e-5, 1 - 1e-5)
    boxes, scores = detect.decode_boxes(torch.tensor(np.log(h / (1 - h))), torch.tensor(size), top=9)
    boxes, scores = n(boxes), n(scores)
    assert boxes.shape == (detect.NUM_CLASSES, 9, 4) and scores.shape == (detect.NUM_CLASSES, 9)
    for cid, gt in [(3, (80, 60, 199, 119)), (8, (30, 150, 89, 199))]:
        assert scores[cid - 1, 0] > 0.9
        np.testing.assert_allclose(boxes[cid - 1, 0], gt, atol=1.5 * detect.STRIDE)
    assert scores[2, 0] >= scores[2, 1]


def _grads_and_step(net, rng):
    """One train step of the same float32 net on the same batch in both
    packages: (port loss, JAX loss, port grads, JAX grads, port params
    after, JAX params after), the dicts keyed by Flax path."""
    if net == "fcn":
        model, jmodel = _fcn_pair()
        batch = _fcn_batch(rng)

        def jloss(p, x, y):
            return jfcn.softmax_xent_ignore_last(jmodel.apply({"params": p}, x), y)

        make_step, jmake_step = fcn.make_train_step, jfcn.make_train_step
    else:
        model, jmodel = _det_pair()
        batch = _det_batch(rng)

        def jloss(p, x, ht, st, pm):
            heat, size = jmodel.apply({"params": p}, x)
            return jdetect.detector_loss(heat, size, ht, st, pm)

        make_step, jmake_step = detect.make_train_step, jdetect.make_train_step
    params = _jax_params(model)
    jbatch = tuple(jnp.asarray(a) for a in batch)
    jl, jg = jax.value_and_grad(jloss)(params, *jbatch)
    tx = optax.adam(LR)
    jparams, _, jl2 = jmake_step(jmodel, tx)(params, tx.init(params), *jbatch)
    assert float(jl2) == float(jl)

    opt = torch.optim.Adam(model.parameters(), lr=LR)
    step = make_step(model, opt)
    loss = float(step(*batch))
    grads = fcn.state_dict_to_flax({k: p.grad for k, p in model.named_parameters()})
    flat = lambda tree: {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}  # noqa: E731
    return loss, float(jl), grads, flat(jg), fcn.state_dict_to_flax(model.state_dict()), flat(jparams)


@pytest.mark.parametrize("net", ["fcn", "detector"])
def test_loss_and_gradients_match_jax(net):
    loss, jloss, grads, jgrads, after, jafter = _grads_and_step(net, np.random.default_rng(3))
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    assert set(grads) == set(jgrads) == set(after) == set(jafter)
    held = 0
    for k, jg in jgrads.items():
        err = np.abs(grads[k] - jg)
        assert err.max() <= 1e-4 * np.abs(jg).max(), k
        # Adam: hold the update where the gradient element is held to rtol
        # 1e-4 itself (one whose sum cancels to rounding noise is not).
        sure = err <= 1e-4 * np.abs(jg)
        np.testing.assert_allclose(after[k][sure], jafter[k][sure], rtol=0, atol=ADAM_ATOL,
                                   err_msg=k)
        held += sure.sum()
    assert held > 0.5 * sum(g.size for g in jgrads.values())


@pytest.mark.parametrize("net", ["fcn", "detector"])
def test_port_checkpoint_serves_in_both_packages(net, tmp_path):
    # A few port train steps (bf16 nets, as served), save_params_npz, then
    # both packages' load_params_npz: the same arrays, the JAX package's
    # bf16 logits within 5 % of scale, float32 labels agreeing >= 99.9 %.
    rng = np.random.default_rng(4)
    if net == "fcn":
        model, _ = _fcn_pair("bfloat16")
        batch = _fcn_batch(rng, h=64, w=96)
        step = fcn.make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR))
    else:
        model, _ = _det_pair("bfloat16")
        batch = _det_batch(rng)
        step = detect.make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR))
    for _ in range(4):
        step(*batch)
    path = str(tmp_path / f"{net}.npz")
    meta = {"model": "AtrousFCN_Vgg16_16s_small" if net == "fcn" else "CenterNetDetector"}
    (fcn if net == "fcn" else detect).save_params_npz(path, model, meta=meta)
    jparams, jmeta = jfcn.load_params_npz(path)
    flat, tmeta = fcn.load_params_npz(path)
    assert jmeta == tmeta == meta
    assert flat.keys() == traverse_util.flatten_dict(jparams, sep="/").keys()
    x = batch[0]
    for dtype in ("bfloat16", "float32"):
        tm, jm = _fcn_pair(dtype) if net == "fcn" else _det_pair(dtype)
        tm = fcn.load_flax_params(tm, flat)
        with torch.no_grad():
            out = tm(torch.as_tensor(x).permute(0, 3, 1, 2))
        got = n((out if net == "fcn" else out[0]).permute(0, 2, 3, 1))
        jout = jm.apply({"params": jparams}, jnp.asarray(x))
        want = np.asarray(jout if net == "fcn" else jout[0])
        if dtype == "bfloat16":
            assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
        else:
            assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999
    # The float16 option halves the file and reloads within float16 rounding.
    path16 = str(tmp_path / f"{net}16.npz")
    fcn.save_params_npz(path16, model, dtype=np.float16)
    flat16, _ = fcn.load_params_npz(path16)
    for k, v in flat.items():
        np.testing.assert_allclose(flat16[k], v, rtol=1e-3, atol=1e-4)
    # The port's own reload gives back the model's parameters exactly.
    back = fcn.flax_to_state_dict(flat)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("net", ["fcn", "detector"])
def test_train_entry_points_on_procedural_meshes(net, tmp_path):
    # The training scripts' train() on the CPU at a tiny size (the three
    # procedural stand-ins of test_torch_synthdata.py, a few scenes and
    # steps): one loss a step, finite, the checkpoint written with its meta
    # and read by both packages' load_params_npz.
    from test_torch_synthdata import OBJECTS, procedural_meshes

    from physimglobalpose_tpu_torch.scripts import train_detector, train_fcn

    meshes, objects = procedural_meshes(), OBJECTS
    out = str(tmp_path / f"{net}.npz")
    logs = []
    if net == "fcn":
        res = train_fcn.train(meshes, objects, steps=3, batch=2, size=64, scenes=3, out=out,
                              device="cpu", log=logs.append)
        score, model_name = res["holdout_miou"], "AtrousFCN_Vgg16_16s_small"
    else:
        res = train_detector.train(meshes, objects, steps=3, batch=2, scenes=3, width=8, out=out,
                                   device="cpu", log=logs.append)
        score, model_name = res["holdout_box_iou"], "CenterNetDetector"
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    assert 0.0 <= score <= 1.0 and res["steps_per_s"] > 0 and res["path"] == out
    assert any(line.startswith("step    2 loss") for line in logs)
    flat, meta = fcn.load_params_npz(out)
    jparams, jmeta = jfcn.load_params_npz(out)
    assert meta == jmeta and meta["model"] == model_name and meta["steps"] == 3
    assert flat.keys() == traverse_util.flatten_dict(jparams, sep="/").keys()
    want = fcn.state_dict_to_flax(res["model"].state_dict())
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v)
