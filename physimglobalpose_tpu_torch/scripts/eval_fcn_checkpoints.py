"""IoU of the shipped FCN checkpoints on held-out synthetic renders.

The port of the JAX package's scripts/eval_fcn_checkpoints.py. Every shipped
checkpoint that the JAX script evaluates ("small", "full" and the unshipped
fcn_synth_apc_vgg16_32s.npz, each where its file exists in the JAX package's
weights directory, read as data) is scored on the SAME held-out scenes: 6
renders of utils/synthdata.render_scene from np.random.default_rng(90210),
plain and domain-randomized, at the two serving scales (320x240 and 640x480;
the renders' poses are the same at both, as the draws do not depend on the
scale). The score is the mean over scenes and classes of the argmax labels'
per-class IoU, the JAX script's loop.

Prints the JAX script's table (its columns are the 320x240 scale) and then
one JSON line with every figure.

Usage (on the card; --device cpu for the CPU):
  python -m physimglobalpose_tpu_torch.scripts.eval_fcn_checkpoints \\
      --obj-config <obj_config.yml> --model-dir <meshes> [--objects a,b,c]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from physimglobalpose_tpu_torch.scripts.train_fcn import INTR_320, INTR_640

HELDOUT_SEED = 90210  # far from the training stream
HELDOUT_SCENES = 6
# The serving scales of the training script.
SCALES = {"320x240": (INTR_320, 240, 320), "640x480": (INTR_640, 480, 640)}


def checkpoints() -> list:
    """(name, path) of the checkpoints the JAX script evaluates, where present."""
    from physimglobalpose_tpu_torch.models import fcn

    out = [(v, fcn.shipped_checkpoint_path(v)) for v in ("small", "full")]
    out.append(("vgg16_32s(unshipped)", os.path.join(
        os.path.dirname(fcn.shipped_checkpoint_path()), "fcn_synth_apc_vgg16_32s.npz")))
    return [(name, path) for name, path in out if os.path.exists(path)]


def per_class_iou(pred: np.ndarray, label: np.ndarray, classes=None) -> dict:
    """{class: |pred == c & label == c| / |pred == c | label == c|} over
    `classes` (0 where the union is empty); by default every class present in
    the label image but the background 0, the JAX script's inner loop."""
    if classes is None:
        classes = sorted(int(c) for c in np.unique(label) if c != 0)
    out = {}
    for c in classes:
        inter = float(((pred == c) & (label == c)).sum())
        union = float(((pred == c) | (label == c)).sum())
        out[c] = inter / union if union else 0.0
    return out


def heldout_scenes(meshes, class_ids, dev) -> dict:
    """{(scale, domain_random): [(color uint8 [h, w, 3], label [h, w]), ...]}:
    HELDOUT_SCENES renders of `meshes` (decimated assets.Mesh by name) a set,
    each set from np.random.default_rng(HELDOUT_SEED)."""
    from physimglobalpose_tpu_torch.utils import synthdata

    sets = {}
    for scale, (intr, h, w) in SCALES.items():
        for dist in (False, True):
            rng = np.random.default_rng(HELDOUT_SEED)
            sets[scale, dist] = [
                synthdata.render_scene(meshes, class_ids, rng, intr, h, w, domain_random=dist,
                                       device=dev)[:2]
                for _ in range(HELDOUT_SCENES)]
    return sets


def load_checkpoint(path: str, dev):
    """(network on dev, the checkpoint's meta) of an .npz checkpoint."""
    from physimglobalpose_tpu_torch.models import fcn

    flat, meta = fcn.load_params_npz(path)
    model = fcn.load_flax_params(fcn.build_model(meta["model"], num_classes=meta["num_classes"]),
                                 flat).to(dev)
    return model, meta


def argmax_labels(model, color: np.ndarray, dev) -> np.ndarray:
    """The network's argmax class of every pixel of a uint8 [h, w, 3] image
    (scaled to [0, 1]), as the JAX script's `infer`."""
    import torch

    x = torch.as_tensor(color).to(dev).permute(2, 0, 1)[None].to(torch.float32) / 255.0
    with torch.no_grad():
        return torch.argmax(model(x)[0], dim=0).cpu().numpy()


def evaluate(meshes, class_ids, device=None, log=print) -> dict:
    """{checkpoint: {"model", "miou": {scale: {"plain", "domain_random"}}}}
    on the held-out renders of `meshes` (decimated assets.Mesh by name)."""
    from physimglobalpose_tpu_torch import _torchcfg

    dev = _torchcfg.resolve_device(device)
    scene_sets = heldout_scenes(meshes, class_ids, dev)
    results = {}
    log(f"{'checkpoint':24s} {'model':28s} {'plain mIoU':>11s} {'dom-rand mIoU':>14s}")
    for name, path in checkpoints():
        model, meta = load_checkpoint(path, dev)
        mious = {}
        for (scale, dist), scenes in scene_sets.items():
            ious = []
            for color, label in scenes:
                ious += list(per_class_iou(argmax_labels(model, color, dev), label).values())
            key = "domain_random" if dist else "plain"
            mious.setdefault(scale, {})[key] = float(np.mean(ious)) if ious else 0.0
        results[name] = {"model": meta["model"], "miou": mious}
        m = mious["320x240"]
        log(f"{name:24s} {meta['model']:28s} {m['plain']:11.3f} {m['domain_random']:14.3f}")
    return results


def load_meshes(obj_config: str, model_dir: str, names, cache_dir=None):
    """({name: mesh decimated to 2,000 faces}, {name: class id}) of the
    renders' objects."""
    from physimglobalpose_tpu_torch.models import assets, objectdb

    db = objectdb.load_object_db(obj_config, model_dir,
                                 cache_dir=cache_dir or objectdb.default_cache_dir(),
                                 only=names, device="cpu")
    return ({n: assets.decimate_to_max_faces(db[n].mesh, 2000) for n in names},
            {n: db[n].class_id for n in names})


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model-dir", required=True, help="mesh directory")
    p.add_argument("--obj-config", required=True, help="obj_config.yml path (class ids)")
    p.add_argument("--objects", default="kleenex_tissue_box,expo_dry_erase_board_eraser,"
                                        "folgers_classic_roast_coffee",
                   help="comma-separated objects of the renders (the JAX script's three)")
    p.add_argument("--cache-dir", default=None,
                   help="asset cache (default: the port's directory under the temporary one)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default) or on the CPU")
    args = p.parse_args(argv)

    from physimglobalpose_tpu_torch import _torchcfg

    dev = _torchcfg.resolve_device(args.device)
    meshes, class_ids = load_meshes(args.obj_config, args.model_dir, args.objects.split(","),
                                    args.cache_dir)
    results = evaluate(meshes, class_ids, device=dev)
    print(json.dumps({**_torchcfg.describe_device(dev), "checkpoints": results}))
    return results


if __name__ == "__main__":
    main()
