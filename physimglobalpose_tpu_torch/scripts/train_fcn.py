"""Train the small FCN on synthetic color scenes and save the checkpoint.

The port of the JAX package's scripts/train_fcn.py. The reference serves
apc_weights.hdf5 trained on real APC imagery (predict:59-155); no real
dataset exists here, so the net trains on the package's own synthetic
renders (utils/synthdata.py) of the objects' meshes, and the checkpoint is
the JAX package's flat .npz (models/fcn.save_params_npz), which both
packages' load_params_npz read.

Usage (on the card; --device cpu for the CPU):
  python -m physimglobalpose_tpu_torch.scripts.train_fcn --steps 400 \\
      --obj-config <obj_config.yml> --model-dir <meshes> --out fcn_synth_apc.npz

train(meshes, ...) is the same run on meshes already loaded.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

OBJECTS = {  # the bundled test-scene objects (obj_config.yml class ids)
    "kleenex_tissue_box": 8,
    "expo_dry_erase_board_eraser": 2,
    "folgers_classic_roast_coffee": 3,
}
NUM_CLASSES = 12  # APC: background + 11 objects (predict:168)
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
                           "build", "weights", "fcn_synth_apc.npz")
# Two rendering scales so the FCN serves both its native training scale and
# the 640x480 pipeline scale (object apparent size varies 2x).
INTR_320 = np.array([[307.0, 0.0, 160.0], [0.0, 307.0, 120.0], [0.0, 0.0, 1.0]], np.float32)
INTR_640 = INTR_320 * np.array([[2.0], [2.0], [1.0]], np.float32)


def render_training_scenes(meshes, objects, rng, n_scenes, appearance="palette",
                           domain_random=False, device=None):
    """The JAX script's training and held-out scenes, drawn from `rng` in its
    order: n_scenes (every third at 640x480, the rest at 320x240), then 4
    held-out scenes at 320x240 and 2 at 640x480. Returns (colors, labels,
    val [(color, label)])."""
    from physimglobalpose_tpu_torch.utils import synthdata

    def render(intr, hh, ww):
        if appearance in ("transfer", "prior"):
            dist = (0.38, 0.85) if appearance == "prior" else (0.55, 1.2)
            return synthdata.render_scene_transfer(
                meshes, objects, rng, intr, hh, ww, cam_dist_range=dist,
                color_priors=synthdata.PRODUCT_COLOR_PRIORS if appearance == "prior" else None,
                device=device)
        return synthdata.render_scene(meshes, objects, rng, intr, hh, ww,
                                      domain_random=domain_random, device=device)

    colors, labels = [], []
    for i in range(n_scenes):
        c, lab, _, _ = render(INTR_640, 480, 640) if i % 3 == 2 else render(INTR_320, 240, 320)
        colors.append(c)
        labels.append(lab)
    val = [render(INTR_320, 240, 320)[:2] for _ in range(4)] + [
        render(INTR_640, 480, 640)[:2] for _ in range(2)]
    return colors, labels, val


def heldout_miou(model, val) -> float:
    """Mean per-instance IoU of the argmax labels on held-out scenes."""
    dev = next(model.parameters()).device
    ious = []
    with torch.no_grad():
        for c_img, l_img in val:
            x = torch.as_tensor(c_img).to(dev).permute(2, 0, 1)[None].to(torch.float32) / 255.0
            pred = torch.argmax(model(x)[0], dim=0).cpu().numpy()
            for cid in set(np.unique(l_img)) - {0}:
                inter = ((pred == cid) & (l_img == cid)).sum()
                union = ((pred == cid) | (l_img == cid)).sum()
                if union:
                    ious.append(inter / union)
    return float(np.mean(ious)) if ious else 0.0


def train(meshes, objects=OBJECTS, steps: int = 600, batch: int = 8, size: int = 160,
          scenes: int = 48, lr: float = 1e-3, model_name: str = "AtrousFCN_Vgg16_16s_small",
          domain_random: bool = False, appearance: str = "palette", save_f16: bool = False,
          out: str | None = DEFAULT_OUT, device=None, seed: int = 0, log=print) -> dict:
    """Render the scenes, train `model_name` with Adam on random crops,
    measure the held-out mIoU and save the checkpoint to `out` (None: no
    file). Runs on the card unless device="cpu". Returns {"model",
    "losses" (one a step), "steps_per_s", "holdout_miou", "path"}."""
    from physimglobalpose_tpu_torch import _torchcfg
    from physimglobalpose_tpu_torch.models import fcn
    from physimglobalpose_tpu_torch.utils import synthdata

    dev = _torchcfg.resolve_device(device)
    rng = np.random.default_rng(seed)
    log(f"rendering {scenes} training scenes (2 scales, {appearance})...")
    colors, labels, val = render_training_scenes(meshes, objects, rng, scenes, appearance,
                                                 domain_random, dev)
    model = fcn.init_like_flax(fcn.build_model(model_name, num_classes=NUM_CLASSES), seed).to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{model_name}: {n_params / 1e6:.2f} M params")
    step_fn = fcn.make_train_step(model, torch.optim.Adam(model.parameters(), lr=lr))

    losses = []
    _torchcfg.synchronize(dev)
    t0 = time.perf_counter()
    for step in range(steps):
        imgs, labs = synthdata.crop_batch(colors, labels, rng, batch, size)
        losses.append(step_fn(imgs, labs))
        if step % 25 == 0 or step == steps - 1:
            log(f"step {step:4d} loss {float(losses[-1]):.4f} ({time.perf_counter() - t0:.0f}s)")
    _torchcfg.synchronize(dev)
    steps_per_s = steps / max(time.perf_counter() - t0, 1e-9)

    miou = heldout_miou(model, val)
    log(f"held-out object mIoU: {miou:.3f}")
    if out is not None:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        fcn.save_params_npz(
            out, model, dtype=np.float16 if save_f16 else None,
            meta={
                "model": model_name,
                "num_classes": NUM_CLASSES,
                "train": "synthetic (utils/synthdata.py)"
                         + (" domain-randomized" if domain_random else "")
                         + (" transfer-randomized (class-agnostic appearance)"
                            if appearance == "transfer" else "")
                         + (" prior-randomized (product color priors)"
                            if appearance == "prior" else ""),
                "steps": steps,
                "holdout_miou": miou,
            },
        )
        log(f"saved {out} ({os.path.getsize(out) / 1e6:.1f} MB)")
    return {"model": model, "losses": [float(x) for x in torch.stack(losses).cpu()] if losses
            else [], "steps_per_s": steps_per_s, "holdout_miou": miou, "path": out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=600)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=160)
    p.add_argument("--scenes", type=int, default=48)
    p.add_argument("--lr", type=float, default=1e-3)
    # stride-16 atrous variant: objects span 2-8 feature cells at the
    # serving scales; the 32s masks were too blobby.
    p.add_argument("--model", default="AtrousFCN_Vgg16_16s_small")
    p.add_argument("--domain-random", action="store_true",
                   help="harder randomized scenes (full-width training)")
    p.add_argument("--appearance", default="palette", choices=["palette", "transfer", "prior"],
                   help="palette: class-keyed colors (render_scene); transfer: "
                        "class-agnostic instance colors, pattern overlays and an oblique "
                        "camera (render_scene_transfer); prior: transfer randomization "
                        "with per-product dominant-color priors")
    p.add_argument("--save-f16", action="store_true",
                   help="save weights as float16 (halves large checkpoints)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="train on the card (default) or on the CPU")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--model-dir", required=True, help="mesh directory")
    p.add_argument("--obj-config", required=True, help="obj_config.yml path")
    p.add_argument("--cache-dir", default=None,
                   help="asset cache (default: the port's directory under the temporary one)")
    args = p.parse_args(argv)

    from physimglobalpose_tpu_torch.models import assets, objectdb

    db = objectdb.load_object_db(args.obj_config, args.model_dir,
                                 cache_dir=args.cache_dir or objectdb.default_cache_dir(),
                                 only=list(OBJECTS), device="cpu")
    meshes = {n: assets.decimate_to_max_faces(db[n].mesh, 2000) for n in OBJECTS}
    res = train(meshes, steps=args.steps, batch=args.batch, size=args.size, scenes=args.scenes,
                lr=args.lr, model_name=args.model, domain_random=args.domain_random,
                appearance=args.appearance, save_f16=args.save_f16, out=args.out,
                device=args.device)
    if res["holdout_miou"] < 0.5:
        print("WARNING: mIoU below 0.5 - checkpoint may not drive the pipeline")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
