"""Train the CenterNet-style detector and save the checkpoint.

The port of the JAX package's scripts/train_detector.py. The reference's
RCNN segmentation strategies call a Faster-RCNN service trained on real APC
imagery (rcnn_detection_package/bin/detect_bbox, recognition.py:27-61); no
real dataset exists here, so the detector trains on the package's own
synthetic renders (utils/synthdata.py) with box targets derived from the GT
masks (models/detect.make_targets), and the checkpoint is the FCN zoo's flat
.npz, which both packages' load_params_npz read.

Usage (on the card; --device cpu for the CPU):
  python -m physimglobalpose_tpu_torch.scripts.train_detector --steps 800 \\
      --obj-config <obj_config.yml> --model-dir <meshes> --out detector_synth_apc.npz

train(meshes, ...) is the same run on meshes already loaded.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from physimglobalpose_tpu_torch.scripts.train_fcn import OBJECTS

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
                           "build", "weights", "detector_synth_apc.npz")


def camera(height: int, width: int) -> np.ndarray:
    """The JAX script's intrinsics for a height x width render."""
    f = 307.0 * width / 320.0
    return np.array([[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0.0, 0.0, 1.0]], np.float32)


def render_training_scenes(meshes, objects, rng, n_scenes, height, width,
                           domain_random_frac=0.5, device=None):
    """The JAX script's training scenes and their targets, then 6 held-out
    scenes, drawn from `rng` in its order. Returns (colors [N, H, W, 3]
    float in [0, 1], heats, sizes, poss, val [(color, label)])."""
    from physimglobalpose_tpu_torch.models import detect
    from physimglobalpose_tpu_torch.utils import synthdata

    intr = camera(height, width)
    colors, heats, sizes, poss = [], [], [], []
    for _ in range(n_scenes):
        dr = rng.uniform() < domain_random_frac
        c, lab, _, _ = synthdata.render_scene(meshes, objects, rng, intr, height, width,
                                              domain_random=dr, device=device)
        heat, size, pos = detect.make_targets(lab, detect.NUM_CLASSES)
        colors.append(c)
        heats.append(heat)
        sizes.append(size)
        poss.append(pos)
    val = []
    for _ in range(6):
        c, lab, _, _ = synthdata.render_scene(meshes, objects, rng, intr, height, width,
                                              device=device)
        val.append((c, lab))
    return (np.stack(colors).astype(np.float32) / 255.0, np.stack(heats), np.stack(sizes),
            np.stack(poss), val)


def heldout_box_iou(model, val) -> tuple[float, int, int]:
    """Top-1 box IoU per present class on held-out scenes: (mean IoU, hits
    at IoU >= 0.5, instances)."""
    from physimglobalpose_tpu_torch.models import detect

    dev = next(model.parameters()).device
    ious, hits = [], 0
    for c_img, l_img in val:
        with torch.no_grad():
            x = torch.as_tensor(c_img).to(dev).permute(2, 0, 1)[None].to(torch.float32) / 255.0
            heat, size = model(x)
            boxes, _scores = detect.decode_boxes(heat[0].permute(1, 2, 0),
                                                 size[0].permute(1, 2, 0), top=9)
        boxes = boxes.cpu().numpy()
        for cid in sorted(set(np.unique(l_img)) - {0}):
            ys, xs = np.nonzero(l_img == cid)
            gt = (xs.min(), ys.min(), xs.max(), ys.max())
            bx = boxes[cid - 1, 0]  # top-1 box of that class
            ix1, iy1 = max(gt[0], bx[0]), max(gt[1], bx[1])
            ix2, iy2 = min(gt[2], bx[2]), min(gt[3], bx[3])
            inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
            a_gt = (gt[2] - gt[0]) * (gt[3] - gt[1])
            a_bx = max(bx[2] - bx[0], 0) * max(bx[3] - bx[1], 0)
            iou = inter / max(a_gt + a_bx - inter, 1e-6)
            ious.append(iou)
            hits += iou >= 0.5
    return (float(np.mean(ious)) if ious else 0.0), int(hits), len(ious)


def train(meshes, objects=OBJECTS, steps: int = 800, batch: int = 8, scenes: int = 64,
          lr: float = 1e-3, width: int = 32, height: int = 240, img_width: int = 320,
          domain_random_frac: float = 0.5, out: str | None = DEFAULT_OUT, device=None,
          seed: int = 0, log=print) -> dict:
    """Render the scenes, train the detector with Adam on random batches,
    measure the held-out top-1 box IoU and save the checkpoint to `out`
    (None: no file). Runs on the card unless device="cpu". Returns
    {"model", "losses" (one a step), "steps_per_s", "holdout_box_iou",
    "path"}."""
    from physimglobalpose_tpu_torch import _torchcfg
    from physimglobalpose_tpu_torch.models import detect, fcn

    dev = _torchcfg.resolve_device(device)
    rng = np.random.default_rng(seed)
    log(f"rendering {scenes} training scenes...")
    colors, heats, sizes, poss, val = render_training_scenes(
        meshes, objects, rng, scenes, height, img_width, domain_random_frac, dev)
    model = fcn.init_like_flax(detect.CenterNetDetector(num_classes=detect.NUM_CLASSES,
                                                        width=width), seed).to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"CenterNetDetector(width={width}): {n_params / 1e6:.2f} M params")
    step_fn = detect.make_train_step(model, torch.optim.Adam(model.parameters(), lr=lr))

    losses = []
    _torchcfg.synchronize(dev)
    t0 = time.perf_counter()
    for step in range(steps):
        idx = rng.integers(0, scenes, batch)
        losses.append(step_fn(colors[idx], heats[idx], sizes[idx], poss[idx]))
        if step % 50 == 0 or step == steps - 1:
            log(f"step {step:4d} loss {float(losses[-1]):.4f} ({time.perf_counter() - t0:.0f}s)")
    _torchcfg.synchronize(dev)
    steps_per_s = steps / max(time.perf_counter() - t0, 1e-9)

    miou, hits, total = heldout_box_iou(model, val)
    log(f"held-out top-1 box IoU: {miou:.3f}; recall@0.5: {hits}/{total}")
    if out is not None:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        detect.save_params_npz(
            out, model,
            meta={
                "model": "CenterNetDetector",
                "num_classes": detect.NUM_CLASSES,
                "width": width,
                "input_size": [height, img_width],
                "train": "synthetic (utils/synthdata.py), box targets from GT masks "
                         "(scripts/train_detector.py)",
                "steps": steps,
                "holdout_box_iou": miou,
            },
        )
        log(f"saved {out} ({os.path.getsize(out) / 1e6:.1f} MB)")
    return {"model": model, "losses": [float(x) for x in torch.stack(losses).cpu()] if losses
            else [], "steps_per_s": steps_per_s, "holdout_box_iou": miou, "path": out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--scenes", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--width", type=int, default=32)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--img-width", type=int, default=320)
    p.add_argument("--domain-random-frac", type=float, default=0.5,
                   help="fraction of training scenes rendered with domain "
                        "randomization (harder appearance)")
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
    res = train(meshes, steps=args.steps, batch=args.batch, scenes=args.scenes, lr=args.lr,
                width=args.width, height=args.height, img_width=args.img_width,
                domain_random_frac=args.domain_random_frac, out=args.out, device=args.device)
    if res["holdout_box_iou"] < 0.5:
        print("WARNING: box IoU below 0.5 - checkpoint may not drive RCNN mode")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
