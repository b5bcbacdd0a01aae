"""Three more accuracy families: sections hard_ycb, hard_six and rcnn of a SYNTH_EVAL-style JSON.

The port of the JAX package's scripts/r5_eval.py. Families:
  hard_ycb   the --hard scenes (r4_hard_eval) with YCB objects: YCB class
             ids and the plain-mm depth codec, the hard-family result
             carried across datasets;
  hard_six   --hard scenes of six objects: occlusion and a larger
             assignment space together;
  rcnn       RCNN segmentation end to end with the shipped detection
             network (models/detect): detection quality (the top-1 box's
             IoU against the box of each instance's GT mask) and then the
             ADD-S downstream.
Each family's scenes are generated with make_synthetic_scenes where missing
and graded with pipeline/evaluate at the small preset, one mode after
another; the section is merged into --out with the JAX script's keys.

Against the JAX script: the meshes and the obj_config (the reference's
obj_config_ycb.yml for hard_ycb, obj_config.yml for the others) are flags,
and --objects overrides a family's names; "backend" is the device record
(the card's name and power limit); --out is created when missing. Each mode's
log, r5_eval_<family>_<mode>_<seed>.jsonl, is written beside the scenes.

Usage (on the card; --device cpu for the CPU):
  python -m physimglobalpose_tpu_torch.scripts.r5_eval --family hard_six \\
      --model-dir <meshes> --obj-config <obj_config.yml> [--objects a,b,...] [--scenes 8]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from physimglobalpose_tpu_torch.scripts import _synth_eval

FAMILIES = {
    "hard_ycb": dict(
        objects="003_cracker_box,005_tomato_soup_can,006_mustard_bottle",
        dataset="YCB", hard=True, modes="LCP,MCTS", segmentation="GT",
    ),
    "hard_six": dict(
        objects=("kleenex_tissue_box,expo_dry_erase_board_eraser,"
                 "folgers_classic_roast_coffee,crayola_24_ct,"
                 "dove_beauty_bar,elmers_washable_no_run_school_glue"),
        dataset="APC", hard=True, modes="LCP,MCTS", segmentation="GT",
    ),
    "rcnn": dict(
        objects=("kleenex_tissue_box,expo_dry_erase_board_eraser,"
                 "folgers_classic_roast_coffee"),
        dataset="APC", hard=False, modes="LCP", segmentation="RCNN",
    ),
}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--family", required=True, choices=sorted(FAMILIES))
    p.add_argument("--scenes", type=int, default=8)
    p.add_argument("--dir", default=None,
                   help="scene directory (default r5_<family>_scenes under the temporary one)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--modes", default=None, help="default: the family's")
    p.add_argument("--out", default=_synth_eval.DEFAULT_OUT,
                   help="JSON file that receives the family's section (merged per mode)")
    p.add_argument("--model-dir", required=True, help="mesh directory")
    p.add_argument("--obj-config", required=True,
                   help="the family dataset's obj_config.yml (YCB class ids for hard_ycb)")
    p.add_argument("--objects", default=None,
                   help="comma-separated object names (default: the family's)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default) or on the CPU")
    return p.parse_args(argv)


def box_iou(gt, b) -> float:
    """IoU of two (x1, y1, x2, y2) boxes, areas without the +1 of pixel
    counts (the JAX script's)."""
    ix1, iy1 = max(gt[0], b[0]), max(gt[1], b[1])
    ix2, iy2 = min(gt[2], b[2]), min(gt[3], b[3])
    inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
    union = ((gt[2] - gt[0]) * (gt[3] - gt[1])
             + max(b[2] - b[0], 0) * max(b[3] - b[1], 0) - inter)
    return float(inter / max(union, 1e-6))


def _detection_quality(scene_dirs, db, class_ids, device=None) -> dict:
    """Top-1 box IoU of the learned detector (the shipped weights, on
    `device`) against the GT-mask boxes, per instance of 8 or more mask
    pixels: instances, mean IoU, recall at IoU 0.5 and misses."""
    from PIL import Image

    from physimglobalpose_tpu_torch.pipeline import detector as detector_mod

    det = detector_mod.make_learned_detector(device=device)
    ious, hits, misses = [], 0, 0
    for sd in scene_dirs:
        color = np.asarray(Image.open(os.path.join(sd, "frame-000000.color.png")))[..., :3]
        mask = np.asarray(Image.open(os.path.join(sd, "frame-000000.mask.png")))
        boxes = det(color, class_ids)
        for cid in class_ids:
            ys, xs = np.nonzero(mask == cid)
            if len(ys) < 8:
                continue
            gt = (xs.min(), ys.min(), xs.max(), ys.max())
            if cid not in boxes:
                misses += 1
                ious.append(0.0)
                continue
            iou = box_iou(gt, boxes[cid])
            ious.append(iou)
            hits += iou >= 0.5
    return {
        "instances": len(ious),
        "mean_box_iou": round(float(np.mean(ious)), 3) if ious else 0.0,
        "recall_at_0.5": round(hits / max(len(ious), 1), 3),
        "missed": misses,
    }


def family_eval(family: str, cfg, device, model_dir: str, obj_config: str, objects=None,
                scenes: int = 8, scene_dir: str | None = None, seed: int = 0, modes=None,
                out: str = _synth_eval.DEFAULT_OUT) -> dict:
    """Generate (where missing), grade and merge one family's section at
    `cfg` on `device` (the card unless "cpu"); returns the section."""
    from physimglobalpose_tpu_torch import _torchcfg
    from physimglobalpose_tpu_torch.models import objectdb

    fam = FAMILIES[family]
    dev = _torchcfg.resolve_device(device)
    objects = list(objects or fam["objects"].split(","))
    modes = list(modes or fam["modes"].split(","))
    scene_dir = scene_dir or os.path.join(_synth_eval.TMP_ROOT, f"r5_{family}_scenes")
    dirs = _synth_eval.ensure_scenes(scene_dir, scenes, objects, seed, model_dir, obj_config, dev,
                                     dataset=fam["dataset"], hard=fam["hard"])
    db = objectdb.load_object_db(obj_config, model_dir, config=cfg,
                                 cache_dir=objectdb.default_cache_dir(), only=objects, device=dev)
    section = {
        "generator": (
            f"make_synthetic_scenes.py {'--hard ' if fam['hard'] else ''}"
            f"--n {scenes} --dataset {fam['dataset']} "
            f"--objects {','.join(objects)} (seed {seed})"
        ),
        "scenes": scenes,
        "instances": scenes * len(objects),
        "segmentation": fam["segmentation"],
        "backend": _torchcfg.describe_device(dev),
    }
    if fam["hard"]:
        section["occlusion_frac"] = _synth_eval.occlusion_frac(dirs)
    if fam["segmentation"] == "RCNN":
        class_ids = [db.class_of(n) for n in objects]
        section["detection"] = _detection_quality(dirs, db, class_ids, device=dev)
        print("detection:", json.dumps(section["detection"]), flush=True)
    _synth_eval.grade_modes(
        section, dirs, db, modes,
        lambda mode: os.path.join(scene_dir, f"r5_eval_{family}_{mode}_{seed}.jsonl"), cfg, seed,
        dev, dataset=fam["dataset"], segmentation=fam["segmentation"])
    _synth_eval.merge_section(out, family, section)
    return section


def main(argv=None) -> int:
    args = parse_args(argv)
    from physimglobalpose_tpu_torch.config import PRESETS

    family_eval(args.family, PRESETS["small"], args.device, args.model_dir, args.obj_config,
                objects=args.objects.split(",") if args.objects else None, scenes=args.scenes,
                scene_dir=args.dir, seed=args.seed,
                modes=args.modes.split(",") if args.modes else None, out=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
