"""Hard-family accuracy evaluation: the "hard" section of a SYNTH_EVAL-style JSON.

The port of the JAX package's scripts/r4_hard_eval.py. Generates --hard
scenes with make_synthetic_scenes (a camera tilted 55 degrees over objects
packed in a line, so that they occlude each other by up to ~0.9; touching
footprints; 15 % depth dropout and 3 mm noise; an unlabeled duplicate of the
first object as a distractor), grades them with pipeline/evaluate at the
small preset in LCP, MCTS and GREEDY mode, one mode after another, and
merges a "hard" section into --out: the occlusion distribution, then per
mode the share of objects within ADD-S 2 cm, the mean and max ADD-S, the
per-object means, the wall time and the worst three. The family exists to
discriminate: on easy scenes every mode saturates, here best-LCP selection
should degrade and the physics-aware searches' margin shows.

Against the JAX script: the meshes, their obj_config and the object names
are flags (the JAX script fixes the reference's); "backend" is the device
record (the card's name and power limit); "instances" is scenes x objects;
--out is created when missing. Each mode's log, hard_eval_<mode>_<seed>.jsonl,
is written beside the scenes in --dir, where r5_hard_miss_analysis reads the
MCTS one.

Usage (on the card; --device cpu for the CPU):
  python -m physimglobalpose_tpu_torch.scripts.r4_hard_eval --model-dir <meshes> \\
      --obj-config <obj_config.yml> [--objects a,b,c] [--scenes 8] [--out synth_eval.json]
"""

from __future__ import annotations

import argparse
import os

from physimglobalpose_tpu_torch.scripts import _synth_eval

OBJECTS = "kleenex_tissue_box,expo_dry_erase_board_eraser,folgers_classic_roast_coffee"
DEFAULT_DIR = os.path.join(_synth_eval.TMP_ROOT, "hard_scenes_r4")
CORRUPTION = "tilt 55 deg, dropout 0.15, noise 3 mm, distractor on"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scenes", type=int, default=8)
    p.add_argument("--dir", default=DEFAULT_DIR,
                   help="scene directory (generated when scene_<scenes-1> is missing)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--modes", default="LCP,MCTS,GREEDY")
    p.add_argument("--out", default=_synth_eval.DEFAULT_OUT,
                   help="JSON file that receives the 'hard' section (merged per mode)")
    p.add_argument("--model-dir", required=True, help="mesh directory")
    p.add_argument("--obj-config", required=True, help="obj_config.yml (the class ids)")
    p.add_argument("--objects", default=OBJECTS, help="comma-separated object names")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default) or on the CPU")
    return p.parse_args(argv)


def hard_eval(cfg, device, model_dir: str, obj_config: str, objects=tuple(OBJECTS.split(",")),
              scenes: int = 8, scene_dir: str = DEFAULT_DIR, seed: int = 0,
              modes=("LCP", "MCTS", "GREEDY"), out: str = _synth_eval.DEFAULT_OUT) -> dict:
    """Generate (where missing), grade and merge the "hard" section at
    `cfg` on `device` (the card unless "cpu"); returns the section."""
    from physimglobalpose_tpu_torch import _torchcfg
    from physimglobalpose_tpu_torch.models import objectdb

    dev = _torchcfg.resolve_device(device)
    objects = list(objects)
    dirs = _synth_eval.ensure_scenes(scene_dir, scenes, objects, seed, model_dir, obj_config, dev)
    db = objectdb.load_object_db(obj_config, model_dir, config=cfg,
                                 cache_dir=objectdb.default_cache_dir(), only=objects, device=dev)
    section = {
        "generator": (f"make_synthetic_scenes.py --hard --n {scenes} "
                      f"--objects {','.join(objects)} (seed {seed})"),
        "scenes": scenes,
        "instances": scenes * len(objects),
        "occlusion_frac": _synth_eval.occlusion_frac(dirs),
        "corruption": CORRUPTION,
        "backend": _torchcfg.describe_device(dev),
    }
    _synth_eval.grade_modes(
        section, dirs, db, modes,
        lambda mode: os.path.join(scene_dir, f"hard_eval_{mode}_{seed}.jsonl"), cfg, seed, dev)
    _synth_eval.merge_section(out, "hard", section)
    return section


def main(argv=None) -> int:
    args = parse_args(argv)
    from physimglobalpose_tpu_torch.config import PRESETS

    hard_eval(PRESETS["small"], args.device, args.model_dir, args.obj_config,
              args.objects.split(","), scenes=args.scenes, scene_dir=args.dir, seed=args.seed,
              modes=args.modes.split(","), out=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
