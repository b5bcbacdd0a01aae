"""ADD-S of the port's estimate_pose on chip_smoke.py's three-box scene over
several seeds, in the hypothesis modes that draw their bases at random
(GT segmentation, LCP verification, the default configuration), on the card.

    python3 tools/mode_seed_sweep.py [--modes SUPER4PCS V4PCS PPF_VOTING PCS] [--seeds 10]
        [--repeat 1]

One JSON line per (mode, seed, repeat): the ADD-S per object (m) and
total_s; then one line per mode with the worst ADD-S and how many (object,
run) draws are beyond 1 cm. --repeat runs each seed again in the same
process: the voxel grid's float sums (index_add_) are atomic on the card, so
a seed can give last-bit different segments and another search. scripts/jax_scene_modes_bar.py gives the JAX package's ADD-S on
the same scene on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--modes", nargs="*", default=["SUPER4PCS", "V4PCS", "PPF_VOTING", "PCS"])
    p.add_argument("--seeds", type=int, default=10)
    p.add_argument("--repeat", type=int, default=1)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from physimglobalpose_tpu_torch.config import DEFAULT_CONFIG
    from physimglobalpose_tpu_torch.geometry import metrics
    from physimglobalpose_tpu_torch.pipeline import api

    if not torch.cuda.is_available():
        raise SystemExit("tools/mode_seed_sweep.py needs an NVIDIA card")
    dev = torch.device("cuda")
    print(chip_smoke.phase_device(), flush=True)
    with tempfile.TemporaryDirectory() as wd:
        setup = chip_smoke.scene_setup(dev, wd)
    inv_cam = np.linalg.inv(setup["cam_pose"])
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    for mode in args.modes:
        worst, misses = 0.0, 0
        runs = [(seed, rep) for seed in range(args.seeds) for rep in range(args.repeat)]
        for seed, rep in runs:
            res = api.estimate_pose("<memory>", setup["db"], hypothesis_mode=mode,
                                    cfg=DEFAULT_CONFIG, seed=seed, scene=setup["scene"],
                                    write_result=False, device=dev)
            adds = {}
            for (name, _cls, size, xy, yaw), est in zip(chip_smoke.BOXES, res.objects):
                gt = inv_cam @ chip_smoke.box_pose_world(size, xy, yaw)
                adds[name] = float(metrics.adds_error(
                    as_t(est.pose_cam), as_t(gt), as_t(setup["objects"][name].validation_pts)))
            worst = max(worst, *adds.values())
            misses += sum(a >= 0.01 for a in adds.values())
            print(json.dumps({"mode": mode, "seed": seed, "repeat": rep, "adds_m": adds,
                              "total_s": res.timings["total_s"]}), flush=True)
        print(json.dumps({"mode": mode, "seeds": args.seeds, "repeat": args.repeat,
                          "worst_m": worst, "draws_beyond_1cm": misses,
                          "draws": len(runs) * len(chip_smoke.BOXES)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
