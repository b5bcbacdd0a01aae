"""Command-line entry honoring the /pose_estimation service contract.

Reference invocation:
  rosservice call /pose_estimation "APC" "<scene>" "GT" "PCS" "LCP"
Here:
  python -m physimglobalpose_tpu_torch.cli --dataset APC --scene <scene> \
      --segmentation GT --hypothesis PCS --verification LCP \
      --obj-config <obj_config.yml> --model-dir <meshes> [--device cpu]

Runs on the card (--device cuda, the default) unless asked for the CPU. The
flags match the JAX package's CLI: every segmentation, hypothesis and
verification mode runs; the FCN modes serve the shipped checkpoint of
--fcn-variant, the RCNN modes the shipped detection network, both on the
chosen device. --debug-dir dumps the JAX package's debug artifacts
(utils/debug.py).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description="6D pose estimation (PyTorch/CUDA)")
    p.add_argument("--dataset", default="APC", choices=["APC", "YCB", "CAM"],
                   help="CAM = live-capture arrays: --scene is a .npz with "
                        "color, depth, intrinsics, cam_pose, object_names")
    p.add_argument("--scene", required=True,
                   help="scene directory (frame-000000.*), or .npz for CAM")
    p.add_argument("--fcn-variant", default="small", choices=["small", "prior"],
                   help="shipped FCN checkpoint for the FCN modes: small (synthetic "
                        "domain) or prior (trained with product-appearance priors)")
    p.add_argument("--fcn-tta", action="store_true",
                   help="multi-scale (0.5/0.75/1.0) FCN test-time augmentation")
    p.add_argument("--segmentation", default="GT",
                   choices=["GT", "FCN", "FCNThreshold", "RCNN", "RCNNThreshold"])
    p.add_argument("--hypothesis", default="PCS", choices=["PCS", "SUPER4PCS", "V4PCS", "PPF_VOTING"])
    p.add_argument("--verification", default="LCP", choices=["LCP", "MCTS", "GREEDY"])
    p.add_argument("--obj-config", required=True, help="obj_config.yml path")
    p.add_argument("--model-dir", required=True, help="mesh directory")
    p.add_argument("--cache-dir", default=None,
                   help="asset cache (default: physimglobalpose_tpu_torch_cache "
                        "under the temporary directory)")
    p.add_argument("--objects", nargs="*", default=None,
                   help="restrict asset prep to these objects")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--repeat", type=int, default=1,
                   help="run the scene N times (steady-state timing)")
    p.add_argument("--trace", default=None,
                   help="write this run's span trees (one a repeat) as JSON to this path")
    p.add_argument("--result", default=None,
                   help="result.txt path (default: scene dir, or cwd if read-only)")
    p.add_argument("--debug-dir", default=None,
                   help="dump per-object debug artifacts (prob images, hypotheses, "
                        "depth, final overlay) into this directory")
    p.add_argument("--preset", default="default", choices=["default", "small"],
                   help="'small' shrinks the fixed-size caps (fast CPU runs)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default) or on the CPU")
    args = p.parse_args(argv)

    import time

    import numpy as np

    from physimglobalpose_tpu_torch.config import PRESETS
    from physimglobalpose_tpu_torch.models import objectdb
    from physimglobalpose_tpu_torch.pipeline import api, scene as scene_mod
    from physimglobalpose_tpu_torch.utils import tracing

    cfg = PRESETS[args.preset]

    scene_obj = None
    if args.dataset == "CAM":
        z = np.load(args.scene, allow_pickle=False)
        sc = scene_obj = scene_mod.scene_from_arrays(
            color=z["color"], depth=z["depth"], intrinsics=z["intrinsics"],
            cam_pose=z["cam_pose"],
            object_names=[str(n) for n in z["object_names"]],
            class_mask=z["class_mask"] if "class_mask" in z.files else None,
        )
    else:
        sc = scene_mod.load_scene(args.scene, dataset=args.dataset)
    only = args.objects if args.objects else sc.object_names
    db = objectdb.load_object_db(
        args.obj_config, args.model_dir, config=cfg,
        cache_dir=args.cache_dir or objectdb.default_cache_dir(), only=only, device=args.device,
    )

    request_ids = []
    for rep in range(args.repeat):
        t0 = time.perf_counter()
        result = api.estimate_pose(
            args.scene, db, dataset=args.dataset,
            segmentation_mode=args.segmentation,
            hypothesis_mode=args.hypothesis,
            verification_mode=args.verification,
            cfg=cfg,
            seed=args.seed + rep,
            result_path=args.result,
            debug_dir=args.debug_dir,
            scene=scene_obj,
            write_result=args.dataset != "CAM" or args.result is not None,
            device=args.device,
            fcn_variant=args.fcn_variant,
            fcn_tta=args.fcn_tta,
        )
        request_ids.append(result.timings["request_id"])
        if args.repeat > 1:
            print(f"[rep {rep}] scene time: {time.perf_counter() - t0:.3f}s")
    for obj in result.objects:
        t = obj.pose_world[:3, 3]
        print(f"{obj.name}: t=({t[0]:.4f}, {t[1]:.4f}, {t[2]:.4f}) score={obj.score:.4f}")
    print(json.dumps({"timings": result.timings}))
    if args.trace:
        with open(args.trace, "w") as fh:
            json.dump([root.to_dict() for rid in request_ids
                       for root in tracing.record(rid).roots], fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
