"""Whole-scene latency benchmark: the <1 s end-to-end north star.

The port of the JAX package's scripts/whole_scene_bench.py. Measures, on one
scene directory in the reference layout, at the small preset (the JAX
bench's configuration, config.PRESETS["small"]):
- serial LCP scene (api.estimate_pose, warm, best of --repeat)  [s/scene]
- batched LCP sweep over --sweep-scenes symlinked copies of the scene,
  unchunked and pipelined in 2 and 4 chunks                     [scenes/s]
- whole-scene MCTS (estimate_pose verification=MCTS) and the multi-scene
  MCTS sweep                                                    [s/scene, scenes/s]
- whole-scene LCP with NEURAL segmentation (FCNThreshold, the reference
  demo's configuration) for the shipped FCN checkpoints, with the
  predictor's own time split out and the poses held to the GT-segmentation
  LCP row's (the "golden" poses); with MCTS too unless --skip-mcts.
  The GT-segmentation row's poses and each neural row's are written too
  (lcp_pose_world, fcn_<row>_pose_world), so that a caller can grade them.
- with --real-frame: the shipped networks' per-class IoU and mIoU on the
  scene's colour frame against its mask (the JAX script reads the bundled
  real frame there).

Each row is a best of --repeat after one warm-up. The results are flushed to
--out after every row, so a late failure keeps the earlier rows.

Usage (on the card; --device cpu for the CPU):
  python -m physimglobalpose_tpu_torch.scripts.whole_scene_bench --scene <dir> \\
      --obj-config <obj_config.yml> --model-dir <meshes> [--out bench.json]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

DEFAULT_OUT = os.path.join(tempfile.gettempdir(), "physimglobalpose_tpu_torch",
                           "whole_scene_bench.json")
PIPELINED_NOTE = (
    "Overlap is complete once the next chunk's HOST preprocessing (the measured "
    "preprocess_host_s per scene, reported per row) hides behind the current chunk's device "
    "work. More chunks past that point only shrink the per-dispatch job batch, losing "
    "batch amortization with nothing left to hide. Tune pipeline_chunks to the smallest "
    "value whose preprocess_host_s is below the device time."
)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", required=True, help="scene directory (reference layout)")
    p.add_argument("--model-dir", required=True, help="mesh directory")
    p.add_argument("--obj-config", required=True, help="obj_config.yml path")
    p.add_argument("--dataset", default="APC", choices=["APC", "YCB"])
    p.add_argument("--repeat", type=int, default=3)
    p.add_argument("--sweep-scenes", type=int, default=8)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--skip-mcts", action="store_true")
    p.add_argument("--skip-fcn", action="store_true")
    p.add_argument("--fcn-variants", default="small,prior,prior_tta",
                   help="the neural-segmentation rows, of small, prior, prior_tta (each "
                        "runs where its checkpoint ships)")
    p.add_argument("--real-frame", action="store_true",
                   help="add the shipped networks' mIoU on the scene's colour frame against "
                        "its mask (a real captured frame, where the scene is one)")
    p.add_argument("--cache-dir", default=None,
                   help="asset cache (default: the port's directory under the temporary one)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default) or on the CPU")
    return p.parse_args(argv)


def timed_best(fn, repeat: int):
    """(best seconds, its result) of `repeat` calls of fn()."""
    best = (float("inf"), None)
    for _ in range(repeat):
        t0 = time.perf_counter()
        res = fn()
        dt = time.perf_counter() - t0
        if dt < best[0]:
            best = (dt, res)
    return best


def poses_of(result) -> dict:
    """{object name: world pose as nested lists} of an estimate_pose result."""
    return {o.name: np.asarray(o.pose_world, np.float64).tolist() for o in result.objects}


def main(argv=None) -> dict:
    args = parse_args(argv)

    import torch

    from physimglobalpose_tpu_torch import _torchcfg
    from physimglobalpose_tpu_torch.config import PRESETS
    from physimglobalpose_tpu_torch.geometry import metrics
    from physimglobalpose_tpu_torch.models import fcn as fcn_mod, objectdb
    from physimglobalpose_tpu_torch.parallel import scene_sweep
    from physimglobalpose_tpu_torch.pipeline import api, scene as scene_mod

    dev = _torchcfg.resolve_device(args.device)
    cfg = PRESETS["small"]
    scene = os.path.abspath(args.scene)
    names = scene_mod.load_scene(scene, dataset=args.dataset, load_color=False).object_names
    db = objectdb.load_object_db(
        args.obj_config, args.model_dir, config=cfg,
        cache_dir=args.cache_dir or objectdb.default_cache_dir(), only=names, device=dev,
    )
    out = {"backend": dev.type, **_torchcfg.describe_device(dev), "scene": scene,
           "objects": len(names)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)

    def flush():
        out["timestamp"] = time.strftime("%Y-%m-%dT%H:%M:%S")
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)

    def estimate(verification="LCP", segmentation="GT", predictor=None):
        return api.estimate_pose(
            scene, db, dataset=args.dataset, segmentation_mode=segmentation,
            hypothesis_mode="PCS", verification_mode=verification, cfg=cfg, seed=0,
            write_result=False, device=dev, nn_predictor=predictor,
        )

    # --- serial LCP scene, warm ---
    estimate()
    dt, golden = timed_best(estimate, args.repeat)
    out["lcp_seconds_per_scene_warm"] = round(dt, 4)
    out["lcp_pose_world"] = poses_of(golden)
    flush()

    with tempfile.TemporaryDirectory(prefix="sweepscene") as tmp:
        # The sweep keys results by directory: symlinked copies of the scene.
        n = args.sweep_scenes
        sweep_dirs = []
        for i in range(n):
            sweep_dirs.append(os.path.join(tmp, f"s{i}"))
            os.symlink(scene, sweep_dirs[-1])

        def sweep(**kw):
            return scene_sweep.sweep_scenes(None, sweep_dirs, db, dataset=args.dataset,
                                            cfg=cfg, device=dev, **kw)

        sweep()  # warm with the same job count
        dt, res = timed_best(sweep, args.repeat)
        out["lcp_sweep_scenes_per_sec"] = round(n / dt, 4)
        out["lcp_sweep_batch"] = n
        out["lcp_sweep_timings"] = {k: round(v, 4) for k, v in
                                    res[sweep_dirs[0]].timings.items()}
        # Pipelined: chunk i+1's host preprocessing overlaps chunk i's device work.
        for chunks in (2, 4):
            sweep(pipeline_chunks=chunks)
            dt, res = timed_best(lambda: sweep(pipeline_chunks=chunks), args.repeat)
            out[f"lcp_sweep_pipelined{chunks}_scenes_per_sec"] = round(n / dt, 4)
            out[f"lcp_sweep_pipelined{chunks}_preprocess_host_s"] = round(
                res[sweep_dirs[0]].timings.get("preprocess_host_s", 0.0), 4)
        out["pipelined_note"] = PIPELINED_NOTE
        flush()

        if not args.skip_mcts:
            estimate("MCTS")
            dt, _ = timed_best(lambda: estimate("MCTS"), args.repeat)
            out["mcts_seconds_per_scene_warm"] = round(dt, 4)
            # The multi-scene search: all scenes' searches share leaf batches.
            sweep(verification_mode="MCTS")
            dt, _ = timed_best(lambda: sweep(verification_mode="MCTS"), args.repeat)
            out["mcts_sweep_scenes_per_sec"] = round(n / dt, 4)
            out["mcts_sweep_seconds_per_scene"] = round(dt / n, 4)
            flush()

    if not args.skip_fcn:
        # (row label, checkpoint variant, TTA scales): prior_tta is the
        # production --fcn-tta path, so its delta against prior is the TTA cost.
        rows = {"small": ("small", (1.0,)), "prior": ("prior", (1.0,)),
                "prior_tta": ("prior", (0.5, 0.75, 1.0))}
        wanted = [r for r in args.fcn_variants.split(",") if r]
        unknown = set(wanted) - set(rows)
        if unknown:
            raise ValueError(f"unknown --fcn-variants {sorted(unknown)}; choose from {list(rows)}")

        def timed_predictor(variant, tta_scales):
            pred = fcn_mod.load_shipped_predictor(variant=variant, tta_scales=tta_scales,
                                                  device=dev)
            calls = []

            def predictor(color, wanted_ids):
                t0 = time.perf_counter()
                r = pred(color, wanted_ids)  # returns host arrays: synchronised
                calls.append(time.perf_counter() - t0)
                return r

            return predictor, calls

        def neural_row(verification, predictor, calls):
            """(best seconds, (result, the predictor's seconds in that run))."""
            def once():
                calls.clear()
                return estimate(verification, "FCNThreshold", predictor), sum(calls)

            once()  # warm-up
            return timed_best(once, args.repeat)

        golden_poses = {o.name: o.pose_world for o in golden.objects}
        for label in wanted:
            variant, tta = rows[label]
            if not os.path.exists(fcn_mod.shipped_checkpoint_path(variant)):
                continue
            predictor, calls = timed_predictor(variant, tta)
            dt, (res, pred_s) = neural_row("LCP", predictor, calls)
            out[f"fcn_{label}_lcp_seconds_per_scene_warm"] = round(dt, 4)
            out[f"fcn_{label}_predictor_seconds_per_scene"] = round(pred_s, 4)
            # Does the neural segmentation reproduce the GT-mask pipeline's answer?
            agree = {}
            for obj in res.objects:
                rot, tr = metrics.pose_error(
                    torch.as_tensor(obj.pose_world, dtype=torch.float32),
                    torch.as_tensor(golden_poses[obj.name], dtype=torch.float32),
                    torch.as_tensor(np.asarray(db[obj.name].symmetry), dtype=torch.float32))
                agree[obj.name] = {"rot_deg": round(float(rot), 2), "trans_m": round(float(tr), 4)}
            out[f"fcn_{label}_vs_golden_pose"] = agree
            out[f"fcn_{label}_pose_world"] = poses_of(res)
            flush()
        # Everything on: neural segmentation + the physics-aware search.
        if not args.skip_mcts:
            for variant in ("small", "prior"):
                if variant not in wanted or not os.path.exists(
                        fcn_mod.shipped_checkpoint_path(variant)):
                    continue
                predictor, calls = timed_predictor(variant, (1.0,))
                dt, (_, pred_s) = neural_row("MCTS", predictor, calls)
                out[f"fcn_{variant}_mcts_seconds_per_scene_warm"] = round(dt, 4)
                out[f"fcn_{variant}_mcts_predictor_seconds_per_scene"] = round(pred_s, 4)
                flush()

    if args.real_frame:
        out["fcn_real_frame_miou"] = real_frame_miou(scene, dev)
        flush()

    flush()
    print(json.dumps(out, indent=1))
    return out


def real_frame_miou(scene: str, dev) -> dict:
    """Per-class IoU and mIoU of every shipped FCN checkpoint (and the
    prior one with TTA) on the scene's colour frame against its mask."""
    from PIL import Image

    from physimglobalpose_tpu_torch.models import fcn as fcn_mod
    from physimglobalpose_tpu_torch.scripts.eval_fcn_checkpoints import per_class_iou

    color = np.array(Image.open(os.path.join(scene, "frame-000000.color.png")).convert("RGB"))
    gt_mask = np.asarray(Image.open(os.path.join(scene, "frame-000000.mask.png")))
    classes = sorted(int(c) for c in np.unique(gt_mask) if c != 0)
    real = {"classes": classes}
    rows = [(v, v, (1.0,)) for v in ("small", "full", "transfer", "prior")]
    rows.append(("prior_tta", "prior", (0.5, 0.75, 1.0)))
    for label, variant, tta in rows:
        path = fcn_mod.shipped_checkpoint_path(variant)
        if not os.path.exists(path):
            continue
        flat, meta = fcn_mod.load_params_npz(path)
        model = fcn_mod.load_flax_params(
            fcn_mod.build_model(meta["model"], num_classes=meta["num_classes"]), flat).to(dev)
        label_img = fcn_mod.make_labeler(model, *color.shape[:2], tta_scales=tta)(color)
        ious = per_class_iou(label_img, gt_mask, classes)
        real[label] = {"per_class_iou": {str(c): round(v, 4) for c, v in ious.items()},
                       "miou": round(sum(ious.values()) / max(len(ious), 1), 4)}
    return real


if __name__ == "__main__":
    main()
