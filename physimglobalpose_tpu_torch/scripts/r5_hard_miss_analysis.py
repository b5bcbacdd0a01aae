"""Per-miss analysis of the hard family's MCTS misses: where each 2 cm is lost.

The port of the JAX package's scripts/r5_hard_miss_analysis.py. For each
(scene, object) of --log (r4_hard_eval's MCTS log) whose ADD-S exceeds
--threshold it measures:
1. segment support: the object's segment points after remove_table and
   compute_3d_segment (the hard scenes hide up to ~0.9 of an object);
2. the hypothesis ceiling: the least ADD-S over the branch set
   (est.hypotheses); above 2 cm no search policy can fix the miss;
3. + 4. the three final-state TrICP candidates (raw, TrICP then settle,
   settle then TrICP; BatchedLeafEvaluator.evaluate_final_tricp) started
   from the chosen pose and from the GT pose, with their costs and ADD-S,
   and the argmin. If the GT start walks away from GT or costs more than
   the chosen pose, the data do not support the GT pose better;
5. the joint cost substitution on every scene with a miss: the full-scene
   MCTS result with each object's pose swapped for GT (and all of them),
   costed at cfg.mcts.render_scale and at full resolution. If the GT
   assignment does not cost less, the search's objective (explained
   pixels) cannot see the fix: a data ceiling, not a search bug.
verdict_hint names the branch.

As in the JAX script, step 1 re-runs estimate_pose in LCP mode (the pose
and branch set analysed are the LCP stage's), the scenes load as "APC", and
the table box is remove_table's, without the depth refinement of
estimate_pose. Against it: the meshes, obj_config and names are flags, and
the report's "meta" names the device.

Usage (after r4_hard_eval, on the card; --device cpu for the CPU):
  python -m physimglobalpose_tpu_torch.scripts.r5_hard_miss_analysis \\
      --model-dir <meshes> --obj-config <obj_config.yml> [--objects a,b,c] \\
      [--log <dir>/hard_eval_MCTS_0.jsonl] [--threshold 0.02] [--out report.json]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from physimglobalpose_tpu_torch.scripts import _synth_eval, r4_hard_eval

DEFAULT_OUT = os.path.join(_synth_eval.TMP_ROOT, "hard_miss_analysis.json")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dir", default=r4_hard_eval.DEFAULT_DIR, help="r4_hard_eval's --dir")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log", default=None,
                   help="the hard-eval MCTS log; misses > threshold are analyzed (default "
                        "<dir>/hard_eval_MCTS_<seed>.jsonl)")
    p.add_argument("--threshold", type=float, default=0.02)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--model-dir", required=True, help="mesh directory")
    p.add_argument("--obj-config", required=True, help="obj_config.yml (the class ids)")
    p.add_argument("--objects", default=r4_hard_eval.OBJECTS,
                   help="comma-separated object names")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default) or on the CPU")
    return p.parse_args(argv)


def adds(obj, pose_cam, gt_cam) -> float:
    """ADD-S (m) of two camera-frame poses over the object's first 1,024
    validation points, on the host."""
    pts = obj.validation_pts[:1024]
    a = pts @ np.asarray(pose_cam)[:3, :3].T + np.asarray(pose_cam)[:3, 3]
    b = pts @ np.asarray(gt_cam)[:3, :3].T + np.asarray(gt_cam)[:3, 3]
    d = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1))
    return float(d.min(1).mean())


def verdict_hint(hyp_errs, from_chosen, win_c, from_gt, win_g) -> str:
    """The branch the numbers point to: no hypothesis within 2 cm; the GT
    start refined more than 1 cm away or no cheaper than the chosen pose's;
    else a gap the search or refinement could close."""
    if np.min(hyp_errs) > 0.02:
        return "hypothesis ceiling"
    if (from_gt[win_g]["adds_m"] > 0.01
            or from_gt[win_g]["cost"] >= from_chosen[win_c]["cost"]):
        return "data ceiling (GT-start refines away or costs more)"
    return "search/refinement gap - fixable"


def _remove_table(sc, cfg, seed: int, dev):
    """(cleaned depth, intrinsics tensor, the settle's world table box) of
    remove_table under the seed's generator, the first draws of
    estimate_pose. The box is remove_table's camera-frame pose taken to the
    world, its z up, moved down by its half extent."""
    import torch

    from physimglobalpose_tpu_torch.geometry import se3
    from physimglobalpose_tpu_torch.pipeline import scene as scene_mod

    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    intr = as_t(sc.intrinsics)
    depth_clean, _plane, table_cam = scene_mod.remove_table(
        as_t(sc.depth), intr, cfg, generator=torch.Generator(device=dev).manual_seed(seed))
    table_pose = se3.to_world(table_cam, as_t(sc.cam_pose)).cpu().numpy()
    if table_pose[2, 2] < 0:
        table_pose[:3, 1] *= -1.0
        table_pose[:3, 2] *= -1.0
    table_pose[:3, 3] -= cfg.physics.table_half_extents[2] * table_pose[:3, 2]
    return depth_clean, intr, table_pose


def substitution_inputs(scene_dir: str, db, cfg, seed: int, dev) -> dict:
    """Step 5's inputs on the host: the MCTS result's world poses ("chosen"),
    GT for all ("gt_all") and for each object alone ("gt_<name>"), with the
    leaf evaluator's scene (hulls, branch set, cleaned depth, camera, table
    box)."""
    from physimglobalpose_tpu_torch.pipeline import api, mcts, scene as scene_mod

    sc = scene_mod.load_scene(scene_dir, dataset="APC")
    res = api.estimate_pose(
        scene_dir, db, dataset="APC", segmentation_mode="GT", verification_mode="MCTS",
        cfg=cfg, seed=seed, write_result=False, device=dev,
    )
    chosen_w = np.stack([np.asarray(o.pose_world, np.float64) for o in res.objects])
    gt_w = np.stack([np.asarray(sc.gt_poses[o.name], np.float64) for o in res.objects])
    depth_clean, _intr, table_pose = _remove_table(sc, cfg, seed, dev)
    hyp_world, _scores, obj_hulls = mcts._scene_search_inputs(res.objects, sc, db, cfg)
    rows = {"chosen": chosen_w, "gt_all": gt_w}
    for oi, o in enumerate(res.objects):
        sub = chosen_w.copy()
        sub[oi] = gt_w[oi]
        rows[f"gt_{o.name}"] = sub
    return dict(obj_hulls=obj_hulls, hyp_world=hyp_world, depth=depth_clean.cpu().numpy(),
                intrinsics=sc.intrinsics, cam_pose=sc.cam_pose, table_pose=table_pose, rows=rows)


def substitution_costs(inputs: dict, cfg, device=None) -> dict:
    """{"scale_<s>": {row: pixel cost}} of each row of poses, no settle, at
    cfg.mcts.render_scale and at 1 (mcts._render_cost_of_poses over a batch
    of one pose set, the JAX package's _poses_cost_jit), on `device`."""
    import torch

    from physimglobalpose_tpu_torch.pipeline import mcts

    entry = {}
    for scale in (cfg.mcts.render_scale, 1):
        ev = mcts.BatchedLeafEvaluator(
            inputs["obj_hulls"], inputs["hyp_world"], inputs["depth"], inputs["intrinsics"],
            inputs["cam_pose"], inputs["table_pose"], cfg, render_scale=scale, device=device)
        act = torch.ones(len(inputs["obj_hulls"]), dtype=torch.bool, device=ev.device)
        entry[f"scale_{scale}"] = {
            label: float(mcts._render_cost_of_poses(
                ev.consts_full, ev.cfg, ev.h, ev.w, ev.splat_radius,
                torch.as_tensor(poses.astype(np.float32), device=ev.device)[None], act)[0])
            for label, poses in inputs["rows"].items()
        }
    return entry


def analyse(log: str, threshold: float, db, cfg, seed: int, dev) -> dict:
    """The report of every miss of `log` over `threshold` (steps 1-5)."""
    import torch

    from physimglobalpose_tpu_torch import _torchcfg
    from physimglobalpose_tpu_torch.geometry import metrics
    from physimglobalpose_tpu_torch.pipeline import api, mcts, scene as scene_mod, segmentation

    misses = []
    with open(log) as fh:
        for line in fh:
            row = json.loads(line)
            for name, entry in row["objects"].items():
                if entry.get("adds_m", 0.0) > threshold:
                    misses.append((row["scene"], name, entry["adds_m"]))
    print(f"analyzing {len(misses)} misses > {threshold * 1000:.1f} mm:", misses, flush=True)

    report = {"meta": {"log": log, "threshold_m": threshold, "seed": seed,
                       "backend": _torchcfg.describe_device(dev)}}
    for scene_dir, name, adds_m in misses:
        sc = scene_mod.load_scene(scene_dir, dataset="APC")
        obj = db[name]
        cam64 = np.asarray(sc.cam_pose, np.float64)
        cam_inv = np.linalg.inv(cam64)
        gt_cam = (cam_inv @ np.asarray(sc.gt_poses[name], np.float64)).astype(np.float32)
        res = api.estimate_pose(
            scene_dir, db, dataset="APC", segmentation_mode="GT", verification_mode="LCP",
            cfg=cfg, seed=seed, write_result=False, device=dev,
        )
        est = res.pose_of(name)

        # 1. segment support.
        depth_clean, intr, table_pose = _remove_table(sc, cfg, seed, dev)
        prob = segmentation.gt_prob_images(sc.class_mask, [obj.class_id])
        seg = segmentation.compute_3d_segment(
            depth_clean, torch.as_tensor(prob[obj.class_id], device=dev), intr, cfg,
            generator=torch.Generator(device=dev).manual_seed(1),
        )
        n_seg = int(seg.mask.sum())

        # 2. hypothesis ceiling over the branch set (pre-settle, folded).
        hyp_errs = np.asarray([adds(obj, h, gt_cam) for h in est.hypotheses])

        # 3 + 4. final-state candidates from the chosen pose and from GT.
        hyp_world, _scores, obj_hulls = mcts._scene_search_inputs([est], sc, db, cfg)
        ev = mcts.BatchedLeafEvaluator(obj_hulls, hyp_world, depth_clean, sc.intrinsics,
                                       sc.cam_pose, table_pose, cfg, device=dev)

        def final3(pose_cam):
            hw = (cam64 @ np.asarray(pose_cam, np.float64)).astype(np.float32)
            ev.consts_full = dict(ev.consts_full, hyp_world=torch.as_tensor(
                hw[None, None].repeat(hyp_world.shape[1], 1), device=ev.device))
            costs3, settled3 = ev.evaluate_final_tricp(
                np.array([0]), np.ones(1, bool), seg.pts[None], seg.mask[None])
            out = []
            for i in range(3):
                pc = (cam_inv @ np.asarray(settled3[i, 0], np.float64)).astype(np.float32)
                out.append({"cost": float(costs3[i]),
                            "adds_m": round(adds(obj, pc, gt_cam), 4)})
            return out, int(np.argmin(costs3))

        from_chosen, win_c = final3(est.pose_cam)
        from_gt, win_g = final3(gt_cam)

        rot, tr = metrics.pose_error(
            torch.as_tensor(np.asarray(est.pose_cam, np.float32)), torch.as_tensor(gt_cam),
            torch.as_tensor(np.asarray(obj.symmetry, np.float32)))

        key = f"{os.path.basename(scene_dir)}/{name}"
        report[key] = {
            "eval_adds_m": adds_m,
            "segment_points": n_seg,
            "lcp_pose_folded": {"rot_deg": round(float(rot), 2),
                                "trans_m": round(float(tr), 4)},
            "branch_set_adds_m": {
                "min": round(float(hyp_errs.min()), 4),
                "chosen_rank0": round(float(hyp_errs[0]), 4),
                "n_within_2cm": int((hyp_errs < 0.02).sum()),
            },
            "final3_from_chosen": {"candidates": from_chosen, "winner": win_c},
            "final3_from_gt": {"candidates": from_gt, "winner": win_g},
            "verdict_hint": verdict_hint(hyp_errs, from_chosen, win_c, from_gt, win_g),
        }
        print(json.dumps(report[key], indent=1), flush=True)

    # 5. Joint cost substitution on every miss scene (see the docstring).
    for scene_dir in sorted({sd for sd, _n, _a in misses}):
        entry = substitution_costs(substitution_inputs(scene_dir, db, cfg, seed, dev), cfg, dev)
        report[f"{os.path.basename(scene_dir)}/joint_cost_substitution"] = entry
        print(os.path.basename(scene_dir), "joint substitution:", json.dumps(entry), flush=True)
    return report


def main(argv=None) -> int:
    args = parse_args(argv)
    from physimglobalpose_tpu_torch import _torchcfg
    from physimglobalpose_tpu_torch.config import PRESETS
    from physimglobalpose_tpu_torch.models import objectdb

    dev = _torchcfg.resolve_device(args.device)
    cfg = PRESETS["small"]
    db = objectdb.load_object_db(
        args.obj_config, args.model_dir, config=cfg, cache_dir=objectdb.default_cache_dir(),
        only=args.objects.split(","), device=dev,
    )
    log = args.log or os.path.join(args.dir, f"hard_eval_MCTS_{args.seed}.jsonl")
    report = analyse(log, args.threshold, db, cfg, args.seed, dev)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
