"""Dataset sweeps with metrics, JSONL logs, and resume.

The reference ships pose-error functions (symmetry-folded rot/trans,
utilities.cpp:514-577; EMD :425-484) but no evaluation loop. This module
runs estimate_pose over many scene directories, scores against gt_info.yml
object poses when present (ADD, ADD-S, folded rot/trans), appends one JSON
line per scene, and skips scenes already in the log on restart.

With a mesh (evaluate_scenes(mesh=...), the CLI's --sharded) the LCP and
MCTS sweeps go through parallel/scene_sweep.sweep_scenes: every pending
scene's (scene, object) jobs in one job batch split over the mesh's devices,
and in MCTS mode the scenes' searches sharing leaf batches.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from physimglobalpose_tpu_torch.config import DEFAULT_CONFIG, PRESETS, PipelineConfig
from physimglobalpose_tpu_torch.geometry import metrics
from physimglobalpose_tpu_torch.models.objectdb import ObjectDB
from physimglobalpose_tpu_torch.pipeline import api, scene as scene_mod


def _metrics_for(est, gt_pose: np.ndarray, obj, emd_exact: bool = False) -> Dict[str, float]:
    """Pose errors of one estimate against its ground truth, on the CPU."""
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    test, gt = as_t(est.pose_world), as_t(gt_pose)
    model = as_t(obj.validation_pts[:1024])
    rot_err, trans_err = metrics.pose_error(test, gt, as_t(obj.symmetry))
    out = {
        "rot_err_deg": float(rot_err),
        "trans_err_m": float(trans_err),
        "add_m": float(metrics.add_error(test, gt, model)),
        "adds_m": float(metrics.adds_error(test, gt, model)),
    }
    if emd_exact:
        # Offline only: the exact transportation-LP EMD with the reference's
        # cv::EMD semantics (utilities.cpp:425-484), host-sequential.
        pts = np.asarray(obj.validation_pts[:1024])
        pad = 0.05
        a, b = se3_apply(est.pose_world, pts), se3_apply(gt_pose, pts)
        lo = np.minimum(a.min(0), b.min(0)) - pad
        hi = np.maximum(a.max(0), b.max(0)) + pad
        out["emd_bins"] = metrics.emd_error_exact(test, gt, model, lo, hi)
    return out


def se3_apply(pose: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ pose[:3, :3].T + pose[:3, 3]


def completed_scenes(log_path: str) -> set:
    done = set()
    if os.path.exists(log_path):
        with open(log_path) as fh:
            for line in fh:
                try:
                    done.add(json.loads(line)["scene"])
                except (json.JSONDecodeError, KeyError):
                    continue
    return done


def evaluate_scenes(
    scene_dirs: Sequence[str],
    db: ObjectDB,
    log_path: str,
    dataset: str = "APC",
    segmentation_mode: str = "GT",
    verification_mode: str = "LCP",
    hypothesis_mode: str = "PCS",
    cfg: PipelineConfig = DEFAULT_CONFIG,
    seed: int = 0,
    add_threshold: float = 0.02,
    mesh=None,
    emd_exact: bool = False,
    device=None,
) -> Dict[str, float]:
    """Sweep scenes, append per-scene JSONL, return aggregate metrics over the
    whole log.

    Re-running with the same log_path resumes: scenes already logged are
    skipped. Runs on the card unless device="cpu". mesh: a
    parallel/mesh.DeviceMesh; the LCP and MCTS sweeps then run all pending
    scenes through scene_sweep.sweep_scenes (rows carry the batch's mean
    time a scene, marked "sharded"); GREEDY runs scene by scene.
    """
    done = completed_scenes(log_path)
    pending = [sd for sd in scene_dirs if sd not in done]

    def write_row(sd: str, result, seconds: float, extra: Optional[dict] = None):
        sc = scene_mod.load_scene(sd, dataset=dataset)
        row = {"scene": sd, "seconds": seconds, "objects": {}, **(extra or {})}
        for est in result.objects:
            entry: dict = {"score": est.score}
            if sc.gt_poses and est.name in sc.gt_poses:
                entry.update(_metrics_for(est, sc.gt_poses[est.name], db[est.name],
                                          emd_exact=emd_exact))
            row["objects"][est.name] = entry
        with open(log_path, "a") as fh:
            fh.write(json.dumps(row) + "\n")

    if mesh is not None and verification_mode in ("LCP", "MCTS") and pending:
        from physimglobalpose_tpu_torch.parallel import scene_sweep

        t0 = time.perf_counter()
        results = scene_sweep.sweep_scenes(
            mesh, pending, db, dataset=dataset, segmentation_mode=segmentation_mode,
            hypothesis_mode=hypothesis_mode, cfg=cfg, seed=seed,
            verification_mode=verification_mode,
        )
        batch_total_s = time.perf_counter() - t0
        for sd in pending:
            # A sharded row carries the batch's mean time a scene, not the
            # scene's own wall time: marked so a log that mixes both tells.
            write_row(sd, results[sd], batch_total_s / len(pending), extra={
                "scenes_per_sec": results[sd].timings.get("scenes_per_sec"),
                "sharded": True, "batch_scenes": len(pending),
                "seconds_batch_total": batch_total_s,
            })
        pending = []

    for sd in pending:
        t0 = time.perf_counter()
        result = api.estimate_pose(
            sd, db, dataset=dataset,
            segmentation_mode=segmentation_mode,
            verification_mode=verification_mode,
            hypothesis_mode=hypothesis_mode,
            cfg=cfg, seed=seed, write_result=False, device=device,
        )
        write_row(sd, result, time.perf_counter() - t0)

    all_rows = []
    with open(log_path) as fh:
        for line in fh:
            try:
                all_rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    adds_all, add_all, secs = [], [], []
    for row in all_rows:
        secs.append(row.get("seconds", 0.0))
        for entry in row.get("objects", {}).values():
            if "adds_m" in entry:
                adds_all.append(entry["adds_m"])
                add_all.append(entry["add_m"])
    agg = {
        "scenes": float(len(all_rows)),
        "mean_seconds": float(np.mean(secs)) if secs else 0.0,
    }
    if adds_all:
        agg.update({
            "mean_adds_m": float(np.mean(adds_all)),
            "mean_add_m": float(np.mean(add_all)),
            "adds_within_2cm": float(np.mean(np.asarray(adds_all) < add_threshold)),
        })
    return agg


def main(argv=None):
    """Dataset-sweep CLI: ADD/ADD-S aggregates over many scene dirs.

    python -m physimglobalpose_tpu_torch.pipeline.evaluate \
        --scenes /data/scenes/scene_* --log eval.jsonl \
        --obj-config obj_config.yml --model-dir meshes/ [--device cpu]
    """
    import argparse
    import glob as glob_mod

    p = argparse.ArgumentParser(description="dataset sweep with ADD/ADD-S (PyTorch/CUDA)")
    p.add_argument("--scenes", nargs="+", required=True, help="scene dirs (globs ok)")
    p.add_argument("--log", required=True, help="JSONL log (resume-safe)")
    p.add_argument("--obj-config", required=True)
    p.add_argument("--model-dir", required=True)
    p.add_argument("--dataset", default="APC", choices=["APC", "YCB"])
    p.add_argument("--segmentation", default="GT")
    p.add_argument("--verification", default="LCP", choices=["LCP", "MCTS", "GREEDY"])
    p.add_argument("--hypothesis", default="PCS",
                   choices=["PCS", "CONGRUENT_SET_MATCHING", "SUPER4PCS", "V4PCS",
                            "PPF_VOTING", "Hough"])
    p.add_argument("--cache-dir", default=None,
                   help="asset cache (default: physimglobalpose_tpu_torch_cache "
                        "under the temporary directory)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sharded", action="store_true",
                   help="run the (scene, object) jobs of all scenes as one batch split over "
                        "every device of --device (every card, or 8 CPU entries); in MCTS "
                        "mode the searches also share leaf batches")
    p.add_argument("--preset", default="default", choices=["default", "small"],
                   help="'small' shrinks the fixed-size caps (fast CPU runs)")
    p.add_argument("--emd-exact", action="store_true",
                   help="add exact transportation-LP EMD per object (host-side, offline)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the card (default) or on the CPU")
    args = p.parse_args(argv)

    from physimglobalpose_tpu_torch.models import objectdb

    cfg = PRESETS[args.preset]
    dirs = sorted(set(sum((glob_mod.glob(s) or [s] for s in args.scenes), [])))
    sc0 = scene_mod.load_scene(dirs[0], dataset=args.dataset)
    db = objectdb.load_object_db(
        args.obj_config, args.model_dir, config=cfg,
        cache_dir=args.cache_dir or objectdb.default_cache_dir(),
        only=sc0.object_names if len(dirs) == 1 else None, device=args.device,
    )
    mesh = None
    if args.sharded:
        from physimglobalpose_tpu_torch.parallel import mesh as mesh_mod

        mesh = mesh_mod.make_mesh(device=args.device)
    agg = evaluate_scenes(
        dirs, db, args.log, dataset=args.dataset,
        segmentation_mode=args.segmentation,
        verification_mode=args.verification,
        hypothesis_mode=args.hypothesis,
        cfg=cfg, seed=args.seed, mesh=mesh, emd_exact=args.emd_exact, device=args.device,
    )
    print(json.dumps(agg))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
