"""Public API: estimate_pose - the /pose_estimation service contract.

Reference: the ROS service EstimateObjectPose.srv takes (OperationMode,
SceneFiles, SegmentationMode, HypothesisGenerationMode,
HypothesisVerificationMode) and returns per-object label+pose, also writing
result.txt (main.cpp:86-171). Here the same contract is a plain function:
scene in, per-object camera- and world-frame poses out, result.txt in the
reference's format. Every segmentation mode (GT, FCN, FCNThreshold, RCNN,
RCNNThreshold), hypothesis mode (PCS, SUPER4PCS, V4PCS, PPF_VOTING, Hough)
and verification mode (LCP, MCTS, GREEDY) of the JAX package runs here for
one scene, and debug_dir dumps the JAX package's debug artifacts
(utils/debug.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from physimglobalpose_tpu_torch import _torchcfg
from physimglobalpose_tpu_torch.config import PipelineConfig, DEFAULT_CONFIG
from physimglobalpose_tpu_torch.geometry import se3
from physimglobalpose_tpu_torch.models.objectdb import ObjectDB
from physimglobalpose_tpu_torch.ops import icp as icp_mod, lcp
from physimglobalpose_tpu_torch.pipeline import hypothesis, mcts, scene as scene_mod, segmentation
from physimglobalpose_tpu_torch.pipeline.selection import lcp_select
from physimglobalpose_tpu_torch.utils.debug import DebugDump
from physimglobalpose_tpu_torch.utils import tracing

# Congruent-set hypothesis modes and their generator mode; the voting modes
# run per object (generate_hypotheses_voting).
_GEN_MODES = {
    "PCS": "stocs",
    "CONGRUENT_SET_MATCHING": "stocs",
    "SUPER4PCS": "super4pcs",
    "V4PCS": "v4pcs",
}
_VOTING_MODES = ("PPF_VOTING", "Hough")


def _finalize_hypotheses_batch(transforms, scores, best_transform, best_score, cam_pose, top_k):
    """Per-object estimate fields of the batched branch, flat-packed so the
    host pays one copy. Returns [K, top_k*16 + top_k + 16 + 16 + 1] rows:
    (top_tf, top_scores, pose_cam, pose_world, best_score)."""
    k = transforms.shape[0]
    idx = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :top_k]
    top_scores = torch.gather(scores, 1, idx)
    top_tf = transforms[torch.arange(k, device=idx.device)[:, None], idx]
    pose_cam = lcp_select(best_transform, best_score[:, None, None])
    pose_world = se3.to_world(pose_cam, cam_pose)
    return torch.cat(
        [
            top_tf.reshape(k, -1), top_scores.reshape(k, -1),
            pose_cam.reshape(k, -1), pose_world.reshape(k, -1),
            best_score.reshape(k, 1),
        ],
        dim=1,
    )


def _refine_final_batch(
    poses, model_pts, model_nrm, seg_pts, seg_mask, cam_pose,
    iters, trim_fraction, max_corr_dist, point_to_plane, model_counts=None,
):
    """Final ICP polish of every object (one pose each, ops/icp.polish_icp),
    then the world frame. Returns [K, 32] rows: (pose_cam, pose_world)
    flattened."""
    refined = icp_mod.polish_icp(
        poses, model_pts, model_nrm, seg_pts, seg_mask, iters=iters,
        trim_fraction=trim_fraction, max_corr_dist=max_corr_dist,
        point_to_plane=point_to_plane, model_counts=model_counts,
    )
    world = se3.to_world(refined, cam_pose)
    k = poses.shape[0]
    return torch.cat([refined.reshape(k, 16), world.reshape(k, 16)], dim=1)


def _padded_stack(clouds) -> np.ndarray:
    """[K, Nmax, 3] float32 stack of [N_k, 3] clouds, zero past each one's N_k."""
    out = np.zeros((len(clouds), max(len(c) for c in clouds), 3), np.float32)
    for i, c in enumerate(clouds):
        out[i, :len(c)] = c
    return out


def _dump_results(dbg, estimates, db, prob_images, sc, intr, cfg, verification_mode) -> None:
    """The debug dump's per-object artifacts, the final assignment's mesh
    render (MCTS and GREEDY) and the final pose overlay."""
    for est in estimates:
        obj = db[est.name]
        dbg.prob_image(est.name, prob_images[obj.class_id])
        dbg.hypotheses(est.name, est.hypotheses, est.hypothesis_scores)
        dbg.info(est.name, {"score": est.score, "pose_world": est.pose_world.tolist()})
    if verification_mode in ("MCTS", "GREEDY") and estimates:
        # Quality render of the final chosen assignment: the triangle
        # rasterization of the meshes at full resolution (the search's leaf
        # cost uses the point splat at render_scale; this is the depth_sim
        # render, camera.cpp:31, renderScene.cpp:45-71).
        from physimglobalpose_tpu_torch.models import assets as assets_mod
        from physimglobalpose_tpu_torch.ops import raster as raster_mod, raster_tri

        dev = intr.device
        final = torch.zeros(cfg.render.height, cfg.render.width, dtype=torch.float32, device=dev)
        for est in estimates:
            mesh = assets_mod.decimate_to_max_faces(db[est.name].mesh, 3000)
            d = raster_tri.render_mesh_depth(
                torch.as_tensor(est.pose_cam.astype(np.float32), device=dev),
                torch.as_tensor(mesh.vertices, device=dev), torch.as_tensor(mesh.faces, device=dev),
                torch.ones(len(mesh.faces), dtype=torch.bool, device=dev), intr,
                cfg.render.height, cfg.render.width,
            )
            final = raster_mod.composite_min(final, d)
        final = torch.where(final > cfg.render.max_render_depth, 0.0, final)
        dbg.depth("final_assignment_mesh_render", final)
    dbg.overlay(
        "final_overlay", sc.color, sc.intrinsics,
        [db[e.name].validation_pts[:1024] for e in estimates],
        [e.pose_cam for e in estimates],
    )


@dataclasses.dataclass
class ObjectPoseEstimate:
    name: str
    pose_cam: np.ndarray  # [4, 4] object pose in camera frame
    pose_world: np.ndarray  # [4, 4]
    score: float
    hypotheses: Optional[np.ndarray] = None  # [K, 4, 4] top-k (camera frame)
    hypothesis_scores: Optional[np.ndarray] = None  # [K]


@dataclasses.dataclass
class PoseEstimationResult:
    objects: List[ObjectPoseEstimate]
    timings: Dict[str, float]

    def pose_of(self, name: str) -> ObjectPoseEstimate:
        return next(o for o in self.objects if o.name == name)


def default_result_path(scene_dir: str) -> str:
    """Where result.txt goes when the caller gave no path: the scene
    directory when this process may write there (by the mode bit of the
    class that applies to it, not only os.access, which root always passes),
    else the working directory."""
    import stat as _stat

    try:
        st = os.stat(scene_dir)
        if st.st_uid == os.geteuid():
            bit = _stat.S_IWUSR
        elif st.st_gid == os.getegid() or st.st_gid in os.getgroups():
            bit = _stat.S_IWGRP
        else:
            bit = _stat.S_IWOTH
        writable = bool(st.st_mode & bit) and os.access(scene_dir, os.W_OK)
    except OSError:
        writable = False
    return os.path.join(scene_dir, "result.txt") if writable else os.path.abspath("result.txt")


def write_result_txt(path: str, result: PoseEstimationResult) -> None:
    """result.txt in the reference format: 'name tx ty tz qx qy qz qw' rows
    (main.cpp:150-166)."""
    with open(path, "w") as fh:
        for obj in result.objects:
            pose = obj.pose_world
            q = se3.matrix_to_quat(torch.as_tensor(pose[:3, :3], dtype=torch.float32)).numpy()
            t = pose[:3, 3]
            fh.write(
                f"{obj.name} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n"
            )


def estimate_pose(
    scene_dir: str,
    db: ObjectDB,
    dataset: str = "APC",
    segmentation_mode: str = "GT",
    hypothesis_mode: str = "PCS",
    verification_mode: str = "LCP",
    cfg: PipelineConfig = DEFAULT_CONFIG,
    seed: int = 0,
    top_k: int = 25,
    refine_final: bool = True,
    write_result: bool = True,
    result_path: Optional[str] = None,
    debug_dir: Optional[str] = None,
    scene: Optional[scene_mod.Scene] = None,
    device=None,
    nn_predictor=None,
    detector=None,
    fcn_variant: str = "small",
    fcn_tta: bool = False,
) -> PoseEstimationResult:
    """Estimate 6D poses for every object in a scene.

    Mirrors estimatePose (main.cpp:86-171): load scene -> remove table ->
    segment -> per-object hypothesis generation -> selection -> world frame.
    LCP selects each object's best-scoring hypothesis, plus a point-to-plane
    ICP polish of each selected pose (refine_final). MCTS and GREEDY search
    placements of the top hypotheses by physics settle, depth render and
    pixel cost (pipeline/mcts.py) and install the settled poses; the polish
    is skipped there. Timings then hold search_s, and in MCTS mode the
    tree's search_expansions, search_budget, search_deadline_cut,
    search_leaf_batches and search_leaves.

    The call is one span "estimate" (utils/tracing), with a child a stage:
    load_scene, remove_table, segmentation, hypotheses, icp_refine or
    search, write_result. The timings are those spans' durations, and
    timings["request_id"] names the request record that holds them (the
    caller's, where the call runs inside one). The hypotheses span counts
    the LCP scan (ops/lcp.take_scan_counts): lcp_scan_points, the segment
    points the kernel scanned, and lcp_slot_points, its calls' Ns.

    The FCN modes take nn_predictor(color, class_ids), by default the
    shipped checkpoint `fcn_variant` ("small" or "prior"; fcn_tta averages
    scales 0.5, 0.75 and 1.0); the RCNN modes take detector(color,
    class_ids), by default the shipped detection network. Both are built on
    the call's device.
    Runs on the card unless device="cpu"; one torch.Generator seeded with
    `seed` drives every random draw, so a seed gives one result per device.

    debug_dir: a directory that receives the JAX package's debug artifacts
    (utils/debug.py): the cleaned depth, each object's probability image,
    top-k hypotheses and score, the final assignment's mesh render in MCTS
    and GREEDY mode, and an overlay of the final poses.
    """
    if verification_mode not in ("LCP", "MCTS", "GREEDY"):
        raise ValueError(f"unknown verification mode {verification_mode!r}")
    if hypothesis_mode not in _GEN_MODES and hypothesis_mode not in _VOTING_MODES:
        raise ValueError(f"unknown hypothesis mode {hypothesis_mode!r}")

    dev = _torchcfg.resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dbg = DebugDump(debug_dir)
    # The timings are the stage spans' durations (one clock for both); each
    # stage that ends in a synchronize holds it inside its span.
    timings: Dict[str, float] = {}
    with tracing.span("estimate") as sp_est:
        timings["request_id"] = sp_est.request_id
        with tracing.span("load_scene") as sp_load:
            sc = scene if scene is not None else scene_mod.load_scene(scene_dir, dataset=dataset)

        with tracing.span("remove_table") as sp_table:
            intr = torch.as_tensor(sc.intrinsics, dtype=torch.float32, device=dev)
            cam_pose = torch.as_tensor(sc.cam_pose, dtype=torch.float32, device=dev)
            depth = torch.as_tensor(sc.depth, dtype=torch.float32, device=dev)
            depth_clean, plane4, table_pose = scene_mod.remove_table(depth, intr, cfg,
                                                                     generator=gen)
            _torchcfg.synchronize(dev)
        timings["preprocess_s"] = (sp_table.end_ns - sp_load.start_ns) * 1e-9
        dbg.depth("depth_clean", depth_clean)

        if segmentation_mode in ("FCN", "FCNThreshold") and nn_predictor is None:
            # The shipped checkpoint (the reference node loads apc_weights.hdf5,
            # predict:59).
            from physimglobalpose_tpu_torch.models import fcn as fcn_mod

            nn_predictor = fcn_mod.load_shipped_predictor(
                variant=fcn_variant, tta_scales=(0.5, 0.75, 1.0) if fcn_tta else (1.0,), device=dev,
            )
        if segmentation_mode in ("RCNN", "RCNNThreshold") and detector is None:
            # The trained detection network when its checkpoint ships, else the
            # shipped FCN as a region scorer.
            from physimglobalpose_tpu_torch.models import detect as detect_mod
            from physimglobalpose_tpu_torch.pipeline import detector as detector_mod

            if os.path.exists(detect_mod.shipped_checkpoint_path()):
                detector = detector_mod.make_learned_detector(device=dev)
            else:
                detector = detector_mod.make_fcn_detector(device=dev)

        with tracing.span("segmentation"):
            class_ids = [db.class_of(n) for n in sc.object_names]
            prob_images = segmentation.build_prob_images(
                segmentation_mode, class_ids, class_mask=sc.class_mask, nn_predictor=nn_predictor,
                color=sc.color, detector=detector, threshold=cfg.preprocess.background_prob,
            )

        def to_dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        def segment_of(obj):
            return segmentation.compute_3d_segment(
                depth_clean, to_dev(prob_images[obj.class_id]), intr, cfg, generator=gen
            )

        with tracing.span("hypotheses") as sp_hyp:
            estimates: List[ObjectPoseEstimate] = []
            segs_by_name: Dict[str, segmentation.Segment3D] = {}
            batchable = (
                hypothesis_mode in _GEN_MODES
                and len(sc.object_names) > 1
                and len({db[n].validation_pts.shape for n in sc.object_names}) == 1
                and len({db[n].search_pts.shape for n in sc.object_names}) == 1
            )

            if batchable:
                objs = [db[n] for n in sc.object_names]
                segs_list = [segment_of(o) for o in objs]
                segs = segmentation.Segment3D(*(torch.stack(f) for f in zip(*segs_list)))
                segs_by_name = dict(zip(sc.object_names, segs_list))
                res_b = hypothesis.generate_hypotheses_batch(
                    segs,
                    torch.stack([to_dev(o.search_pts) for o in objs]),
                    torch.stack([to_dev(o.search_mask, torch.bool) for o in objs]),
                    hypothesis.stack_object_tables([o.ppf_table for o in objs]),
                    torch.stack([to_dev(o.validation_pts) for o in objs]),
                    torch.stack([to_dev(o.validation_nrm) for o in objs]),
                    cfg, generator=gen, mode=_GEN_MODES[hypothesis_mode],
                )
                flat = _finalize_hypotheses_batch(
                    res_b.transforms, res_b.scores, res_b.best_transform,
                    res_b.best_score, cam_pose, top_k,
                ).cpu().numpy()
                kk = min(top_k, res_b.scores.shape[1])
                tf_sz, ts_sz = kk * 16, kk
                for i, name in enumerate(sc.object_names):
                    row = flat[i]
                    estimates.append(ObjectPoseEstimate(
                        name=name,
                        pose_cam=row[tf_sz + ts_sz : tf_sz + ts_sz + 16].reshape(4, 4),
                        pose_world=row[tf_sz + ts_sz + 16 : tf_sz + ts_sz + 32].reshape(4, 4),
                        score=float(row[-1]),
                        hypotheses=row[:tf_sz].reshape(kk, 4, 4),
                        hypothesis_scores=row[tf_sz : tf_sz + ts_sz],
                    ))
            else:
                for name in sc.object_names:
                    obj = db[name]
                    with tracing.span(f"object:{name}"):
                        seg = segs_by_name[name] = segment_of(obj)
                        if hypothesis_mode in _VOTING_MODES:
                            res = hypothesis.generate_hypotheses_voting(
                                seg, to_dev(obj.search_pts), to_dev(obj.search_nrm),
                                to_dev(obj.search_mask, torch.bool), obj.ppf_table,
                                to_dev(obj.validation_pts), to_dev(obj.validation_nrm), cfg,
                                generator=gen,
                            )
                        else:
                            res = hypothesis.generate_hypotheses(
                                seg, to_dev(obj.search_pts), to_dev(obj.search_mask, torch.bool),
                                obj.ppf_table, to_dev(obj.validation_pts),
                                to_dev(obj.validation_nrm),
                                cfg, generator=gen, mode=_GEN_MODES[hypothesis_mode],
                            )
                        top_tf, top_scores = hypothesis.top_k_hypotheses(res, top_k)
                        pose_cam = lcp_select(res.best_transform, res.best_score)
                        estimates.append(ObjectPoseEstimate(
                            name=name,
                            pose_cam=pose_cam.cpu().numpy(),
                            pose_world=se3.to_world(pose_cam, cam_pose).cpu().numpy(),
                            score=float(res.best_score),
                            hypotheses=top_tf.cpu().numpy(),
                            hypothesis_scores=top_scores.cpu().numpy(),
                        ))
            _torchcfg.synchronize(dev)
            sp_hyp.count(**lcp.take_scan_counts(dev))
        timings["hypothesis_s"] = sp_hyp.duration

        # The searches take the hypotheses and overwrite the poses with the
        # settled chosen assignment, so a polish of the best-LCP pose would be
        # dead work there (the reference feeds raw hypotheses to UCT too,
        # UCTSearch.cpp:56-88).
        if refine_final and verification_mode == "LCP":
            with tracing.span("icp_refine") as sp_icp:
                live = [i for i, est in enumerate(estimates) if est.score > 0]
                if live:
                    names = [estimates[i].name for i in live]
                    vp = [db[n].validation_pts[:1024] for n in names]
                    flat = _refine_final_batch(
                        to_dev(np.stack([estimates[i].pose_cam for i in live])),
                        to_dev(_padded_stack(vp)),
                        to_dev(_padded_stack([db[n].validation_nrm[:1024] for n in names])),
                        torch.stack([segs_by_name[n].pts for n in names]),
                        torch.stack([segs_by_name[n].mask for n in names]),
                        cam_pose,
                        cfg.icp.iters, cfg.icp.trim_fraction,
                        cfg.icp.max_corr_dist, cfg.icp.point_to_plane,
                        model_counts=[len(v) for v in vp],
                    ).cpu().numpy()
                    for row_i, i in enumerate(live):
                        estimates[i] = dataclasses.replace(
                            estimates[i],
                            pose_cam=flat[row_i, :16].reshape(4, 4),
                            pose_world=flat[row_i, 16:].reshape(4, 4),
                        )
                _torchcfg.synchronize(dev)
            timings["icp_refine_s"] = sp_icp.duration

        if verification_mode in ("MCTS", "GREEDY"):
            table_world = scene_mod.physics_table_pose(depth, intr, plane4, table_pose,
                                                       cam_pose, cfg, gen)
            with tracing.span("search") as sp_search:
                estimates = mcts.mcts_select(
                    estimates, sc, db, table_world, depth_clean, cfg, seed=seed,
                    search="greedy" if verification_mode == "GREEDY" else "uct",
                    # The per-object 3D segments enable the final-pass TrICP
                    # refinement (cfg.mcts.tricp_final).
                    segs=[segs_by_name[e.name] for e in estimates], device=dev,
                    # MCTS adds search_expansions, search_budget, search_deadline_cut.
                    stats=timings,
                )
                _torchcfg.synchronize(dev)
            timings["search_s"] = sp_search.duration

        if dbg.enabled:
            _dump_results(dbg, estimates, db, prob_images, sc, intr, cfg, verification_mode)

        timings["total_s"] = sp_est.duration
        result = PoseEstimationResult(objects=estimates, timings=timings)
        if write_result:
            with tracing.span("write_result"):
                if result_path is None:
                    result_path = default_result_path(scene_dir)
                write_result_txt(result_path, result)
            timings["result_path"] = result_path
        return result
