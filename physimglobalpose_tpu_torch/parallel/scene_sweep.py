"""Multi-scene sweep: many scenes' (scene, object) jobs in one job batch.

The reference processes one scene per service call, objects serially
(main.cpp:86-171). As in the JAX package (physimglobalpose_tpu/parallel/
scene_sweep.py), a batch of scenes is preprocessed, every (scene, object)
job is flattened into one leading axis, and hypothesis generation, LCP
scoring (kernel 1 on the card, one launch a job) and the ICP polish run over
that axis with no host round trip; with a mesh the job axis is split over
its devices (parallel/mesh.py), each device running its contiguous share.

Random streams. The port's serial estimate_pose draws everything from one
torch.Generator(device).manual_seed(seed) in a fixed order: the table
removal's subsample and MSAC draws, each object's segment subsample, then
each object's generation draws. Here every scene gets its own generator,
seeded with `seed` on the sweep's first device, and consumes it in exactly
that order (the generation draws through hypothesis.draw_generation, handed
to the job batch as injected draws), so the sweep equals the serial
estimate_pose of every scene, bit for bit on one card as on the CPU: the
voxel grid's sums are a segmented reduction in sorted order (ops/voxel.py),
the same order in every run.

The table removal and the segments run scene by scene and object by object
(the port's remove_table and compute_3d_segment take no leading batch); a
batched variant is later speed work.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from physimglobalpose_tpu_torch import _torchcfg
from physimglobalpose_tpu_torch.config import PipelineConfig, DEFAULT_CONFIG
from physimglobalpose_tpu_torch.geometry import depthio
from physimglobalpose_tpu_torch.models.objectdb import ObjectDB
from physimglobalpose_tpu_torch.ops import icp as icp_mod, ppf
from physimglobalpose_tpu_torch.parallel import mesh as mesh_mod
from physimglobalpose_tpu_torch.parallel.mesh import DeviceMesh
from physimglobalpose_tpu_torch.pipeline import hypothesis, scene as scene_mod, segmentation
from physimglobalpose_tpu_torch.pipeline.api import (
    _GEN_MODES, ObjectPoseEstimate, PoseEstimationResult,
)
from physimglobalpose_tpu_torch.pipeline.segmentation import Segment3D
from physimglobalpose_tpu_torch.utils import tracing


@dataclasses.dataclass
class _SceneJobs:
    """One preprocessed scene, its tensors on the sweep's first device."""

    scene_dir: str
    sc: scene_mod.Scene
    names: List[str]
    segs: Segment3D  # stacked [K, ...]
    # The scene's generator, positioned after the table and segment draws:
    # the generation draws come next (_dispatch_jobs takes them).
    gen: torch.Generator
    table_pose: torch.Tensor  # [4, 4] camera frame, remove_table's (MCTS reads it)
    depth_clean: torch.Tensor  # [H, W] table-removed depth (the MCTS leaf observation)


def _segments(depth_clean, prob_of, intr, names, db, cfg, gen) -> Segment3D:
    """Every object's segment, in object order, stacked [K, ...]."""
    segs = [
        segmentation.compute_3d_segment(depth_clean, prob_of(i, db[n].class_id), intr, cfg,
                                        generator=gen)
        for i, n in enumerate(names)
    ]
    return Segment3D(*(torch.stack(f) for f in zip(*segs)))


def prepare_scene(
    scene_dir: str,
    db: ObjectDB,
    dataset: str = "APC",
    segmentation_mode: str = "GT",
    cfg: PipelineConfig = DEFAULT_CONFIG,
    seed: int = 0,
    nn_predictor=None,
    detector=None,
    device=None,
) -> _SceneJobs:
    """Load and preprocess one scene with estimate_pose's draw order."""
    dev = _torchcfg.resolve_device(device)
    sc = scene_mod.load_scene(scene_dir, dataset=dataset)
    gen = torch.Generator(device=dev).manual_seed(seed)
    intr = torch.as_tensor(sc.intrinsics, dtype=torch.float32, device=dev)
    depth = torch.as_tensor(sc.depth, dtype=torch.float32, device=dev)
    depth_clean, _plane, table_pose = scene_mod.remove_table(depth, intr, cfg, generator=gen)
    class_ids = [db.class_of(n) for n in sc.object_names]
    prob_images = segmentation.build_prob_images(
        segmentation_mode, class_ids, class_mask=sc.class_mask, nn_predictor=nn_predictor,
        color=sc.color, detector=detector, threshold=cfg.preprocess.background_prob,
    )
    segs = _segments(
        depth_clean,
        lambda _i, cid: torch.as_tensor(np.asarray(prob_images[cid]), dtype=torch.float32,
                                        device=dev),
        intr, sc.object_names, db, cfg, gen,
    )
    return _SceneJobs(scene_dir, sc, list(sc.object_names), segs, gen, table_pose, depth_clean)


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on the device without waiting: from pinned memory on the
    card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def _depth_batch(scs, dev) -> torch.Tensor:
    """[S, H, W] float32 depth on the device from the scenes' uint16 codec
    values (load_scene keeps them): 2 bytes a pixel go up as int16 (the card
    has little uint16 arithmetic), are widened there and divided by a device
    scalar, a true division like the host decoder's (a host scalar would
    become a reciprocal product, one bit off)."""
    raw16 = np.stack([sc.depth_raw16 for sc in scs])
    raw = _upload(raw16.view(np.int16), dev).to(torch.int32) & 0xFFFF
    return raw.to(torch.float32) / torch.full((), depthio.DEPTH_SCALE, device=dev)


def prepare_scenes(
    scene_dirs: Sequence[str],
    db: ObjectDB,
    dataset: str = "APC",
    segmentation_mode: str = "GT",
    cfg: PipelineConfig = DEFAULT_CONFIG,
    seed: int = 0,
    nn_predictor=None,
    detector=None,
    device=None,
) -> List[_SceneJobs]:
    """Preprocess MANY scenes; each scene's result equals prepare_scene's.

    Host traffic is the JAX package's: the scene files load in threads (the
    color image only where the segmentation reads it), the depth goes up at
    2 bytes a pixel and is decoded on the device (the codec values of the
    PNG), and the GT probability
    images are built on the device from one integer class mask a scene
    (uint8 where every mask value and compared class id fits, else int32).
    The table removals run scene by scene and the segments object by object.
    """
    if not scene_dirs:
        return []
    dev = _torchcfg.resolve_device(device)
    load_color = segmentation_mode != "GT"
    with ThreadPoolExecutor(max_workers=min(8, len(scene_dirs))) as pool:
        scs = list(pool.map(
            lambda sd: scene_mod.load_scene(sd, dataset=dataset, load_color=load_color),
            scene_dirs,
        ))
    if any(sc.depth.shape != scs[0].depth.shape for sc in scs):
        raise ValueError("mixed depth sizes")
    gens = [torch.Generator(device=dev).manual_seed(seed) for _ in scs]
    depths = _depth_batch(scs, dev)
    intrs = _upload(np.stack([sc.intrinsics for sc in scs]).astype(np.float32), dev)
    tables = [scene_mod.remove_table(depths[si], intrs[si], cfg, generator=gens[si])
              for si in range(len(scs))]

    if segmentation_mode == "GT":
        if any(sc.class_mask is None for sc in scs):
            raise ValueError("GT segmentation needs a class mask")
        masks_np = np.stack([sc.class_mask for sc in scs])
        cids = [db.class_of(n) for sc in scs for n in sc.object_names]
        u8_ok = (masks_np.min(initial=0) >= 0 and masks_np.max(initial=0) < 256
                 and all(0 <= c < 256 for c in cids))
        masks = _upload(masks_np.astype(np.uint8 if u8_ok else np.int32), dev)
        prob_of_scene = lambda si: (lambda _i, cid: (masks[si] == cid).to(torch.float32))  # noqa: E731
    else:
        def prob_of_scene(si):
            sc = scs[si]
            images = segmentation.build_prob_images(
                segmentation_mode, [db.class_of(n) for n in sc.object_names],
                class_mask=sc.class_mask, nn_predictor=nn_predictor, color=sc.color,
                detector=detector, threshold=cfg.preprocess.background_prob,
            )
            return lambda _i, cid: _upload(np.asarray(images[cid], np.float32), dev)

    out = []
    for si, sc in enumerate(scs):
        depth_clean, _plane, table_pose = tables[si]
        segs = _segments(depth_clean, prob_of_scene(si), intrs[si], sc.object_names, db, cfg,
                         gens[si])
        out.append(_SceneJobs(scene_dirs[si], sc, list(sc.object_names), segs, gens[si],
                              table_pose, depth_clean))
    return out


def _job_rows(dev: torch.device, rows: dict, tables: list, cfg, gen_mode, top_k,
              do_refine) -> torch.Tensor:
    """Generation, scoring, top-k and polish of a job batch on one device;
    packed [J, 17 + 17 * top_k] rows (pose_cam, best score, top-k transforms,
    top-k scores)."""
    st = hypothesis.stack_object_tables(tables)
    table = ppf.PPFTable(st.presence.to(dev), st.offsets.to(dev), st.counts.to(dev),
                         st.pairs.to(dev), st.trans_disc, st.rot_disc, st.max_dist_mm)
    r = {k: v.to(dev, non_blocking=True) for k, v in rows.items()}
    segs = Segment3D(r["seg_pts"], r["seg_nrm"], r["seg_prob"], r["seg_mask"])
    res = hypothesis.generate_hypotheses_jobs(
        segs, r["msp"], r["msm"], table, r["mvp"], r["mvn"], cfg,
        gumbel=r["gumbel"], quad_priority=r["quad_priority"], mode=gen_mode,
        pair_priority=r.get("pair_priority"),
    )
    j = res.scores.shape[0]
    kk = min(top_k, res.scores.shape[1])
    idx = torch.sort(res.scores, dim=1, descending=True, stable=True).indices[:, :kk]
    top_scores = torch.gather(res.scores, 1, idx)
    top_tf = res.transforms[torch.arange(j, device=dev)[:, None], idx]
    pose_cam = res.best_transform  # lcp_select: the best-scoring pose
    if do_refine:
        refined = torch.stack([
            icp_mod.refine_icp(
                pose_cam[i][None], r["mvp"][i][:1024], r["mvn"][i][:1024],
                segs.pts[i], segs.mask[i], iters=cfg.icp.iters,
                trim_fraction=cfg.icp.trim_fraction, max_corr_dist=cfg.icp.max_corr_dist,
                point_to_plane=cfg.icp.point_to_plane,
            )[0]
            for i in range(j)
        ])
        # estimate_pose polishes only objects that scored above 0.
        pose_cam = torch.where((res.best_score > 0)[:, None, None], refined, pose_cam)
    return torch.cat([pose_cam.reshape(j, 16), res.best_score[:, None],
                      top_tf.reshape(j, kk * 16), top_scores], dim=1)


def _dispatch_jobs(
    mesh: Optional[DeviceMesh],
    prepared: List[_SceneJobs],
    db: ObjectDB,
    cfg: PipelineConfig,
    gen_mode: str,
    top_k: int,
    do_refine: bool,
    device=None,
) -> dict:
    """Flatten the (scene, object) jobs of a batch and queue generation,
    scoring and the polish, with no host synchronisation: the results stay
    on the device, packed into one array, so a pipelined caller prepares the
    next chunk while the device runs this one. Takes each scene's
    generation draws from its generator, in job order. With a mesh the job
    axis is padded to a multiple of its size (repeating job 0) and split."""
    job_names = [(si, oi, name) for si, pj in enumerate(prepared)
                 for oi, name in enumerate(pj.names)]
    j = len(job_names)
    if j == 0:
        return dict(job_names=job_names, prepared=prepared, packed=None)
    dev = mesh.device_list[0] if mesh is not None else _torchcfg.resolve_device(device)
    objs = [db[name] for _si, _oi, name in job_names]
    if len({o.validation_pts.shape for o in objs}) > 1 or len({o.search_pts.shape for o in objs}) > 1:
        raise ValueError("the sweep stacks every job: objects need one cloud size")
    n_seg = prepared[0].segs.pts.shape[1]
    draws = [hypothesis.draw_generation(prepared[si].gen, gen_mode, n_seg,
                                        objs[0].search_pts.shape[0], cfg, device=dev)
             for si, _oi, _name in job_names]
    rows = {
        "msp": _upload(np.stack([o.search_pts for o in objs]).astype(np.float32), dev),
        "msm": _upload(np.stack([o.search_mask for o in objs]).astype(bool), dev),
        "mvp": _upload(np.stack([o.validation_pts for o in objs]).astype(np.float32), dev),
        "mvn": _upload(np.stack([o.validation_nrm for o in objs]).astype(np.float32), dev),
        **{f"seg_{f}": torch.cat([getattr(pj.segs, f) for pj in prepared])
           for f in ("pts", "nrm", "prob", "mask")},
        **{k: torch.stack([d[k] for d in draws]) for k in draws[0]},
    }
    tables = [o.ppf_table for o in objs]
    length = mesh_mod.padded_length(j, mesh)
    if length > j:
        rows = {k: mesh_mod.pad_rows(v, length) for k, v in rows.items()}
        tables += [tables[0]] * (length - j)
    if mesh is None:
        packed = _job_rows(dev, rows, tables, cfg, gen_mode, top_k, do_refine)
    else:
        per = length // mesh.size
        split = {k: v.split(per) for k, v in rows.items()}
        packed = mesh_mod.gather([
            _job_rows(d, {k: v[i] for k, v in split.items()},
                      tables[i * per:(i + 1) * per], cfg, gen_mode, top_k, do_refine)
            for i, d in enumerate(mesh.device_list)
        ], dev)
    return dict(job_names=job_names, prepared=prepared, packed=packed[:j])


def _finalize_jobs(state: dict) -> Dict[int, List[ObjectPoseEstimate]]:
    """Copy a dispatched batch's packed results to the host (the one
    synchronous copy) and build the per-scene estimate lists."""
    prepared = state["prepared"]
    per_scene: Dict[int, List[ObjectPoseEstimate]] = {i: [] for i in range(len(prepared))}
    if state["packed"] is None:
        return per_scene
    packed = state["packed"].cpu().numpy()
    kk = (packed.shape[1] - 17) // 17
    pose_cam = packed[:, :16].reshape(-1, 4, 4)
    for row, (si, _oi, name) in enumerate(state["job_names"]):
        pj = prepared[si]
        per_scene[si].append(ObjectPoseEstimate(
            name=name,
            pose_cam=pose_cam[row],
            pose_world=np.asarray(pj.sc.cam_pose, np.float32) @ pose_cam[row],  # se3.to_world
            score=float(packed[row, 16]),
            hypotheses=packed[row, 17:17 + 16 * kk].reshape(kk, 4, 4),
            hypothesis_scores=packed[row, 17 + 16 * kk:],
        ))
    return per_scene


def sweep_scenes(
    mesh: Optional[DeviceMesh],
    scene_dirs: Sequence[str],
    db: ObjectDB,
    dataset: str = "APC",
    segmentation_mode: str = "GT",
    hypothesis_mode: str = "PCS",
    cfg: PipelineConfig = DEFAULT_CONFIG,
    seed: int = 0,
    top_k: int = 25,
    refine_final: bool = True,
    nn_predictor=None,
    detector=None,
    verification_mode: str = "LCP",
    pipeline_chunks: int = 1,
    device=None,
) -> Dict[str, PoseEstimationResult]:
    """Estimate poses for many scenes: {scene_dir: PoseEstimationResult}, the
    per-object contents of estimate_pose(..., verification_mode=...).

    mesh: a parallel/mesh.DeviceMesh (the job axis and, in MCTS mode, the
    shared leaf batches split over its devices, results on its first), or
    None for one device (`device`: the card unless "cpu").
    verification_mode="MCTS" runs every scene's search concurrently through
    pipeline/mcts.mcts_select_multi, with the camera-frame table pose of
    remove_table (as the JAX sweep does; estimate_pose gives its search a
    world-frame box refined from the raw depth); the pre-search polish is
    skipped there, as estimate_pose skips it.
    pipeline_chunks > 1 (LCP mode) splits the scenes into that many chunks
    and prepares chunk i+1 while the device runs chunk i; results are the
    unchunked sweep's. timings then report preprocess_host_s, the host's
    share, measured though overlapped.
    The call is one span "sweep" (utils/tracing) with the children
    sweep.prepare (to its synchronize), sweep.jobs (the job batch's dispatch
    and finalize) and, in MCTS mode, sweep.search; pipelined, one
    sweep.prepare and one sweep.jobs a chunk. The timings are those spans'
    durations, and every scene's timings["request_id"] names the call's
    request record.
    """
    if hypothesis_mode not in _GEN_MODES:
        raise ValueError(f"unsupported sweep hypothesis mode {hypothesis_mode!r}")
    if verification_mode not in ("LCP", "MCTS"):
        raise ValueError(f"unsupported sweep verification mode {verification_mode!r}")
    dev = mesh.device_list[0] if mesh is not None else _torchcfg.resolve_device(device)
    is_mcts = verification_mode == "MCTS"
    prep_kwargs = dict(dataset=dataset, segmentation_mode=segmentation_mode, cfg=cfg, seed=seed,
                       nn_predictor=nn_predictor, detector=detector, device=dev)
    dispatch_kwargs = dict(db=db, cfg=cfg, gen_mode=_GEN_MODES[hypothesis_mode], top_k=top_k,
                           do_refine=refine_final and not is_mcts, device=dev)

    with tracing.span("sweep") as sp_sweep:
        if pipeline_chunks > 1 and not is_mcts and len(scene_dirs) > 1:
            return _sweep_pipelined(sp_sweep, mesh, scene_dirs, db, pipeline_chunks,
                                    prep_kwargs, dispatch_kwargs)

        with tracing.span("sweep.prepare") as sp_prep:
            prepared = prepare_scenes(scene_dirs, db, **prep_kwargs)
            _torchcfg.synchronize(dev)
        with tracing.span("sweep.jobs") as sp_jobs:
            state = _dispatch_jobs(mesh, prepared, **dispatch_kwargs)
            if state["packed"] is None:
                return {}
            per_scene = _finalize_jobs(state)

        mcts_s = 0.0
        if is_mcts:
            from physimglobalpose_tpu_torch.pipeline import mcts as mcts_mod

            with tracing.span("sweep.search") as sp_search:
                refined = mcts_mod.mcts_select_multi(
                    [(per_scene[si], pj.sc, pj.table_pose.cpu().numpy(), pj.depth_clean)
                     for si, pj in enumerate(prepared)],
                    db, cfg, seed=seed, mesh=mesh, segs_list=[pj.segs for pj in prepared],
                    device=dev,
                )
            per_scene = dict(enumerate(refined))
            mcts_s = sp_search.duration

    prep_s, device_s = sp_prep.duration, sp_jobs.duration
    n_scenes = len(prepared)
    return {
        pj.scene_dir: PoseEstimationResult(objects=per_scene[si], timings={
            "preprocess_s": prep_s / n_scenes,
            "device_s": device_s / n_scenes,
            "mcts_s": mcts_s / n_scenes,
            "scenes_per_sec": n_scenes / (prep_s + device_s + mcts_s),
            "request_id": sp_sweep.request_id,
        })
        for si, pj in enumerate(prepared)
    }


def _sweep_pipelined(sp_sweep, mesh, scene_dirs, db, pipeline_chunks, prep_kwargs,
                     dispatch_kwargs):
    """sweep_scenes with pipeline_chunks > 1: chunk i+1 is prepared while the
    device runs chunk i. A chunk's sweep.jobs span runs from its dispatch to
    its finalize, across the next chunk's sweep.prepare, so it is opened and
    closed out of the context's nesting."""
    idx_chunks = [list(b) for b in np.array_split(
        np.arange(len(scene_dirs)), min(pipeline_chunks, len(scene_dirs))) if len(b)]
    scene_lists: List[tuple] = []
    inflight, prep_host_s = None, 0.0
    for idxs in idx_chunks + [None]:
        state = None
        if idxs is not None:
            with tracing.span("sweep.prepare") as sp_prep:
                chunk = prepare_scenes([scene_dirs[i] for i in idxs], db, **prep_kwargs)
            prep_host_s += sp_prep.duration
            jobs = tracing.span("sweep.jobs").open()
            state = _dispatch_jobs(mesh, chunk, **dispatch_kwargs)
        if inflight is not None:
            in_state, in_jobs = inflight
            per_scene = _finalize_jobs(in_state)
            in_jobs.close()
            scene_lists += [(pj.scene_dir, per_scene[si])
                            for si, pj in enumerate(in_state["prepared"])]
        inflight = None if state is None else (state, jobs)
    total = sp_sweep.duration
    n_scenes = max(len(scene_lists), 1)
    timings = {
        "preprocess_s": 0.0,
        "preprocess_host_s": prep_host_s / n_scenes,
        "device_s": total / n_scenes,
        "mcts_s": 0.0,
        "scenes_per_sec": n_scenes / total,
        "pipelined": True,
        "pipeline_chunks": len(idx_chunks),
        "request_id": sp_sweep.request_id,
    }
    return {sd: PoseEstimationResult(objects=est, timings=dict(timings))
            for sd, est in scene_lists}
