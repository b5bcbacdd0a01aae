"""Physics-aware MCTS over object placement orders.

Reference (UCTSearch/UCTState): tree node = partial scene (first k objects
placed, one hypothesis each). Expansion picks the best-unexpanded child by
LCP heuristic, then runs physics settle -> depth render -> pixel cost;
rollouts pick random hypotheses to full depth; backup sums costs; descent
uses a *minimizing* UCB qval/n - alpha sqrt(2 ln N / n) with alpha = 5000
(UCTState.cpp:275-296); budget 60 s or sum_i branching^i expansions
(UCTSearch.cpp:286-307).

As in the JAX package (physimglobalpose_tpu/pipeline/mcts.py), the tree lives
on the host and every leaf evaluation is batched: the controller collects up
to leaf_batch pending evaluations with virtual loss, and one device batch
evaluates them all: [B, K] placements -> batched settle -> one splat render
of every placed object of every leaf -> [B] costs. The host tree, its numpy
random stream and the batch padding are the JAX package's, so the same costs
give the same tree.

The device work of a batch is queued without waiting for it
(BatchedLeafEvaluator.evaluate_async copies the batch from pinned memory and
reads nothing back), so the host builds the next batch while the card runs
earlier ones; _backup fetches the oldest batch only once
cfg.mcts.inflight_batches are queued.

The search over many scenes at once (MultiSceneLeafEvaluator,
uct_search_multi, mcts_select_multi) puts the pending leaves of every
scene's tree into one shared batch: each row carries its scene's index and
gathers that scene's constants (stacked and padded to the largest scene), so
one batch's launches serve every scene. With a mesh (parallel/mesh.py) the
batch's rows are split over its devices. One scene and many share the round
loop (_search_rounds) and the final pass (_final_pass); a scene's
BatchedLeafEvaluator is the unit both are built from.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from physimglobalpose_tpu_torch import _torchcfg
from physimglobalpose_tpu_torch.config import PipelineConfig, DEFAULT_CONFIG
from physimglobalpose_tpu_torch.geometry import se3
from physimglobalpose_tpu_torch.models import assets
from physimglobalpose_tpu_torch.ops import cost as cost_mod
from physimglobalpose_tpu_torch.ops import icp as icp_mod
from physimglobalpose_tpu_torch.ops import physics, raster
from physimglobalpose_tpu_torch.parallel import mesh as mesh_mod
from physimglobalpose_tpu_torch.utils import tracing


@dataclasses.dataclass
class _Node:
    depth: int  # number of objects placed
    choice: int  # hypothesis index chosen for object depth-1 (-1 at root)
    parent: Optional["_Node"]
    children: Dict[int, "_Node"]
    qval: float = 0.0
    n: int = 0
    virtual: int = 0
    hval: float = 0.0  # LCP heuristic of this placement
    # Cached leaf cost of a TERMINAL node (depth == K): its assignment is
    # fully determined, so re-descents back up the cached value on the host
    # instead of evaluating the same row again.
    cached_cost: Optional[float] = None
    # True once this subtree is fully enumerated; a search whose root is
    # exhausted has evaluated every reachable assignment and stops.
    exhausted: bool = False


def _min_ucb_child(node: _Node, alpha: float) -> _Node:
    """The child of least UCB qval/n - alpha sqrt(2 ln N / n), n and N
    counting virtual loss, an unvisited child first; ties to the first in
    insertion order, as min() gives them. The parent's 2 ln N is taken once
    for all children: the same operations on the same values as a child at
    a time."""
    log_term = 2 * math.log(max(node.n + node.virtual, 1))
    best, best_v = None, math.inf
    for ch in node.children.values():
        n = ch.n + ch.virtual
        v = -math.inf if n == 0 else ch.qval / n - alpha * math.sqrt(log_term / n)
        if best is None or v < best_v:
            best, best_v = ch, v
    return best


def _to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    """A host array on the device without waiting for the device: on the card
    the copy goes from pinned memory, queued behind the work already there."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _pad_stack(parts, fill=0, dtype=None):
    """Arrays (or tensors) of one rank stacked on a new leading axis, each
    padded with `fill` (broadcast over the trailing axes) to the largest
    extent of every axis."""
    shape = (len(parts), *(max(n) for n in zip(*(p.shape for p in parts))))
    if isinstance(parts[0], torch.Tensor):
        out = torch.empty(shape, dtype=parts[0].dtype, device=parts[0].device)
        out[...] = torch.as_tensor(fill, dtype=out.dtype, device=out.device)
    else:
        out = np.empty(shape, dtype or parts[0].dtype)
        out[...] = fill
    for i, part in enumerate(parts):
        out[(i, *map(slice, part.shape))] = part
    return out


def _rigid_inverse(pose) -> np.ndarray:
    """The inverse of a rigid transform [4, 4], in float64 on the host."""
    p = np.asarray(pose, np.float64)
    inv = np.eye(4)
    inv[:3, :3] = p[:3, :3].T
    inv[:3, 3] = -p[:3, :3].T @ p[:3, 3]
    return inv


def _hyp_poses(consts, choices, rows=()):
    """World poses [..., K, 4, 4] of hypothesis choices [..., K] (-1, not
    placed, clamped to hypothesis 0). rows: the leading index of constants
    that carry a row axis (the multi-scene batch's); one scene's have none."""
    safe_choice = torch.clamp(choices, 0, consts["hyp_world"].shape[-3] - 1)
    return consts["hyp_world"][(*rows, consts["obj_idx"], safe_choice)]


def _leaf_eval(consts, cfg, h, w, radius, choices, active, rows=()):
    """Evaluate B placement assignments: settle -> render -> pixel cost.

    choices [B, K] hypothesis index per object (-1 = not placed), active
    [B, K] bool; rows as _hyp_poses'. Returns (costs [B], settled world
    poses [B, K, 4, 4])."""
    poses_w = _hyp_poses(consts, choices, rows)
    return _settle_render_cost(consts, cfg, h, w, radius, poses_w, active)


def _placement_order(active, sequential: bool):
    """The settle's placement positions of B assignments (active [B, K]):
    (dyn [B, D] the dynamic body at each position or -1, placed [B, D, K]
    the bodies in the world there). Objects are placed in index order.

    Sequential (D = K), the reference's defaultPolicy settles each newly
    placed object on top of the previously settled ones
    (UCTSearch.cpp:140-194): the object at position d dynamic, 0..d-1 static
    at their settled poses, later objects absent. Otherwise (D = 1) one
    settle of the complete assignment, only the last-placed object dynamic
    (equivalent for non-stacked scenes)."""
    order_pos = torch.cumsum(active.to(torch.int64), dim=1) - 1
    if sequential:
        d = torch.arange(active.shape[-1], device=active.device)[:, None]  # [D, 1]
        is_dyn = active[:, None, :] & (order_pos[:, None, :] == d)
        placed = active[:, None, :] & (order_pos[:, None, :] <= d)
    else:
        last_idx = torch.amax(torch.where(active, order_pos, -1), dim=1, keepdim=True)
        is_dyn = (active & (order_pos == last_idx))[:, None, :]
        placed = active[:, None, :]
    dyn = torch.where(torch.any(is_dyn, dim=-1), torch.argmax(is_dyn.to(torch.uint8), dim=-1), -1)
    return dyn, placed


def _settle_render_cost(consts, cfg, h, w, radius, poses_w, active):
    """Settle explicit world poses [B, K, 4, 4], then render + pixel cost (the
    leaf body, split out so the TrICP final pass feeds refined poses through
    the same settle/cost path). Exactly one body is dynamic a settle
    (correctPhysics semantics); physics.settle_in_order runs every placement
    position of every row, in one launch on the card."""
    ph = cfg.physics
    dyn, placed = _placement_order(active, cfg.mcts.sequential_settle)
    quat, pos = physics.settle_in_order(
        consts, se3.matrix_to_quat(poses_w[..., :3, :3]), poses_w[..., :3, 3], dyn, placed,
        object_mass=ph.object_mass, steps=ph.steps, substeps=ph.substeps, dt=ph.dt,
        gravity=ph.gravity, damping=ph.damping, friction=ph.friction,
        restitution=ph.restitution,
    )
    settled_w = se3.pose_from_rot_trans(se3.quat_to_matrix(quat), pos)
    return _render_cost_of_poses(consts, cfg, h, w, radius, settled_w, active), settled_w


def _render_cost_of_poses(consts, cfg, h, w, radius, poses_w, active):
    """Pixel cost of explicit world poses [..., K, 4, 4] (no settle); a
    leading batch of pose sets is the JAX package's _poses_cost_jit.

    All placed objects of a leaf render in one scatter (scatter-min is the
    reference's per-object min-composite, UCTState.cpp:62-68). The
    max_depth clamp is the reference's 1 m render cut (renderScene.cpp:70):
    objects pushed out of the workspace render as empty."""
    cam_inv = consts["cam_pose_inv"]
    if cam_inv.dim() == 3:  # a camera a row (the multi-scene leaf batch)
        cam_inv = cam_inv[:, None]
    poses_cam = cam_inv @ poses_w
    depth = raster.render_scene_depth(
        poses_cam, consts["render_pts"], consts["render_mask"] & active[..., None],
        consts["intr"], h, w, radius=radius, max_depth=cfg.render.max_render_depth,
    )
    return cost_mod.render_cost(consts["obs"], depth, cfg.render.explanation_threshold)


_FAR_PLANE = (0.0, 0.0, 1.0, -1e9)  # a padded hull face: never a contact

_TRICP_MODEL_POINTS = 1024  # strided model-cloud budget for the ICP products


def _tricp_refine_cam(poses_c, model_pts, model_nrm, model_mask, seg_pts,
                      seg_mask, active, cfg):
    """_tricp_refine_steps run alone."""
    return icp_mod.lockstep([_tricp_refine_steps(poses_c, model_pts, model_nrm, model_mask,
                                                 seg_pts, seg_mask, active, cfg)])[0]


def _tricp_refine_steps(poses_c, model_pts, model_nrm, model_mask, seg_pts,
                        seg_mask, active, cfg):
    """Sequential unexplained-segment trimmed ICP, camera frame, as a
    generator of ICP steps (ops/icp.icp_steps; icp_mod.lockstep drives it
    beside other scenes').

    UCTState::performTrICP (UCTState.cpp:121-204) semantics: for each placed
    object in placement order, drop segment points within
    tricp_removal_radius of any already-placed object's transformed model
    cloud (UCTState.cpp:158-175), then refine the object's pose by trimmed
    point-to-point ICP against the remaining segment (PCL TrimmedICP). An
    object keeps its pose when inactive, when its unexplained segment has
    fewer than 10 points, or when the solve goes non-finite.
    """
    mc = cfg.mcts
    far = 1e4  # masked points live 10 km away: never matched, no overflow
    placed: list = []  # transformed model clouds of already-placed objects
    out = []
    for i in range(poses_c.shape[0]):
        seg_m = seg_mask[i]
        if placed:
            allp = torch.cat(placed, dim=0)  # [i*M, 3]
            d2 = (
                torch.sum(seg_pts[i] * seg_pts[i], dim=-1)[:, None]
                + torch.sum(allp * allp, dim=-1)[None, :]
                - 2.0 * seg_pts[i] @ allp.T
            )
            seg_m = seg_m & (torch.amin(d2, dim=-1) > mc.tricp_removal_radius ** 2)
        mp = torch.where(model_mask[i][:, None], model_pts[i], far)
        tf = (yield from icp_mod.icp_steps(
            poses_c[i][None], mp, model_nrm[i], seg_pts[i], seg_m,
            iters=mc.tricp_iters, trim_fraction=mc.tricp_trim,
            max_corr_dist=mc.tricp_max_corr_dist,
            point_to_plane=False,  # PCL TrimmedICP is point-to-point
            exact_trim=True,  # the trim is the outlier model here
            nn_refresh=1,
        ))[0]
        ok = active[i] & torch.all(torch.isfinite(tf)) & (torch.sum(seg_m) >= 10)
        tf = torch.where(ok, tf, poses_c[i])
        out.append(tf)
        placed.append(torch.where(
            model_mask[i][:, None] & active[i], model_pts[i] @ tf[:3, :3].T + tf[:3, 3], far,
        ))
    return torch.stack(out)


def _perturb_poses(rng, poses_w, sig_t, sig_r, batch, only_obj=None):
    """[K,4,4] -> [B,K,4,4]: row 0 = unperturbed; rows 1.. rotate about each
    object's own origin and translate in world (host numpy Rodrigues).
    only_obj: perturb just that object index (others stay fixed)."""
    k = poses_w.shape[0]
    out = np.tile(poses_w[None], (batch, 1, 1, 1)).astype(np.float64)
    w_axis = rng.normal(0.0, sig_r, (batch - 1, k, 3))
    dt = rng.normal(0.0, sig_t, (batch - 1, k, 3))
    if only_obj is not None:
        keep = np.zeros((1, k, 1))
        keep[0, only_obj, 0] = 1.0
        w_axis = w_axis * keep
        dt = dt * keep
    theta = np.linalg.norm(w_axis, axis=-1, keepdims=True)
    ax = w_axis / np.maximum(theta, 1e-12)
    ct = np.cos(theta)[..., None]
    st = np.sin(theta)[..., None]
    x, y, z = ax[..., 0], ax[..., 1], ax[..., 2]
    zeros = np.zeros_like(x)
    kx = np.stack([
        np.stack([zeros, -z, y], -1),
        np.stack([z, zeros, -x], -1),
        np.stack([-y, x, zeros], -1),
    ], -2)  # [B-1, K, 3, 3]
    eye = np.eye(3)[None, None]
    dr = eye + st * kx + (1.0 - ct) * (kx @ kx)
    out[1:, :, :3, :3] = out[1:, :, :3, :3] @ dr
    out[1:, :, :3, 3] += dt
    return out


def _final_polish(evaluator, poses_w, active, cfg, seed=0):
    """Stochastic descent on the render cost around the final state.

    Each round: batched no-settle costs of perturbations of the current best
    (row 0 keeps it, so the result is monotone in cost); sigma halves per
    round. final_polish_per_object perturbs one object per batch. The
    evaluator should be built at cfg.mcts.final_polish_scale. Returns
    (poses [K,4,4], cost)."""
    mc = cfg.mcts
    rng = np.random.default_rng(seed)
    best = np.asarray(poses_w, np.float64)
    best_cost = np.inf
    k = best.shape[0]
    active = np.asarray(active)
    active_dev = _to_device(active, evaluator.device)
    obj_rounds = [i for i in range(k) if active[i]] if mc.final_polish_per_object else [None]
    sig_t, sig_r = mc.final_polish_sigma_t, math.radians(mc.final_polish_sigma_r_deg)
    for _ in range(mc.final_polish_rounds):
        for oi in obj_rounds:
            batch = _perturb_poses(rng, best, sig_t, sig_r, mc.final_polish_batch, only_obj=oi)
            costs = _render_cost_of_poses(
                evaluator.consts_full, evaluator.cfg, evaluator.h, evaluator.w,
                evaluator.splat_radius, _to_device(batch.astype(np.float32), evaluator.device),
                active_dev,
            ).cpu().numpy()
            i = int(np.argmin(costs))
            if costs[i] <= best_cost:
                best, best_cost = batch[i], float(costs[i])
        sig_t *= 0.5
        sig_r *= 0.5
    return best.astype(np.float32), best_cost


_TRICP_ORDER = (1, 2, 0)  # tie preference: tricp->settle, settle->tricp, raw


def _tricp_pick(costs3) -> int:
    """The installed final state: min render cost, ties broken for the
    refined candidates (_TRICP_ORDER). Heavily occluded objects give a
    handful of pixels at the search scale, so the candidates often tie; the
    cost vote only vetoes regressions of the refinement the reference
    applies unconditionally (Search.cpp:45)."""
    costs3 = np.asarray(costs3)
    return int(min(_TRICP_ORDER, key=lambda i: (costs3[i], _TRICP_ORDER.index(i))))


def _decimate_contact_hull(h: dict, max_vertices: int) -> dict:
    """Search-time contact hull: farthest-point-sampled vertex subset with
    recomputed faces (cfg.mcts.contact_hull_vertices).

    The subset's hull is inscribed in the true hull, so every face plane is
    shifted outward by its largest overhang over the original vertices: the
    decimated hull circumscribes the object (the role of Bullet's convex
    collision margin) and face-contact rest heights match the full hull.
    """
    pts = np.asarray(h["hull_pts"])[np.asarray(h["hull_mask"])]
    if len(pts) <= max_vertices:
        return h
    dec = assets.convex_hull_points(pts, max_vertices)
    eqs = assets.convex_hull_planes(dec, max_faces=2 * max_vertices)
    overhang = np.maximum((pts @ eqs[:, :3].T + eqs[:, 3][None, :]).max(axis=0), 0.0)
    eqs = eqs.copy()
    eqs[:, 3] -= overhang
    out = dict(h)
    out["hull_pts"] = dec
    out["hull_mask"] = np.ones(len(dec), bool)
    out["hull_eqs"] = eqs.astype(np.float32)
    return out


class BatchedLeafEvaluator:
    """Evaluates B candidate placements (settle + render + cost) on one device.

    Runs on the card unless device="cpu"; raises when the card is asked for
    and absent."""

    def __init__(
        self,
        obj_hulls: List[dict],  # per object: hull_pts/hull_mask/hull_eqs/render_pts/render_mask
        hypotheses_world: np.ndarray,  # [K, C, 4, 4] world-frame hypothesis poses
        obs_depth,  # [H, W] numpy array or tensor
        intrinsics: np.ndarray,
        cam_pose: np.ndarray,
        table_pose: np.ndarray,
        cfg: PipelineConfig,
        render_scale: int | None = None,
        device=None,
    ):
        if render_scale is None:
            render_scale = cfg.mcts.render_scale
        self.device = dev = _torchcfg.resolve_device(device)
        self.cfg = cfg
        self.k = k = len(obj_hulls)
        self.num_hyp = hypotheses_world.shape[1]
        ph = cfg.physics
        as_dev = lambda a, dtype=torch.float32: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        def pack_hulls(hull_list):
            hull_pts = _pad_stack([h["hull_pts"] for h in hull_list], dtype=np.float32)
            hull_mask = _pad_stack([h["hull_mask"][: len(h["hull_pts"])] for h in hull_list],
                                   False, bool)
            inv_inertia = np.zeros((k, 3), np.float32)
            for i in range(k):
                valid = hull_pts[i][hull_mask[i]]
                ext = np.maximum(valid.max(0) - valid.min(0), 1e-3)
                m = ph.object_mass / 12.0
                inv_inertia[i] = 1.0 / np.array(
                    [m * (ext[1] ** 2 + ext[2] ** 2),
                     m * (ext[0] ** 2 + ext[2] ** 2),
                     m * (ext[0] ** 2 + ext[1] ** 2)], np.float32,
                )
            return dict(
                hull_pts=as_dev(hull_pts), hull_mask=as_dev(hull_mask, torch.bool),
                hull_eqs=as_dev(_pad_stack([h["hull_eqs"] for h in hull_list], _FAR_PLANE,
                                           np.float32)),
                inv_inertia=as_dev(inv_inertia),
            )

        # Search-time hulls may be decimated (cfg.mcts.contact_hull_vertices);
        # the full hulls are kept for evaluate_final*, so the reported poses
        # carry no decimation.
        cv = cfg.mcts.contact_hull_vertices
        search_hulls = [_decimate_contact_hull(h, cv) for h in obj_hulls] if cv > 0 else obj_hulls
        scene_const = pack_hulls(search_hulls)
        scene_const_full = pack_hulls(obj_hulls) if search_hulls is not obj_hulls else None

        pts, nrm = zip(*((h["render_pts"], h.get("render_nrm")) for h in obj_hulls))
        render_pts = _pad_stack(pts, dtype=np.float32)
        render_mask = _pad_stack([h["render_mask"][: len(p)] for h, p in zip(obj_hulls, pts)],
                                 False, bool)
        render_nrm = _pad_stack([np.zeros_like(p) if n is None else n for p, n in zip(pts, nrm)],
                                dtype=np.float32)
        self.render_nrm = as_dev(render_nrm)
        self.cam_pose = as_dev(cam_pose)
        s = render_scale
        self.h = cfg.render.height // s
        self.w = cfg.render.width // s
        self.splat_radius = (
            cfg.mcts.leaf_splat_radius if cfg.mcts.leaf_splat_radius >= 0 else (1 if s == 1 else 0)
        )
        intr = np.asarray(intrinsics, np.float32).copy()
        intr[:2] /= s
        if not isinstance(obs_depth, torch.Tensor):
            obs_depth = torch.from_numpy(np.array(obs_depth, np.float32))
        obs = obs_depth.to(dev, torch.float32)
        shared = dict(
            render_pts=as_dev(render_pts),
            render_mask=as_dev(render_mask, torch.bool),
            hyp_world=as_dev(hypotheses_world),
            obj_idx=torch.arange(k, device=dev),
            table_pose=as_dev(table_pose),
            table_half_extents=as_dev(ph.table_half_extents),
            cam_pose_inv=as_dev(_rigid_inverse(cam_pose).astype(np.float32)),
            intr=as_dev(intr),
            obs=obs[::s, ::s][: self.h, : self.w].contiguous(),
        )
        self.consts = dict(**scene_const, **shared)
        self.consts_full = (
            dict(**scene_const_full, **shared) if scene_const_full is not None else self.consts
        )

    def _eval(self, consts, batch_choices, batch_active):
        return _leaf_eval(
            consts, self.cfg, self.h, self.w, self.splat_radius,
            _to_device(batch_choices, self.device, torch.int64),
            _to_device(batch_active, self.device, torch.bool),
        )

    def evaluate_async(self, batch_choices: np.ndarray, batch_active: np.ndarray):
        """Queue a batch without waiting for it: returns device (costs [B],
        settled [B, K, 4, 4]). The search builds its next batch on the host
        while the card runs this one."""
        return self._eval(self.consts, batch_choices, batch_active)

    def evaluate(self, batch_choices: np.ndarray, batch_active: np.ndarray):
        """choices: [B, K] hypothesis index per object (-1 = not placed);
        active: [B, K] bool. Returns numpy (costs [B], settled world poses
        [B, K, 4, 4])."""
        costs, settled = self.evaluate_async(batch_choices, batch_active)
        return costs.cpu().numpy(), settled.cpu().numpy()

    def evaluate_final(self, batch_choices: np.ndarray, batch_active: np.ndarray):
        """Chosen-assignment settle with the FULL (undecimated) hulls."""
        costs, settled = self._eval(self.consts_full, batch_choices, batch_active)
        return costs.cpu().numpy(), settled.cpu().numpy()

    def evaluate_final_tricp(self, choices: np.ndarray, active: np.ndarray, seg_pts, seg_mask):
        """final_tricp_steps run alone."""
        return icp_mod.lockstep([self.final_tricp_steps(choices, active, seg_pts, seg_mask)])[0]

    def final_tricp_steps(self, choices: np.ndarray, active: np.ndarray, seg_pts, seg_mask):
        """Final settle + TrICP refinement (FULL hulls), as a generator of
        ICP steps (icp_mod.lockstep drives it beside other scenes'): three
        candidate final states through the same settle/cost path,
          0: raw chosen hypotheses -> settle
          1: TrICP -> settle   (reference expandNode order, Search.cpp:43-47)
          2: settle -> TrICP polish (cost re-rendered).

        choices/active: [K]; seg_pts [K, N, 3] / seg_mask [K, N] are the
        per-object camera-frame 3D segments. Returns numpy (costs [3],
        settled [3, K, 4, 4]); the caller installs _tricp_pick's row."""
        consts, cfg, view = self.consts_full, self.cfg, (self.h, self.w, self.splat_radius)
        seg_pts = torch.as_tensor(seg_pts, dtype=torch.float32, device=self.device)
        seg_mask = torch.as_tensor(seg_mask, dtype=torch.bool, device=self.device)
        choices = _to_device(np.asarray(choices), self.device, torch.int64)
        active = _to_device(np.asarray(active), self.device, torch.bool)
        poses_w = _hyp_poses(consts, choices)
        stride = max(1, consts["render_pts"].shape[1] // _TRICP_MODEL_POINTS)
        mp, mm, mn = (x[:, ::stride] for x in (consts["render_pts"], consts["render_mask"],
                                               self.render_nrm))
        cam_inv = consts["cam_pose_inv"]
        refined_c = yield from _tricp_refine_steps(cam_inv @ poses_w, mp, mn, mm, seg_pts,
                                                   seg_mask, active, cfg)
        # Candidates 0 and 1 settle as two rows of one batch.
        c01, s01 = _settle_render_cost(
            consts, cfg, *view, torch.stack([poses_w, self.cam_pose @ refined_c]),
            active[None].expand(2, self.k),
        )
        polish_c = yield from _tricp_refine_steps(cam_inv @ s01[0], mp, mn, mm, seg_pts,
                                                  seg_mask, active, cfg)
        s2 = self.cam_pose @ polish_c
        c2 = _render_cost_of_poses(consts, cfg, *view, s2, active)
        costs, settled = torch.cat([c01, c2[None]]), torch.cat([s01, s2[None]])
        return costs.cpu().numpy(), settled.cpu().numpy()


@dataclasses.dataclass
class _Tree:
    """Host-side UCT search state for one scene."""

    root: _Node
    k: int
    c: int
    hyp_scores: np.ndarray  # [K, C]
    rng: np.random.Generator
    budget: int
    expansions: int = 0
    best_cost: float = math.inf
    best_assign: np.ndarray = None  # [K]

    @property
    def done(self) -> bool:
        return self.expansions >= self.budget


def _make_tree(hyp_scores, k, c, budget, seed) -> _Tree:
    best_assign = np.argmax(hyp_scores[:, :c], axis=1).astype(np.int64)
    return _Tree(
        root=_Node(depth=0, choice=-1, parent=None, children={}),
        k=k, c=c, hyp_scores=hyp_scores,
        rng=np.random.default_rng(seed), budget=budget,
        best_assign=best_assign,
    )


def _assignment_of(tree: _Tree, node: _Node, rollout_tail: bool) -> np.ndarray:
    """Choices along the path to node, random tail to full depth."""
    choices = np.full(tree.k, -1, np.int64)
    cur = node
    while cur.parent is not None:
        choices[cur.depth - 1] = cur.choice
        cur = cur.parent
    if rollout_tail:
        for d in range(node.depth, tree.k):
            choices[d] = tree.rng.integers(0, tree.c)
    return choices


def _add_virtual_loss(node: _Node) -> None:
    while node is not None:
        node.virtual += 1
        node = node.parent


def _collect_batch(tree: _Tree, alpha: float, quota: int) -> List[tuple]:
    """Collect up to `quota` pending leaf evaluations with virtual loss.

    Tree policy: descend fully-expanded nodes by min-UCB; expand the best
    unexpanded child by hval (LCP heuristic), as the reference does
    (UCTSearch.cpp:204-211); rollouts pick random hypotheses to full depth.
    """
    pend: List[tuple] = []  # (node_to_backup, choices)
    for _ in range(quota):
        node = tree.root
        while node.depth < tree.k and len(node.children) == tree.c:
            node = _min_ucb_child(node, alpha)
        if node.depth == tree.k and node.cached_cost is not None:
            # Deterministic terminal re-visit: back up the cached cost now,
            # no device work. (_backup pairs with a virtual-loss increment
            # along the path, so add one first - net zero.)
            _add_virtual_loss(node)
            _backup(tree, [(node, _assignment_of(tree, node, False))], [node.cached_cost])
            continue
        if node.depth < tree.k:
            unexpanded = [i for i in range(tree.c) if i not in node.children]
            pick = max(unexpanded, key=lambda i: tree.hyp_scores[node.depth, i])
            child = _Node(
                depth=node.depth + 1, choice=pick, parent=node, children={},
                hval=float(tree.hyp_scores[node.depth, pick]),
            )
            node.children[pick] = child
            node = child
            tree.expansions += 1
        _add_virtual_loss(node)
        pend.append((node, _assignment_of(tree, node, rollout_tail=True)))
        if tree.done:
            break
    return pend


def _mark_exhausted(tree: _Tree, node: _Node) -> None:
    """Propagate subtree exhaustion from a newly-cached terminal upward."""
    node.exhausted = True
    cur = node.parent
    while (
        cur is not None
        and len(cur.children) == tree.c
        and all(ch.exhausted for ch in cur.children.values())
    ):
        cur.exhausted = True
        cur = cur.parent


def _backup(tree: _Tree, pend: List[tuple], costs) -> None:
    for (node, choices), cost_v in zip(pend, costs):
        cost_v = float(cost_v)
        if node.depth == tree.k and node.cached_cost is None:
            node.cached_cost = cost_v
            _mark_exhausted(tree, node)
        if cost_v < tree.best_cost:
            tree.best_cost = cost_v
            tree.best_assign = choices.copy()
        cur = node
        while cur is not None:
            cur.virtual -= 1
            cur.n += 1
            cur.qval += cost_v
            cur = cur.parent


def _scene_tree(hyp_scores, k: int, cfg: PipelineConfig, max_iterations, seed: int) -> _Tree:
    """A scene's tree. Budget: sum_{i=0}^{k} branching^i expansions
    (UCTSearch.cpp:290-294), capped by max_iterations or
    cfg.mcts.max_expansions (the reference's 60 s cut binds first there)."""
    c = min(cfg.mcts.branching, hyp_scores.shape[1])
    budget = min(sum(c**i for i in range(0, k + 1)), max_iterations or cfg.mcts.max_expansions)
    return _make_tree(hyp_scores, k, c, budget, seed)


def _search_rounds(trees: List[_Tree], cfg: PipelineConfig, batch: int, k_max: int,
                   enqueue) -> tuple[int, int]:
    """The pipelined UCT rounds of one or more trees, until each is spent or
    exhausted or cfg.mcts.max_search_seconds pass. A round splits `batch`
    rows over the live trees, collects their leaves with virtual loss and
    queues them as one batch through enqueue(rows_scene, choices [B, k_max],
    active) -> device costs (rows_scene: each row's tree; B padded to a
    multiple of `batch` by repeating row 0). The oldest round is read and
    backed up once cfg.mcts.inflight_batches are queued. Spans:
    search.collect, search.leaf_eval (the enqueue), search.backup (the wait
    and the backup). Returns (leaf batches, leaves without the padding),
    also counted on the caller's span as leaf_batches and leaves, beside
    leaf_rows: the rows queued, padding included."""
    mc = cfg.mcts
    deadline = time.monotonic() + mc.max_search_seconds
    inflight: List[tuple] = []  # (pending leaves a tree, device costs), oldest first
    leaf_batches = leaves = rows = 0

    def backup(pend, costs_dev):
        with tracing.span("search.backup"):
            costs = costs_dev.cpu().numpy()
            ofs = 0
            for si, p in pend:
                _backup(trees[si], p, costs[ofs: ofs + len(p)])
                ofs += len(p)

    while time.monotonic() < deadline:
        live = [si for si, t in enumerate(trees) if not (t.done or t.root.exhausted)]
        pend = []  # (tree index, its pending leaves)
        if live:
            quota = max(1, batch // len(live))
            with tracing.span("search.collect"):
                pend = [(si, _collect_batch(trees[si], mc.alpha, quota)) for si in live]
        n = sum(len(p) for _, p in pend)
        if n:
            leaf_batches += 1
            leaves += n
            with tracing.span("search.leaf_eval"):
                size = n + (-n) % batch
                rows += size
                rows_scene = np.empty(size, np.int64)
                choices = np.full((size, k_max), -1, np.int64)
                ofs = 0
                for si, p in pend:
                    if p:
                        rows_scene[ofs: ofs + len(p)] = si
                        choices[ofs: ofs + len(p), : trees[si].k] = [ch for _, ch in p]
                        ofs += len(p)
                rows_scene[n:], choices[n:] = rows_scene[0], choices[0]
                inflight.append((pend, enqueue(rows_scene, choices, choices >= 0)))
        if len(inflight) > max(1, mc.inflight_batches) or (not n and inflight):
            backup(*inflight.pop(0))
        if not live and not inflight:
            break
        # Otherwise (a round of cached-terminal backups only) keep searching.

    # A deadline exit can leave queued rounds not backed up; their work is
    # done, and the best assignment may be in them.
    for queued in inflight:
        backup(*queued)
    tracing.count(leaf_batches=leaf_batches, leaves=leaves, leaf_rows=rows)
    return leaf_batches, leaves


def uct_search(
    evaluator: BatchedLeafEvaluator,
    hyp_scores: np.ndarray,  # [K, C] LCP heuristic per hypothesis
    cfg: PipelineConfig = DEFAULT_CONFIG,
    seed: int = 0,
    max_iterations: Optional[int] = None,
    stats: Optional[dict] = None,
) -> tuple[np.ndarray, float]:
    """The batched UCT search: _search_rounds on one tree, in leaf batches
    of cfg.mcts.leaf_batch queued through evaluator.evaluate_async.

    Returns (best complete assignment [K] hypothesis indices, best cost).
    stats: a dict that receives search_expansions, search_budget,
    search_deadline_cut (the deadline ended the search before the budget
    was spent or the tree exhausted), search_leaf_batches (leaf batches
    evaluated) and search_leaves (their leaves, padding not counted).
    Spans and counters: _search_rounds'.
    """
    tree = _scene_tree(hyp_scores, evaluator.k, cfg, max_iterations, seed)
    leaf_batches, leaves = _search_rounds(
        [tree], cfg, cfg.mcts.leaf_batch, evaluator.k,
        lambda _rows_scene, choices, active: evaluator.evaluate_async(choices, active)[0])
    if stats is not None:
        stats.update(search_expansions=tree.expansions, search_budget=tree.budget,
                     search_deadline_cut=not (tree.done or tree.root.exhausted),
                     search_leaf_batches=leaf_batches, search_leaves=leaves)
    return tree.best_assign, tree.best_cost


def _scene_search_inputs(estimates, sc, db, cfg):
    """Per-scene search inputs: (hyp_world [K,C,4,4], hyp_scores [K,C],
    obj_hulls) from the LCP-stage estimates, on the host."""
    k = len(estimates)
    c = min(cfg.mcts.branching, max(len(e.hypothesis_scores) for e in estimates))
    hyp_world = np.zeros((k, c, 4, 4), np.float32)
    hyp_scores = np.zeros((k, c), np.float32)
    obj_hulls = []
    cam = np.asarray(sc.cam_pose, np.float32)
    for i, est in enumerate(estimates):
        obj = db[est.name]
        n_h = min(c, len(est.hypothesis_scores))
        if n_h > 0:
            hyps_cam = np.asarray(est.hypotheses[:n_h], np.float32)
            hyp_world[i, :n_h] = np.einsum("ij,njk->nik", cam, hyps_cam)
            hyp_scores[i, :n_h] = est.hypothesis_scores[:n_h]
        hyp_world[i, n_h:] = hyp_world[i, 0]
        hyp_scores[i, n_h:] = -1.0
        obj_hulls.append(dict(
            hull_pts=obj.hull_pts, hull_mask=obj.hull_mask, hull_eqs=obj.hull_eqs,
            render_pts=obj.validation_pts, render_nrm=obj.validation_nrm,
            render_mask=np.ones(len(obj.validation_pts), bool),
        ))
    return hyp_world, hyp_scores, obj_hulls


def _segs_to_arrays(segs, k: int):
    """Segments as ([k, N, 3], [k, N]) tensors: a list of per-object
    Segment3D or one stacked Segment3D with a leading object axis, cut to
    k objects."""
    if hasattr(segs, "pts"):  # stacked Segment3D
        pts, mask = torch.as_tensor(segs.pts), torch.as_tensor(segs.mask)
    else:
        pts = torch.stack([torch.as_tensor(s.pts) for s in segs])
        mask = torch.stack([torch.as_tensor(s.mask) for s in segs])
    return pts[:k].to(torch.float32), mask[:k].to(torch.bool)


def _install_assignment(estimates, assign, settled_row, cam):
    """Write the settled world poses of the chosen assignment back into the
    per-object estimates (pose_cam recomputed through the camera), on the
    host."""
    cam_inv = _rigid_inverse(cam)
    out = []
    for i, est in enumerate(estimates):
        pose_w = settled_row[i]
        pose_cam = (cam_inv @ np.asarray(pose_w, np.float64)).astype(np.float32)
        out.append(dataclasses.replace(
            est,
            pose_cam=pose_cam,
            pose_world=np.asarray(pose_w),
            score=float(est.hypothesis_scores[assign[i]])
            if assign[i] < len(est.hypothesis_scores) else est.score,
        ))
    return out


def _scene_evaluator(estimates, sc, db, table_pose, depth_clean, cfg, device):
    """A scene's BatchedLeafEvaluator at the search's render scale, its
    hypothesis scores [K, C], and remake(scale): the same evaluator at
    another render scale."""
    hyp_world, hyp_scores, obj_hulls = _scene_search_inputs(estimates, sc, db, cfg)
    remake = lambda scale=None: BatchedLeafEvaluator(  # noqa: E731
        obj_hulls, hyp_world, depth_clean, sc.intrinsics, sc.cam_pose, table_pose, cfg,
        render_scale=scale, device=device,
    )
    return remake(), hyp_scores, remake


def _final_pass(evaluator: BatchedLeafEvaluator, remake, assign, segs, seed: int) -> np.ndarray:
    """_final_pass_steps run alone."""
    return icp_mod.lockstep([_final_pass_steps(evaluator, remake, assign, segs, seed)])[0]


def _final_pass_steps(evaluator: BatchedLeafEvaluator, remake, assign, segs, seed: int):
    """One scene's final state, as a generator of ICP steps that returns it
    (icp_mod.lockstep drives several scenes' in lockstep): the chosen
    assignment [K] settled with the FULL hulls, as world poses [K, 4, 4].
    With segments and cfg.mcts.tricp_final, the TrICP refinement's min-cost
    row of {raw, tricp->settle, settle->tricp} (_tricp_pick), then the
    optional _final_polish on remake(cfg.mcts.final_polish_scale), the
    scene's evaluator at that scale, where it differs from the search's."""
    cfg, k, mc = evaluator.cfg, evaluator.k, evaluator.cfg.mcts
    if not (mc.tricp_final and segs is not None):
        _, settled = evaluator.evaluate_final(assign[None, :], np.ones((1, k), bool))
        return settled[0]
    seg_pts, seg_mask = _segs_to_arrays(segs, k)
    costs3, settled3 = yield from evaluator.final_tricp_steps(assign, np.ones(k, bool), seg_pts,
                                                              seg_mask)
    settled_row = settled3[_tricp_pick(costs3)]
    if mc.final_polish_rounds > 0:
        scale = mc.final_polish_scale
        pev = evaluator if scale == mc.render_scale else remake(scale)
        settled_row, _c = _final_polish(pev, settled_row, np.ones(k, bool), cfg, seed=seed)
    return settled_row


def mcts_select(estimates, sc, db, table_pose, depth_clean, cfg, seed=0,
                snapshot_path=None, search="uct", segs=None, device=None, stats=None):
    """MCTSSelection::selectBestPoses analogue: refine the per-object pose
    choice by physics-aware search; installs the best state's settled poses.

    segs: optional per-object 3D segments aligned with `estimates`. When
    given and cfg.mcts.tricp_final is on, the final pass adds the
    UCTState::performTrICP refinement (_final_pass). Runs on the card unless
    device="cpu". stats: a dict that receives uct_search's counts (the
    greedy search leaves it as it is). snapshot_path: a JSON file that
    receives the search's outcome (utils/checkpoint.py).

    Spans (utils/tracing): the search's rounds (uct_search's spans), then
    search.final: the final pass through the installed poses.
    """
    if not estimates:
        return estimates
    evaluator, hyp_scores, remake = _scene_evaluator(estimates, sc, db, table_pose, depth_clean,
                                                     cfg, device)
    if search == "greedy":
        from physimglobalpose_tpu_torch.pipeline.greedy_search import greedy_bfs_search

        assign, best_cost = greedy_bfs_search(evaluator, hyp_scores, cfg)
    else:
        assign, best_cost = uct_search(evaluator, hyp_scores, cfg, seed=seed, stats=stats)
    if snapshot_path:
        from physimglobalpose_tpu_torch.utils.checkpoint import save_search_snapshot

        save_search_snapshot(snapshot_path, sc.scene_dir, assign, best_cost, seed)

    with tracing.span("search.final"):
        settled_row = _final_pass(evaluator, remake, assign, segs, seed)
        return _install_assignment(estimates, assign, settled_row, sc.cam_pose)


# ------------------------------------------------------------ many scenes

# The constants that differ from scene to scene; a multi-scene row gathers
# its scene's entry of each (the JAX package's _eval_batch_multi_jit gathers
# the whole per-scene tree inside its vmap).
_SCENE_KEYS = ("hull_pts", "hull_mask", "hull_eqs", "inv_inertia", "render_pts", "render_mask",
               "hyp_world", "table_pose", "cam_pose_inv", "intr", "obs")


def _leaf_eval_multi(consts, cfg, h, w, radius, scene_idx, choices, active):
    """Evaluate B (scene, placement) rows: row b gathers scene scene_idx[b]'s
    constants, then _leaf_eval on them. Returns (costs [B], settled world
    poses [B, K_max, 4, 4])."""
    rows = {key: (v[scene_idx] if key in _SCENE_KEYS else v) for key, v in consts.items()}
    return _leaf_eval(rows, cfg, h, w, radius, choices, active,
                      rows=(torch.arange(choices.shape[0], device=choices.device)[:, None],))


class MultiSceneLeafEvaluator:
    """Evaluates (scene, leaf) rows of MANY scenes in one device batch.

    Scene constants are padded to common (K, P, F, N, C) shapes and stacked
    on a leading axis; each row gathers its scene's by index. All scenes
    share the render resolution and cfg (true for a dataset sweep). With a
    mesh (parallel/mesh.DeviceMesh) the row axis is padded to a multiple of
    its size (repeating row 0) and split into contiguous chunks, each run on
    its device against its copy of the constants, the results gathered on
    the first device; callers read only the real prefix.
    """

    def __init__(self, evaluators: List[BatchedLeafEvaluator], mesh=None):
        assert evaluators, "need at least one scene"
        self.mesh = mesh
        self.n_shards = mesh.size if mesh is not None else 1
        self.device = dev = evaluators[0].device
        self.cfg = evaluators[0].cfg
        self.h, self.w = evaluators[0].h, evaluators[0].w
        assert all((ev.h, ev.w) == (self.h, self.w) for ev in evaluators), "mixed resolutions"
        self.ks = [ev.k for ev in evaluators]
        self.k_max = k_max = max(self.ks)
        self.splat_radius = evaluators[0].splat_radius
        assert all(ev.splat_radius == self.splat_radius for ev in evaluators)
        c_max = max(ev.num_hyp for ev in evaluators)
        # Padded objects take the far plane, an inverse inertia of 1 and the
        # identity (never active); padded hypothesis slots repeat hypothesis 0.
        fills = {"hull_eqs": _FAR_PLANE, "inv_inertia": 1.0, "hyp_world": torch.eye(4)}

        def stack_consts(scene_consts):
            parts = {key: [c[key] for c in scene_consts] for key in _SCENE_KEYS}
            parts["hyp_world"] = [torch.cat([hw, hw[:, [0] * (c_max - hw.shape[1])]], 1)
                                  for hw in parts["hyp_world"]]
            stacked = {key: _pad_stack(v, fills.get(key, 0)) for key, v in parts.items()}
            stacked["obj_idx"] = torch.arange(k_max, device=dev)
            stacked["table_half_extents"] = scene_consts[0]["table_half_extents"]
            return stacked

        self.evaluators = evaluators
        self.consts = stack_consts([ev.consts for ev in evaluators])
        self.consts_full = (
            stack_consts([ev.consts_full for ev in evaluators])
            if any(ev.consts_full is not ev.consts for ev in evaluators) else self.consts
        )
        # Each device's copy of the constants (the first device's are these).
        self._devices = mesh.device_list if mesh is not None else [dev]
        self._consts_on = {which: [{key: v.to(d, non_blocking=True) for key, v in consts.items()}
                                   for d in self._devices]
                           for which, consts in (("consts", self.consts),
                                                 ("consts_full", self.consts_full))}

    def _run(self, which: str, scene_idx, choices, active):
        """Queue the leaf batch on the constants `which` ("consts" or
        "consts_full"), its rows split over the mesh's devices."""
        n = len(scene_idx)
        pad = (-n) % self.n_shards
        if pad:
            scene_idx, choices, active = (np.concatenate([x, np.repeat(x[:1], pad, 0)])
                                          for x in (scene_idx, choices, active))
        per = (n + pad) // self.n_shards
        parts = [
            _leaf_eval_multi(self._consts_on[which][i], self.cfg, self.h, self.w, self.splat_radius,
                             *(_to_device(x[i * per:(i + 1) * per], d, dtype) for x, dtype in (
                                 (scene_idx, torch.int64), (choices, torch.int64),
                                 (active, torch.bool))))
            for i, d in enumerate(self._devices)
        ]
        if len(parts) == 1:
            return parts[0]
        return tuple(mesh_mod.gather([p[j] for p in parts], self.device) for j in range(2))

    def evaluate_async(self, scene_idx: np.ndarray, choices: np.ndarray, active: np.ndarray):
        """Queue the batch without waiting for it: device (costs, settled).
        With a mesh the rows may carry padding to a multiple of the device
        count; read only the first len(scene_idx)."""
        return self._run("consts", np.asarray(scene_idx), np.asarray(choices), np.asarray(active))

    def evaluate(self, scene_idx: np.ndarray, choices: np.ndarray, active: np.ndarray):
        costs, settled = self.evaluate_async(scene_idx, choices, active)
        return costs.cpu().numpy(), settled.cpu().numpy()

    def evaluate_final(self, scene_idx: np.ndarray, choices: np.ndarray, active: np.ndarray):
        """Chosen-assignment settles with the FULL hulls; padding stripped."""
        n_real = len(scene_idx)
        costs, settled = self._run(
            "consts_full", np.asarray(scene_idx), np.asarray(choices), np.asarray(active))
        return costs[:n_real].cpu().numpy(), settled[:n_real].cpu().numpy()

    def evaluate_final_tricp(self, choices: np.ndarray, active: np.ndarray, seg_pts, seg_mask):
        """Final settles + TrICP refinement of every scene (FULL hulls),
        each through its own evaluator's final_tricp_steps.

        choices/active: [S, k_max]; seg_pts [S, k_max, N, 3] / seg_mask
        [S, k_max, N]. Returns numpy (costs [S, 3], settled [S, 3, k_max, 4,
        4]), the padding objects at the identity. The JAX package vmaps the
        scenes in one program; here the TrICP chains (per-object loops of
        ICP solves) run in lockstep (icp_mod.lockstep), each scene's answer
        the one it gets alone."""
        choices, active = np.asarray(choices), np.asarray(active)
        settled = np.tile(np.eye(4, dtype=np.float32), (len(self.evaluators), 3, self.k_max, 1, 1))
        answers = icp_mod.lockstep([
            ev.final_tricp_steps(choices[s, :ev.k], active[s, :ev.k], seg_pts[s][:ev.k],
                                 seg_mask[s][:ev.k])
            for s, ev in enumerate(self.evaluators)])
        for s, (ev, (_c3, s3)) in enumerate(zip(self.evaluators, answers)):
            settled[s, :, :ev.k] = s3
        return np.stack([c3 for c3, _s3 in answers]), settled


def uct_search_multi(
    msev: MultiSceneLeafEvaluator,
    hyp_scores_list: List[np.ndarray],  # per scene [K_s, C_s]
    cfg: PipelineConfig = DEFAULT_CONFIG,
    seed: int = 0,
    max_iterations: Optional[int] = None,
    stats: Optional[dict] = None,
) -> List[tuple[np.ndarray, float]]:
    """S concurrent UCT searches sharing one leaf batch a round:
    _search_rounds on S trees (tree s seeded with seed + s), in batches of
    max(leaf_batch, leaf_batch_multi) rows rounded up to the mesh size.

    Returns per scene (best assignment [K_s], best cost). stats: a dict
    that receives search_expansions, search_budget and search_deadline_cut
    (per scene, as uct_search gives them for one), shared_batches and
    leaves (rows evaluated, padding not counted), and the same two counts as
    search_leaf_batches and search_leaves. Spans and counters:
    _search_rounds'.
    """
    mc = cfg.mcts
    trees = [_scene_tree(hs, msev.ks[si], cfg, max_iterations, seed + si)
             for si, hs in enumerate(hyp_scores_list)]
    batch = max(mc.leaf_batch, mc.leaf_batch_multi)
    batch += (-batch) % msev.n_shards
    leaf_batches, leaves = _search_rounds(
        trees, cfg, batch, msev.k_max,
        lambda rows_scene, choices, active: msev.evaluate_async(rows_scene, choices, active)[0])
    if stats is not None:
        stats.update(search_expansions=[t.expansions for t in trees],
                     search_budget=[t.budget for t in trees],
                     search_deadline_cut=[not (t.done or t.root.exhausted) for t in trees],
                     shared_batches=leaf_batches, leaves=leaves,
                     search_leaf_batches=leaf_batches, search_leaves=leaves)
    return [(t.best_assign, t.best_cost) for t in trees]


def mcts_select_multi(scene_rows, db, cfg, seed=0, mesh=None, segs_list=None, device=None,
                      stats=None):
    """Physics-aware MCTS selection for MANY scenes in shared batches.

    scene_rows: (estimates, sc, table_pose, depth_clean) per scene, the
    inputs mcts_select takes. Every search runs concurrently through one
    MultiSceneLeafEvaluator, and the final chosen-assignment settles of all
    scenes run as one batch. segs_list: optional per-scene segments aligned
    with scene_rows; with cfg.mcts.tricp_final the final pass is instead
    mcts_select's (_final_pass) a scene, through the scene's own evaluator
    and seeded with seed + s. mesh: split every leaf batch's rows over its
    devices (the host trees are unchanged, so the results are the unsplit
    ones). Runs on the mesh's first device, else on `device` (the card
    unless "cpu"). stats: receives uct_search_multi's counts, its per-scene
    lists in input order (None for a scene without objects, which runs no
    search). Returns the per-scene refined estimate lists, in input order.

    Spans (utils/tracing): the rounds (uct_search_multi's), then one
    search.final around every scene's final pass and install, as
    mcts_select opens it for one.
    """
    live = [(i, row) for i, row in enumerate(scene_rows) if len(row[0]) > 0]
    out: List[list] = [row[0] for row in scene_rows]
    if not live:
        return out
    dev = mesh.device_list[0] if mesh is not None else device
    built = [_scene_evaluator(est, sc, db, tp, dc, cfg, dev) for _i, (est, sc, tp, dc) in live]
    msev = MultiSceneLeafEvaluator([ev for ev, _hs, _remake in built], mesh=mesh)
    results = uct_search_multi(msev, [hs for _ev, hs, _remake in built], cfg, seed=seed,
                               stats=stats)
    if stats is not None:
        for key in ("search_expansions", "search_budget", "search_deadline_cut"):
            per_scene = [None] * len(scene_rows)
            for (orig_i, _row), v in zip(live, stats[key]):
                per_scene[orig_i] = v
            stats[key] = per_scene

    with tracing.span("search.final"):
        if cfg.mcts.tricp_final and segs_list is not None:
            # The scenes' TrICP passes wait for the card at every ICP
            # iteration: in lockstep they wait once a round for all scenes.
            settled = icp_mod.lockstep([
                _final_pass_steps(ev, remake, assign, segs_list[orig_i], seed + si)
                for si, ((ev, _hs, remake), (orig_i, _row), (assign, _cost))
                in enumerate(zip(built, live, results))])
        else:
            # Every scene's chosen assignment in one batch, with the FULL hulls.
            choices = np.full((len(live), msev.k_max), -1, np.int64)
            for si, (assign, _cost) in enumerate(results):
                choices[si, : len(assign)] = assign
            _, settled = msev.evaluate_final(np.arange(len(live)), choices, choices >= 0)

        for si, (orig_i, (estimates, sc, _tp, _dc)) in enumerate(live):
            out[orig_i] = _install_assignment(
                estimates, results[si][0], settled[si][: len(estimates)], sc.cam_pose)
    return out
