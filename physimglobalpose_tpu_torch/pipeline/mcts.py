"""Physics-aware MCTS over object placement orders (one scene).

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
batch's rows are split over its devices.
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

    def ucb(self, alpha: float, parent_n: int) -> float:
        n = self.n + self.virtual
        if n == 0:
            return -math.inf
        return self.qval / n - alpha * math.sqrt(2 * math.log(max(parent_n, 1)) / n)


def _to_device(a, device: torch.device, dtype=None) -> torch.Tensor:
    """A host array on the device without waiting for the device: on the card
    the copy goes from pinned memory, queued behind the work already there."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _leaf_eval(consts, cfg, h, w, radius, choices, active):
    """Evaluate B placement assignments: settle -> render -> pixel cost.

    choices [B, K] hypothesis index per object (-1 = not placed), active
    [B, K] bool. Returns (costs [B], settled world poses [B, K, 4, 4])."""
    k, num_hyp = consts["hyp_world"].shape[:2]
    safe_choice = torch.clamp(choices, 0, num_hyp - 1)
    poses_w = consts["hyp_world"][consts["obj_idx"][None, :], safe_choice]  # [B, K, 4, 4]
    return _settle_render_cost(consts, cfg, h, w, radius, poses_w, active)


def _settle_render_cost(consts, cfg, h, w, radius, poses_w, active):
    """Settle explicit world poses [B, K, 4, 4], then render + pixel cost (the
    leaf body, split out so the TrICP final pass feeds refined poses through
    the same settle/cost path)."""
    ph = cfg.physics
    order_pos = torch.cumsum(active.to(torch.int64), dim=1) - 1
    quat = se3.matrix_to_quat(poses_w[..., :3, :3])
    pos = poses_w[..., :3, 3]

    def scene_for(inv_mass, placed):
        # Unplaced objects have no hull and are no collider either (the
        # reference's correctPhysics adds only placed objects to the world,
        # UCTState.cpp:208-270).
        return physics.PhysicsScene(
            hull_pts=consts["hull_pts"],
            hull_mask=consts["hull_mask"] & placed[..., None],
            hull_eqs=consts["hull_eqs"],
            inv_mass=inv_mass,
            inv_inertia=consts["inv_inertia"],
            table_pose=consts["table_pose"],
            table_half_extents=consts["table_half_extents"],
            body_active=placed,
        )

    def run_settle(scene, q, p, is_dyn):
        # Exactly one body is dynamic per settle (correctPhysics semantics).
        dyn_idx = torch.where(
            torch.any(is_dyn, dim=1), torch.argmax(is_dyn.to(torch.uint8), dim=1), -1
        )
        return physics.settle_single_dynamic(
            scene, q, p, dyn_idx,
            steps=ph.steps, substeps=ph.substeps, dt=ph.dt,
            gravity=ph.gravity, damping=ph.damping,
            friction=ph.friction, restitution=ph.restitution,
        )

    if cfg.mcts.sequential_settle:
        # The reference's defaultPolicy settles each newly placed object on
        # top of the previously settled ones (UCTSearch.cpp:140-194): the
        # object at placement position d dynamic, 0..d-1 static at their
        # settled poses, later objects absent.
        for d in range(active.shape[-1]):
            is_dyn = active & (order_pos == d)
            placed = active & (order_pos <= d)
            inv_mass = torch.where(is_dyn, 1.0 / ph.object_mass, 0.0)
            quat, pos = run_settle(scene_for(inv_mass, placed), quat, pos, is_dyn)
    else:
        # One settle of the complete assignment, only the last-placed object
        # dynamic (equivalent for non-stacked scenes).
        last_idx = torch.amax(torch.where(active, order_pos, -1), dim=1, keepdim=True)
        is_dyn = active & (order_pos == last_idx)
        inv_mass = torch.where(is_dyn, 1.0 / ph.object_mass, 0.0)
        quat, pos = run_settle(scene_for(inv_mass, active), quat, pos, is_dyn)
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


_TRICP_MODEL_POINTS = 1024  # strided model-cloud budget for the ICP products


def _tricp_refine_cam(poses_c, model_pts, model_nrm, model_mask, seg_pts,
                      seg_mask, active, cfg):
    """Sequential unexplained-segment trimmed ICP, camera frame.

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
        tf = icp_mod.icp_single(
            poses_c[i], mp, model_nrm[i], seg_pts[i], seg_m,
            iters=mc.tricp_iters, trim_fraction=mc.tricp_trim,
            max_corr_dist=mc.tricp_max_corr_dist,
            point_to_plane=False,  # PCL TrimmedICP is point-to-point
            exact_trim=True,  # the trim is the outlier model here
        )
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


def _tricp_final_core(consts, cam_pose, model_nrm, seg_pts, seg_mask,
                      cfg, h, w, radius, choices, active):
    """Final-state evaluation with TrICP refinement, one scene.

    Three candidate final states through the same settle/cost path:
      0: raw chosen hypotheses -> settle
      1: TrICP -> settle   (reference expandNode order, Search.cpp:43-47)
      2: settle -> TrICP polish (cost re-rendered)
    choices/active [K]. Returns (costs [3], settled [3, K, 4, 4]); the
    caller installs the argmin row.
    """
    k, num_hyp = consts["hyp_world"].shape[:2]
    safe_choice = torch.clamp(choices, 0, num_hyp - 1)
    poses_w = consts["hyp_world"][consts["obj_idx"], safe_choice]
    stride = max(1, consts["render_pts"].shape[1] // _TRICP_MODEL_POINTS)
    mp = consts["render_pts"][:, ::stride]
    mm = consts["render_mask"][:, ::stride]
    mn = model_nrm[:, ::stride]
    cam_inv = consts["cam_pose_inv"]

    refined_c = _tricp_refine_cam(cam_inv @ poses_w, mp, mn, mm, seg_pts, seg_mask, active, cfg)
    # Candidates 0 and 1 settle as two rows of one batch.
    c01, s01 = _settle_render_cost(
        consts, cfg, h, w, radius, torch.stack([poses_w, cam_pose @ refined_c]),
        active[None].expand(2, k),
    )
    polish_c = _tricp_refine_cam(cam_inv @ s01[0], mp, mn, mm, seg_pts, seg_mask, active, cfg)
    s2 = cam_pose @ polish_c
    c2 = _render_cost_of_poses(consts, cfg, h, w, radius, s2, active)
    return torch.cat([c01, c2[None]]), torch.cat([s01, s2[None]])


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
        k = len(obj_hulls)
        self.k = k
        self.num_hyp = hypotheses_world.shape[1]
        ph = cfg.physics
        as_dev = lambda a, dtype=torch.float32: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        def pack_hulls(hull_list):
            p_max = max(h["hull_pts"].shape[0] for h in hull_list)
            f_max = max(h["hull_eqs"].shape[0] for h in hull_list)
            hull_pts = np.zeros((k, p_max, 3), np.float32)
            hull_mask = np.zeros((k, p_max), bool)
            hull_eqs = np.tile(np.array([0, 0, 1, -1e9], np.float32), (k, f_max, 1))
            inv_inertia = np.zeros((k, 3), np.float32)
            for i, h in enumerate(hull_list):
                hp = h["hull_pts"]
                hull_pts[i, : len(hp)] = hp
                hull_mask[i, : len(hp)] = h["hull_mask"][: len(hp)]
                he = h["hull_eqs"]
                hull_eqs[i, : len(he)] = he
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
                hull_eqs=as_dev(hull_eqs), inv_inertia=as_dev(inv_inertia),
            )

        # Search-time hulls may be decimated (cfg.mcts.contact_hull_vertices);
        # the full hulls are kept for evaluate_final*, so the reported poses
        # carry no decimation.
        cv = cfg.mcts.contact_hull_vertices
        search_hulls = [_decimate_contact_hull(h, cv) for h in obj_hulls] if cv > 0 else obj_hulls
        scene_const = pack_hulls(search_hulls)
        scene_const_full = pack_hulls(obj_hulls) if search_hulls is not obj_hulls else None

        n_max = max(h["render_pts"].shape[0] for h in obj_hulls)
        render_pts = np.zeros((k, n_max, 3), np.float32)
        render_nrm = np.zeros((k, n_max, 3), np.float32)
        render_mask = np.zeros((k, n_max), bool)
        for i, h in enumerate(obj_hulls):
            rp = h["render_pts"]
            render_pts[i, : len(rp)] = rp
            render_mask[i, : len(rp)] = h["render_mask"][: len(rp)]
            rn = h.get("render_nrm")
            if rn is not None:
                render_nrm[i, : len(rn)] = rn
        self.render_nrm = as_dev(render_nrm)
        self.cam_pose = as_dev(cam_pose)
        cp = np.asarray(cam_pose, np.float64)
        cp_inv = np.eye(4)
        cp_inv[:3, :3] = cp[:3, :3].T
        cp_inv[:3, 3] = -cp[:3, :3].T @ cp[:3, 3]
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
            cam_pose_inv=as_dev(cp_inv.astype(np.float32)),
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
        """Final settle + TrICP refinement (FULL hulls).

        choices/active: [K]; seg_pts [K, N, 3] / seg_mask [K, N] are the
        per-object camera-frame 3D segments. Returns numpy (costs [3],
        settled [3, K, 4, 4]), rows raw / tricp->settle / settle->tricp;
        the caller installs _tricp_pick's row."""
        costs, settled = _tricp_final_core(
            self.consts_full, self.cam_pose, self.render_nrm,
            torch.as_tensor(seg_pts, dtype=torch.float32, device=self.device),
            torch.as_tensor(seg_mask, dtype=torch.bool, device=self.device),
            self.cfg, self.h, self.w, self.splat_radius,
            _to_device(np.asarray(choices), self.device, torch.int64),
            _to_device(np.asarray(active), self.device, torch.bool),
        )
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
            parent_n = node.n + node.virtual
            node = min(node.children.values(), key=lambda ch: ch.ucb(alpha, parent_n))
        if node.depth == tree.k and node.cached_cost is not None:
            # Deterministic terminal re-visit: back up the cached cost now,
            # no device work. (_backup pairs with a virtual-loss increment
            # along the path, so add one first - net zero.)
            cur = node
            while cur is not None:
                cur.virtual += 1
                cur = cur.parent
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
        cur = node
        while cur is not None:
            cur.virtual += 1
            cur = cur.parent
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


def _search_budget(k: int, c: int, cap: int) -> int:
    # sum_{i=0}^{k} branching^i expansions (UCTSearch.cpp:290-294), capped by
    # cfg.mcts.max_expansions (the reference's 60 s cut binds first there).
    return min(sum(c**i for i in range(0, k + 1)), cap)


def uct_search(
    evaluator: BatchedLeafEvaluator,
    hyp_scores: np.ndarray,  # [K, C] LCP heuristic per hypothesis
    cfg: PipelineConfig = DEFAULT_CONFIG,
    seed: int = 0,
    max_iterations: Optional[int] = None,
    stats: Optional[dict] = None,
) -> tuple[np.ndarray, float]:
    """Run the batched UCT search.

    Returns (best complete assignment [K] hypothesis indices, best cost).
    stats: a dict that receives search_expansions, search_budget,
    search_deadline_cut (the deadline ended the search before the budget
    was spent or the tree exhausted), search_leaf_batches (leaf batches
    evaluated) and search_leaves (their leaves, padding not counted).
    Each round is spans search.collect, search.leaf_eval (the batch's
    enqueue) and search.backup (the wait for a batch's costs and their
    backup); the two counts are also added to the caller's current span
    (utils/tracing) as leaf_batches and leaves.
    """
    mc = cfg.mcts
    k = evaluator.k
    c = min(mc.branching, hyp_scores.shape[1])
    budget = _search_budget(k, c, max_iterations or mc.max_expansions)
    tree = _make_tree(hyp_scores, k, c, budget, seed)
    deadline = time.monotonic() + mc.max_search_seconds

    # Pipelined loop: collect the next batch (virtual loss decorrelates it
    # from the batches not yet backed up) while the device runs earlier
    # ones; fetch + back up the oldest batch only once
    # cfg.mcts.inflight_batches are queued.
    depth = max(1, mc.inflight_batches)
    inflight: List[tuple] = []  # (pend, device costs), oldest first
    leaf_batches = leaves = 0
    while time.monotonic() < deadline:
        finished = tree.done or tree.root.exhausted
        pend = []
        if not finished:
            with tracing.span("search.collect"):
                pend = _collect_batch(tree, mc.alpha, mc.leaf_batch)
        if pend:
            # Pad to the fixed leaf_batch (repeating row 0, results
            # discarded): cached-terminal backups make pend length variable.
            with tracing.span("search.leaf_eval"):
                rows = [p[1] for p in pend]
                rows += [rows[0]] * (mc.leaf_batch - len(rows))
                batch_choices = np.stack(rows)
                costs_dev, _settled = evaluator.evaluate_async(batch_choices, batch_choices >= 0)
            inflight.append((pend, costs_dev))
            leaf_batches += 1
            leaves += len(pend)
        if len(inflight) > depth or (not pend and inflight):
            prev_pend, prev_costs = inflight.pop(0)
            with tracing.span("search.backup"):
                _backup(tree, prev_pend, prev_costs.cpu().numpy())
        if not pend and not inflight:
            if finished:
                break
            # A round of cached-terminal backups only: budget remains and the
            # tree is not exhausted, so keep searching.
            continue

    # A deadline exit can leave queued batches not backed up; their work is
    # done, and the best assignment may be in them.
    for prev_pend, prev_costs in inflight:
        with tracing.span("search.backup"):
            _backup(tree, prev_pend, prev_costs.cpu().numpy())

    tracing.count(leaf_batches=leaf_batches, leaves=leaves)
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
        for j in range(n_h, c):
            hyp_world[i, j] = hyp_world[i, 0]
            hyp_scores[i, j] = -1.0
        obj_hulls.append(dict(
            hull_pts=obj.hull_pts, hull_mask=obj.hull_mask, hull_eqs=obj.hull_eqs,
            render_pts=obj.validation_pts, render_nrm=obj.validation_nrm,
            render_mask=np.ones(len(obj.validation_pts), bool),
        ))
    return hyp_world, hyp_scores, obj_hulls


def _segs_to_arrays(segs, k: int):
    """Segments as ([k, N, 3], [k, N]) tensors: a list of per-object
    Segment3D or one stacked Segment3D with a leading object axis; the
    object axis is padded (empty masks) or cut to k."""
    if hasattr(segs, "pts"):  # stacked Segment3D
        pts, mask = torch.as_tensor(segs.pts), torch.as_tensor(segs.mask)
    else:
        pts = torch.stack([torch.as_tensor(s.pts) for s in segs])
        mask = torch.stack([torch.as_tensor(s.mask) for s in segs])
    pts, mask = pts.to(torch.float32), mask.to(torch.bool)
    n_obj, n = pts.shape[:2]
    if n_obj < k:
        pts = torch.cat([pts, pts.new_zeros((k - n_obj, n, 3))])
        mask = torch.cat([mask, mask.new_zeros((k - n_obj, n))])
    return pts[:k], mask[:k]


def _install_assignment(estimates, assign, settled_row, cam):
    """Write the settled world poses of the chosen assignment back into the
    per-object estimates (pose_cam recomputed through the camera), on the
    host."""
    cam = np.asarray(cam, np.float64)
    cam_inv = np.eye(4)
    cam_inv[:3, :3] = cam[:3, :3].T
    cam_inv[:3, 3] = -cam[:3, :3].T @ cam[:3, 3]
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


def mcts_select(estimates, sc, db, table_pose, depth_clean, cfg, seed=0,
                snapshot_path=None, search="uct", segs=None, device=None, stats=None):
    """MCTSSelection::selectBestPoses analogue: refine the per-object pose
    choice by physics-aware search; installs the best state's settled poses.

    segs: optional per-object 3D segments aligned with `estimates`. When
    given and cfg.mcts.tricp_final is on, the final pass adds the
    UCTState::performTrICP refinement (see _tricp_final_core). Runs on the
    card unless device="cpu". stats: a dict that receives uct_search's
    counts (the greedy search leaves it as it is). snapshot_path: a JSON
    file that receives the search's outcome (utils/checkpoint.py).
    """
    k = len(estimates)
    if k == 0:
        return estimates
    hyp_world, hyp_scores, obj_hulls = _scene_search_inputs(estimates, sc, db, cfg)
    make_evaluator = lambda scale=None: BatchedLeafEvaluator(
        obj_hulls, hyp_world, depth_clean, sc.intrinsics, sc.cam_pose, table_pose, cfg,
        render_scale=scale, device=device,
    )
    evaluator = make_evaluator()
    if search == "greedy":
        from physimglobalpose_tpu_torch.pipeline.greedy_search import greedy_bfs_search

        assign, best_cost = greedy_bfs_search(evaluator, hyp_scores, cfg)
    else:
        assign, best_cost = uct_search(evaluator, hyp_scores, cfg, seed=seed, stats=stats)
    if snapshot_path:
        from physimglobalpose_tpu_torch.utils.checkpoint import save_search_snapshot

        save_search_snapshot(snapshot_path, sc.scene_dir, assign, best_cost, seed)

    # Final pass: settle the chosen assignment with the FULL hulls. With
    # segments, the same pass runs the TrICP refinement and installs the
    # min-cost of {raw, tricp->settle, settle->tricp}.
    if cfg.mcts.tricp_final and segs is not None:
        seg_pts, seg_mask = _segs_to_arrays(segs, k)
        costs3, settled3 = evaluator.evaluate_final_tricp(assign, np.ones(k, bool), seg_pts, seg_mask)
        settled_row = settled3[_tricp_pick(costs3)]
        if cfg.mcts.final_polish_rounds > 0:
            pev = evaluator
            if cfg.mcts.final_polish_scale != cfg.mcts.render_scale:
                pev = make_evaluator(cfg.mcts.final_polish_scale)
            settled_row, _c = _final_polish(pev, settled_row, np.ones(k, bool), cfg, seed=seed)
    else:
        _, settled = evaluator.evaluate_final(assign[None, :], np.ones((1, k), bool))
        settled_row = settled[0]
    return _install_assignment(estimates, assign, settled_row, sc.cam_pose)


# ------------------------------------------------------------ many scenes

# The constants that differ from scene to scene; a multi-scene row gathers
# its scene's entry of each (the JAX package's _eval_batch_multi_jit gathers
# the whole per-scene tree inside its vmap).
_SCENE_KEYS = ("hull_pts", "hull_mask", "hull_eqs", "inv_inertia", "render_pts", "render_mask",
               "hyp_world", "table_pose", "cam_pose_inv", "intr", "obs")


def _leaf_eval_multi(consts, cfg, h, w, radius, scene_idx, choices, active):
    """Evaluate B (scene, placement) rows: row b gathers scene scene_idx[b]'s
    constants, then settle -> render -> pixel cost as _leaf_eval. Returns
    (costs [B], settled world poses [B, K_max, 4, 4])."""
    rows = {key: (v[scene_idx] if key in _SCENE_KEYS else v) for key, v in consts.items()}
    num_hyp = rows["hyp_world"].shape[2]
    safe_choice = torch.clamp(choices, 0, num_hyp - 1)
    b = choices.shape[0]
    poses_w = rows["hyp_world"][
        torch.arange(b, device=choices.device)[:, None], rows["obj_idx"][None, :], safe_choice
    ]
    return _settle_render_cost(rows, cfg, h, w, radius, poses_w, active)


def _scene_consts(consts, s: int) -> dict:
    """Scene s's constants out of the stacked multi-scene ones."""
    return {key: (v[s] if key in _SCENE_KEYS else v) for key, v in consts.items()}


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
        for ev in evaluators:
            assert (ev.h, ev.w) == (self.h, self.w), "mixed render resolutions"
        self.ks = [ev.k for ev in evaluators]
        self.k_max = k_max = max(self.ks)
        self.num_scenes = len(evaluators)
        self.splat_radius = evaluators[0].splat_radius
        assert all(ev.splat_radius == self.splat_radius for ev in evaluators)
        n_max = max(ev.consts["render_pts"].shape[1] for ev in evaluators)
        c_max = max(ev.consts["hyp_world"].shape[1] for ev in evaluators)

        def pad_to(x, shape, fill=0):
            out = torch.full(shape, fill, dtype=x.dtype, device=dev)
            out[tuple(slice(0, n) for n in x.shape)] = x
            return out

        def stack_consts(scene_consts):
            p_max = max(c["hull_pts"].shape[1] for c in scene_consts)
            f_max = max(c["hull_eqs"].shape[1] for c in scene_consts)
            far = torch.tensor([0.0, 0.0, 1.0, -1e9], device=dev)
            out = {key: [] for key in _SCENE_KEYS}
            for c in scene_consts:
                k, f = c["hull_pts"].shape[0], c["hull_eqs"].shape[1]
                out["hull_pts"].append(pad_to(c["hull_pts"], (k_max, p_max, 3)))
                out["hull_mask"].append(pad_to(c["hull_mask"], (k_max, p_max)))
                # Padded faces and objects take the far plane: never a contact.
                eqs = far.expand(k_max, f_max, 4).clone()
                eqs[:k, :f] = c["hull_eqs"]
                out["hull_eqs"].append(eqs)
                out["inv_inertia"].append(pad_to(c["inv_inertia"], (k_max, 3), fill=1.0))
                out["render_pts"].append(pad_to(c["render_pts"], (k_max, n_max, 3)))
                out["render_mask"].append(pad_to(c["render_mask"], (k_max, n_max)))
                # Padded hypothesis slots repeat hypothesis 0; padded objects
                # take the identity (never active).
                hw = torch.eye(4, device=dev).expand(k_max, c_max, 4, 4).clone()
                c_s = c["hyp_world"].shape[1]
                hw[:k, :c_s] = c["hyp_world"]
                hw[:k, c_s:] = c["hyp_world"][:, :1]
                out["hyp_world"].append(hw)
                for key in ("table_pose", "cam_pose_inv", "intr", "obs"):
                    out[key].append(c[key])
            stacked = {key: torch.stack(v) for key, v in out.items()}
            stacked["obj_idx"] = torch.arange(k_max, device=dev)
            stacked["table_half_extents"] = scene_consts[0]["table_half_extents"]
            return stacked

        self.consts = stack_consts([ev.consts for ev in evaluators])
        self.consts_full = (
            stack_consts([ev.consts_full for ev in evaluators])
            if any(ev.consts_full is not ev.consts for ev in evaluators) else self.consts
        )
        # The final pass's TrICP inputs: cameras and the model normals aligned
        # with consts["render_pts"].
        self.cam_pose_stacked = torch.stack([ev.cam_pose for ev in evaluators])
        self.render_nrm_stacked = torch.stack(
            [pad_to(ev.render_nrm, (k_max, n_max, 3)) for ev in evaluators])
        if mesh is not None:
            copy = lambda consts: [{key: v.to(d, non_blocking=True) for key, v in consts.items()}
                                   for d in mesh.device_list]
            self._consts_on = copy(self.consts)
            self._consts_full_on = (self._consts_on if self.consts_full is self.consts
                                    else copy(self.consts_full))

    def _run(self, which: str, scene_idx, choices, active):
        """Queue the leaf batch on the constants `which` ("consts" or
        "consts_full"), split over the mesh when there is one."""
        if self.mesh is None:
            return _leaf_eval_multi(
                getattr(self, which), self.cfg, self.h, self.w, self.splat_radius,
                _to_device(scene_idx, self.device, torch.int64),
                _to_device(choices, self.device, torch.int64),
                _to_device(active, self.device, torch.bool),
            )
        n = len(scene_idx)
        pad = (-n) % self.n_shards
        if pad:
            scene_idx, choices, active = (np.concatenate([x, np.repeat(x[:1], pad, 0)])
                                          for x in (scene_idx, choices, active))
        per = (n + pad) // self.n_shards
        consts_on = self._consts_on if which == "consts" else self._consts_full_on
        parts = [
            _leaf_eval_multi(
                consts_on[i], self.cfg, self.h, self.w, self.splat_radius,
                _to_device(scene_idx[i * per:(i + 1) * per], d, torch.int64),
                _to_device(choices[i * per:(i + 1) * per], d, torch.int64),
                _to_device(active[i * per:(i + 1) * per], d, torch.bool),
            )
            for i, d in enumerate(self.mesh.device_list)
        ]
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
        """Final settles + TrICP refinement of every scene (FULL hulls).

        choices/active: [S, k_max]; seg_pts [S, k_max, N, 3] / seg_mask
        [S, k_max, N]. Returns numpy (costs [S, 3], settled [S, 3, k_max, 4,
        4]), _tricp_final_core's rows per scene. The JAX package vmaps the
        scenes in one program; here they run one after another (the TrICP
        chain is a per-object loop of ICP solves, once a sweep)."""
        seg_pts = torch.as_tensor(seg_pts, dtype=torch.float32, device=self.device)
        seg_mask = torch.as_tensor(seg_mask, dtype=torch.bool, device=self.device)
        choices_t = _to_device(np.asarray(choices), self.device, torch.int64)
        active_t = _to_device(np.asarray(active), self.device, torch.bool)
        out = [
            _tricp_final_core(
                _scene_consts(self.consts_full, s), self.cam_pose_stacked[s],
                self.render_nrm_stacked[s], seg_pts[s], seg_mask[s], self.cfg, self.h,
                self.w, self.splat_radius, choices_t[s], active_t[s],
            )
            for s in range(len(choices_t))
        ]
        return (torch.stack([c for c, _ in out]).cpu().numpy(),
                torch.stack([st for _, st in out]).cpu().numpy())


def uct_search_multi(
    msev: MultiSceneLeafEvaluator,
    hyp_scores_list: List[np.ndarray],  # per scene [K_s, C_s]
    cfg: PipelineConfig = DEFAULT_CONFIG,
    seed: int = 0,
    max_iterations: Optional[int] = None,
    stats: Optional[dict] = None,
) -> List[tuple[np.ndarray, float]]:
    """S concurrent UCT searches sharing one leaf batch a round.

    Each round splits max(leaf_batch, leaf_batch_multi) rows (rounded up to
    the mesh size) across the still-running trees, collects their pending
    leaves with virtual loss, evaluates all of them in one batch padded to
    that fixed size (repeating the first row), and backs up per tree; up to
    cfg.mcts.inflight_batches rounds are queued before the oldest is read.
    Tree s is seeded with seed + s. Returns per scene (best assignment
    [K_s], best cost). stats: a dict that receives search_expansions (per
    scene), search_budget (per scene), shared_batches and leaves (rows
    evaluated, padding not counted), and the same two counts as
    search_leaf_batches and search_leaves. Spans and counters as
    uct_search's.
    """
    mc = cfg.mcts
    trees: List[_Tree] = []
    for si, hs in enumerate(hyp_scores_list):
        k = msev.ks[si]
        c = min(mc.branching, hs.shape[1])
        budget = _search_budget(k, c, max_iterations or mc.max_expansions)
        trees.append(_make_tree(hs, k, c, budget, seed + si))
    deadline = time.monotonic() + mc.max_search_seconds
    k_max = msev.k_max
    batch = max(mc.leaf_batch, mc.leaf_batch_multi)
    batch += (-batch) % msev.n_shards
    counts = {"shared_batches": 0, "leaves": 0}
    empty_round = object()  # a round of cached-terminal backups only

    def collect_round():
        live = [si for si, t in enumerate(trees) if not (t.done or t.root.exhausted)]
        if not live:
            return None
        quota = max(1, batch // len(live))
        rows_scene: List[int] = []
        rows_choices: List[np.ndarray] = []
        pend_per_scene: List[tuple] = []
        with tracing.span("search.collect"):
            for si in live:
                pend = _collect_batch(trees[si], mc.alpha, quota)
                pend_per_scene.append((si, pend))
                for _, choices in pend:
                    row = np.full(k_max, -1, np.int64)
                    row[: trees[si].k] = choices
                    rows_scene.append(si)
                    rows_choices.append(row)
        if not rows_choices:
            return empty_round
        counts["shared_batches"] += 1
        counts["leaves"] += len(rows_choices)
        with tracing.span("search.leaf_eval"):
            pad = (-len(rows_choices)) % batch  # fixed batch-size multiples
            rows_scene += [rows_scene[0]] * pad
            rows_choices += [rows_choices[0]] * pad
            choices_arr = np.stack(rows_choices)
            costs_dev, _settled = msev.evaluate_async(np.asarray(rows_scene), choices_arr,
                                                      choices_arr >= 0)
        return pend_per_scene, costs_dev

    def backup_round(round_result):
        pend_per_scene, costs_dev = round_result
        with tracing.span("search.backup"):
            costs = costs_dev.cpu().numpy()
            ofs = 0
            for si, pend in pend_per_scene:
                _backup(trees[si], pend, costs[ofs: ofs + len(pend)])
                ofs += len(pend)

    depth = max(1, mc.inflight_batches)
    inflight = []  # queued rounds, oldest first
    while time.monotonic() < deadline:
        nxt = collect_round()
        if nxt is not None and nxt is not empty_round:
            inflight.append(nxt)
        if len(inflight) > depth or (nxt in (None, empty_round) and inflight):
            backup_round(inflight.pop(0))
        if nxt is empty_round:
            continue
        if nxt is None and not inflight:
            break
    # A deadline exit: back up the queued rounds (their work is done).
    for r in inflight:
        backup_round(r)
    tracing.count(leaf_batches=counts["shared_batches"], leaves=counts["leaves"])
    if stats is not None:
        stats.update(search_expansions=[t.expansions for t in trees],
                     search_budget=[t.budget for t in trees], **counts,
                     search_leaf_batches=counts["shared_batches"],
                     search_leaves=counts["leaves"])
    return [(t.best_assign, t.best_cost) for t in trees]


def mcts_select_multi(scene_rows, db, cfg, seed=0, mesh=None, segs_list=None, device=None,
                      stats=None):
    """Physics-aware MCTS selection for MANY scenes in shared batches.

    scene_rows: (estimates, sc, table_pose, depth_clean) per scene, the
    inputs mcts_select takes. Every search runs concurrently through one
    MultiSceneLeafEvaluator, and the final chosen-assignment settles of all
    scenes run as one batch. segs_list: optional per-scene segments aligned
    with scene_rows; with cfg.mcts.tricp_final they add the TrICP final pass
    per scene. mesh: split every leaf batch's rows over its devices (the
    host trees are unchanged, so the results are the unsplit ones). Runs on
    the mesh's first device, else on `device` (the card unless "cpu").
    stats: receives uct_search_multi's counts. Returns the per-scene
    refined estimate lists, in input order.
    """
    live = [(i, row) for i, row in enumerate(scene_rows) if len(row[0]) > 0]
    out: List[list] = [row[0] for row in scene_rows]
    if not live:
        return out
    dev = mesh.device_list[0] if mesh is not None else device

    def make_evaluator(row, scale=None):
        estimates, sc, table_pose, depth_clean = row
        hyp_world, hyp_scores, obj_hulls = _scene_search_inputs(estimates, sc, db, cfg)
        ev = BatchedLeafEvaluator(obj_hulls, hyp_world, depth_clean, sc.intrinsics, sc.cam_pose,
                                  table_pose, cfg, render_scale=scale, device=dev)
        return ev, hyp_scores

    built = [make_evaluator(row) for _i, row in live]
    evaluators = [ev for ev, _hs in built]
    msev = MultiSceneLeafEvaluator(evaluators, mesh=mesh)
    results = uct_search_multi(msev, [hs for _ev, hs in built], cfg, seed=seed, stats=stats)

    # Final pass: every scene's chosen assignment in one batch, with the FULL
    # hulls; with segments, the TrICP refinement per scene as well.
    s = len(live)
    choices = np.full((s, msev.k_max), -1, np.int64)
    active = np.zeros((s, msev.k_max), bool)
    for si, (assign, _cost) in enumerate(results):
        choices[si, : len(assign)] = assign
        active[si, : len(assign)] = True
    if cfg.mcts.tricp_final and segs_list is not None:
        seg_rows = [_segs_to_arrays(segs_list[orig_i], msev.k_max) for orig_i, _row in live]
        costs3, settled3 = msev.evaluate_final_tricp(
            choices, active, torch.stack([r[0].to(msev.device) for r in seg_rows]),
            torch.stack([r[1].to(msev.device) for r in seg_rows]),
        )
        settled = settled3[np.arange(s), [_tricp_pick(costs3[si]) for si in range(s)]]
        if cfg.mcts.final_polish_rounds > 0:
            # Each scene's polish through its own evaluator at the polish
            # scale (the k_max padding rows stay as they are).
            for si in range(s):
                k_s = evaluators[si].k
                pev = evaluators[si]
                if cfg.mcts.final_polish_scale != cfg.mcts.render_scale:
                    pev, _hs = make_evaluator(live[si][1], cfg.mcts.final_polish_scale)
                settled[si, :k_s], _c = _final_polish(
                    pev, settled[si, :k_s], np.ones(k_s, bool), cfg, seed=seed + si)
    else:
        _, settled = msev.evaluate_final(np.arange(s), choices, active)

    for si, (orig_i, (estimates, sc, _tp, _dc)) in enumerate(live):
        out[orig_i] = _install_assignment(
            estimates, results[si][0], settled[si, : len(estimates)], sc.cam_pose)
    return out
