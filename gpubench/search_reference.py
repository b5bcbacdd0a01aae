"""A plain reference of the physics-aware search's leaf objective.

The search (arXiv:1710.08577; the program's pipeline/mcts.py) scores a
placement of the scene's objects, one hypothesis pose each, in three steps:

1. the sequential settle: the objects are placed in order; the object
   placed d-th is dynamic, the ones placed before it are static at their
   settled poses, and the ones placed after it are absent (the reference
   code's UCTSearch defaultPolicy and UCTState::correctPhysics);
2. a depth render of the placed objects at the leaf scale, with the 1 m cut
   (renderScene.cpp:70);
3. the three-term unexplained-pixel cost (UCTState::computeCost): over the
   pixels where the observed and the rendered depth differ by more than the
   explanation threshold, observed-occupied plus rendered-occupied minus
   both.

This file computes that objective for one assignment at a time, in float32,
with plain torch operations: no batch of leaves, no cache, no packed
colliders, no scatter. It imports neither JAX nor the program, and it turns
TF32 off for its own products (`strict_fp32`), so it is the float32 answer
to hold the program to, on the CPU and on the card.

The settle is position-based dynamics (PBD), written from the model the
program's ops/physics.py states:
- gravity along world z, applied to the dynamic body only; velocities
  damped by `damping` each substep; `steps` x `substeps` substeps of
  dt / substeps;
- a contact is a set of hull vertices of the dynamic body inside a convex
  collider, a set of face planes: the table box (`table_half_extents` at
  `table_pose`) and each static body's hull faces;
- per collider: the penetration of a vertex is its distance behind the
  nearest face plane; the contact's depth is the deepest vertex's, its
  normal the nearest face's normal at that vertex, its point the
  penetration-weighted mean of the penetrating vertices;
- per substep, one solve of all the body's contacts at once: positional
  impulses depth / (1/m + (r x n) . I^-1 (r x n)) summed; velocity fixes
  (the inward normal velocity removed with restitution 0, min(1, 0.8 mu)
  of the tangential velocity removed) averaged over the active contacts;
- quaternion integration q' = normalize(q + dt/2 (0, w) q).

Departures from the published description (Bullet in the paper's code),
all of them the program's model too:
- PBD in place of Bullet's impulse solver, with vertex-face contacts only
  (no edge-edge contact, no convex margin);
- the inertia is the hull's bounding box taken as a solid box of the
  object's mass;
- the angular velocity fix is halved (the program's stabilisation of
  single-point contacts);
- the render is a z-min splat of the object's surface points (the
  program's render points), not a rasterised mesh; a point covers the
  (2 r + 1)^2 pixels around the pixel it projects to;
- the table is a box collider, and unplaced objects are absent from the
  world and from the render.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

FAR_PLANE_D = -1e8  # a hull's padding rows carry d = -1e9: they are no faces

# How close the program's leaf has to come to this reference's, both in
# float32 with TF32 off:
TOL = {
    # a point on a pixel's edge rounds to either side under another order of
    # the same products, and two points within rounding of each other's
    # depth can swap which one a pixel keeps
    "cost_px": 2.0,
    # settled positions, m: the contact products and sums run in another
    # order and the quaternion comes from the matrix by another route
    "pos_m": 1e-5,
    # settled rotation matrix entries, for the same reasons
    "rot": 5e-5,
}
# The settle amplifies rounding where bodies rock and slide against each
# other, and it is not continuous everywhere: a vertex near a corner of a
# collider is pushed out through one face or the other, and a box on an edge
# tips or stays. There a change in the last bits of the inputs moves the
# answer by more than TOL, in this reference as in the program. So a leaf
# whose answer lies outside TOL is held to this reference's own spread
# instead: its answers to NUDGES nudged inputs (every hypothesis moved by up
# to NUDGE_M, about 8 float32 steps at 1 m), the largest distance of these
# from its answer to the inputs as they are, times SPREAD_FACTOR.
NUDGE_M = 1e-6
NUDGES = 4
SPREAD_FACTOR = 2.0
UNRESOLVED_SHARE = 0.02  # of the leaves compared, the share that may still disagree


@contextlib.contextmanager
def strict_fp32():
    """Float32 products with TF32 off for the block; the settings as they
    were afterwards."""
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


@dataclasses.dataclass
class SearchScene:
    """One scene's search inputs, as float32 tensors on one device."""

    hull_pts: list  # per object [P, 3], the hull's valid vertices, object frame
    hull_planes: list  # per object [F, 4], the hull's face planes n.x + d = 0, object frame
    inv_inertia: list  # per object [3], diagonal, body frame
    render_pts: list  # per object [N, 3], the valid render points, object frame
    hyp_world: torch.Tensor  # [K, C, 4, 4] the hypotheses, world frame
    obs: torch.Tensor  # [h, w] the observed depth at the leaf scale
    intrinsics: torch.Tensor  # [3, 3] at the leaf scale
    cam_inv: torch.Tensor  # [4, 4] world to camera
    table_planes: torch.Tensor  # [6, 4] the table box's faces, world frame
    physics: dict
    sequential: bool
    splat_radius: int
    max_depth: float
    threshold: float


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def scene(obj_hulls, hyp_world, obs_depth, intrinsics, cam_pose, table_pose, cfg,
          render_scale=None, device="cpu") -> SearchScene:
    """A SearchScene from what the program's leaf evaluator is built from
    (pipeline/mcts.BatchedLeafEvaluator's arguments): per object a dict of
    hull_pts, hull_mask, hull_eqs, render_pts, render_mask; the program's
    PipelineConfig, read by field name."""
    ph, mc, rc = cfg.physics, cfg.mcts, cfg.render
    s = mc.render_scale if render_scale is None else render_scale
    h, w = rc.height // s, rc.width // s
    hull_pts, hull_planes, inv_inertia, render_pts = [], [], [], []
    for o in obj_hulls:
        hp = np.asarray(o["hull_pts"], np.float32)[np.asarray(o["hull_mask"], bool)]
        eqs = np.asarray(o["hull_eqs"], np.float32)
        hull_pts.append(_f32(hp, device))
        hull_planes.append(_f32(eqs[eqs[:, 3] > FAR_PLANE_D], device))
        ext = np.maximum(hp.max(0) - hp.min(0), 1e-3)
        m = ph.object_mass / 12.0
        inv_inertia.append(_f32(1.0 / np.array([m * (ext[1] ** 2 + ext[2] ** 2),
                                                m * (ext[0] ** 2 + ext[2] ** 2),
                                                m * (ext[0] ** 2 + ext[1] ** 2)]), device))
        rp = np.asarray(o["render_pts"], np.float32)
        render_pts.append(_f32(rp[np.asarray(o["render_mask"], bool)[: len(rp)]], device))
    obs = np.asarray(obs_depth.cpu() if isinstance(obs_depth, torch.Tensor) else obs_depth,
                     np.float32)
    intr = np.asarray(intrinsics, np.float32).copy()
    intr[:2] /= s
    cam = np.asarray(cam_pose, np.float64)
    cam_inv = np.eye(4)
    cam_inv[:3, :3] = cam[:3, :3].T
    cam_inv[:3, 3] = -cam[:3, :3].T @ cam[:3, 3]
    radius = mc.leaf_splat_radius if mc.leaf_splat_radius >= 0 else (1 if s == 1 else 0)
    return SearchScene(
        hull_pts=hull_pts, hull_planes=hull_planes, inv_inertia=inv_inertia,
        render_pts=render_pts, hyp_world=_f32(hyp_world, device),
        obs=_f32(obs[::s, ::s][:h, :w], device), intrinsics=_f32(intr, device),
        cam_inv=_f32(cam_inv, device),
        table_planes=_box_planes(_f32(table_pose, device), _f32(ph.table_half_extents, device)),
        physics=dict(gravity=ph.gravity, steps=ph.steps, substeps=ph.substeps, dt=ph.dt,
                     damping=ph.damping, friction=ph.friction, restitution=ph.restitution,
                     mass=ph.object_mass),
        sequential=bool(mc.sequential_settle), splat_radius=int(radius),
        max_depth=float(rc.max_render_depth), threshold=float(rc.explanation_threshold))


# ------------------------------------------------------------- rotations


def quat_of(rot: torch.Tensor) -> torch.Tensor:
    """A rotation matrix's unit quaternion (w, x, y, z), by the largest of
    the four diagonal forms."""
    m = rot
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    forms = torch.stack([1.0 + tr, 1.0 + m[0, 0] - m[1, 1] - m[2, 2],
                         1.0 - m[0, 0] + m[1, 1] - m[2, 2], 1.0 - m[0, 0] - m[1, 1] + m[2, 2]])
    i = int(torch.argmax(forms))
    big = forms[i]
    if i == 0:
        q = [big, m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]]
    elif i == 1:
        q = [m[2, 1] - m[1, 2], big, m[0, 1] + m[1, 0], m[0, 2] + m[2, 0]]
    elif i == 2:
        q = [m[0, 2] - m[2, 0], m[0, 1] + m[1, 0], big, m[1, 2] + m[2, 1]]
    else:
        q = [m[1, 0] - m[0, 1], m[0, 2] + m[2, 0], m[1, 2] + m[2, 1], big]
    q = torch.stack(q)
    return q / torch.linalg.norm(q)


def rot_of(q: torch.Tensor) -> torch.Tensor:
    """The rotation matrix of a quaternion (w, x, y, z), normalised first."""
    w, x, y, z = q / torch.linalg.norm(q)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])


def _integrate(q: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """q' = normalize(q + 1/2 (0, omega) q): omega is the rotation of the step."""
    w, x, y, z = q
    a, b, c = omega
    dq = torch.stack([-a * x - b * y - c * z,
                      a * w + b * z - c * y,
                      b * w - a * z + c * x,
                      c * w + a * y - b * x])
    q2 = q + 0.5 * dq
    return q2 / torch.clamp(torch.linalg.norm(q2), min=1e-12)


def _planes_in_world(planes: torch.Tensor, rot: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Object-frame planes n.x + d = 0 under the pose (rot, pos): the normal
    turns with the body, and d moves by the normal's reach to pos."""
    n = planes[:, :3] @ rot.T
    return torch.cat([n, (planes[:, 3] - n @ pos)[:, None]], dim=1)


def _box_planes(pose: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    """The six outward faces of a box of half extents `half` at `pose`."""
    rows = []
    for axis in range(3):
        for sign in (1.0, -1.0):
            n = [0.0, 0.0, 0.0]
            n[axis] = sign
            rows.append(torch.cat([torch.tensor(n, device=half.device), -half[axis:axis + 1]]))
    return _planes_in_world(torch.stack(rows), pose[:3, :3], pose[:3, 3])


# ------------------------------------------------------------ the settle


def _contact(verts: torch.Tensor, planes: torch.Tensor):
    """The contact of a body's world vertices [P, 3] with one convex
    collider's world planes [F, 4]: (depth, normal, point), None where no
    vertex is inside."""
    sd = verts @ planes[:, :3].T + planes[:, 3]  # [P, F] signed distance to each face
    inside = -torch.amax(sd, dim=1)  # > 0 behind every face
    pen = torch.clamp(inside, min=0.0)
    depth = torch.amax(pen)
    if not depth > 0:
        return None
    deepest = int(torch.argmax(pen))
    normal = planes[int(torch.argmax(sd[deepest])), :3]
    point = (pen[:, None] * verts).sum(0) / pen.sum()
    return depth, normal, point


def _settle_one(sc: SearchScene, obj: int, rot: torch.Tensor, pos: torch.Tensor, colliders):
    """Settle object `obj` from (rot, pos) among `colliders` (world plane
    sets: the table and the static hulls); returns its quaternion and
    position."""
    ph = sc.physics
    h = ph["dt"] / ph["substeps"]
    inv_m = 1.0 / ph["mass"]
    inv_i = sc.inv_inertia[obj]
    tan = min(max(0.8 * ph["friction"], 0.0), 1.0)
    hull = sc.hull_pts[obj]
    dev = pos.device
    q = quat_of(rot)
    p = pos.clone()
    v = torch.zeros(3, device=dev)
    omega = torch.zeros(3, device=dev)
    g = torch.tensor([0.0, 0.0, ph["gravity"] * h], device=dev)
    for _ in range(ph["steps"] * ph["substeps"]):
        v = v + g
        p = p + v * h
        q = _integrate(q, omega * h)
        r_body = rot_of(q)
        verts = hull @ r_body.T + p
        contacts = [c for c in (_contact(verts, planes) for planes in colliders) if c is not None]
        i_world = r_body @ torch.diag(inv_i) @ r_body.T
        dpos = torch.zeros(3, device=dev)
        dang_pos = torch.zeros(3, device=dev)
        dv = torch.zeros(3, device=dev)
        dw = torch.zeros(3, device=dev)
        for depth, n, point in contacts:
            r = point - p
            rxn = torch.linalg.cross(r, n)
            k_eff = inv_m + rxn @ (i_world @ rxn)
            impulse = depth / torch.clamp(k_eff, min=1e-9) * n
            dpos = dpos + inv_m * impulse
            dang_pos = dang_pos + i_world @ torch.linalg.cross(r, impulse)
            v_pt = v + torch.linalg.cross(omega, r)
            vn = v_pt @ n
            fix = -(1.0 + ph["restitution"]) * torch.clamp(vn, max=0.0) * n
            fix = fix - tan * (v_pt - vn * n)
            dv = dv + fix
            dw = dw + i_world @ torch.linalg.cross(r, fix)
        count = max(len(contacts), 1)
        q = _integrate(q, dang_pos)
        p = p + dpos
        v = (v + dv / count) * ph["damping"]
        omega = (omega + 0.5 * dw / count) * ph["damping"]
    return q, p


def settle(sc: SearchScene, choices, active) -> torch.Tensor:
    """The settled world poses [K, 4, 4] of one assignment: choices [K]
    (hypothesis index; -1 for an object not placed, which keeps its first
    hypothesis's pose), active [K] bool. Objects are placed in index order.
    Every pose, moved or not, goes through its quaternion once."""
    k, c = sc.hyp_world.shape[:2]
    quat, pos = [], []
    for i in range(k):
        pose = sc.hyp_world[i, min(max(int(choices[i]), 0), c - 1)]
        quat.append(quat_of(pose[:3, :3]))
        pos.append(pose[:3, 3].clone())
    placed = [i for i in range(k) if bool(active[i])]
    dynamic = placed if sc.sequential else placed[-1:]
    for obj in dynamic:
        statics = placed[:placed.index(obj)] if sc.sequential else placed[:-1]
        colliders = [sc.table_planes] + [
            _planes_in_world(sc.hull_planes[j], rot_of(quat[j]), pos[j]) for j in statics]
        quat[obj], pos[obj] = _settle_one(sc, obj, rot_of(quat[obj]), pos[obj], colliders)
    out = torch.zeros(k, 4, 4, device=sc.hyp_world.device)
    for i in range(k):
        out[i, :3, :3] = rot_of(quat[i])
        out[i, :3, 3] = pos[i]
        out[i, 3, 3] = 1.0
    return out


# --------------------------------------------------- the render and the cost


def render(sc: SearchScene, poses_w: torch.Tensor, active) -> torch.Tensor:
    """The z-min depth [h, w] of the placed objects' render points at world
    poses [K, 4, 4]; 0 where nothing lands or the nearest point lies beyond
    the cut. A point projects to the pixel nearest its image position and
    covers the (2 r + 1)^2 pixels around it. Each pixel keeps the nearest
    point that covers it: the points are sorted by depth and each pixel
    takes the first of its own."""
    h, w = sc.obs.shape
    dev = sc.obs.device
    cols, rows, zs = [], [], []
    for i in range(poses_w.shape[0]):
        if not bool(active[i]):
            continue
        pose_c = sc.cam_inv @ poses_w[i]
        pts = sc.render_pts[i] @ pose_c[:3, :3].T + pose_c[:3, 3]
        img = pts @ sc.intrinsics.T
        z = img[:, 2]
        front = z > 0
        z = z[front]
        cols.append(torch.floor(img[front, 0] / z + 0.5).long())
        rows.append(torch.floor(img[front, 1] / z + 0.5).long())
        zs.append(z)
    depth = torch.zeros(h * w, device=dev)
    if not zs:
        return depth.reshape(h, w)
    col, row, z = torch.cat(cols), torch.cat(rows), torch.cat(zs)
    taps = range(-sc.splat_radius, sc.splat_radius + 1)
    pix, tz = [], []
    for dr in taps:
        for dc in taps:
            r, c = row + dr, col + dc
            ok = (r >= 0) & (r < h) & (c >= 0) & (c < w)
            pix.append((r * w + c)[ok])
            tz.append(z[ok])
    pix, tz = torch.cat(pix), torch.cat(tz)
    by_z = torch.argsort(tz, stable=True)
    pix, tz = pix[by_z], tz[by_z]
    by_pix = torch.argsort(pix, stable=True)
    pix, tz = pix[by_pix], tz[by_pix]
    first = torch.ones_like(pix, dtype=torch.bool)
    first[1:] = pix[1:] != pix[:-1]
    depth[pix[first]] = tz[first]
    if sc.max_depth > 0:
        depth = torch.where(depth > sc.max_depth, torch.zeros_like(depth), depth)
    return depth.reshape(h, w)


def cost(sc: SearchScene, rendered: torch.Tensor) -> float:
    """Pixels unexplained: over the pixels where observed and rendered depth
    differ by more than the threshold, observed-occupied plus
    rendered-occupied minus both."""
    differ = (sc.obs - rendered).abs() > sc.threshold
    ob = differ & (sc.obs > 0)
    ren = differ & (rendered > 0)
    return float(ob.sum() + ren.sum() - (ob & ren).sum())


def leaf(sc: SearchScene, choices, active) -> tuple:
    """One leaf of the search: (cost, settled world poses [K, 4, 4])."""
    with strict_fp32():
        settled = settle(sc, choices, active)
        return cost(sc, render(sc, settled, active)), settled


def nudged(sc: SearchScene, seed: int) -> SearchScene:
    """The scene with every hypothesis's position moved by up to NUDGE_M in
    each axis, drawn from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    step = (torch.rand(sc.hyp_world.shape[:2] + (3,), generator=gen) * 2 - 1) * NUDGE_M
    hyp = sc.hyp_world.clone()
    hyp[..., :3, 3] += step.to(hyp.device)
    return dataclasses.replace(sc, hyp_world=hyp)


def within(d: dict, limit: dict = TOL) -> bool:
    return all(d[k] <= limit[k] for k in limit)


def agree(sc: SearchScene, choices, active, program: tuple, nudges: int = NUDGES) -> tuple:
    """(the deviation of the program's (cost, settled) from this
    reference's leaf, and how it agrees: "as_is" within TOL; "spread"
    within SPREAD_FACTOR times this reference's own spread under `nudges`
    nudged inputs; None where it does not)."""
    ref = leaf(sc, choices, active)
    d = deviation(program, ref)
    if within(d):
        return d, "as_is"
    if not nudges:
        return d, None
    spread = dict.fromkeys(TOL, 0.0)
    for k in range(1, nudges + 1):
        c, st = leaf(nudged(sc, k), choices, active)
        dk = deviation((c, st.cpu().numpy()), ref)
        spread = {n: max(v, dk[n]) for n, v in spread.items()}
    limit = {n: max(TOL[n], SPREAD_FACTOR * spread[n]) for n in TOL}
    return d, "spread" if within(d, limit) else None


def compare(leaves, share: float = UNRESOLVED_SHARE) -> dict:
    """Hold the program's leaves to this reference: `leaves` are (scene,
    choices, active, (cost, settled)). The comparison passes where at most
    `share` of them disagree (agree() says None). Once more than that
    disagree it has failed, and the rest are compared as they are, without
    nudges. Returns the counts and the largest deviations: over every leaf,
    and over the leaves that agree as they are."""
    allowed = int(share * len(leaves))
    zero = dict.fromkeys(TOL, 0.0)
    out = {"leaves": len(leaves), "as_is": 0, "spread": 0, "disagree": 0,
           "max": dict(zero), "max_as_is": dict(zero)}
    for sc, choices, active, program in leaves:
        d, how = agree(sc, choices, active, program, NUDGES if out["disagree"] <= allowed else 0)
        out["max"] = {n: max(v, d[n]) for n, v in out["max"].items()}
        if how == "as_is":
            out["max_as_is"] = {n: max(v, d[n]) for n, v in out["max_as_is"].items()}
        out["disagree" if how is None else how] += 1
    out["ok"] = bool(leaves) and out["disagree"] <= allowed
    return out


def deviation(program: tuple, reference: tuple) -> dict:
    """How far the program's (cost, settled [K, 4, 4]) of one leaf lies from
    the reference's: cost in pixels, position in m and rotation entries,
    over every object of the leaf."""
    (c_p, s_p), (c_r, s_r) = program, reference
    s_p = torch.as_tensor(np.asarray(s_p), dtype=torch.float32)
    s_r = s_r.detach().cpu()
    return {"cost_px": abs(float(c_p) - float(c_r)),
            "pos_m": float((s_p[:, :3, 3] - s_r[:, :3, 3]).abs().max()),
            "rot": float((s_p[:, :3, :3] - s_r[:, :3, :3]).abs().max())}
