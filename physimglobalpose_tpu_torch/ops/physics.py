"""Rigid-body settle by position-based dynamics, in place of Bullet.

Reference (PhySim.cpp): a btDiscreteDynamicsWorld with gravity (0,0,-2), a
static table box (half extents 0.4x0.4x0.2), convex-hull collision shapes,
damping 0.99, friction 1.0, restitution 0; each MCTS node places previously
decided objects as static (mass 0), the new object dynamic (mass 10), steps
and reads back the settled pose (UCTState::correctPhysics).

The model is the JAX package's (physimglobalpose_tpu/ops/physics.py):
contacts are convex vertex-face, object hull vertices against convex plane
sets (other objects' hulls and the table box, which is one more 6-face
collider). All candidates are evaluated densely with masks. Per substep,
each body's contacts against every collider go into one Jacobi solve
(velocity fixes averaged over active contacts); bodies are Gauss-Seidel
ordered in the general solver. Vertex-face contact cannot see two convex
shapes with exactly coincident lateral boundaries (equal boxes perfectly
stacked); real hulls have distinct footprints.

Every function takes a leading batch of rows where the JAX package vmaps:
settle over a batch of initial states, settle_single_dynamic over rows that
each carry their own dynamic body, placement mask and static poses (the MCTS
leaf batch). The substep chain runs eagerly, so its launches are counted
per substep, not per row.

State layout (per row): K bodies x (quat wxyz [4], pos [3], linvel [3],
angvel [3]). Static bodies have inv_mass 0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)
from physimglobalpose_tpu_torch.geometry import se3


class PhysicsScene(NamedTuple):
    """Physics inputs for K bodies. hull_mask, inv_mass and body_active may
    carry a leading batch of rows ([B, K, P], [B, K], [B, K]) for
    settle_single_dynamic."""

    hull_pts: torch.Tensor  # [K, P, 3] object-local hull vertices
    hull_mask: torch.Tensor  # [K, P]
    hull_eqs: torch.Tensor  # [K, F, 4] object-local hull face planes
    inv_mass: torch.Tensor  # [K] 0 for static
    inv_inertia: torch.Tensor  # [K, 3] diagonal body-frame inverse inertia
    table_pose: torch.Tensor  # [4, 4] world
    table_half_extents: torch.Tensor  # [3]
    # [K] bool, or None = all active. An inactive body is absent from the
    # world: no contacts in either role (the reference's correctPhysics adds
    # only placed objects to the Bullet world, UCTState.cpp:208-270).
    body_active: Optional[torch.Tensor] = None


def box_inv_inertia(hull_pts: torch.Tensor, hull_mask: torch.Tensor, mass: float) -> torch.Tensor:
    """Diagonal inverse inertia of the hull's AABB as a solid box."""
    big = 1e9
    lo = torch.amin(torch.where(hull_mask[:, None], hull_pts, big), dim=0)
    hi = torch.amax(torch.where(hull_mask[:, None], hull_pts, -big), dim=0)
    ext = torch.clamp(hi - lo, min=1e-3)
    ixx = mass / 12.0 * (ext[1] ** 2 + ext[2] ** 2)
    iyy = mass / 12.0 * (ext[0] ** 2 + ext[2] ** 2)
    izz = mass / 12.0 * (ext[0] ** 2 + ext[1] ** 2)
    return 1.0 / torch.stack([ixx, iyy, izz])


def _quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def _integrate_quat(q, omega, dt):
    """q' = q + dt/2 * (0, omega) * q, renormalized."""
    oq = torch.cat([torch.zeros_like(omega[..., :1]), omega], dim=-1)
    q2 = q + 0.5 * dt * _quat_mul(oq, q)
    return q2 / torch.clamp(torch.linalg.norm(q2, dim=-1, keepdim=True), min=1e-12)


def _box_local_planes(half_extents: torch.Tensor) -> torch.Tensor:
    """[6, 4] outward face planes of an axis-aligned box (local frame)."""
    # Made on the tensors' device (no host copy): +x, -x, +y, -y, +z, -z.
    e = torch.eye(3, device=half_extents.device)
    n = torch.stack([e, -e], dim=1).reshape(6, 3)
    d = -torch.stack([half_extents, half_extents], dim=1).reshape(6)
    return torch.cat([n, d[:, None]], dim=-1)


def _planes_to_world(rot, pos, eqs):
    """Local plane set [..., F, 4] -> world frame under pose (rot [..., 3, 3],
    pos [..., 3]).

    n_l.x_l + d = 0 with x_l = R^T (x_w - p)  =>  (R n_l).x_w + (d - (R n_l).p).
    """
    n_w = eqs[..., :3] @ rot.transpose(-1, -2)
    d_w = eqs[..., 3] - (n_w @ pos[..., :, None])[..., 0]
    return torch.cat([n_w, d_w[..., None]], dim=-1)


def _planeset_contact(world_pts, mask, planes):
    """Contact of vertex sets against convex plane sets (world frame),
    batched over leading dims: world_pts [..., P, 3], mask [..., P],
    planes [..., F, 4].

    Normal from the deepest vertex's closest face; lever arm from the
    penetration-weighted centroid of all penetrating vertices.
    Returns (centroid [..., 3], normal [..., 3], max_pen [...], active [...]).
    """
    sd = world_pts @ planes[..., :3].transpose(-1, -2) + planes[..., None, :, 3]  # [..., P, F]
    planes = planes.expand(sd.shape[:-2] + planes.shape[-2:])
    inside = -torch.amax(sd, dim=-1)  # >0 when inside the hull
    face = torch.argmax(sd, dim=-1)  # closest face per vertex
    pen = torch.where(mask & (inside > 0), inside, 0.0)
    best = torch.argmax(pen, dim=-1)
    wsum = torch.sum(pen, dim=-1)
    centroid = torch.sum(world_pts * pen[..., None], dim=-2) / torch.clamp(wsum, min=1e-12)[..., None]
    face_best = torch.gather(face, -1, best[..., None])  # [..., 1]
    idx = face_best[..., None].expand(face_best.shape + (3,))
    n_w = torch.gather(planes[..., :3], -2, idx)[..., 0, :]
    max_pen = torch.amax(pen, dim=-1)
    return centroid, n_w, max_pen, max_pen > 0


def _solve_contacts(
    pos, quat, linvel, angvel, inv_mass, inv_inertia,
    centroids, normals, depths, act,
    friction=1.0, restitution=0.0, rot=None,
):
    """Jacobi solve of C simultaneous contacts of one body per row.

    pos/linvel/angvel [B, 3], quat [B, 4], inv_mass [B], inv_inertia [B, 3],
    centroids/normals [B, C, 3], depths/act [B, C].
    Material model (PhySim.cpp:53-79 semantics): restitution e reflects the
    inward normal velocity to -e*vn; friction mu removes min(1, 0.8*mu) of
    the tangential contact-point velocity per solve. Positional corrections
    are summed over contacts; velocity fixes are averaged over active
    contacts. Returns additive deltas (dpos, drot_vec, dlinvel, dangvel),
    each [B, 3].
    """
    if rot is None:
        rot = se3.quat_to_matrix(quat)
    inv_i_world = rot @ torch.diag_embed(inv_inertia) @ rot.transpose(-1, -2)  # [B, 3, 3]
    r = centroids - pos[:, None, :]  # [B, C, 3]
    rxn = torch.linalg.cross(r, normals)
    w = inv_mass[:, None] + torch.sum(rxn * (rxn @ inv_i_world.transpose(-1, -2)), dim=-1)
    lam = torch.where(act & (w > 0), depths / torch.clamp(w, min=1e-9), 0.0)
    p_imp = lam[..., None] * normals
    dpos = torch.sum(p_imp, dim=1) * inv_mass[:, None]
    drot = (inv_i_world @ torch.sum(torch.linalg.cross(r, p_imp), dim=1)[..., None])[..., 0]
    v_pt = linvel[:, None, :] + torch.linalg.cross(angvel[:, None, :].expand_as(r), r)
    vn = torch.sum(v_pt * normals, dim=-1)
    v_norm_fix = torch.where(act & (vn < 0), -(1.0 + restitution) * vn, 0.0)[..., None] * normals
    tan_coeff = min(max(0.8 * friction, 0.0), 1.0)
    v_tan = v_pt - vn[..., None] * normals
    v_tan_fix = torch.where(act, -tan_coeff, 0.0)[..., None] * v_tan
    dv_each = v_norm_fix + v_tan_fix
    n_act = torch.clamp(torch.sum(act.to(dv_each.dtype), dim=1), min=1.0)[:, None]
    dlin = torch.sum(dv_each, dim=1) / n_act
    # The 0.5 under-relaxes the angular velocity correction; full-strength
    # coupling makes single-point contact patches ring (solver stabilization
    # constant, not a material parameter).
    dang = (inv_i_world @ torch.sum(torch.linalg.cross(r, dv_each), dim=1)[..., None])[..., 0]
    dang = dang * 0.5 / n_act
    use = (inv_mass > 0)[:, None]
    return (
        torch.where(use, dpos, 0.0),
        torch.where(use, drot, 0.0),
        torch.where(use, dlin, 0.0),
        torch.where(use, dang, 0.0),
    )


def _contact_deltas(
    pos, quat, linvel, angvel, inv_mass, inv_inertia, r, n, depth, active,
    friction=1.0, restitution=0.0,
):
    """Single-contact deltas of one body (unit-test surface; see _solve_contacts)."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    pos = f32(pos)
    deltas = _solve_contacts(
        pos[None], f32(quat)[None], f32(linvel)[None], f32(angvel)[None],
        f32(inv_mass).reshape(1), f32(inv_inertia)[None],
        (pos + f32(r))[None, None], f32(n)[None, None], f32(depth).reshape(1, 1),
        torch.as_tensor(active).reshape(1, 1),
        friction=friction, restitution=restitution,
    )
    return tuple(d[0] for d in deltas)


def _apply_contact(
    pos, quat, linvel, angvel, inv_mass, inv_inertia, r, n, depth, active,
    friction=1.0, restitution=0.0,
):
    """Positional contact resolution: apply one contact's deltas."""
    dpos, drot, dlin, dang = _contact_deltas(
        pos, quat, linvel, angvel, inv_mass, inv_inertia, r, n, depth, active,
        friction=friction, restitution=restitution,
    )
    quat = torch.as_tensor(quat, dtype=torch.float32)
    use = bool(active) and float(inv_mass) > 0
    new_quat = _integrate_quat(quat, drot, 1.0) if use else quat
    return pos + dpos, new_quat, linvel + dlin, angvel + dang


def settle(
    scene: PhysicsScene,
    init_quat: torch.Tensor,  # [..., K, 4] world
    init_pos: torch.Tensor,  # [..., K, 3] world
    steps: int = 60,
    substeps: int = 2,
    dt: float = 1.0 / 60.0,
    gravity: float = -2.0,
    damping: float = 0.99,
    friction: float = 1.0,
    restitution: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Settle K bodies, every body free to move; returns (quat, pos) of the
    shape of the inputs. A leading batch of initial states settles together
    against the one scene."""
    batch = init_quat.shape[:-2]
    k = scene.hull_pts.shape[0]
    quat = init_quat.reshape(-1, k, 4)
    pos = init_pos.reshape(-1, k, 3)
    b = quat.shape[0]
    dev = quat.device
    h = dt / substeps
    moving = (scene.inv_mass > 0)[None, :, None]  # [1, K, 1]
    gstep = torch.zeros(3, device=dev)
    gstep[2] = gravity * h
    table_planes = _planes_to_world(
        scene.table_pose[:3, :3], scene.table_pose[:3, 3],
        _box_local_planes(scene.table_half_extents),
    )  # [6, 4], constant through the settle
    inv_mass = scene.inv_mass.expand(b, k)
    inv_inertia = scene.inv_inertia.expand(b, k, 3)
    not_self = ~torch.eye(k, dtype=torch.bool, device=dev)

    linvel = torch.zeros(b, k, 3, device=dev)
    angvel = torch.zeros(b, k, 3, device=dev)
    for _ in range(steps * substeps):
        linvel = linvel + torch.where(moving, gstep, 0.0)
        pos = pos + linvel * h
        quat = _integrate_quat(quat, angvel * h, 1.0)
        # One Jacobi solve per body of all its contacts (the other hulls and
        # the table box), Gauss-Seidel across bodies: body a sees 0..a-1
        # already corrected.
        for a in range(k):
            rot_a = se3.quat_to_matrix(quat[:, a])  # [B, 3, 3]
            world_a = scene.hull_pts[a] @ rot_a.transpose(-1, -2) + pos[:, a, None, :]  # [B, P, 3]
            mask_a = scene.hull_mask[a]
            planes_b = _planes_to_world(
                se3.quat_to_matrix(quat), pos, scene.hull_eqs
            )  # [B, K, F, 4]
            cs, ns, ds, acts = _planeset_contact(world_a[:, None], mask_a, planes_b)
            acts = acts & not_self[a]
            ct, nt, d_t, at_t = _planeset_contact(world_a, mask_a, table_planes)
            if scene.body_active is not None:
                acts = acts & scene.body_active[a] & scene.body_active
                at_t = at_t & scene.body_active[a]
            dpos, drot, dlin, dang = _solve_contacts(
                pos[:, a], quat[:, a], linvel[:, a], angvel[:, a],
                inv_mass[:, a], inv_inertia[:, a],
                torch.cat([cs, ct[:, None]], dim=1), torch.cat([ns, nt[:, None]], dim=1),
                torch.cat([ds, d_t[:, None]], dim=1), torch.cat([acts, at_t[:, None]], dim=1),
                friction=friction, restitution=restitution, rot=rot_a,
            )
            sel = torch.arange(k, device=dev)[None, :, None] == a  # [1, K, 1]
            quat = torch.where(sel, _integrate_quat(quat[:, a], drot, 1.0)[:, None], quat)
            pos = torch.where(sel, (pos[:, a] + dpos)[:, None], pos)
            linvel = torch.where(sel, (linvel[:, a] + dlin)[:, None], linvel)
            angvel = torch.where(sel, (angvel[:, a] + dang)[:, None], angvel)
        linvel = linvel * damping
        angvel = angvel * damping
    return quat.reshape(batch + (k, 4)), pos.reshape(batch + (k, 3))


def _pad_faces(planes: torch.Tensor, f_max: int) -> torch.Tensor:
    """Pad a [..., F', 4] plane set to f_max with far planes (never the
    nearest face, never penetrated)."""
    short = f_max - planes.shape[-2]
    if short <= 0:
        return planes
    far = torch.zeros(planes.shape[:-2] + (short, 4), device=planes.device)
    far[..., 2] = 1.0
    far[..., 3] = -1e9
    return torch.cat([planes, far], dim=-2)


def settle_single_dynamic(
    scene: PhysicsScene,
    init_quat: torch.Tensor,  # [..., K, 4] world
    init_pos: torch.Tensor,  # [..., K, 3] world
    dyn_idx: torch.Tensor,  # [...] int; -1 = no dynamic body (no-op)
    steps: int = 60,
    substeps: int = 2,
    dt: float = 1.0 / 60.0,
    gravity: float = -2.0,
    damping: float = 0.99,
    friction: float = 1.0,
    restitution: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """settle() with exactly one dynamic body per row (index dyn_idx).

    The MCTS leaf evaluator always settles one dynamic body (the reference's
    correctPhysics adds one btRigidBody with mass > 0 per node,
    UCTState.cpp:208-270). Static bodies never move, so only the dynamic
    body's state is carried; all colliders' face planes (the K static hulls
    and the table box) are put in the world frame once and packed into one
    [(K+1)*F, 4] set, and each substep's contact detection is one
    [P, (K+1)*F] product plus per-collider reductions. Equal to settle()
    with one inv_mass > 0 body, except that static quats skip settle()'s
    idempotent renormalization.

    Rows: init_quat/init_pos/dyn_idx may carry a leading batch, and with it
    scene.hull_mask, scene.inv_mass and scene.body_active ([B, K, P],
    [B, K], [B, K]). hull_pts, hull_eqs, inv_inertia and the table pose are
    shared by every row, or carry the batch too ([B, K, P, 3], [B, K, F, 4],
    [B, K, 3], [B, 4, 4]: rows of different scenes, the multi-scene leaf
    batch).
    """
    batch = init_quat.shape[:-2]
    k, p_max = scene.hull_pts.shape[-3:-1]
    f_max = max(scene.hull_eqs.shape[-2], 6)
    quat0 = init_quat.reshape(-1, k, 4)
    pos0 = init_pos.reshape(-1, k, 3)
    b = quat0.shape[0]
    dev = quat0.device
    dyn_idx = torch.as_tensor(dyn_idx, device=dev).reshape(b)
    hull_mask = scene.hull_mask.reshape(-1, k, p_max).expand(b, k, p_max)
    inv_mass = scene.inv_mass.reshape(-1, k).expand(b, k)
    h = dt / substeps
    rows = torch.arange(b, device=dev)
    has = dyn_idx >= 0
    dyn = torch.clamp(dyn_idx, 0, k - 1).to(torch.int64)

    inv_mass_d = torch.where(has, inv_mass[rows, dyn], 0.0)  # [B]
    inv_inertia_d = scene.inv_inertia.expand(b, k, 3)[rows, dyn]  # [B, 3]
    hull_d = scene.hull_pts.expand(b, k, p_max, 3)[rows, dyn]  # [B, P, 3]
    mask_d = hull_mask[rows, dyn]  # [B, P]
    active_d = has
    coll_ok = torch.arange(k, device=dev)[None, :] != dyn[:, None]  # [B, K]
    if scene.body_active is not None:
        body_active = scene.body_active.reshape(-1, k).expand(b, k)
        active_d = has & body_active[rows, dyn]
        coll_ok = coll_ok & body_active
    coll_ok = torch.cat([coll_ok, torch.ones_like(coll_ok[:, :1])], dim=1)  # table always

    # Static colliders never move: their world planes are constants.
    eqs_world = _planes_to_world(
        se3.quat_to_matrix(quat0), pos0, scene.hull_eqs
    )  # [B, K, F', 4]
    table_planes = _planes_to_world(
        scene.table_pose[..., :3, :3], scene.table_pose[..., :3, 3],
        _box_local_planes(scene.table_half_extents),
    )  # [6, 4], or [B, 6, 4] with a table a row
    table_planes = _pad_faces(table_planes, f_max).reshape(-1, 1, f_max, 4)
    planes_all = torch.cat(
        [_pad_faces(eqs_world, f_max), table_planes.expand(b, 1, f_max, 4)], dim=1,
    )  # [B, K+1, F, 4]
    pl3 = planes_all[..., :3].reshape(b, -1, 3).transpose(-1, -2)  # [B, 3, (K+1)F]
    pld = planes_all[..., 3].reshape(b, 1, -1)
    normals_all = planes_all[..., :3]
    gvec = torch.zeros(b, 3, device=dev)
    gvec[:, 2] = torch.where(inv_mass_d > 0, gravity * h, 0.0)
    pen_ok = mask_d[:, :, None] & coll_ok[:, None, :]  # [B, P, K+1]

    q_d = quat0[rows, dyn]
    p_d = pos0[rows, dyn]
    lv = torch.zeros(b, 3, device=dev)
    av = torch.zeros(b, 3, device=dev)
    for _ in range(steps * substeps):
        lv = lv + gvec
        p_d = p_d + lv * h
        q_d = _integrate_quat(q_d, av * h, 1.0)

        # Contact detection against all colliders in one product.
        rot = se3.quat_to_matrix(q_d)
        world = hull_d @ rot.transpose(-1, -2) + p_d[:, None, :]  # [B, P, 3]
        sd3 = (world @ pl3 + pld).reshape(b, p_max, k + 1, f_max)
        inside = -torch.amax(sd3, dim=-1)  # [B, P, K+1] >0 when inside
        pen = torch.where(pen_ok & (inside > 0), inside, 0.0)
        max_pen = torch.amax(pen, dim=1)  # [B, K+1]
        act = (max_pen > 0) & active_d[:, None]
        best = torch.argmax(pen, dim=1)  # [B, K+1] deepest vertex per collider
        sd_best = torch.gather(sd3, 1, best[:, None, :, None].expand(b, 1, k + 1, f_max))[:, 0]
        face = torch.argmax(sd_best, dim=-1)  # [B, K+1] its closest face
        normals = torch.gather(normals_all, 2, face[..., None, None].expand(b, k + 1, 1, 3))[:, :, 0]
        wsum = torch.sum(pen, dim=1)
        centroids = (pen.transpose(1, 2) @ world) / torch.clamp(wsum, min=1e-12)[..., None]

        dpos, drot, dlin, dang = _solve_contacts(
            p_d, q_d, lv, av, inv_mass_d, inv_inertia_d,
            centroids, normals, max_pen, act,
            friction=friction, restitution=restitution, rot=rot,
        )
        q_d = _integrate_quat(q_d, drot, 1.0)
        p_d = p_d + dpos
        lv = (lv + dlin) * damping
        av = (av + dang) * damping

    # As in settle(): an inv_mass > 0 body integrates (gravity applies even
    # when body_active masks its contacts); statics never move.
    moved = (has & (inv_mass_d > 0))[:, None, None]
    sel = (torch.arange(k, device=dev)[None, :] == dyn[:, None])[..., None] & moved  # [B, K, 1]
    quat = torch.where(sel, q_d[:, None], quat0)
    pos = torch.where(sel, p_d[:, None], pos0)
    return quat.reshape(batch + (k, 4)), pos.reshape(batch + (k, 3))


def settle_batch(scene: PhysicsScene, init_quat: torch.Tensor, init_pos: torch.Tensor, **kw):
    """A leading batch of initial poses: [B, K, 4], [B, K, 3]."""
    return settle(scene, init_quat, init_pos, **kw)


def settle_poses(scene: PhysicsScene, poses_world: torch.Tensor, **kw) -> torch.Tensor:
    """Convenience: [K, 4, 4] world poses in -> settled [K, 4, 4] out."""
    quat = se3.matrix_to_quat(poses_world[:, :3, :3])
    q2, p2 = settle(scene, quat, poses_world[:, :3, 3], **kw)
    return se3.pose_from_rot_trans(se3.quat_to_matrix(q2), p2)
