"""Seeded synthetic inputs of the kernels' checks and timings.

A box model seen in a scene segment, hypotheses around its true pose, and the
packed arguments the LCP and ICP kernels' wrappers take. chip_smoke.py holds
the kernels against their plain versions on these inputs on the card,
tools/compare_lcp_kernels.py times two revisions on them, and the CPU tests
hold the plain versions against the JAX package on small ones.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from physimglobalpose_tpu_torch.ops import icp, lcp


def _rot_z(deg: float) -> np.ndarray:
    a = math.radians(deg)
    return np.array([[math.cos(a), -math.sin(a), 0.0], [math.sin(a), math.cos(a), 0.0],
                     [0.0, 0.0, 1.0]])


def _box_surface(rng, n, size):
    half = np.asarray(size) / 2.0
    areas = np.array([size[1] * size[2], size[0] * size[2], size[0] * size[1]]).repeat(2)
    face = rng.choice(6, size=n, p=areas / areas.sum())
    axis, sign = face // 2, np.where(face % 2 == 0, 1.0, -1.0)
    pts = rng.uniform(-1, 1, size=(n, 3)) * half
    nrm = np.zeros((n, 3))
    pts[np.arange(n), axis] = sign * half[axis]
    nrm[np.arange(n), axis] = sign
    return pts.astype(np.float32), nrm.astype(np.float32)


def lcp_inputs(seed: int, h: int, nv: int, ns: int, n_masked: int, device, scale: float = 1.0):
    """A box model seen in a scene segment (noise + clutter + masked rows)
    and h hypotheses scattered a few mm / degrees around the truth. scale
    enlarges the box and the clutter's spread and narrows the hypotheses'
    rotations alike; the noise of a few mm stays."""
    rng = np.random.default_rng(seed)
    mpts, mnrm = _box_surface(rng, nv, (0.12 * scale, 0.08 * scale, 0.06 * scale))
    true_rot = _rot_z(30.0) @ np.array([[1, 0, 0], [0, 0.8, -0.6], [0, 0.6, 0.8]])
    true_t = np.array([0.05, -0.02, 0.7])
    n_obj = ns - ns // 8
    idx = rng.choice(nv, size=n_obj, replace=n_obj > nv)
    spts = mpts[idx] @ true_rot.T + true_t + rng.normal(scale=0.001, size=(n_obj, 3))
    snrm = mnrm[idx] @ true_rot.T
    clutter = true_t + rng.uniform(-0.15, 0.15, size=(ns - n_obj, 3)) * scale
    cnrm = rng.normal(size=(ns - n_obj, 3))
    cnrm /= np.linalg.norm(cnrm, axis=1, keepdims=True)
    spts = np.concatenate([spts, clutter]).astype(np.float32)
    snrm = np.concatenate([snrm, cnrm]).astype(np.float32)
    sprob = rng.uniform(0.3, 1.0, size=ns).astype(np.float32)
    smask = np.ones(ns, bool)
    smask[rng.choice(ns, size=n_masked, replace=False)] = False
    tfs = np.tile(np.eye(4), (h, 1, 1))
    for k in range(h):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = rng.uniform(0, math.radians(8.0)) / scale
        kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        dr = np.eye(3) + math.sin(ang) * kx + (1 - math.cos(ang)) * kx @ kx
        tfs[k, :3, :3] = dr @ true_rot
        tfs[k, :3, 3] = true_t + rng.normal(scale=0.004, size=3)
    as_t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=device)
    return (as_t(tfs), as_t(mpts), as_t(mnrm), as_t(spts), as_t(snrm), as_t(sprob),
            as_t(smask, torch.bool))


def at_delta_inputs(device, h: int = 256, n: int = 256, delta: float = 0.005):
    """lcp_inputs-style arguments with identity hypotheses (half of them
    shifted by at most 0.2 mm) and a model whose points sit 0.5 or 1.5 delta
    from a segment point, and one in 128 exactly delta: there a nearest
    distance is on the edge of delta. (Only those few, so that the float32
    plain version, whose d2 rounds otherwise than the kernels', stays within
    2 / Nv of them.)"""
    rng = np.random.default_rng(36)
    seg = rng.uniform(-0.06, 0.06, size=(n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = np.where(np.arange(n) % 2 == 0, 0.5, 1.5) * delta
    dist[::128] = delta
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    tfs = np.tile(np.eye(4), (h, 1, 1))
    tfs[1::2, :3, 3] = rng.uniform(-2e-4, 2e-4, size=(h // 2, 3))
    as_t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=device)
    return (as_t(tfs), as_t(seg + dist[:, None] * d), as_t(nrm), as_t(seg), as_t(nrm),
            as_t(rng.uniform(0.3, 1.0, size=n)), as_t(np.ones(n, bool), torch.bool))


# Band cases: rows of segment points 0-7 placed again, in other 8-point column
# tiles and 32-point chunks of the first 256 points and in later 256-point
# chunks (the mask chunks of lcp_segside_hb's tensor-core filter).
BAND_COPIES = (197, 300, 530)


def band_inputs(device, h: int = 256, n: int = 192, ns: int = 600, delta: float = 0.005):
    """at_delta_inputs on n model points, whose first n segment points are
    followed by copies of segment points 0-7 at BAND_COPIES (own normals and
    probabilities) and by masked points: the nearest point of model point 0,
    exactly delta off, is tied in four places (two 8-point column tiles and
    three chunks of 256 points); the rest are 0.5 or 1.5 delta off."""
    tfs, mpts, mnrm, spts, snrm, sprob, smask = at_delta_inputs(device, h=h, n=n, delta=delta)
    rng = np.random.default_rng(39)
    seg = np.concatenate([spts.cpu().numpy(), rng.uniform(0.9, 1.1, size=(ns - n, 3))])
    nrm = np.concatenate([snrm.cpu().numpy(), rng.normal(size=(ns - n, 3))])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    prob = np.concatenate([sprob.cpu().numpy(), rng.uniform(0.3, 1.0, size=ns - n)])
    mask = np.arange(ns) < n
    for off in BAND_COPIES:
        seg[off:off + 8] = seg[:8]
        mask[off:off + 8] = True
    as_t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=device)
    return tfs, mpts, mnrm, as_t(seg), as_t(nrm), as_t(prob), as_t(mask, torch.bool)


def band_delta(args, matmul_precision=None, side: int = 0, delta: float = 0.005) -> float:
    """A delta for band_inputs whose delta^2, rounded to float32 as the
    kernels and the plain version round it, is the nearest d2 of one row
    (hypothesis 0, model point i < 8, the positive d2 nearest to the given
    delta's square) in the tier's plain arithmetic (side 0), one float32 step
    above it (side 1: that row is just within) or below it (side -1: just
    beyond). The rows of the other identity hypotheses tie with it. (The
    "default" tier's bf16 operands move d2 by up to a third of delta^2, so
    model point 0, exactly delta off, is not always the row nearest it.)"""
    d2 = lcp.nearest_d2_plain(args[0][:1], args[1][:8], args[3], args[6], matmul_precision)[0]
    d2 = torch.where(d2 > 0, d2, math.inf)
    v = float(d2[torch.argmin((d2 - delta * delta).abs())].cpu())
    if side:
        v = float(np.nextafter(np.float32(v), np.float32(np.inf if side > 0 else -np.inf)))
    return math.sqrt(v)


def far_hypotheses(args, seed: int = 37):
    """lcp_inputs with every other hypothesis moved 0.1-0.3 m in x and y (the
    clutter inputs' garbage half), in place."""
    rng = np.random.default_rng(seed)
    tfs = args[0]
    h = tfs.shape[0]
    off = rng.uniform(0.1, 0.3, size=(h // 2, 2)) * rng.choice((-1.0, 1.0), size=(h // 2, 2))
    tfs[1::2, :2, 3] += torch.as_tensor(off, dtype=torch.float32, device=tfs.device)
    return args


def packed_lcp_args(args, delta: float = 0.005, gate_deg: float = 30.0):
    """What lcp_scores hands the LCP kernels' wrappers for these inputs:
    (tr12, model_pts, model_nrm, segcat, delta^2, cos gate)."""
    tfs, mpts, mnrm, spts, snrm, sprob, smask = args
    seg_c, tr = lcp.center_at_segment(tfs, spts, smask)
    return (tr[:, :3, :].reshape(-1, 12).contiguous(), mpts.contiguous(), mnrm.contiguous(),
            lcp.pack_segment(seg_c, snrm, sprob, smask), delta * delta,
            math.cos(math.radians(gate_deg)))


def stream_lcp_args(args, delta: float = 0.005, gate_deg: float = 30.0):
    """What lcp_scores_stream hands the streaming kernels' wrappers for these
    inputs: (tr12, model_pts, model_nrm, segcat, delta^2, cos gate)."""
    tfs, mpts, mnrm, spts, snrm, sprob, smask = args
    return (tfs[:, :3, :].reshape(-1, 12).contiguous(), mpts.contiguous(), mnrm.contiguous(),
            lcp.pack_stream_segment(spts, snrm, sprob, smask), delta * delta,
            math.cos(math.radians(gate_deg)))


def icp_inputs(seed: int, h: int, nm: int, ns: int, n_masked: int, n_garbage: int, device):
    """The box of lcp_inputs as the ICP model; the last n_garbage hypotheses
    sit 0.5 m away, where no segment point is in range."""
    tfs, mpts, mnrm, spts, _snrm, _sprob, smask = lcp_inputs(seed, h, nm, ns, n_masked, device)
    tfs[h - n_garbage:, :3, 3] += torch.tensor([0.5, 0.5, 0.0], device=device)
    return tfs, mpts, mnrm, spts, smask


def icp_pass_args(tfs, mpts, mnrm, spts, smask):
    """(tr12, seg4, centred poses) of one correspondence pass."""
    seg_c, tr_c = lcp.center_at_segment(tfs, spts, smask)
    return tr_c[:, :3, :].reshape(-1, 12).contiguous(), icp.pack_icp_segment(seg_c, smask), tr_c


def icp_tie_inputs(device, n_seg: int = 200, n_masked: int = 12, side: int = 6):
    """A model on a lattice of spacing 4/256 m near the origin (side^3
    points in a shuffled order, random unit normals) and segment points at
    its cell centres, face centres, edge midpoints and points (8-, 4-, 2- and
    1-fold exact ties of the nearest distance) or at odd offsets; every
    coordinate is a multiple of 2^-8 m and every pose keeps it so (rotations
    by quarter turns, translations on the grid), so every d2 of the
    model-streaming pass is exact in float32 and any two computations of it
    find the same ties. Poses: the identity, a quarter turn about z, a half
    turn about x, a shift by half a cell (which swaps the roles of cell
    centres and lattice points) and one 0.7 m away (no correspondence)."""
    rng = np.random.default_rng(11)
    g = np.arange(-(side // 2), side - side // 2) * 4
    lattice = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    model = lattice[rng.permutation(len(lattice))] / 256.0
    mnrm = rng.normal(size=model.shape)
    mnrm /= np.linalg.norm(mnrm, axis=1, keepdims=True)
    offsets = np.array([[2, 2, 2], [2, 2, 0], [0, 2, 2], [2, 0, 0], [0, 0, 0], [1, 3, 0],
                        [3, 1, 2]])
    seg = (lattice[rng.choice(len(lattice), n_seg)]
           + offsets[rng.integers(len(offsets), size=n_seg)]) / 256.0
    mask = np.ones(n_seg, bool)
    mask[rng.choice(n_seg, n_masked, replace=False)] = False
    tfs = np.tile(np.eye(4), (5, 1, 1))
    tfs[1, :3, :3] = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    tfs[1, :3, 3] = np.array([4, 0, -4]) / 256.0
    tfs[2, :3, :3] = np.diag([1.0, -1.0, -1.0])
    tfs[2, :3, 3] = np.array([0, 4, 0]) / 256.0
    tfs[3, :3, 3] = np.array([2, 2, 2]) / 256.0
    tfs[4, :3, 3] = [0.5, 0.5, 0.0]
    as_t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=device)
    return as_t(tfs), as_t(model), as_t(mnrm), as_t(seg), as_t(mask, torch.bool)


def with_singular_hypothesis(tfs, mpts, mnrm, spts, smask):
    """The ICP inputs with one hypothesis more, the last, whose pass has
    exactly one correspondence and an exactly singular system: a model point
    m = (0.25, 0, 0) with normal (1, 0, 0), a segment point (0.25, 0, 2) and
    the pose (I, (0, 0, 2)), which puts m on it. There d2 = 0 exactly, w = 1,
    r = 0 and the Jacobian row is (0, 2, 0, 1, 0, 0), all powers of two, so A
    is exactly of rank one (1e-8 is lost beside 4 and 1), b = 0, and an LU
    factorisation of A + 1e-8 I meets an exact zero pivot. m lies about 20 cm from
    a model of a few centimetres, the segment point over a metre from the
    other hypotheses' models."""
    dev = tfs.device
    pose = torch.eye(4, device=dev)
    pose[2, 3] = 2.0
    cat = lambda a, row: torch.cat([a, torch.as_tensor(row, dtype=a.dtype, device=dev)[None]])
    return (torch.cat([tfs, pose[None]]), cat(mpts, [0.25, 0.0, 0.0]), cat(mnrm, [1.0, 0.0, 0.0]),
            cat(spts, [0.25, 0.0, 2.0]), cat(smask, True))


# Box sizes of the polish's objects, cycled: the benchmark's three boxes.
POLISH_BOXES = ((0.12, 0.08, 0.06), (0.07, 0.05, 0.14), (0.16, 0.1, 0.045))


def polish_inputs(seed: int, k: int, nm: int, ns: int, device, lengths=None,
                  n_valid: int | None = None):
    """The final polish's inputs for K objects: box k's surface as its model
    (model k holds lengths[k] points, zero-padded to nm), a segment of it seen
    about 0.7 m from the camera (1 mm noise, one point in eight of clutter,
    ten points masked at random, and past n_valid the masked padding of a
    fixed-size segment) and its pose a few mm and degrees off the truth.
    Returns (poses [K, 4, 4], model_pts, model_nrm [K, nm, 3], seg_pts
    [K, ns, 3], seg_mask [K, ns], lengths)."""
    rng = np.random.default_rng(seed)
    lengths = [nm] * k if lengths is None else list(lengths)
    n_valid = ns if n_valid is None else n_valid
    poses = np.tile(np.eye(4), (k, 1, 1))
    mpts, mnrm = np.zeros((k, nm, 3)), np.zeros((k, nm, 3))
    spts, smask = np.zeros((k, ns, 3)), np.zeros((k, ns), bool)
    for i in range(k):
        mp, mn = _box_surface(rng, lengths[i], POLISH_BOXES[i % len(POLISH_BOXES)])
        mpts[i, :lengths[i]], mnrm[i, :lengths[i]] = mp, mn
        true_rot = _rot_z(rng.uniform(0, 360)) @ np.array([[1, 0, 0], [0, 0.8, -0.6], [0, 0.6, 0.8]])
        true_t = np.array([0.16 * (i % 3 - 1), rng.uniform(-0.05, 0.05), 0.7])
        n_obj = n_valid - n_valid // 8
        seg = mp[rng.choice(lengths[i], size=n_obj)] @ true_rot.T + true_t
        seg += rng.normal(scale=0.001, size=seg.shape)
        clutter = true_t + rng.uniform(-0.1, 0.1, size=(n_valid - n_obj, 3))
        spts[i, :n_valid] = np.concatenate([seg, clutter])
        smask[i, :n_valid] = True
        smask[i, rng.choice(n_valid, size=min(10, n_valid), replace=False)] = False
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        poses[i, :3, :3] = _axis_angle(axis, math.radians(rng.uniform(1.0, 5.0))) @ true_rot
        poses[i, :3, 3] = true_t + rng.normal(scale=0.004, size=3)
    as_t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=device)
    return (as_t(poses), as_t(mpts), as_t(mnrm), as_t(spts), as_t(smask, torch.bool), lengths)


def settle_hulls(sizes=POLISH_BOXES, p: int = 64, f: int = 96, mass: float = 10.0,
                 round_hulls: bool = False):
    """The search's contact hulls of boxes, as the object database and the
    leaf evaluator pack them: the 8 corners padded to p points (masked), the
    qhull face planes (12 triangles a box) padded to f with the far plane,
    and the inverse inertia of the hull's box. round_hulls: the hull of the
    ellipsoid inscribed in each box instead (p vertices, as many faces as f
    keeps), the most a search hull holds. Returns numpy (hull_pts [K, p,
    3], hull_mask [K, p], hull_eqs [K, f, 4], inv_inertia [K, 3])."""
    from physimglobalpose_tpu_torch.models import assets
    from physimglobalpose_tpu_torch.ops import physics

    k = len(sizes)
    pts, mask = np.zeros((k, p, 3), np.float32), np.zeros((k, p), bool)
    eqs, inertia = np.zeros((k, f, 4), np.float32), np.zeros((k, 3), np.float32)
    for i, size in enumerate(sizes):
        half = np.asarray(size) / 2.0
        if round_hulls:
            d = np.random.default_rng(i).normal(size=(400, 3))
            hull = assets.convex_hull_points((d / np.linalg.norm(d, axis=1, keepdims=True) * half)
                                             .astype(np.float32), p)
        else:
            hull = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]) * half
        n = len(hull)
        pts[i, :n], mask[i, :n] = hull, True
        eqs[i] = assets.convex_hull_planes(pts[i, :n], max_faces=f)
        inertia[i] = physics.box_inv_inertia(torch.as_tensor(pts[i, :n]),
                                             torch.ones(n, dtype=torch.bool), mass).numpy()
    return pts, mask, eqs, inertia


def settle_inputs(seed: int, b: int, device, sequential: bool = True, per_row: bool = False,
                  p: int = 64, f: int = 96, round_hulls: bool = False):
    """Leaf rows of the search's in-order settle on the benchmark's three
    boxes: placements as the tree makes them (each row places a random
    subset of the objects, one row in eight none), each box at a hypothesis
    near a stack on a table whose top is at z = 0 (box 0 on the table, box
    1 on box 0, box 2 beside them), moved by up to 8 mm and turned by up to
    10 degrees about a random axis, so that some start inside what lies
    under them and some above it. per_row: each row carries its own
    constants (the multi-scene leaf batch): the boxes in a row's own order
    and the table's height and tilt drawn a row. round_hulls: settle_hulls'. Returns (consts, quat [B,
    3, 4], pos [B, 3, 3], dyn, placed) as _settle_render_cost hands them to
    physics.settle_in_order."""
    from physimglobalpose_tpu_torch.geometry import se3
    from physimglobalpose_tpu_torch.pipeline import mcts

    rng = np.random.default_rng(seed)
    k = len(POLISH_BOXES)
    pts, mask, eqs, inertia = settle_hulls(POLISH_BOXES, p, f, round_hulls=round_hulls)
    order = np.stack([rng.permutation(k) if per_row else np.arange(k) for _ in range(b)])
    table = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    table[:, 2, 3] = -0.2  # the top face at z = 0
    if per_row:
        table[:, 2, 3] += rng.uniform(-0.05, 0.05, b)
        for r in range(b):
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            table[r, :3, :3] = _axis_angle(axis, math.radians(rng.uniform(0.0, 3.0)))
    poses = np.tile(np.eye(4), (b, k, 1, 1))
    for r in range(b):
        sizes = [POLISH_BOXES[i] for i in order[r]]
        top = table[r, 2, 3] + 0.2
        centres = [(0.0, 0.0, top + sizes[0][2] / 2),
                   (0.01, -0.005, top + sizes[0][2] + sizes[1][2] / 2),
                   (0.15, 0.02, top + sizes[2][2] / 2)]
        for i in range(k):
            axis = rng.normal(size=3)
            axis /= np.linalg.norm(axis)
            rot = _axis_angle(axis, math.radians(rng.uniform(0.0, 10.0))) @ _rot_z(rng.uniform(-20, 20))
            poses[r, i, :3, :3] = rot
            poses[r, i, :3, 3] = np.asarray(centres[i]) + rng.uniform(-0.008, 0.008, 3)
    active = rng.random((b, k)) < 0.7
    active[::8] = False
    as_t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    if per_row:
        consts = dict(hull_pts=as_t(pts[order]), hull_mask=as_t(mask[order], torch.bool),
                      hull_eqs=as_t(eqs[order]), inv_inertia=as_t(inertia[order]),
                      table_pose=as_t(table))
    else:
        consts = dict(hull_pts=as_t(pts), hull_mask=as_t(mask, torch.bool), hull_eqs=as_t(eqs),
                      inv_inertia=as_t(inertia), table_pose=as_t(table[0]))
    consts["table_half_extents"] = as_t([0.4, 0.4, 0.2])
    poses_t = as_t(poses)
    dyn, placed = mcts._placement_order(as_t(active, torch.bool), sequential)
    return (consts, se3.matrix_to_quat(poses_t[..., :3, :3]), poses_t[..., :3, 3].contiguous(),
            dyn, placed)


def _axis_angle(axis, ang: float) -> np.ndarray:
    kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + math.sin(ang) * kx + (1 - math.cos(ang)) * kx @ kx
