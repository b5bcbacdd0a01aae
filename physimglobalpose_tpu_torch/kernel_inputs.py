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
