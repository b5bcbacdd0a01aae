"""Batched fixed-iteration ICP: point-to-plane and point-to-point.

Reference: PCL TrimmedICP / point-to-point / point-to-plane refiners run one
pose at a time (utilities.cpp:651-739). Here H hypotheses refine together;
each iteration is one nearest-neighbour block + one closed-form update, with
a fixed iteration count and masked correspondences.

Correspondences run segment -> transformed model (every observed point has a
true correspondence on the model under partial occlusion). Outliers are
down-weighted by a Welsch kernel (default) or exactly trimmed to the best
trim_fraction of in-range matches. Hypotheses run in chunks of h_chunk, so
the [h_chunk, Ns, Nm] distance block is the largest tensor built.

Four refiners:
- refine_icp: plain PyTorch, every option; its loop is icp_steps, a
  generator without the finite guard (the MCTS TrICP final pass runs it,
  JAX's ops/icp._icp_single), and lockstep drives several such loops at
  once (refine_icp_each, the TrICP passes of a sweep's scenes), one wait
  for the card a point-to-point iteration for all of them;
- polish_icp: the final polish of estimate_pose and of the scene sweep, K
  poses each against its own model and segment, refine_icp's point-to-plane
  Welsch function. On the card it is one launch of csrc/icp_polish.cu
  (icp_polish below) for all poses and iterations; on the CPU, and for what
  the kernel does not take, it is the per-object refine_icp loop;
- refine_icp_segside: point-to-plane with Welsch weights only, in the
  segment-centred frame, one correspondence pass per iteration that returns
  just the 6x6 normal equations per hypothesis. On the card the pass is the
  CUDA kernel csrc/icp_corr_segside.cu (icp_corr_segside below); on the CPU
  it is icp_segside_pass_plain, which the tests and chip_smoke.py hold the
  kernel against. The scoring pipeline refines its survivors with it.
- refine_icp_stream: the same kind of pass for a model and a segment of any
  size, in the scene frame, the model streaming past the segment in tiles of
  nm_tile points (csrc/icp_corr_stream.cu, icp_corr_stream; plain version
  icp_stream_pass_plain). Within a tile exactly tied nearest model points are
  averaged; a later tile replaces the match only when strictly nearer. Its
  update has no finite guard, as the JAX package's refine_icp_pallas. No
  other code of the package calls it, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from physimglobalpose_tpu_torch import _build
from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)
from physimglobalpose_tpu_torch.ops import lcp as lcp_mod
from physimglobalpose_tpu_torch.utils import tracing


def _trim_weights(mind2, seg_mask, trim_fraction, max_corr_dist):
    """Weight 1 for the best trim_fraction of in-range correspondences. [B, Ns]."""
    ns = mind2.shape[-1]
    in_range = seg_mask & (mind2 <= max_corr_dist * max_corr_dist)
    n_valid = torch.sum(in_range, dim=-1)
    n_keep = torch.clamp((n_valid * trim_fraction).to(torch.int64), min=3)
    d_sorted = torch.sort(torch.where(in_range, mind2, torch.inf), dim=-1).values
    kth = torch.gather(d_sorted, -1, torch.clamp(n_keep - 1, 0, ns - 1)[:, None])
    return (in_range & (mind2 <= kth)).to(torch.float32)


def _robust_weights(mind2, seg_mask, max_corr_dist):
    """Welsch kernel at scale max_corr_dist/2, zero beyond max_corr_dist."""
    sigma2 = (max_corr_dist * 0.5) ** 2
    in_range = seg_mask & (mind2 <= max_corr_dist * max_corr_dist)
    return torch.where(in_range, torch.exp(-mind2 / (2.0 * sigma2)), 0.0)


def _skew(k: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(k[..., 0])
    return torch.stack(
        [
            torch.stack([z, -k[..., 2], k[..., 1]], dim=-1),
            torch.stack([k[..., 2], z, -k[..., 0]], dim=-1),
            torch.stack([-k[..., 1], k[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def _kabsch_matrix(p, q, w):
    """The weighted Kabsch solve's cross-covariance h [B, 3, 3] and the
    weighted centroids pc, qc [B, 3] (p, q: [B, N, 3]; w: [B, N])."""
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-6)
    pc = torch.sum(p * w[..., None], dim=-2) / wsum
    qc = torch.sum(q * w[..., None], dim=-2) / wsum
    x = (p - pc[:, None]) * w[..., None]
    y = q - qc[:, None]
    return x.transpose(-1, -2) @ y, pc, qc


def _kabsch_rotation(u, vt, pc, qc):
    """(R, t) of the weighted Kabsch solve from the SVD u, vt of its h."""
    v = vt.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(v @ u.transpose(-1, -2)))
    diag = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    rot = v @ diag @ u.transpose(-1, -2)
    t = qc - torch.einsum("bij,bj->bi", rot, pc)
    return rot, t


def _solve_point_to_plane(p, q, n, w):
    """Linearized point-to-plane per batch row: minimize
    sum w ((p + omega x p + t - q).n)^2, omega -> rotation by Rodrigues."""
    r = torch.sum((p - q) * n, dim=-1)  # [B, N]
    c = torch.linalg.cross(p, n)  # [B, N, 3]
    jac = torch.cat([c, n], dim=-1)  # [B, N, 6]
    jw = jac * w[..., None]
    a = jw.transpose(-1, -2) @ jac + 1e-8 * torch.eye(6, device=p.device)
    b = -(jw.transpose(-1, -2) @ r[..., None])
    x = torch.linalg.solve_ex(a, b).result[..., 0]  # no host sync; NaN rows fall back
    omega, t = x[..., :3], x[..., 3:]
    theta = torch.linalg.norm(omega, dim=-1)
    kx = _skew(omega / torch.clamp(theta, min=1e-12)[..., None])
    eye = torch.eye(3, device=p.device)
    rot = (
        eye
        + torch.sin(theta)[..., None, None] * kx
        + (1.0 - torch.cos(theta))[..., None, None] * (kx @ kx)
    )
    return rot, t


def _icp_chunk(tf, model_pts, model_nrm, seg_pts, seg_mask, iters, trim_fraction,
               max_corr_dist, point_to_plane, exact_trim, nn_refresh):
    """Refine tf [B, 4, 4] (nn_refresh > 1 reuses correspondences for that
    many solves, re-solving against the model-frame matches in between)."""
    return lockstep([icp_steps(tf, model_pts, model_nrm, seg_pts, seg_mask, iters,
                               trim_fraction, max_corr_dist, point_to_plane, exact_trim,
                               nn_refresh)])[0]


def icp_steps(tf, model_pts, model_nrm, seg_pts, seg_mask, iters, trim_fraction,
              max_corr_dist, point_to_plane, exact_trim, nn_refresh):
    """_icp_chunk's refinement as a generator: each point-to-point solve
    yields its Kabsch matrices h [B, 3, 3] and is sent back their SVD (u,
    vt); it returns the refined tf. lockstep drives several at once."""
    seg_sq = torch.sum(seg_pts * seg_pts, dim=-1)

    def correspond(tf):
        rot, t = tf[:, :3, :3], tf[:, :3, 3]
        tm = model_pts @ rot.transpose(-1, -2) + t[:, None, :]  # [B, Nm, 3]
        d2 = (
            seg_sq[None, :, None]
            + torch.sum(tm * tm, dim=-1)[:, None, :]
            - 2.0 * (seg_pts @ tm.transpose(-1, -2))
        )  # [B, Ns, Nm]
        mind2 = torch.amin(d2, dim=-1)
        # Matched point/normal as a row-normalized argmin one-hot (ties averaged).
        onehot = (d2 <= mind2[..., None]).to(torch.float32)
        onehot = onehot / torch.clamp(torch.sum(onehot, dim=-1, keepdim=True), min=1.0)
        p_model = onehot @ model_pts  # [B, Ns, 3] in the MODEL frame
        n_model = onehot @ model_nrm
        mind2 = torch.where(seg_mask, mind2, torch.inf)
        if exact_trim:
            w = _trim_weights(mind2, seg_mask, trim_fraction, max_corr_dist)
        else:
            w = _robust_weights(mind2, seg_mask, max_corr_dist)
        return p_model, n_model, w

    def solve(tf, p_model, n_model, w):
        rot, t = tf[:, :3, :3], tf[:, :3, 3]
        p = p_model @ rot.transpose(-1, -2) + t[:, None, :]
        seg_b = seg_pts.expand(p.shape[0], -1, -1)
        if point_to_plane:
            drot, dt = _solve_point_to_plane(p, seg_b, n_model @ rot.transpose(-1, -2), w)
        else:
            h, pc, qc = _kabsch_matrix(p, seg_b, w)
            u, vt = yield h
            drot, dt = _kabsch_rotation(u, vt, pc, qc)
        out = torch.zeros_like(tf)
        out[:, :3, :3] = drot @ rot
        out[:, :3, 3] = torch.einsum("bij,bj->bi", drot, t) + dt
        out[:, 3, 3] = 1.0
        return out

    done = 0
    while done < iters:
        corr = correspond(tf)
        for _ in range(min(max(nn_refresh, 1), iters - done)):
            tf = yield from solve(tf, *corr)
            done += 1
    return tf


def lockstep(steps: list) -> list:
    """Drive generators that yield Kabsch matrices and take back their SVD
    as icp_steps does (or that yield from it) together; returns what each
    returns. Each round's matrices of every generator go through one
    torch.linalg.svd call: it synchronises with the card to check its
    result, so refinements run in lockstep wait once a round where run one
    after another they wait once each. The SVD of a stack of matrices is
    each matrix's own, so every refinement gets the answer it gets alone."""
    out = [None] * len(steps)
    sent = [None] * len(steps)
    while True:
        pending = {}
        for i, g in enumerate(steps):
            if out[i] is None:
                try:
                    pending[i] = g.send(sent[i])
                except StopIteration as stop:
                    out[i] = stop.value
        if not pending:
            return out
        hs = list(pending.values())
        u, _, vt = torch.linalg.svd(hs[0] if len(hs) == 1 else torch.cat(hs))
        sizes = [h.shape[0] for h in hs]
        for i, ui, vti in zip(pending, u.split(sizes), vt.split(sizes)):
            sent[i] = (ui, vti)


def refine_icp(
    transforms: torch.Tensor,  # [H, 4, 4]
    model_pts: torch.Tensor,  # [Nm, 3]
    model_nrm: torch.Tensor,  # [Nm, 3]
    seg_pts: torch.Tensor,  # [Ns, 3]
    seg_mask: torch.Tensor,  # [Ns]
    iters: int = 20,
    trim_fraction: float = 0.8,
    max_corr_dist: float = 0.02,
    point_to_plane: bool = True,
    h_chunk: int = 64,
    exact_trim: bool = False,
    nn_refresh: int = 1,
) -> torch.Tensor:
    """Refine H poses; returns [H, 4, 4]. A hypothesis whose refinement goes
    non-finite (too few correspondences) keeps its input pose."""
    out = []
    for tf in transforms.split(h_chunk):
        ref = _icp_chunk(
            tf, model_pts, model_nrm, seg_pts, seg_mask, iters, trim_fraction,
            max_corr_dist, point_to_plane, exact_trim, nn_refresh,
        )
        out.append(_finite_or_input(ref, tf))
    return torch.cat(out)


def _finite_or_input(ref, tf):
    """refine_icp's guard: a pose whose refinement went non-finite keeps tf's."""
    ok = torch.all(torch.isfinite(ref).reshape(ref.shape[0], -1), dim=-1)
    return torch.where(ok[:, None, None], ref, tf)


def refine_icp_each(jobs, iters: int = 20, trim_fraction: float = 0.8,
                    max_corr_dist: float = 0.02, point_to_plane: bool = True) -> list:
    """refine_icp of several independent jobs, (transforms [H, 4, 4] with H
    <= 64, model_pts, model_nrm, seg_pts, seg_mask) each: returns each job's
    refine_icp answer, bit for bit, the refinements run in lockstep
    (lockstep: one wait for the card a point-to-point iteration for all of
    them)."""
    refined = lockstep([icp_steps(tf, mp, mn, sp, sm, iters, trim_fraction, max_corr_dist,
                                  point_to_plane, False, 1)
                        for tf, mp, mn, sp, sm in jobs])
    return [_finite_or_input(ref, job[0]) for ref, job in zip(refined, jobs)]


# ------------------------------------------------------------ the final polish

# Largest model the polish kernel takes: each block of a pose's cluster holds
# the transformed model in shared memory, 40 bytes a point (166 KB at 4,096).
MAX_POLISH_MODEL_POINTS = 4096


def _polish_on_kernel(device: torch.device, point_to_plane: bool, nm_max: int) -> bool:
    """polish_icp's route: the kernel for tensors on the card when the polish
    is point-to-plane and every model fits the kernel's shared memory."""
    return device.type == "cuda" and point_to_plane and nm_max <= MAX_POLISH_MODEL_POINTS


def _icp_polish_launcher():
    fn = _build.load("icp_polish").icp_polish_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def icp_polish(poses, model_pts, model_nrm, seg_pts, seg_mask, iters: int = 20,
               max_corr_dist: float = 0.02, model_counts=None) -> torch.Tensor:
    """Launch csrc/icp_polish.cu on the current stream: all `iters`
    iterations of polish_icp for K poses in one launch; returns [K, 4, 4].

    poses [K, 4, 4], model_pts and model_nrm [K, Nm, 3] (row k's first
    model_counts[k] points, all Nm where model_counts is None; 1 <= Nm <=
    MAX_POLISH_MODEL_POINTS), seg_pts [K, Ns, 3] float32, seg_mask [K, Ns]
    bool, model_counts [K] int32 or None; all contiguous on one card. Counts
    its launches in icp_polish.launches."""
    tensors = [poses, model_pts, model_nrm, seg_pts, seg_mask]
    if model_counts is not None:
        tensors.append(model_counts)
    if any(x.dtype != torch.float32 for x in tensors[:4]) or seg_mask.dtype != torch.bool:
        raise ValueError("icp_polish takes float32 poses, models and segments and a bool mask")
    if model_counts is not None and model_counts.dtype != torch.int32:
        raise ValueError("icp_polish takes int32 model_counts")
    k, nm, ns = poses.shape[0], model_pts.shape[1], seg_pts.shape[1]
    if poses.shape != (k, 4, 4) or model_pts.shape != (k, nm, 3) or model_nrm.shape != (k, nm, 3):
        raise ValueError("icp_polish: poses must be [K, 4, 4] and the models [K, Nm, 3]")
    if seg_pts.shape != (k, ns, 3) or seg_mask.shape != (k, ns):
        raise ValueError("icp_polish: seg_pts must be [K, Ns, 3] and seg_mask [K, Ns]")
    if model_counts is not None and model_counts.shape != (k,):
        raise ValueError("icp_polish: model_counts must be [K]")
    if not 1 <= nm <= MAX_POLISH_MODEL_POINTS:
        raise ValueError(f"icp_polish takes models of 1 to {MAX_POLISH_MODEL_POINTS} points")
    if iters < 0:
        raise ValueError("icp_polish: iters must be >= 0")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("icp_polish takes contiguous tensors")
    dev = poses.device
    if any(x.device != dev or x.device.type != "cuda" for x in tensors):
        raise ValueError("icp_polish takes CUDA tensors on one device")
    out = torch.empty((k, 4, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):  # launch in the tensors' own context
        rc = _icp_polish_launcher()(
            poses.data_ptr(), model_pts.data_ptr(), model_nrm.data_ptr(),
            0 if model_counts is None else model_counts.data_ptr(),
            seg_pts.data_ptr(), seg_mask.data_ptr(), out.data_ptr(), k, nm, ns, int(iters),
            max_corr_dist * max_corr_dist, 2.0 * (max_corr_dist * 0.5) ** 2,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"icp_polish launch failed with CUDA error {rc}")
    icp_polish.launches += 1
    return out


icp_polish.launches = 0


def _model_lengths(model_pts, model_counts, k: int) -> list[int]:
    """The valid points of each model: a list's lengths, else model_counts,
    else the stack's width."""
    if isinstance(model_pts, (list, tuple)):
        return [int(m.shape[0]) for m in model_pts]
    if model_counts is not None:
        return [int(c) for c in model_counts]
    return [int(model_pts.shape[1])] * k


def polish_icp_plain(poses, model_pts, model_nrm, seg_pts, seg_mask, iters: int = 20,
                     trim_fraction: float = 0.8, max_corr_dist: float = 0.02,
                     point_to_plane: bool = True, model_counts=None) -> torch.Tensor:
    """Plain PyTorch version of polish_icp: refine_icp once per pose."""
    lengths = _model_lengths(model_pts, model_counts, poses.shape[0])
    return torch.stack([
        refine_icp(
            poses[i][None], model_pts[i][:n], model_nrm[i][:n], seg_pts[i], seg_mask[i],
            iters=iters, trim_fraction=trim_fraction, max_corr_dist=max_corr_dist,
            point_to_plane=point_to_plane,
        )[0]
        for i, n in enumerate(lengths)
    ])


def polish_icp(
    poses: torch.Tensor,  # [K, 4, 4]
    model_pts,  # [K, Nm, 3] or a list of K [Nm_k, 3]
    model_nrm,  # the same
    seg_pts: torch.Tensor,  # [K, Ns, 3]
    seg_mask: torch.Tensor,  # [K, Ns]
    iters: int = 20,
    trim_fraction: float = 0.8,
    max_corr_dist: float = 0.02,
    point_to_plane: bool = True,
    model_counts=None,  # K ints: the valid points of each row of a stack
) -> torch.Tensor:
    """The final polish: pose k refined against model k and segment k;
    returns [K, 4, 4], row k being refine_icp(poses[k][None], model k,
    seg_pts[k], seg_mask[k], iters, trim_fraction, max_corr_dist,
    point_to_plane)[0] (exact_trim off, nn_refresh 1: Welsch weights, tied
    nearest model points averaged, a pose whose result is not finite keeps
    its input).

    On the card, with point_to_plane and every model of at most
    MAX_POLISH_MODEL_POINTS points, that is one launch of icp_polish, which
    adds polish_poses and polish_launches to the current span; otherwise,
    and on the CPU, polish_icp_plain.
    """
    k = poses.shape[0]
    lengths = _model_lengths(model_pts, model_counts, k)
    nm = max(lengths)
    if not _polish_on_kernel(poses.device, point_to_plane, nm):
        return polish_icp_plain(poses, model_pts, model_nrm, seg_pts, seg_mask, iters,
                                trim_fraction, max_corr_dist, point_to_plane, model_counts)
    if isinstance(model_pts, (list, tuple)):
        pad = torch.nn.utils.rnn.pad_sequence
        model_pts, model_nrm = pad(list(model_pts), batch_first=True), pad(list(model_nrm), batch_first=True)
    counts = None
    if any(n != nm for n in lengths):
        counts = torch.tensor(lengths, dtype=torch.int32, device=poses.device)
    f32 = lambda x: x.to(torch.float32).contiguous()  # noqa: E731
    out = icp_polish(
        f32(poses), f32(model_pts[:, :nm]), f32(model_nrm[:, :nm]), f32(seg_pts),
        seg_mask.to(torch.bool).contiguous(), iters, max_corr_dist, counts,
    )
    tracing.count(polish_poses=k, polish_launches=1)
    return out


# ------------------------------------------------- segment-stationary pass

# Largest model the kernel takes: it holds the d2 operands in shared memory (16
# bytes a point; 144 KB with its other arrays at 8,192 points).
def icp_fitness(
    transforms: torch.Tensor,  # [H, 4, 4]
    model_pts: torch.Tensor,  # [Nm, 3]
    seg_pts: torch.Tensor,  # [Ns, 3]
    seg_mask: torch.Tensor,  # [Ns]
    inlier_dist: float = 0.01,
) -> torch.Tensor:
    """Fraction of segment points within inlier_dist of the transformed model
    [H] (the squared distance expanded as |s|^2 + |u|^2 - 2 s.u, as the JAX
    package's _nn_model does). No code of the package calls it."""
    tm = model_pts @ transforms[:, :3, :3].transpose(-1, -2) + transforms[:, None, :3, 3]
    d2 = (
        torch.sum(seg_pts * seg_pts, dim=-1)[None, :, None]
        + torch.sum(tm * tm, dim=-1)[:, None, :]
        - 2.0 * (seg_pts @ tm.transpose(-1, -2))
    )  # [H, Ns, Nm]
    mind2 = torch.where(seg_mask, torch.amin(d2, dim=-1), torch.inf)
    ok = seg_mask & (mind2 <= inlier_dist * inlier_dist)
    return torch.sum(ok, dim=-1) / torch.clamp(torch.sum(seg_mask), min=1)


MAX_SEGSIDE_MODEL_POINTS = 8192
# matmul_precision -> the kernel's tier argument (no "high3" tier here).
ICP_TIERS = {None: 0, "highest": 0, "default": 1}


def pack_icp_segment(seg_c, seg_mask) -> torch.Tensor:
    """[Ns, 4] kernel layout of a centred segment: x, y, z, |s|^2 (1e9 where
    masked, so the point is never within max_corr_dist of anything)."""
    seg_sq = torch.where(seg_mask, torch.sum(seg_c * seg_c, dim=-1), 1e9)
    return torch.cat([seg_c, seg_sq[:, None]], dim=1).to(torch.float32).contiguous()


def icp_segside_pass_plain(tr12, seg4, model_pts, model_nrm, max_corr_dist: float = 0.02,
                           matmul_precision: str | None = None, h_chunk: int = 32):
    """Plain PyTorch version of one correspondence pass: (A [H, 6, 6], b [H, 6]).

    tr12 [H, 12] row-major (R | t) in the centred frame, seg4 from
    pack_icp_segment. Per segment point j: the nearest transformed model
    point by d2 = |s|^2 + |u|^2 - 2 s.u, the Welsch weight
    w = exp(-mind2 / (2 sigma^2)) (sigma = max_corr_dist / 2) when
    mind2 <= max_corr_dist^2 and 0 otherwise, shared equally by exactly tied
    nearest points. With col_i = (u_i x R n_i, R n_i) and the residual
    r_ji = (u_i - s_j) . R n_i:
      A = sum w_ji col_i col_i^T,   b = -sum w_ji col_i r_ji.
    "default" rounds to bf16 both operands of the d2 product (s, |s|^2, -2u,
    |u|^2), then w / ties, the segment coordinates in r_ji and col_i; the
    products and sums stay float32. d2 is a fixed chain of elementwise
    products and sums, the kernel's own, so both find the same
    correspondences.
    """
    lowp = bool(ICP_TIERS[matmul_precision])
    max_corr2 = max_corr_dist * max_corr_dist
    two_sigma2 = 2.0 * (max_corr_dist * 0.5) ** 2
    s4 = lcp_mod.round_bf16(seg4) if lowp else seg4
    a_out, b_out = [], []
    for tc in tr12.split(h_chunk):
        rt = tc.reshape(-1, 3, 4)
        rot, t = rt[:, :, :3], rt[:, :, 3]
        u = lcp_mod.rotate_points(rot, model_pts, t)  # [hc, Nm, 3]
        un = lcp_mod.rotate_points(rot, model_nrm)
        usq = (u[..., 0] * u[..., 0] + u[..., 1] * u[..., 1]) + u[..., 2] * u[..., 2]
        a = -2.0 * u
        if lowp:
            a, usq = lcp_mod.round_bf16(a), lcp_mod.round_bf16(usq)
        d2 = s4[:, 3, None] + usq[:, None, :]  # [hc, Ns, Nm]
        for ax in (2, 1, 0):
            d2 = s4[:, ax, None] * a[:, None, :, ax] + d2
        mind2 = torch.amin(d2, dim=-1)  # [hc, Ns]
        w = torch.where(mind2 <= max_corr2, torch.exp(-mind2 / two_sigma2), 0.0)
        is_best = d2 <= mind2[..., None]
        wq = w / torch.clamp(torch.sum(is_best, dim=-1), min=1)
        if lowp:
            wq = lcp_mod.round_bf16(wq)
        wone = is_best * wq[..., None]  # [hc, Ns, Nm]
        ux, uy, uz = u.unbind(-1)
        nx, ny, nz = un.unbind(-1)
        col = torch.stack(
            [uy * nz - uz * ny, uz * nx - ux * nz, ux * ny - uy * nx, nx, ny, nz], dim=-1
        )  # [hc, Nm, 6]
        if lowp:
            col = lcp_mod.round_bf16(col)
        res = (
            (ux[:, None, :] - s4[:, 0, None]) * nx[:, None, :]
            + (uy[:, None, :] - s4[:, 1, None]) * ny[:, None, :]
        ) + (uz[:, None, :] - s4[:, 2, None]) * nz[:, None, :]  # [hc, Ns, Nm]
        w_model = torch.sum(wone, dim=1)  # [hc, Nm]
        g_model = torch.sum(wone * res, dim=1)
        a_out.append(torch.einsum("hia,hi,hib->hab", col, w_model, col))
        b_out.append(-torch.einsum("hia,hi->ha", col, g_model))
    return torch.cat(a_out), torch.cat(b_out)


def _icp_launcher():
    fn = _build.load("icp_corr_segside").icp_corr_segside_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def icp_corr_segside(tr12, seg4, model_pts, model_nrm, max_corr_dist: float = 0.02,
                     matmul_precision: str | None = None):
    """Launch csrc/icp_corr_segside.cu on the current stream: one
    correspondence pass, the arguments and result of icp_segside_pass_plain.
    Counts its launches in icp_corr_segside.launches."""
    dev = tr12.device
    for x in (tr12, seg4, model_pts, model_nrm):
        if x.device != dev or x.device.type != "cuda":
            raise ValueError("icp_corr_segside takes CUDA tensors on one device")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("icp_corr_segside takes contiguous float32 tensors")
    h, ns, nm = tr12.shape[0], seg4.shape[0], model_pts.shape[0]
    if tr12.shape != (h, 12) or seg4.shape != (ns, 4):
        raise ValueError("icp_corr_segside: tr12 must be [H, 12] and seg4 [Ns, 4]")
    if model_pts.shape != (nm, 3) or model_nrm.shape != (nm, 3) or nm < 1:
        raise ValueError("icp_corr_segside: model_pts and model_nrm must be [Nm >= 1, 3]")
    if nm > MAX_SEGSIDE_MODEL_POINTS:
        raise NotImplementedError(
            f"models above {MAX_SEGSIDE_MODEL_POINTS} points do not fit the kernel's "
            "shared memory; use refine_icp"
        )
    out = torch.empty((h, 42), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):  # launch in the tensors' own context
        rc = _icp_launcher()(
            tr12.data_ptr(), seg4.data_ptr(), model_pts.data_ptr(), model_nrm.data_ptr(),
            out.data_ptr(), h, ns, nm, max_corr_dist * max_corr_dist,
            2.0 * (max_corr_dist * 0.5) ** 2, ICP_TIERS[matmul_precision],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"icp_corr_segside launch failed with CUDA error {rc}")
    icp_corr_segside.launches += 1
    return out[:, :36].reshape(h, 6, 6), out[:, 36:]


icp_corr_segside.launches = 0


def icp_segside_pass(tr12, seg4, model_pts, model_nrm, max_corr_dist: float = 0.02,
                     matmul_precision: str | None = None):
    """One correspondence pass: the kernel for tensors on the card, the plain
    version for tensors on the CPU."""
    fn = icp_segside_pass_plain if tr12.device.type == "cpu" else icp_corr_segside
    return fn(tr12, seg4, model_pts, model_nrm, max_corr_dist, matmul_precision)


def icp_update(tfs, a, b):
    """One pose update from the normal equations, the step of the JAX
    package's refine_icp_pallas: solve (A + 1e-8 I) x = b by an LU
    factorisation, x = (omega, t) -> Rodrigues rotation, composed onto tfs
    [H, 4, 4]. No guard: where the solve is not finite (an exactly singular
    system meets a zero pivot) the pose comes out non-finite."""
    eye6 = torch.eye(6, device=tfs.device, dtype=a.dtype)
    lu, pivots, _ = torch.linalg.lu_factor_ex(a + 1e-8 * eye6)  # no host sync
    x = torch.linalg.lu_solve(lu, pivots, b[..., None])[..., 0]
    omega, t = x[:, :3], x[:, 3:]
    theta = torch.linalg.norm(omega, dim=-1, keepdim=True)
    kx = _skew(omega / torch.clamp(theta, min=1e-12))
    drot = (
        torch.eye(3, device=tfs.device)
        + torch.sin(theta)[..., None] * kx
        + (1.0 - torch.cos(theta))[..., None] * (kx @ kx)
    )
    out = torch.zeros_like(tfs)
    out[:, :3, :3] = drot @ tfs[:, :3, :3]
    out[:, :3, 3] = torch.einsum("hij,hj->hi", drot, tfs[:, :3, 3]) + t
    out[:, 3, 3] = 1.0
    return out


def segside_update(tfs, a, b):
    """icp_update with the guard of refine_icp_pallas_segside: a hypothesis
    whose update is not finite keeps its pose."""
    out = icp_update(tfs, a, b)
    finite = torch.all(torch.isfinite(out).reshape(out.shape[0], -1), dim=-1)
    return torch.where(finite[:, None, None], out, tfs)


def refine_icp_segside(
    transforms: torch.Tensor,  # [H, 4, 4]
    model_pts: torch.Tensor,  # [Nm, 3]
    model_nrm: torch.Tensor,  # [Nm, 3]
    seg_pts: torch.Tensor,  # [Ns, 3]
    seg_mask: torch.Tensor,  # [Ns]
    iters: int = 6,
    max_corr_dist: float = 0.02,
    matmul_precision: str | None = None,
) -> torch.Tensor:
    """Segment-stationary point-to-plane ICP; returns [H, 4, 4].

    The same function as refine_icp(point_to_plane=True, exact_trim=False,
    nn_refresh=1): every iteration finds correspondences anew. Segment and
    poses are centred at the masked segment centroid before the passes (the
    "default" tier rounds coordinates to bf16, which is only safe at segment
    scale) and the result is returned in the original frame.
    matmul_precision: None / "highest" or "default".
    """
    if matmul_precision not in ICP_TIERS:
        raise ValueError(f"unknown ICP matmul_precision {matmul_precision!r}")
    seg_c, tfs = lcp_mod.center_at_segment(transforms, seg_pts, seg_mask)
    seg4 = pack_icp_segment(seg_c, seg_mask)
    mp = model_pts.to(torch.float32).contiguous()
    mn = model_nrm.to(torch.float32).contiguous()
    tfs = tfs.to(torch.float32)
    for _ in range(iters):
        tr12 = tfs[:, :3, :].reshape(-1, 12).contiguous()
        a, b = icp_segside_pass(tr12, seg4, mp, mn, max_corr_dist, matmul_precision)
        tfs = segside_update(tfs, a, b)
    tfs = tfs.clone()
    tfs[:, :3, 3] += lcp_mod.segment_centroid(seg_pts, seg_mask)
    return tfs


# ------------------------------------------------------ model-streaming pass

# Model points per tile of the tie rule, as the TPU wrapper sets it.
STREAM_NM_TILE = 256
# Segment points whose 27 sums the kernel keeps apart, a warp's group (kGroup
# in csrc/icp_corr_stream.cu): its workspace holds a row per group.
_STREAM_SEG_CHUNK = 128


def pack_icp_stream_segment(seg_pts, seg_mask) -> torch.Tensor:
    """[Ns, 4] layout of the streaming ICP kernel: x, y, z, mask (1 or 0), in
    the scene frame as given."""
    return torch.cat(
        [seg_pts, seg_mask.to(torch.float32)[:, None]], dim=1
    ).to(torch.float32).contiguous()


def icp_stream_pass_plain(tr12, seg4, model_pts, model_nrm, max_corr_dist: float = 0.02,
                          nm_tile: int = STREAM_NM_TILE, h_chunk: int | None = None):
    """Plain PyTorch version of one model-streaming correspondence pass:
    (A [H, 6, 6], b [H, 6]).

    tr12 [H, 12] row-major (R | t) in the scene frame, seg4 from
    pack_icp_stream_segment. Per hypothesis the model is transformed,
    p_i = R m_i + t, n_i = R nrm_i, and passes by in tiles of
    min(nm_tile, Nm) points. Per segment point s the tile's nearest distance
    by d2 = (|s|^2 + |p|^2) - 2 s . p (the kernel's fused chain, lcp.fma) and
    the mean (p, n) over the tile's exactly tied nearest points; a later tile
    replaces the running match only when strictly nearer. Then the Welsch
    weight w = exp(-d2 / (2 sigma^2)), sigma = max_corr_dist / 2, zero beyond
    max_corr_dist or where masked, the residual r = (p - s) . n and the row
    c = (p x n, n):  A = sum w c c^T,  b = -sum w c r.
    """
    ns, nm = seg4.shape[0], model_pts.shape[0]
    tile = min(nm_tile, nm)
    if h_chunk is None:
        h_chunk = max(1, lcp_mod._plain_block_values(tr12.device) // (ns * tile))
    max_corr2 = max_corr_dist * max_corr_dist
    two_sigma2 = 2.0 * (max_corr_dist * 0.5) ** 2
    seg, smask = seg4[:, :3], seg4[:, 3] > 0.5
    ssq = (seg[:, 0] * seg[:, 0] + seg[:, 1] * seg[:, 1]) + seg[:, 2] * seg[:, 2]
    a = -2.0 * seg
    a_out, b_out = [], []
    for tc in tr12.split(h_chunk):
        rt = tc.reshape(-1, 3, 4)
        rot, t = rt[:, :, :3], rt[:, :, 3]
        tm = lcp_mod.rotate_points(rot, model_pts, t)  # [hc, Nm, 3]
        tn = lcp_mod.rotate_points(rot, model_nrm)
        tsq = (tm[..., 0] * tm[..., 0] + tm[..., 1] * tm[..., 1]) + tm[..., 2] * tm[..., 2]
        packed = torch.cat([tm, tn], dim=-1)  # [hc, Nm, 6]
        run_min = torch.full((tc.shape[0], ns), 1e9, dtype=torch.float32, device=tc.device)
        run_matched = torch.zeros((tc.shape[0], ns, 6), dtype=torch.float32, device=tc.device)
        for m0 in range(0, nm, tile):
            sl = slice(m0, min(m0 + tile, nm))
            d2 = ssq[None, :, None] + tsq[:, None, sl]  # [hc, Ns, tile]
            for ax in (2, 1, 0):
                d2 = lcp_mod.fma(a[None, :, ax, None], tm[:, None, sl, ax], d2)
            tile_min = torch.amin(d2, dim=-1)
            onehot = (d2 <= tile_min[..., None]).to(torch.float32)
            onehot = onehot / torch.clamp(torch.sum(onehot, dim=-1, keepdim=True), min=1.0)
            matched = onehot @ packed[:, sl]  # [hc, Ns, 6]
            better = tile_min < run_min
            run_min = torch.where(better, tile_min, run_min)
            run_matched = torch.where(better[..., None], matched, run_matched)
        w = torch.where(smask & (run_min <= max_corr2), torch.exp(-run_min / two_sigma2), 0.0)
        p, nn = run_matched[..., :3], run_matched[..., 3:]
        resid = torch.sum((p - seg) * nn, dim=-1)  # [hc, Ns]
        cols = torch.cat([torch.linalg.cross(p, nn), nn], dim=-1)  # [hc, Ns, 6]
        a_out.append(torch.einsum("hsa,hs,hsb->hab", cols, w, cols))
        b_out.append(-torch.einsum("hsa,hs->ha", cols, w * resid))
    return torch.cat(a_out), torch.cat(b_out)


def _icp_stream_launcher():
    fn = _build.load("icp_corr_stream").icp_corr_stream_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def icp_corr_stream(tr12, seg4, model_pts, model_nrm, max_corr_dist: float = 0.02,
                    nm_tile: int = STREAM_NM_TILE):
    """Launch csrc/icp_corr_stream.cu on the current stream: one
    model-streaming correspondence pass, the arguments and result of
    icp_stream_pass_plain, for a model and a segment of any size. Counts its
    launches in icp_corr_stream.launches."""
    dev = tr12.device
    for x in (tr12, seg4, model_pts, model_nrm):
        if x.device != dev or x.device.type != "cuda":
            raise ValueError("icp_corr_stream takes CUDA tensors on one device")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("icp_corr_stream takes contiguous float32 tensors")
    h, ns, nm = tr12.shape[0], seg4.shape[0], model_pts.shape[0]
    if tr12.shape != (h, 12) or seg4.shape != (ns, 4) or ns < 1:
        raise ValueError("icp_corr_stream: tr12 must be [H, 12] and seg4 [Ns >= 1, 4]")
    if model_pts.shape != (nm, 3) or model_nrm.shape != (nm, 3) or nm < 1:
        raise ValueError("icp_corr_stream: model_pts and model_nrm must be [Nm >= 1, 3]")
    if nm_tile < 1:
        raise ValueError("icp_corr_stream: nm_tile must be positive")
    out = torch.empty((h, 42), dtype=torch.float32, device=dev)
    # 27 sums per (hypothesis, segment group); the launcher's second kernel
    # adds the groups per hypothesis in index order.
    partial = torch.empty((h, -(-ns // _STREAM_SEG_CHUNK), 27), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):  # launch in the tensors' own context
        rc = _icp_stream_launcher()(
            tr12.data_ptr(), seg4.data_ptr(), model_pts.data_ptr(), model_nrm.data_ptr(),
            partial.data_ptr(), out.data_ptr(), h, ns, nm, min(int(nm_tile), nm),
            max_corr_dist * max_corr_dist, 2.0 * (max_corr_dist * 0.5) ** 2,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"icp_corr_stream launch failed with CUDA error {rc}")
    icp_corr_stream.launches += 1
    return out[:, :36].reshape(h, 6, 6), out[:, 36:]


icp_corr_stream.launches = 0


def icp_stream_pass(tr12, seg4, model_pts, model_nrm, max_corr_dist: float = 0.02,
                    nm_tile: int = STREAM_NM_TILE):
    """One model-streaming correspondence pass: the kernel for tensors on the
    card, the plain version for tensors on the CPU."""
    fn = icp_stream_pass_plain if tr12.device.type == "cpu" else icp_corr_stream
    return fn(tr12, seg4, model_pts, model_nrm, max_corr_dist, nm_tile)


def refine_icp_stream(
    transforms: torch.Tensor,  # [H, 4, 4]
    model_pts: torch.Tensor,  # [Nm, 3]
    model_nrm: torch.Tensor,  # [Nm, 3]
    seg_pts: torch.Tensor,  # [Ns, 3]
    seg_mask: torch.Tensor,  # [Ns]
    iters: int = 10,
    max_corr_dist: float = 0.02,
    nm_tile: int = STREAM_NM_TILE,
) -> torch.Tensor:
    """Model-streaming point-to-plane ICP for clouds of any size (the JAX
    package's refine_icp_pallas); returns [H, 4, 4].

    Every iteration is one icp_stream_pass and one icp_update (the 6x6 solve,
    Rodrigues rotation and composition), with no finite guard, as in
    refine_icp_pallas: a hypothesis whose solve is not finite comes out
    non-finite. One without any correspondence keeps its pose (A = 1e-8 I,
    b = 0). It works in the scene frame, without centring, in float32 only.
    The matches differ from refine_icp's where nearest distances tie exactly:
    ties are averaged within a tile of nm_tile model points and a later tile
    does not join them.
    """
    seg4 = pack_icp_stream_segment(seg_pts, seg_mask)
    mp = model_pts.to(torch.float32).contiguous()
    mn = model_nrm.to(torch.float32).contiguous()
    tfs = transforms.to(torch.float32)
    for _ in range(iters):
        tr12 = tfs[:, :3, :].reshape(-1, 12).contiguous()
        a, b = icp_stream_pass(tr12, seg4, mp, mn, max_corr_dist, nm_tile)
        tfs = icp_update(tfs, a, b)
    return tfs
