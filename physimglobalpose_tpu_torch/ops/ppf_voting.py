"""PPF (Drost-style) Hough voting pose generation.

Reference status: PPFVoting::generate is a stub (its core call commented
out, ObjectPoseCandidateSet.cpp:113) and the Hough machinery of the fork
(computeTransformRT / computeAlpha / Perform_Hough_Voting,
match4pcsBase.cc:1062-1409,1804-1820) is inactive; the JAX package provides
a working version of that pathway, and this module is its port.

Algorithm (Drost et al. CVPR'10): for every scene reference point s_r, every
other scene point s_i forms a PPF; the model's pair list for that PPF bin
proposes (m_r, m_i) correspondences. Each correspondence votes for
(m_r, alpha), alpha the roll angle about the aligned normal axis. Peaks of
the vote table give poses T = T_s^-1 . Rx(alpha) . T_m.

The vote table [n_ref, n_model, n_alpha] is one integer scatter-add
(bincount, exact in any order) with a spill slot for masked votes; the top
poses keep tied counts in index order, as jax.lax.top_k does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)
from physimglobalpose_tpu_torch.ops import ppf as ppf_mod
from physimglobalpose_tpu_torch.ops.sampling import NEG_INF, _categorical_rows, gumbel_noise


def _skew(k: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(k[..., 0])
    return torch.stack(
        [z, -k[..., 2], k[..., 1], k[..., 2], z, -k[..., 0], -k[..., 1], k[..., 0], z], dim=-1
    ).reshape(k.shape[:-1] + (3, 3))


def _homogeneous(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    top = torch.cat([rot, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=rot.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def canonical_frame(p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """SE(3) transform T with T(p) = 0 and T's rotation mapping n -> +x
    (computeTransformRT semantics). Inputs [..., 3]; returns [..., 4, 4]."""
    ex = torch.tensor([1.0, 0.0, 0.0], device=p.device).expand(n.shape)
    n = n / torch.clamp(torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True)), min=1e-12)
    axis = torch.linalg.cross(n, ex)
    s = torch.sqrt(torch.sum(axis * axis, dim=-1, keepdim=True))
    c = torch.sum(n * ex, dim=-1, keepdim=True)
    kx = _skew(axis / torch.clamp(s, min=1e-12))
    eye = torch.eye(3, device=p.device).expand(kx.shape)
    rot = eye + s[..., None] * kx + (1 - c[..., None]) * (kx @ kx)  # Rodrigues
    # n == +x -> identity; n == -x -> 180 deg about z.
    flip = torch.tensor([[-1.0, 0, 0], [0, -1.0, 0], [0, 0, 1.0]], device=p.device).expand(kx.shape)
    degenerate = s[..., 0] < 1e-6
    rot = torch.where(degenerate[..., None, None], torch.where(c[..., None] > 0, eye, flip), rot)
    t = -torch.einsum("...ij,...j->...i", rot, p)
    return _homogeneous(rot, t)


def _alpha_of(frame: torch.Tensor, partner: torch.Tensor) -> torch.Tensor:
    """Roll angle of a partner point in the canonical frame (about +x)."""
    local = torch.einsum("...ij,...j->...i", frame[..., :3, :3], partner) + frame[..., :3, 3]
    return torch.atan2(local[..., 2], local[..., 1])


class VoteResult(NamedTuple):
    transforms: torch.Tensor  # [P, 4, 4] candidate poses (model -> scene)
    votes: torch.Tensor  # [P] vote counts (int64)
    valid: torch.Tensor  # [P]


def ppf_vote(
    seg_pts: torch.Tensor,  # [Ns, 3]
    seg_nrm: torch.Tensor,
    seg_mask: torch.Tensor,
    model_pts: torch.Tensor,  # [Nm, 3]
    model_nrm: torch.Tensor,
    model_mask: torch.Tensor,
    table: ppf_mod.PPFTable,
    n_ref: int = 64,
    max_pairs: int = 32,
    n_alpha: int = 32,
    top_poses: int = 64,
    generator: torch.Generator | None = None,
    gumbel: torch.Tensor | None = None,
) -> VoteResult:
    """Run PPF voting; returns the top-voted candidate poses.

    gumbel: optional injected [n_ref, Ns] Gumbel draws that pick the
    reference points uniformly among the unmasked segment points.
    """
    ns = seg_pts.shape[0]
    nm = model_pts.shape[0]
    dev = seg_pts.device
    if gumbel is None:
        gumbel = gumbel_noise((n_ref, ns), generator, dev)
    logw = torch.where(seg_mask, 0.0, NEG_INF)[None].expand(n_ref, ns)
    ref_idx = _categorical_rows(logw, gumbel)  # [R]

    ref_p = seg_pts[ref_idx]  # [R, 3]
    ref_n = seg_nrm[ref_idx]
    ref_frame = canonical_frame(ref_p, ref_n)  # [R, 4, 4]

    # PPFs between each reference point and every scene partner.
    bins = ppf_mod.ppf_bins_torch(
        ref_p[:, None, :], ref_n[:, None, :], seg_pts[None], seg_nrm[None],
        table.trans_disc, table.rot_disc, table.max_dist_mm,
    )  # [R, Ns]
    pairs, pmask = ppf_mod.gather_pairs(table, bins, max_pairs)  # [R, Ns, K, 2], [R, Ns, K]
    # The partner must be unmasked and not the reference itself.
    partner_ok = seg_mask[None, :] & (torch.arange(ns, device=dev)[None, :] != ref_idx[:, None])
    pmask = pmask & partner_ok[:, :, None]

    # Scene-side roll angle per (ref, partner); model side per candidate m_r.
    alpha_s = _alpha_of(ref_frame[:, None], seg_pts[None])  # [R, Ns]
    m_r = pairs[..., 0].long()  # [R, Ns, K]
    m_i = pairs[..., 1].long()
    alpha_m = _alpha_of(canonical_frame(model_pts[m_r], model_nrm[m_r]), model_pts[m_i])
    alpha = alpha_s[:, :, None] - alpha_m  # [R, Ns, K]
    abin = torch.remainder(
        torch.floor((alpha + math.pi) / (2 * math.pi) * n_alpha).to(torch.int64), n_alpha
    )

    # Vote table [R, Nm, n_alpha]: counts of the flat index, masked votes in
    # the spill slot at the end.
    size = n_ref * nm * n_alpha
    flat = (torch.arange(n_ref, device=dev)[:, None, None] * nm + m_r) * n_alpha + abin
    flat = torch.where(pmask, flat, size)
    votes = torch.bincount(flat.reshape(-1), minlength=size + 1)[:size].reshape(n_ref, nm, n_alpha)
    votes = torch.where(model_mask[None, :, None], votes, 0)  # padding rows never win

    # Top poses across the whole table, ties in index order: the int64 key
    # (votes << 32) + (size - 1 - index) is distinct per entry and orders as
    # jax.lax.top_k does, so a top-k selection needs no full sort.
    flat_votes = votes.reshape(-1)
    key = (flat_votes << 32) + (size - 1 - torch.arange(size, device=dev))
    top_i = torch.topk(key, top_poses, sorted=True).indices
    top_v = flat_votes[top_i]
    r_i = top_i // (nm * n_alpha)
    m_i2 = (top_i // n_alpha) % nm
    a_i = top_i % n_alpha

    alpha_c = (a_i.to(torch.float32) + 0.5) / n_alpha * 2 * math.pi - math.pi
    ca, sa = torch.cos(alpha_c), torch.sin(alpha_c)
    zeros, ones = torch.zeros_like(ca), torch.ones_like(ca)
    rx = torch.stack(
        [ones, zeros, zeros, zeros,
         zeros, ca, -sa, zeros,
         zeros, sa, ca, zeros,
         zeros, zeros, zeros, ones],
        dim=-1,
    ).reshape(-1, 4, 4)

    ts = ref_frame[r_i]  # [P, 4, 4] scene frame
    tm = canonical_frame(model_pts[m_i2], model_nrm[m_i2])
    ts_inv_rot = ts[:, :3, :3].transpose(-1, -2)
    ts_inv = _homogeneous(ts_inv_rot, -torch.einsum("pij,pj->pi", ts_inv_rot, ts[:, :3, 3]))
    pose = ts_inv @ rx @ tm
    return VoteResult(transforms=pose, votes=top_v, valid=top_v > 0)
