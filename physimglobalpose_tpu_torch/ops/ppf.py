"""Point-pair features: discretization, model table build, device lookup.

Reference semantics (match4pcsBase.cc:582-598 computePPF, :150-160
approximate_bin; table format Objects.cpp:31-49 PPFMap.txt):

  u = p1 - p2
  f1 = int(|u| * 1000)                    # mm, truncated
  f2 = int(atan2(|n1 x u|, n1.u) deg)     # [0, 180]
  f3 = int(atan2(|n2 x u|, n2.u) deg)
  f4 = int(atan2(|n1 x n2|, n1.n2) deg)
  bin(v, disc) = round-to-nearest-multiple of disc, ties to the upper multiple

with trans_disc = 5 mm and rot_disc = 10 deg. The reference's hash map
bin -> directed model point-index pairs becomes a dense presence bitmap over
the flat bin space (edge-factor lookups during base sampling) and a CSR
(offsets + bin-sorted pair array) read under a fixed per-row cap. The table
is built on the host with numpy, then moved to the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)

N_ANGLE_BINS = 19  # multiples of 10 deg in [0, 180]


def n_dist_bins(max_dist_mm: int, trans_disc: int) -> int:
    return max_dist_mm // trans_disc + 1


def total_bins(max_dist_mm: int, trans_disc: int) -> int:
    return n_dist_bins(max_dist_mm, trans_disc) * N_ANGLE_BINS**3


def _approximate_bin_np(val: np.ndarray, disc: int) -> np.ndarray:
    """Reference approximate_bin (match4pcsBase.cc:150-160), vectorized."""
    lower = val - (val % disc)
    upper = lower + disc
    return np.where(val - lower < upper - val, lower, upper)


def ppf_features_np(p1, n1, p2, n2) -> np.ndarray:
    """Raw (undiscretized-int) PPF features; inputs [..., 3] -> [..., 4] int."""
    u = p1 - p2
    unorm = np.linalg.norm(u, axis=-1)
    f1 = (unorm * 1000.0).astype(np.int64)

    def angle(a, b):
        cr = np.linalg.norm(np.cross(a, b), axis=-1)
        dt = np.sum(a * b, axis=-1)
        return (np.degrees(np.arctan2(cr, dt))).astype(np.int64)

    return np.stack([f1, angle(n1, u), angle(n2, u), angle(n1, n2)], axis=-1)


def ppf_bins_np(
    p1, n1, p2, n2, trans_disc: int = 5, rot_disc: int = 10, max_dist_mm: int = 640
) -> np.ndarray:
    """Flat discretized bin index; -1 where the distance exceeds the range."""
    f = ppf_features_np(p1, n1, p2, n2)
    d = _approximate_bin_np(f[..., 0], trans_disc)
    a2 = _approximate_bin_np(f[..., 1], rot_disc) // rot_disc
    a3 = _approximate_bin_np(f[..., 2], rot_disc) // rot_disc
    a4 = _approximate_bin_np(f[..., 3], rot_disc) // rot_disc
    a2 = np.clip(a2, 0, N_ANGLE_BINS - 1)
    a3 = np.clip(a3, 0, N_ANGLE_BINS - 1)
    a4 = np.clip(a4, 0, N_ANGLE_BINS - 1)
    db = d // trans_disc
    nd = n_dist_bins(max_dist_mm, trans_disc)
    flat = ((db * N_ANGLE_BINS + a2) * N_ANGLE_BINS + a3) * N_ANGLE_BINS + a4
    return np.where(db < nd, flat, -1)


def ppf_bins_torch(
    p1, n1, p2, n2, trans_disc: int = 5, rot_disc: int = 10, max_dist_mm: int = 640
) -> torch.Tensor:
    """Same binning as ppf_bins_np on torch tensors; inputs broadcast [..., 3]."""
    u = p1 - p2
    unorm = torch.sqrt(torch.sum(u * u, dim=-1))
    f1 = (unorm * 1000.0).to(torch.int32)

    def angle(a, b):
        a, b = torch.broadcast_tensors(a, b)
        c = torch.linalg.cross(a, b)
        cr = torch.sqrt(torch.sum(c * c, dim=-1))
        dt = torch.sum(a * b, dim=-1)
        return torch.rad2deg(torch.atan2(cr, dt)).to(torch.int32)

    def abin(val, disc):
        lower = val - (val % disc)
        upper = lower + disc
        return torch.where(val - lower < upper - val, lower, upper)

    d = abin(f1, trans_disc)
    a2 = torch.clamp(abin(angle(n1, u), rot_disc) // rot_disc, 0, N_ANGLE_BINS - 1)
    a3 = torch.clamp(abin(angle(n2, u), rot_disc) // rot_disc, 0, N_ANGLE_BINS - 1)
    a4 = torch.clamp(abin(angle(n1, n2), rot_disc) // rot_disc, 0, N_ANGLE_BINS - 1)
    db = d // trans_disc
    nd = n_dist_bins(max_dist_mm, trans_disc)
    flat = ((db * N_ANGLE_BINS + a2) * N_ANGLE_BINS + a3) * N_ANGLE_BINS + a4
    return torch.where(db < nd, flat, -1)


class PPFTable(NamedTuple):
    """Model PPF table in dense CSR form (device tensors)."""

    presence: torch.Tensor  # [n_bins] bool - does any model pair land here
    offsets: torch.Tensor  # [n_bins] int32 - CSR row start into pairs
    counts: torch.Tensor  # [n_bins] int32 - CSR row length
    pairs: torch.Tensor  # [total_pairs, 2] int32 - directed (i, j), bin-sorted
    trans_disc: int
    rot_disc: int
    max_dist_mm: int


def table_from_arrays(
    offsets: np.ndarray,
    counts: np.ndarray,
    pairs: np.ndarray,
    trans_disc: int,
    rot_disc: int,
    max_dist_mm: int,
    device=None,
) -> PPFTable:
    """PPFTable on `device` from its CSR arrays (build output or .npz cache)."""
    counts_t = torch.tensor(np.asarray(counts), dtype=torch.int32, device=device)
    return PPFTable(
        presence=counts_t > 0,
        offsets=torch.tensor(np.asarray(offsets), dtype=torch.int32, device=device),
        counts=counts_t,
        pairs=torch.tensor(np.asarray(pairs), dtype=torch.int32, device=device).reshape(-1, 2),
        trans_disc=trans_disc,
        rot_disc=rot_disc,
        max_dist_mm=max_dist_mm,
    )


def build_ppf_table(
    points: np.ndarray,
    normals: np.ndarray,
    trans_disc: int = 5,
    rot_disc: int = 10,
    max_dist_mm: int = 640,
    device=None,
) -> PPFTable:
    """Build the model PPF table over all N^2-N directed point pairs, the
    content of the reference's offline PPFMap.txt. Uses the native C++
    builder (runtime/) when it builds; numpy otherwise."""
    from physimglobalpose_tpu_torch.runtime import build_ppf_native

    nat = build_ppf_native(points, normals, trans_disc, rot_disc, max_dist_mm)
    if nat is not None:
        return table_from_arrays(*nat, trans_disc, rot_disc, max_dist_mm, device)
    n = len(points)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    mask = ii != jj
    ii, jj = ii[mask], jj[mask]
    bins = ppf_bins_np(
        points[ii], normals[ii], points[jj], normals[jj], trans_disc, rot_disc, max_dist_mm
    )
    keep = bins >= 0
    ii, jj, bins = ii[keep], jj[keep], bins[keep]
    order = np.argsort(bins, kind="stable")
    bins_s = bins[order]
    pairs = np.stack([ii[order], jj[order]], axis=1).astype(np.int32)
    nb = total_bins(max_dist_mm, trans_disc)
    offsets = np.searchsorted(bins_s, np.arange(nb)).astype(np.int32)
    counts = np.diff(np.append(offsets, len(bins_s))).astype(np.int32)
    return table_from_arrays(offsets, counts, pairs, trans_disc, rot_disc, max_dist_mm, device)


def lookup_presence(table: PPFTable, flat_bins: torch.Tensor) -> torch.Tensor:
    """Vectorized presence lookup; -1 bins -> False."""
    safe = torch.clamp(flat_bins, 0, table.presence.shape[0] - 1).long()
    return (flat_bins >= 0) & table.presence[safe]


def gather_pairs(
    table: PPFTable, flat_bin: torch.Tensor, max_pairs: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fetch up to max_pairs model pairs for each bin of flat_bin [...].

    Returns (pairs [..., max_pairs, 2] int32, mask [..., max_pairs] bool).
    Rows longer than max_pairs are truncated (the reference randomly
    subsamples congruent sets anyway, match4pcsBase.cc:1864-1871).
    """
    safe_bin = torch.clamp(flat_bin, 0, table.offsets.shape[0] - 1).long()
    start = table.offsets[safe_bin].long()
    count = torch.where(flat_bin >= 0, table.counts[safe_bin], 0)
    count = torch.clamp(count, max=max_pairs)
    # Tail padding keeps the fixed-size window in bounds for every row start.
    padded = torch.cat(
        [table.pairs, torch.zeros(max_pairs, 2, dtype=table.pairs.dtype, device=table.pairs.device)]
    )
    ar = torch.arange(max_pairs, device=flat_bin.device)
    rows = padded[start[..., None] + ar]  # [..., max_pairs, 2]
    mask = ar < count[..., None]
    return torch.where(mask[..., None], rows, 0), mask
