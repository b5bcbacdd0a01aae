"""Voxel-grid downsampling with fixed output size.

Replaces PCL VoxelGrid (5 mm for the scene, 1 cm for segments): one centroid
per occupied voxel, computed by a stable sort on the voxel key and segment
sums, compacted to the front of a fixed-size buffer with a validity mask.
The sums are a segmented reduction over the sorted points, so they do not
depend on the device or the run.
"""

from __future__ import annotations

import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)


def voxel_ids(points: torch.Tensor, mask: torch.Tensor, voxel: float) -> torch.Tensor:
    """Integer voxel key per point (invalid points get the max key).

    Keys pack 3x10 bits: valid within +-512 voxels of the origin; coordinates
    outside clamp.
    """
    ijk = torch.clamp(torch.floor(points / voxel).to(torch.int32) + 512, 0, 1023)
    key = (ijk[..., 0] * 1024 + ijk[..., 1]) * 1024 + ijk[..., 2]
    return torch.where(mask, key, 2**30)


def voxel_downsample(
    points: torch.Tensor,
    mask: torch.Tensor,
    voxel: float,
    max_out: int,
    extras: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Centroid-per-voxel downsample.

    Args:
      points: [N, 3]; mask: [N] bool; voxel: edge length (m).
      max_out: output size.
      extras: optional [N, C] per-point attributes averaged alongside.
    Returns:
      (out [max_out, 3], out_mask [max_out], out_extras [max_out, C] | None)
    """
    keys = voxel_ids(points, mask, voxel)
    order = torch.argsort(keys, stable=True)
    keys_s = keys[order]
    pts_s = points[order]
    valid_s = mask[order]

    # Segment boundaries: first occurrence of each key.
    is_first = torch.ones_like(valid_s)
    is_first[1:] = keys_s[1:] != keys_s[:-1]
    is_first = is_first & valid_s
    seg = torch.cumsum(is_first.to(torch.int64), dim=0) - 1
    # Invalid points and voxels past max_out go to the overflow bucket.
    seg = torch.where(valid_s, seg, max_out).clamp(max=max_out)

    num_seg = max_out + 1
    w = valid_s.to(torch.float32)
    # Per-voxel sums: seg is non-decreasing, so each voxel is a contiguous run
    # of the sorted points, and a segmented reduction adds each run in order,
    # the same order on the CPU and on the card (index_add_'s float atomics
    # would add in another order each run on the card).
    bounds = torch.searchsorted(seg, torch.arange(num_seg + 1, device=points.device))
    cols = [pts_s * w[:, None], w[:, None]]
    if extras is not None:
        cols.append(extras[order] * w[:, None])
    sums_all = torch.segment_reduce(torch.cat(cols, dim=1), "sum",
                                    lengths=bounds[1:] - bounds[:-1], axis=0, unsafe=True)
    sums, counts = sums_all[:, :3], sums_all[:, 3]
    denom = torch.clamp(counts, min=1.0)[:, None]
    out_mask = counts[:max_out] > 0
    cent = torch.where(out_mask[:, None], (sums / denom)[:max_out], 0.0)

    out_extras = None
    if extras is not None:
        out_extras = torch.where(out_mask[:, None], (sums_all[:, 4:] / denom)[:max_out], 0.0)
    return cent, out_mask, out_extras
