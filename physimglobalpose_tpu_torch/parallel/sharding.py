"""Hypothesis-sharded variants of the hot pipeline stages.

The hypothesis batch H is the workload's long axis: LCP scoring and ICP
refinement batch over it. Here H is padded to a multiple of the mesh size,
split into contiguous shards, each shard is scored against its own copy of
the model and segment clouds on its device (kernel 1 on a card, or kernel 4
above 2,048 segment points: ops/lcp.lcp_scores routes per call), and the
shards come back to the mesh's first device. The JAX package's versions
(physimglobalpose_tpu/parallel/sharding.py) do the same with a NamedSharding.
"""

from __future__ import annotations

import torch

from physimglobalpose_tpu_torch.ops import icp, lcp
from physimglobalpose_tpu_torch.parallel import mesh as mesh_mod
from physimglobalpose_tpu_torch.parallel.mesh import DeviceMesh


def _per_shard(mesh: DeviceMesh, transforms: torch.Tensor, shared, fn) -> torch.Tensor:
    """fn(shard, *shared on the shard's device) over H shards, gathered and
    cut back to H rows."""
    h = transforms.shape[0]
    shards = mesh_mod.shard_along(mesh, mesh_mod.pad_rows(transforms, mesh_mod.padded_length(h, mesh)))
    copies = [mesh_mod.replicated(mesh, a) for a in shared]
    outs = [fn(tf, *(c[i] for c in copies)) for i, tf in enumerate(shards)]
    return mesh_mod.gather(outs, mesh.device_list[0])[:h]


def sharded_lcp_scores(
    mesh: DeviceMesh,
    transforms: torch.Tensor,  # [H, 4, 4]
    model_pts, model_nrm, seg_pts, seg_nrm, seg_prob, seg_mask,
    delta: float = 0.005,
    normal_gate_deg: float = 30.0,
    weighted: bool = True,
    matmul_precision: str | None = None,
) -> torch.Tensor:
    """LCP scores [H] with H split over every device of the mesh."""
    return _per_shard(
        mesh, transforms, (model_pts, model_nrm, seg_pts, seg_nrm, seg_prob, seg_mask),
        lambda tf, *args: lcp.lcp_scores(
            tf, *args, delta=delta, normal_gate_deg=normal_gate_deg, weighted=weighted,
            matmul_precision=matmul_precision,
        ),
    )


def sharded_refine_icp(
    mesh: DeviceMesh,
    transforms: torch.Tensor,  # [H, 4, 4]
    model_pts, model_nrm, seg_pts, seg_mask,
    iters: int = 20,
    trim_fraction: float = 0.8,
    max_corr_dist: float = 0.02,
    point_to_plane: bool = True,
) -> torch.Tensor:
    """Batched ICP ([H, 4, 4] out) with H split over every device."""
    return _per_shard(
        mesh, transforms, (model_pts, model_nrm, seg_pts, seg_mask),
        lambda tf, *args: icp.refine_icp(
            tf, *args, iters=iters, trim_fraction=trim_fraction,
            max_corr_dist=max_corr_dist, point_to_plane=point_to_plane,
        ),
    )
