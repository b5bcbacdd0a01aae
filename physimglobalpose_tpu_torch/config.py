"""Typed configuration for the whole pipeline.

A field-for-field copy of the JAX package's configuration tree
(physimglobalpose_tpu/config.py), which documents where each default comes
from in the reference (cmitash/PhysimGlobalPose). Both packages must agree on
every field and default; tests/test_torch_config.py holds them equal.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Depth/scene preprocessing knobs."""

    depth_min: float = 0.1
    depth_max: float = 2.0
    scene_voxel: float = 0.005
    plane_dist_threshold: float = 0.005
    plane_ransac_iters: int = 256
    segment_voxel: float = 0.01
    normal_k: int = 16  # k-NN PCA normals (replaces reference MLS normals)
    outlier_radius: float = 0.03
    outlier_min_neighbors: int = 10
    min_segment_points: int = 30
    max_segment_points: int = 1024  # fixed-size cap for a 3D segment
    prob_scale: float = 10000.0  # 16-bit prob-image fixed-point scale
    background_prob: float = 0.8  # FCN threshold mode background gate


@dataclasses.dataclass(frozen=True)
class StoCSConfig:
    """Stochastic Congruent Sets hypothesis generation."""

    num_bases: int = 100
    max_quads_per_base: int = 100
    delta: float = 0.005
    distance_factor: float = 2.0  # pair/invariant match radius multiplier
    trans_disc_mm: int = 5
    rot_disc_deg: int = 10
    min_base_angle_deg: float = 30.0
    coplanarity_threshold: float = 0.01
    min_point_spacing: float = 0.01
    max_pairs_per_ppf: int = 256  # pair-list cap per PPF bin (CSR row cap)
    max_ppf_dist_mm: int = 640  # distance-feature range cap (sets the bin count)
    max_hypotheses: int = 4096  # global per-object hypothesis cap


@dataclasses.dataclass(frozen=True)
class LCPConfig:
    """Largest-common-pointset verification."""

    delta: float = 0.005
    normal_gate_deg: float = 30.0


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Batched fixed-iteration ICP refinement."""

    iters: int = 20
    trim_fraction: float = 0.8  # keep this fraction of best correspondences
    max_corr_dist: float = 0.02
    point_to_plane: bool = True


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Depth rendering + pixel cost."""

    width: int = 640
    height: int = 480
    max_render_depth: float = 1.0
    explanation_threshold: float = 0.01


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """Vectorized rigid-body settle."""

    gravity: float = -2.0
    steps: int = 30
    dt: float = 1.0 / 60.0
    substeps: int = 2
    damping: float = 0.99
    friction: float = 1.0
    restitution: float = 0.0
    object_mass: float = 10.0
    table_half_extents: Tuple[float, float, float] = (0.40, 0.40, 0.20)
    contact_slop: float = 0.001


@dataclasses.dataclass(frozen=True)
class MCTSConfig:
    """UCT search over object placement orders."""

    alpha: float = 5000.0
    max_search_seconds: float = 60.0
    branching: int = 25
    render_scale: int = 4
    contact_hull_vertices: int = 0
    leaf_splat_radius: int = -1
    sequential_settle: bool = True
    leaf_batch: int = 128
    leaf_batch_multi: int = 512
    inflight_batches: int = 2
    tricp_final: bool = True
    tricp_trim: float = 0.9
    tricp_removal_radius: float = 0.008
    tricp_iters: int = 12
    tricp_max_corr_dist: float = 0.06
    final_polish_rounds: int = 0
    final_polish_batch: int = 192
    final_polish_sigma_t: float = 0.01
    final_polish_sigma_r_deg: float = 4.0
    final_polish_scale: int = 1
    final_polish_per_object: bool = True
    max_expansions: int = 1200


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level pipeline configuration."""

    preprocess: PreprocessConfig = PreprocessConfig()
    stocs: StoCSConfig = StoCSConfig()
    lcp: LCPConfig = LCPConfig()
    icp: ICPConfig = ICPConfig()
    render: RenderConfig = RenderConfig()
    physics: PhysicsConfig = PhysicsConfig()
    mcts: MCTSConfig = MCTSConfig()
    # Model asset caps (fixed shapes).
    max_model_points: int = 1024  # sampled model cloud (matching)
    max_validation_points: int = 4096  # dense model cloud (LCP / render)
    max_hull_points: int = 64  # convex hull vertices (physics / pose dist)


DEFAULT_CONFIG = PipelineConfig()

# The entry points' --preset. "small" shrinks the fixed-size caps for fast
# CPU runs; it is the JAX package's SMALL_CFG (tests/test_e2e_scene.py), the
# configuration of its whole-scene bench and service load test.
PRESETS = {
    "default": DEFAULT_CONFIG,
    "small": PipelineConfig(
        preprocess=PreprocessConfig(max_segment_points=512),
        stocs=StoCSConfig(num_bases=48, max_quads_per_base=32, max_pairs_per_ppf=128),
        max_model_points=512,
        max_validation_points=1024,
    ),
}
