"""SE(3) helpers on torch tensors.

Conventions as in the JAX package: quaternions are [w, x, y, z], poses are
4x4 homogeneous matrices, world<->camera changes are plain matrix products.
Every function accepts arbitrary leading batch dimensions.
"""

from __future__ import annotations

import torch

from physimglobalpose_tpu_torch import _torchcfg  # noqa: F401  (precision setup)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] (w, x, y, z) -> rotation matrix [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - w * z),
            2 * (x * z + w * y),
            2 * (x * y + w * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - w * x),
            2 * (x * z - w * y),
            2 * (y * z + w * x),
            1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion [..., 4] (w, x, y, z).

    Branch-free Shepperd's method: all four candidate forms, pick the one
    with the largest pivot, canonical sign w >= 0.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)

    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4 cand, 4 comp]
    best = torch.argmax(pivots, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def pose_from_quat_trans(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(quat [..., 4], trans [..., 3]) -> homogeneous pose [..., 4, 4]."""
    return pose_from_rot_trans(quat_to_matrix(q), t)


def pose_from_rot_trans(rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(rotation [..., 3, 3], trans [..., 3]) -> pose [..., 4, 4], broadcast."""
    batch = torch.broadcast_shapes(rot.shape[:-2], t.shape[:-1])
    rot = rot.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([rot, t[..., :, None]], dim=-1)
    bottom = top.new_zeros(batch + (1, 4))  # filled on the device: no host copy
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def invert_pose(pose: torch.Tensor) -> torch.Tensor:
    """Rigid inverse: [R|t]^-1 = [R^T | -R^T t] (utilities.cpp:303-329)."""
    rot_t = pose[..., :3, :3].transpose(-1, -2)
    t_new = -torch.einsum("...ij,...j->...i", rot_t, pose[..., :3, 3])
    return pose_from_rot_trans(rot_t, t_new)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pose composition a @ b with broadcasting."""
    return a @ b


def to_world(pose_cam: torch.Tensor, cam_pose: torch.Tensor) -> torch.Tensor:
    """Camera-frame object pose -> world frame."""
    return cam_pose @ pose_cam


def transform_points(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply pose [..., 4, 4] to points [..., N, 3] -> [..., N, 3]."""
    rot = pose[..., :3, :3]
    t = pose[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", rot, points) + t[..., None, :]


def rotate_vectors(pose: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Apply only the rotation of pose [..., 4, 4] to vectors [..., N, 3]."""
    return torch.einsum("...ij,...nj->...ni", pose[..., :3, :3], vecs)


def to_camera(pose_world: torch.Tensor, cam_pose: torch.Tensor) -> torch.Tensor:
    """World-frame object pose -> camera frame (utilities.cpp:332-338)."""
    return compose(invert_pose(cam_pose), pose_world)


def quat_to_euler_xyz(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> (roll, pitch, yaw) radians: roll about x,
    pitch about y (asin, clamped), yaw about z, the reference's
    toEulerianAngle (utilities.cpp:341-361)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def matrix_to_euler_xyz(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> euler XYZ via the quaternion path."""
    return quat_to_euler_xyz(matrix_to_quat(m))
